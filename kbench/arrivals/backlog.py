"""A closed loop: before every step the queue is topped up to
``queue_per_slot`` x slots waiting requests, so the system never waits for
work (an offline batch; vLLM's ``benchmark_serving.py --request-rate inf``
sends every request at once)."""

OPEN = False


def target(spec: dict, slots: int) -> int:
    return int(spec["queue_per_slot"] * slots)
