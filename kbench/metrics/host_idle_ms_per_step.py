"""Scheduler: the device's idle time in the traced slice that falls in the
host phases of the traced steps other than ``replay`` (admission, planning,
packing, sampling, bookkeeping: each step record's ``phases``, stamped on
the host clock the profiler converts its device timestamps to), per traced
step. The phases are moved by how far the trace's device timestamps stray
from that clock (``replays.stray_ns``). Idle inside ``replay`` is the
graph's own; idle outside every phase (the harness) is not the
scheduler's. None when the steps carry no phases."""

from kbench.metrics.replays import stray_ns


def idle_spans(trace) -> list[tuple[int, int]]:
    """The slice's intervals with no device event, in order."""
    w0, w1 = trace.window
    spans, t = [], w0
    for _, a, b in trace.device:  # in start order
        if a > t:
            spans.append((t, a))
        t = max(t, b)
    if w1 > t:
        spans.append((t, w1))
    return spans


def overlap_ns(xs, ys) -> int:
    """Total overlap of two sorted lists of disjoint intervals."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run):
    t = run.trace
    steps = [s for s in run.steps if s.get("traced") and s.get("phases")]
    if t is None or not steps:
        return None
    d = stray_ns(run) or 0
    host = sorted((a + d, b + d) for s in steps for name, a, b in s["phases"] if name != "replay")
    return overlap_ns(idle_spans(t), host) / len(steps) / 1e6
