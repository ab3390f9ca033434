"""Fault-tolerance machinery (port of ``repro/distributed/fault_tolerance.py``).

* :class:`StepMonitor` keeps a running window of a scalar series (step
  times, or the numerics layer's per-site drift scores) in the telemetry's
  :class:`~repro_torch.serving.telemetry.StreamingStats` and flags a value
  above ``straggler_factor`` times the running median.
* :func:`elastic_plan` -- given the surviving chip count, the largest valid
  (pod, data, model) mesh that keeps the tensor-parallel degree, and the
  re-split global batch. The launcher rebuilds the mesh and restores the
  latest checkpoint, which holds the state unsharded and logical, so any
  mesh can load it.
* :class:`Heartbeat` -- a liveness file per host; a stale heartbeat is a
  dead host.
* :func:`find_resumable_step` -- the newest COMMIT-marked checkpoint step
  (the ``step_<N>/COMMIT`` layout of ``checkpoint.checkpointer``).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time

from repro_torch.serving.telemetry import StreamingStats

__all__ = ["StepMonitor", "StreamingStats", "Heartbeat", "ElasticPlan", "elastic_plan",
           "find_resumable_step"]


class StepMonitor:
    """Straggler detection (value > factor x running median, once the
    window holds 8 values) over a :class:`StreamingStats` window."""

    def __init__(self, window: int = 64, straggler_factor: float = 2.0):
        self.stats = StreamingStats(window=window)
        self.factor = straggler_factor
        self.straggler_count = 0

    @property
    def window(self) -> int:
        return self.stats.window

    @property
    def times(self) -> list[float]:
        return self.stats.times

    def record(self, dt: float) -> None:
        self.stats.record(dt)
        if self.is_straggler(dt):
            self.straggler_count += 1

    def median(self) -> float:
        return self.stats.median()

    def is_straggler(self, dt: float) -> bool:
        return len(self.stats) >= 8 and dt > self.factor * self.median()

    def summary(self) -> dict:
        if not len(self.stats):
            return {}
        return {
            "median_s": self.median(),
            "p95_s": self.stats.percentile(95),
            "stragglers": self.straggler_count,
        }


class Heartbeat:
    """Per-host liveness file; the launcher declares a host dead when stale."""

    def __init__(self, directory: str, host_id: int, stale_after_s: float = 60.0):
        self.path = pathlib.Path(directory) / f"heartbeat_{host_id}.json"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.stale_after = stale_after_s
        self.host_id = host_id

    def beat(self, step: int = -1) -> None:
        self.path.write_text(json.dumps({"t": time.time(), "step": step, "host": self.host_id}))

    @staticmethod
    def live_hosts(directory: str, stale_after_s: float = 60.0) -> list[int]:
        now = time.time()
        out = []
        for f in pathlib.Path(directory).glob("heartbeat_*.json"):
            try:
                d = json.loads(f.read_text())
            except (json.JSONDecodeError, OSError):
                continue
            if now - d["t"] < stale_after_s:
                out.append(int(d["host"]))
        return sorted(out)


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    mesh_shape: tuple[int, ...]
    mesh_axes: tuple[str, ...]
    global_batch: int
    note: str


def elastic_plan(surviving_chips: int, model_parallel: int, old_global_batch: int,
                 old_chips: int, chips_per_pod: int = 256) -> ElasticPlan:
    """Largest valid mesh after failures, keeping the TP degree.

    The TP degree is kept (changing it reshards the weights); the DP extent
    shrinks to the largest multiple that fits, and the global batch scales
    with the chips (the per-replica batch stays)."""
    if surviving_chips < model_parallel:
        raise ValueError("fewer chips than one TP group — cannot continue")
    dp = surviving_chips // model_parallel
    chips = dp * model_parallel
    pods = max(1, chips // chips_per_pod)
    new_batch = max(1, old_global_batch * chips // old_chips)
    if pods > 1 and chips % chips_per_pod == 0:
        shape = (pods, chips_per_pod // model_parallel, model_parallel)
        axes = ("pod", "data", "model")
    else:
        shape = (dp, model_parallel)
        axes = ("data", "model")
    return ElasticPlan(
        mesh_shape=shape,
        mesh_axes=axes,
        global_batch=new_batch,
        note=f"dropped {old_chips - chips} chips; DP {old_chips // model_parallel} -> {dp}",
    )


def find_resumable_step(ckpt_dir: str) -> int | None:
    """Newest COMMIT-marked checkpoint step (None if none exist)."""
    best = None
    for d in pathlib.Path(ckpt_dir).glob("step_*"):
        if (d / "COMMIT").exists():
            s = int(d.name.split("_")[1])
            best = s if best is None else max(best, s)
    return best
