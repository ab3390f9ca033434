"""Finds each traced step's graph replay in the profiler's device events,
for the readers of the program's step records (``comp_share``,
``dispatch_share``, ``orizuru_roofline``, ``host_idle_ms_per_step``).

A step record's ``phases`` are stamped on the host's ``time.time_ns``, the
clock the profiler converts its device timestamps to; but over a long
session the device timestamps stray from it, by up to milliseconds. So a
replay is found by the device order, near its ``replay`` phase: the step's
uploads (host-to-device copies of its inputs) come first, then the graph's
ops. The uploads also measure how far the device timestamps stray: the
first starts right after the phase opens."""

import bisect
import statistics
from collections import defaultdict

UPLOAD = "Memcpy HtoD"
MARKER = "spin_kernel"  # the program's region marker (a one-cycle torch.cuda._sleep)
STRAY_NS = 20_000_000  # the farthest the device timestamps are looked for from the host's


def _replay_phase(step) -> tuple[int, int] | None:
    return next(((a, b) for name, a, b in step.get("phases") or () if name == "replay"), None)


def graph_starts(run) -> list[tuple[dict, int, int]]:
    """(step, index of its first upload, index of the graph's first op) in
    ``run.trace.device`` for each traced step with phases whose uploads the
    trace holds."""
    t = run.trace
    if t is None:
        return []
    starts = [a for _, a, _ in t.device]
    out = []
    for s in run.steps:
        phase = _replay_phase(s) if s.get("traced") else None
        if phase is None:
            continue
        a = phase[0]
        lo, hi = bisect.bisect_left(starts, a - STRAY_NS), bisect.bisect_right(starts, a + STRAY_NS)
        # the upload run whose first copy starts nearest the phase's opening
        runs = [j for j in range(lo, hi) if t.device[j][0].startswith(UPLOAD)
                and (j == 0 or not t.device[j - 1][0].startswith(UPLOAD))]
        if not runs:
            continue
        first = min(runs, key=lambda j: abs(starts[j] - a))
        j = first
        while j < len(t.device) and t.device[j][0].startswith(UPLOAD):
            j += 1
        out.append((s, first, j))
    return out


def stray_ns(run) -> int | None:
    """How far the trace's device timestamps lie after the host's: the
    median over the traced steps of the first upload's start less the
    ``replay`` phase's opening."""
    found = graph_starts(run)
    if not found:
        return None
    return int(statistics.median(run.trace.device[first][1] - _replay_phase(s)[0]
                                 for s, first, _ in found))


def step_regions(run) -> list[tuple[dict, dict]]:
    """(step, {region: device ns}) of each traced step whose replay the
    trace holds whole. A fenced step's record carries ``region_marks``,
    the regions of the captured step in the order of its marker kernels
    (``MARKER``): its replay opens with a marker, closes with one, and the
    ops between the k-th marker and the next belong to the k-th region.
    Each op counts from its start to the next op's start; the markers' own
    time counts to no region. A replay with another number of markers
    before the next step's uploads is left out."""
    dev = run.trace.device if run.trace is not None else []
    out = []
    for s, _, j in graph_starts(run):
        marks = s.get("region_marks")
        if not marks or j >= len(dev) or MARKER not in dev[j][0]:
            continue
        ns: dict[str, int] = defaultdict(int)
        k = -1
        for i in range(j, len(dev)):
            name, start, end = dev[i]
            if MARKER in name:
                k += 1
                if k == len(marks) - 1:
                    break
            elif name.startswith(UPLOAD):
                break
            else:
                ns[marks[k]] += (dev[i + 1][1] if i + 1 < len(dev) else end) - start
        if k == len(marks) - 1:
            out.append((s, dict(ns)))
    return out


def region_share(run, names) -> float | None:
    """The regions ``names`` over all region time of the matched steps, in %."""
    regions = [ns for _, ns in step_regions(run)]
    total = sum(sum(r.values()) for r in regions)
    if not total:
        return None
    return 100.0 * sum(r.get(n, 0) for r in regions for n in names) / total
