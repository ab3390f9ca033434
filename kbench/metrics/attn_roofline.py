"""Kernels: every int4 paged-attention launch of the traced window, the
sum of their least times (``counts.attention_least_s``: each query's
visible context, the distinct visible KV cells of each request once) over
the sum of their device times. One launch per layer and packed step; the
least time is scaled by the launches the profiler saw when they are within
1 % of the slice's count (it may lose a few events), else nothing."""

from collections import defaultdict

from kbench import counts

KERNEL = "paged_attn::kernel"


def step_least_s(cfg: dict, slots, pos) -> float:
    """One layer's launch in a step whose cells are at ``pos`` of ``slots``."""
    w = cfg.get("sliding_window") or 0
    by_slot = defaultdict(list)
    for s, p in zip(slots.tolist(), pos[:, 0].tolist()):
        if p >= 0:
            by_slot[s].append(p)
    contexts, cells = [], 0
    for ps in by_slot.values():
        contexts += [min(p + 1, w) if w else p + 1 for p in ps]
        lo = max(0, min(ps) - w + 1) if w else 0
        cells += max(ps) - lo + 1
    if not contexts:
        return 0.0
    return counts.attention_least_s(contexts, cells, cfg["num_attention_heads"],
                                    cfg["num_key_value_heads"], cfg["head_dim"])


def read(run):
    t = run.trace
    steps = [s for s in run.steps if s.get("traced")]
    if t is None or not steps:
        return None
    ns, launches = t.kernel_ns(KERNEL)
    expected = len(steps) * run.cfg["num_hidden_layers"]
    if not ns or abs(launches - expected) > 0.01 * expected:
        return None
    least = sum(step_least_s(run.cfg, s["slots"], s["pos"]) for s in steps)
    return 100.0 * least * run.cfg["num_hidden_layers"] * launches / expected / (ns / 1e9)
