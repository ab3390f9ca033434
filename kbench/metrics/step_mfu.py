"""Model step: model FLOPs of the window's valid tokens over the window's
seconds at the bf16 peak (``counts.H100``). A token counts 2 x the active
non-embedding parameters and attention over its visible context (the
window's keys at most); a row that samples counts the LM head. Needs the
positions of every step (recorded with ``--trace 1``)."""

from kbench import counts


def read(run):
    if not run.steps or "pos" not in run.steps[0] or run.window_s <= 0:
        return None
    w = run.cfg.get("sliding_window") or 0
    flops = 0
    for s in run.steps:
        pos = s["pos"][s["pos"] >= 0]
        ctx = pos + 1 if not w else (pos + 1).clip(max=w)
        flops += sum(counts.token_flops(run.cfg, int(c)) for c in ctx)
        flops += s["sampled"] * counts.head_flops(run.cfg)
    return 100.0 * flops / (run.window_s * counts.H100["bf16_flops"])
