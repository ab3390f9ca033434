"""Prompt tokens prefilled plus tokens generated in the window, over the
window's seconds (vLLM's total tokens/s of an offline batch)."""


def read(run):
    return (run.prefilled + run.generated) / run.window_s if run.window_s > 0 else None
