"""Model step: the share of the device's time outside the program's hand
kernels (``tracing.HAND_KERNELS``, by name): the plain PyTorch around them
(the outlier compensation's gathers and products, the MoE dispatch and
experts, norms, RoPE, the LM head)."""


def read(run):
    t = run.trace
    if t is None or not t.total_ns():
        return None
    return 100.0 * (1.0 - t.hand_ns() / t.total_ns())
