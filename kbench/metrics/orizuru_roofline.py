"""Kernels: Orizuru outlier detection against its least time. The least
time of one projection's detection in a step of M replayed rows reads each
activation once at its stored width and writes each row's 2k outlier
values (float32) and channels (int32), k = round(K x outlier_frac) a side,
at the HBM rate (``counts.H100``). The metric is the summed least time of
every quantized projection of every layer over the summed device time of
the region ``qlinear.detect`` (the float cast and the top-k kernel, or the
streaming kernel) in the traced steps (``replays.step_regions``). The
count lives here, so it reads the same work whatever implements
detection."""

from kbench import counts
from kbench.metrics.replays import step_regions
from kbench.metrics.lut_gemm_roofline import projections

OUTLIER_BYTES = 4 + 4  # a float32 value and an int32 channel
ACT_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def detect_least_s(m: int, k: int, frac: float, act_bytes: int) -> float:
    """One detection over an (m x k) activation."""
    per_side = max(1, int(round(k * frac)))
    return (m * k * act_bytes + m * 2 * per_side * OUTLIER_BYTES) / counts.H100["hbm_bytes_per_s"]


def read(run):
    quant = run.cell["quant"]
    steps = step_regions(run)
    detect_ns = sum(ns.get("qlinear.detect", 0) for _, ns in steps)
    if not detect_ns or quant.get("detection", "none") == "none":
        return None
    act = ACT_BYTES[run.cfg["torch_dtype"]]
    widths = [k for k, _, _ in projections(run.cfg, quant)]
    least = sum(detect_least_s(s["budget"], k, quant["outlier_frac"], act)
                for s, _ in steps for k in widths)
    return 100.0 * least * run.cfg["num_hidden_layers"] / (detect_ns / 1e9)
