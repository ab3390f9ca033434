"""Kernels: every fused LUT-GEMM launch of the traced window, the sum of
their least times (``counts.lut_gemm_least_s`` at the step's replayed rows)
over the sum of their device times. Each packed step launches one per
quantized projection of every layer; a trace whose launches are not whole
steps' gives nothing."""

from kbench import counts

KERNEL = "fused_lut_gemm_kernel"


def projections(cfg: dict, quant: dict) -> list[tuple[int, int, int]]:
    """(K, N, w_bits) of one layer's quantized projections: attention's,
    and the MLP's where the FFN is not float experts."""
    d, h, kv, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"], cfg["head_dim"])
    shapes = {"attn/wq": (d, h * hd), "attn/wk": (d, kv * hd), "attn/wv": (d, kv * hd),
              "attn/wo": (h * hd, d)}
    if not cfg.get("num_local_experts"):
        f = cfg["intermediate_size"]
        shapes.update({"mlp/wi": (d, 2 * f), "mlp/wd": (f, d)})
    out = []
    for path, (k, n) in shapes.items():
        bits = quant["w_bits"]
        for pattern, over in quant.get("rules", ()):
            if path.endswith(pattern):
                bits = over.get("w_bits", bits)
        out.append((k, n, bits))
    return out


def read(run):
    t = run.trace
    steps = [s for s in run.steps if s.get("traced")]
    if t is None or not steps:
        return None
    ns, launches = t.kernel_ns(KERNEL)
    per_layer = projections(run.cfg, run.cell["quant"])
    expected = len(steps) * run.cfg["num_hidden_layers"] * len(per_layer)
    if not ns or abs(launches - expected) > 0.01 * expected:
        return None
    least = sum(counts.lut_gemm_least_s(s["budget"], k, n, b, run.cell["quant"]["a_bits"])
                for s in steps for k, n, b in per_layer)
    return 100.0 * least * run.cfg["num_hidden_layers"] * launches / expected / (ns / 1e9)
