"""The yardstick's peaks and the operations and bytes of the work.

``H100`` is one NVIDIA H100 SXM's published peaks (NVIDIA's data sheet,
dense rates, no sparsity; the program's ``launch/roofline.py`` carries the
same numbers). The counts describe the work the inputs need, whatever
implements it: each input byte read once, each output byte written once,
activations and outputs in the served dtype (bfloat16).
"""

from __future__ import annotations

__all__ = ["H100", "lut_gemm_least_s", "attention_least_s", "active_params",
           "token_flops", "head_flops"]

H100 = {
    "bf16_flops": 989e12,  # FLOP/s, dense
    "hbm_bytes_per_s": 3.35e12,
    "hbm_bytes": 80e9,
}
ACT_BYTES = 2  # bfloat16 activations in and out


def _least(flops: float, nbytes: float) -> float:
    return max(flops / H100["bf16_flops"], nbytes / H100["hbm_bytes_per_s"])


def lut_gemm_bytes(m: int, k: int, n: int, w_bits: int, a_bits: int = 4) -> int:
    """One launch: the packed weight, both codebooks (float32), the channel
    scales (float32), the activations in, the token scales (float32), the
    output."""
    return (n * k * w_bits // 8 + (2**w_bits + 2**a_bits) * 4 + n * 4
            + m * k * ACT_BYTES + m * 4 + m * n * ACT_BYTES)


def lut_gemm_least_s(m: int, k: int, n: int, w_bits: int, a_bits: int = 4) -> float:
    """Least time of one (m x k) @ (k x n) quantized product: the larger of
    2mnk at the bf16 peak and its bytes at the HBM rate."""
    return _least(2 * m * k * n, lut_gemm_bytes(m, k, n, w_bits, a_bits))


def attention_bytes(n_queries: int, kv_cells: int, heads: int, kv_heads: int,
                    head_dim: int, kv_bits: int = 4) -> int:
    """One launch: each distinct visible (token, KV head) key and value
    once, int4 with a float32 scale each, plus q and the output."""
    per_cell = kv_heads * 2 * (head_dim * kv_bits // 8 + 4)
    return kv_cells * per_cell + 2 * n_queries * heads * head_dim * ACT_BYTES


def attention_least_s(contexts: list[int], kv_cells: int, heads: int, kv_heads: int,
                      head_dim: int, kv_bits: int = 4) -> float:
    """Least time of one paged-attention launch over queries whose visible
    contexts are ``contexts`` (keys each sees) and ``kv_cells`` distinct
    (token) cells among them: 4 x heads x head_dim x context operations
    per query, against those bytes."""
    flops = 4 * heads * head_dim * sum(contexts)
    return _least(flops, attention_bytes(len(contexts), kv_cells, heads, kv_heads, head_dim,
                                         kv_bits))


def active_params(cfg: dict) -> int:
    """Non-embedding parameters a token passes through: the attention
    projections, the MLP or the k routed experts and the router, per layer."""
    d, h, kv, hd = (cfg["hidden_size"], cfg["num_attention_heads"],
                    cfg["num_key_value_heads"], cfg["head_dim"])
    attn = 2 * d * h * hd + 2 * d * kv * hd
    f = cfg["intermediate_size"]
    if cfg.get("num_local_experts"):
        ffn = cfg["num_experts_per_tok"] * 3 * d * f + d * cfg["num_local_experts"]
    else:
        ffn = 3 * d * f
    return cfg["num_hidden_layers"] * (attn + ffn)


def token_flops(cfg: dict, context: int) -> int:
    """Model FLOPs of one token at a visible context of ``context`` keys
    (itself included): 2 x the active parameters, and 4 x heads x
    head_dim x context of attention in every layer."""
    att = 4 * cfg["num_attention_heads"] * cfg["head_dim"] * context
    return 2 * active_params(cfg) + cfg["num_hidden_layers"] * att


def head_flops(cfg: dict) -> int:
    """The LM head for one row that samples."""
    return 2 * cfg["hidden_size"] * cfg["vocab_size"]
