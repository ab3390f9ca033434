"""The plain reference of the served model: K-Means W4A4 (a W8 rule by
path), dynamic outliers, int4 K-Means KV, in float32 with TF32 off.

It imports nothing of the program. From the float weights that the
benchmark made (``weights.make``) it works out again everything the
program's set-up derives: each projection's weight codebook (scalar
K-Means, quantile start, 25 Lloyd steps), indices and channel scales, the
structural Gaussian activation and KV codebooks, and at run time every
token scale, activation index, outlier set and KV index. The formulas are
frozen copies of the paper's method as the program states it
(``core/codebook.py``, ``core/quantize.py``, ``core/outlier.py``,
``models/layers.py``), written out here in plain operations:

* projection: ``x_hat @ W~`` where ``W~ = C_w[idx] * scale`` and
  ``x_hat`` is the activation quantized per token (RMS scale, nearest
  centroid of the Gaussian codebook) except at the k largest and k
  smallest channels of each token, which keep their value: the main
  branch plus the outlier compensation, summed exactly;
* attention: RoPE (rotate-half), K and V quantized per (token, KV head)
  to the 4-bit Gaussian codebook, causal softmax over the visible keys
  (sliding window where the config has one), scale ``hd ** -0.5``;
* MoE: float32 router, softmax, top-k by a stable sort (ties to the lower
  expert), weights renormalised, float experts (gated SiLU). The program's
  capacity rule drops nothing at the benchmark's step sizes
  (``moe_drops_nothing``), so every assignment is kept;
* RMSNorm with eps 1e-6, the program's value (the published configs' own
  eps are listed as departures in the config files).

``forward`` runs the sequences layer by layer (each layer's weights are
quantized once, and the layer runs over the tokens of every sequence at
once, in blocks of rows, attention per sequence in blocks of query rows),
so that it fits beside nothing else on the card.
``rnd`` / ``wrnd`` round activations / float weights at every point where
the program rounds to its compute dtype: identity for the reference, a
lower precision for the control (``fp8_rows`` / ``fp8_tensor``).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

__all__ = ["gaussian_codebook", "kmeans_codebook", "quantize_weight", "qlinear",
           "kv_quantize", "rope", "moe_capacity", "moe_drops_nothing", "forward",
           "fp8_rows", "fp8_tensor", "no_tf32"]

KMEANS_ITERS = 25
NORM_EPS = 1e-6
Q_ROWS = 1024  # query rows per attention block


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale per row (the last axis), as an fp8
    inference engine quantizes activations: the control's rounding."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / 448.0
    return (x / s).clamp(-448.0, 448.0).to(torch.float8_e4m3fn).float() * s


def fp8_tensor(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale per tensor: the control's weights."""
    s = x.abs().amax().clamp(min=1e-30) / 448.0
    return (x.float() / s).clamp(-448.0, 448.0).to(torch.float8_e4m3fn).float() * s


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def gaussian_codebook(nbits: int, device) -> torch.Tensor:
    """Centroids at the standard normal's quantiles ``(i + 0.5) / 2^n``,
    worked out in float64 and rounded to float32."""
    p = (torch.arange(2**nbits, dtype=torch.float64) + 0.5) / 2**nbits
    return torch.special.ndtri(p).float().to(device)


def _boundaries(book: torch.Tensor) -> torch.Tensor:
    return (0.5 * (book[:-1] + book[1:])).contiguous()


def _assign(x: torch.Tensor, book: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of a sorted codebook: the bucket between midpoints."""
    return torch.searchsorted(_boundaries(book), x.contiguous(), right=True)


def kmeans_codebook(x: torch.Tensor, n: int, iters: int = KMEANS_ITERS) -> torch.Tensor:
    """Sorted float32 scalar K-Means of ``x``: centroids start at the
    ``(i + 0.5) / n`` quantiles (linear interpolation), then ``iters``
    Lloyd steps, cluster sums in float64, an empty cluster keeping its
    centroid."""
    xf = x.reshape(-1).float()
    xs = torch.sort(xf).values
    m = xs.shape[0]
    qs = (torch.arange(n, dtype=torch.float32, device=xf.device) + 0.5) / n
    q = qs * torch.tensor(float(m), dtype=torch.float32, device=xf.device).sub(1.0)
    lo, hi = torch.floor(q), torch.ceil(q)
    w_hi = q - lo
    c = xs[lo.clamp(0, m - 1).long()] * (1.0 - w_hi) + xs[hi.clamp(0, m - 1).long()] * w_hi
    c = torch.sort(c).values
    del xs
    x64 = xf.double()
    for _ in range(iters):
        idx = _assign(xf, c)
        count = torch.bincount(idx, minlength=n).double()
        total = torch.bincount(idx, weights=x64, minlength=n)
        c = torch.sort(torch.where(count > 0, (total / count.clamp(min=1e-30)).float(), c)).values
    return c


def quantize_weight(w: torch.Tensor, nbits: int) -> torch.Tensor:
    """The dequantized K-Means weight ``C_w[idx] * scale`` (K, N) float32:
    per-output-channel absmax scale, one codebook per matrix."""
    w = w.float()
    scale = w.abs().amax(dim=0).clamp(min=1e-12)
    wn = w / scale
    book = kmeans_codebook(wn, 2**nbits)
    return book[_assign(wn, book)] * scale


def qlinear(x: torch.Tensor, w_deq: torch.Tensor, act_book: torch.Tensor,
            outlier_frac: float) -> torch.Tensor:
    """x (T, K) float32 through the dual-branch quantized projection."""
    s = torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True)).clamp(min=1e-12)
    xq = act_book[_assign(x / s, act_book)] * s
    if outlier_frac > 0:
        k = max(1, int(round(x.shape[-1] * outlier_frac)))
        keep = torch.zeros_like(x, dtype=torch.bool)
        keep.scatter_(-1, torch.topk(x, k, dim=-1).indices, True)
        keep.scatter_(-1, torch.topk(-x, k, dim=-1).indices, True)
        xq = torch.where(keep, x, xq)
    return xq @ w_deq


def kv_quantize(x: torch.Tensor, book: torch.Tensor) -> torch.Tensor:
    """(T, KV, hd): each (token, head) vector to the 4-bit Gaussian
    codebook at its RMS scale, dequantized."""
    s = torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True)).clamp(min=1e-12)
    return book[_assign(x / s, book)] * s


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, rotate-half convention. x (T, H, hd), pos (T,)."""
    half = x.shape[-1] // 2
    freq = torch.pow(torch.tensor(theta, dtype=torch.float32, device=x.device),
                     -torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float()[:, None, None] * freq
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def rms_norm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + NORM_EPS) * scale


def moe_capacity(tokens_per_group: int, k: int, n_experts: int, factor: float) -> int:
    """Slots per expert in one dispatch group (the program's rule, as JAX's:
    ``tokens * k * factor / E`` rounded up to a multiple of 8, at least 8)."""
    c = tokens_per_group * k * factor / n_experts
    return max(8, int(math.ceil(c / 8.0)) * 8)


def dispatch_group_tokens(step_tokens: int, max_groups: int) -> int:
    """Tokens per dispatch group of a step: the step splits into the most
    groups up to ``max_groups`` that divide it."""
    g = max(1, min(max_groups, step_tokens))
    while step_tokens % g:
        g -= 1
    return step_tokens // g


def moe_drops_nothing(step_tokens: int, cfg: dict) -> bool:
    """True when no expert can overflow: a token picks k distinct experts,
    so an expert sees at most one assignment per token of its group."""
    tg = dispatch_group_tokens(step_tokens, cfg["moe_dispatch_groups"])
    return moe_capacity(tg, cfg["num_experts_per_tok"], cfg["num_local_experts"],
                        cfg["capacity_factor"]) >= tg


class _Layer:
    """One block's quantized projections, worked out from its float weights."""

    def __init__(self, blk: dict, quant: dict, wrnd):
        self.p = {}
        for group, names in (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("wi", "wd"))):
            for name in names if group in blk else ():
                bits = quant["w_bits"]
                for pattern, over in quant.get("rules", ()):
                    if f"{group}/{name}".endswith(pattern):
                        bits = over.get("w_bits", bits)
                self.p[name] = quantize_weight(wrnd(blk[group][name]["w"].float()), bits)
        self.norm1 = wrnd(blk["norm1"]["scale"].float())
        self.norm2 = wrnd(blk["norm2"]["scale"].float())
        self.moe = None
        if "moe" in blk:
            m = blk["moe"]
            self.moe = (m["router"]["w"].float(), wrnd(m["wi"].float()), wrnd(m["wd"].float()))


def _rows(fn, x: torch.Tensor, rows: int = 16384) -> torch.Tensor:
    """``fn`` over blocks of rows (every op it applies is per token)."""
    if x.shape[0] <= rows:
        return fn(x)
    return torch.cat([fn(x[i:i + rows]) for i in range(0, x.shape[0], rows)])


def _attention(x, pos, spans, lyr: _Layer, cfg, quant, books, rnd) -> torch.Tensor:
    """x (T, d): the tokens of every sequence, ``spans`` their rows, ``pos``
    each token's position in its sequence."""
    t = x.shape[0]
    h, kv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    g = h // kv
    window = cfg.get("sliding_window") or 0
    proj = lambda name, y: rnd(_rows(lambda r: qlinear(r, lyr.p[name], books["act"],
                                                       quant["outlier_frac"]), y))
    q = rnd(rope(proj("wq", x).reshape(t, h, hd), pos, cfg["rope_theta"]))
    k = rnd(rope(proj("wk", x).reshape(t, kv, hd), pos, cfg["rope_theta"]))
    v = proj("wv", x).reshape(t, kv, hd)
    if quant.get("kv_bits"):
        k, v = kv_quantize(k, books["kv"]), kv_quantize(v, books["kv"])
    out = torch.empty((t, h, hd), dtype=torch.float32, device=x.device)
    for a, b in spans:
        ks = k[a:b].repeat_interleave(g, dim=1).transpose(0, 1)  # (H, S, hd)
        vs = v[a:b].repeat_interleave(g, dim=1).transpose(0, 1)
        sp = pos[a:b]
        for q0 in range(0, b - a, Q_ROWS):
            q1 = min(b - a, q0 + Q_ROWS)
            k0 = max(0, q0 - window + 1) if window else 0
            qp, kp = sp[q0:q1, None], sp[None, k0:q1]
            ok = kp <= qp
            if window:
                ok &= kp > qp - window
            s = torch.einsum("qhd,hkd->hqk", q[a + q0:a + q1], ks[:, k0:q1]) * hd ** -0.5
            s = s.masked_fill(~ok, float("-inf"))
            out[a + q0:a + q1] = torch.einsum("hqk,hkd->qhd", torch.softmax(s, dim=-1),
                                              vs[:, k0:q1])
    return proj("wo", rnd(out.reshape(t, h * hd)))


def _mlp(x, lyr: _Layer, quant, books, rnd) -> torch.Tensor:
    frac = quant["outlier_frac"]

    def mlp(r):
        gate, up = rnd(qlinear(r, lyr.p["wi"], books["act"], frac)).chunk(2, dim=-1)
        return rnd(qlinear(rnd(rnd(F.silu(gate)) * up), lyr.p["wd"], books["act"], frac))

    return _rows(mlp, x)


def _moe(x, lyr: _Layer, cfg, rnd) -> torch.Tensor:
    router, wi, wd = lyr.moe
    k = cfg["num_experts_per_tok"]
    gates = torch.softmax(x @ router, dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    topw, topi = vals[:, :k], idx[:, :k]
    topw = topw / topw.sum(-1, keepdim=True).clamp(min=1e-9)
    out = torch.zeros_like(x)
    for e in torch.unique(topi).tolist():
        tok, slot = torch.nonzero(topi == e, as_tuple=True)
        hh = rnd(x[tok] @ wi[e])
        gate, up = hh.chunk(2, dim=-1)
        y = rnd(rnd(rnd(F.silu(gate)) * up) @ wd[e])
        out.index_add_(0, tok, rnd(y * topw[tok, slot, None]))
    return rnd(out)


@torch.no_grad()
def forward(tree: dict, cfg: dict, quant: dict, seqs: list[torch.Tensor],
            want: list[torch.Tensor], rnd=identity, wrnd=identity) -> list[torch.Tensor]:
    """Logits (len(want[i]), vocab) float32 of each token sequence
    ``seqs[i]`` (a prompt and its served tokens) at positions
    ``want[i]``, through the whole model, no cache: each layer attends over
    the sequence itself."""
    dev = seqs[0].device
    books = {"act": gaussian_codebook(quant["a_bits"], dev), "kv": gaussian_codebook(4, dev)}
    table = wrnd(tree["embed"]["table"].float())
    x = rnd(table[torch.cat(seqs).long()])
    ends = torch.cumsum(torch.tensor([len(s) for s in seqs]), 0).tolist()
    spans = list(zip([0] + ends[:-1], ends))
    pos = torch.cat([torch.arange(len(s), device=dev) for s in seqs])
    with no_tf32():
        for i in range(cfg["num_hidden_layers"]):
            lyr = _Layer(_index(tree["blocks"], i), quant, wrnd)
            x = rnd(x + _attention(rnd(rms_norm(x, lyr.norm1)), pos, spans, lyr, cfg, quant,
                                   books, rnd))
            n = rnd(rms_norm(x, lyr.norm2))
            x = rnd(x + (_moe(n, lyr, cfg, rnd) if lyr.moe else _mlp(n, lyr, quant, books, rnd)))
            del lyr, n
        head = (table.T if cfg.get("tie_word_embeddings")
                else wrnd(tree["head"]["w"].float()))
        nf = wrnd(tree["norm_f"]["scale"].float())
        vocab = cfg["vocab_size"]
        return [rnd((rnd(rms_norm(x[a + w], nf)) @ head)[:, :vocab])
                for (a, _), w in zip(spans, want)]


def _index(tree, i: int):
    """Layer ``i`` of a layer-stacked tree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]
