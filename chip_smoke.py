#!/usr/bin/env python3
"""Drives the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Phases, each printing one JSON line:

1. device  -- the card's name and count, and what ``nvidia-smi`` reports.
2. build   -- compiles the three CUDA kernels from ``src/repro_torch/csrc``.
3. kernels -- each kernel against its plain PyTorch version on the card, at
              llama3_2_1b's serving shapes (72 token rows = 8 decode slots +
              a 64-token prefill chunk), with times, bounds and yardsticks;
              the LUT-GEMM also bit for bit on inputs with exact sums.
4. model   -- a 2-layer, full-width llama3_2_1b: one packed serving step on
              the card against the same step on the CPU (plain versions),
              for three seeds, with a nibble-swapped control that must fail.
5. serve   -- the full 16-layer llama3_2_1b, quantized by the port under the
              W4A4 + W8 mlp/wd + int4 KV spec, serving 16 seeded requests;
              every projection and attention of every step must have gone
              through its kernel (launch counts exact, no plain route and
              no plain version on a CUDA tensor), then a profiled extra run.

The last three lines are the card's ``nvidia-smi`` name and power limit,
``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``. Any failure
exits non-zero. Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
U32 = 2.0**-24  # float32 unit roundoff
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
TPU_KERNELS = {
    "fused_lut_gemm": "src/repro/kernels/lut_gemm.py:241",
    "topk_outlier": "src/repro/kernels/topk_outlier.py:195",
    "paged_attn_int4": "src/repro/kernels/paged_attn.py:117",
}
ROWS = 72  # token budget of the serving phase: 8 slots + 64 prefill tokens


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fns, reps: int) -> float:
    """Mean device ms per call, cycling through ``fns`` (one closure per
    input copy, so inputs larger than L2 in total arrive cold)."""
    import torch

    for f in fns:
        f()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def copies_for(nbytes: int) -> int:
    """Input copies so one cycle moves > 120 MB (2.4x the 50 MB L2)."""
    return max(1, min(32, math.ceil(120e6 / max(nbytes, 1))))


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def gemm_case(dev, gen, m, k, n, x_dtype, byte_packed, tag, reps=50):
    """Two checks, then the times. (1) Gaussian codebooks as served: the
    kernel within 2 sqrt(K) u max(|a| @ |w|) of its plain version, the scale
    of float32 rounding over K terms summed in two orders, and asserted below
    the smallest change one activation index on a neighbouring centroid
    makes to its row. (2) ``exact_sum_inputs``: every summation order gives
    the same sum, so the kernel must equal its plain version bit for bit on
    activations planted on and next to the boundaries; as a control, the
    kernel run with the other compare form must differ there."""
    import torch

    from repro_torch.core.codebook import boundaries_from_centroids
    from repro_torch.kernels.lut_gemm import (exact_sum_inputs, fused_lut_gemm,
                                              fused_lut_gemm_plain)
    from repro_torch.models.model import _default_codebook

    a_book = _default_codebook(4, device=dev)
    bounds = boundaries_from_centroids(a_book).contiguous()
    n_w = 256 if byte_packed else 16
    w_book = torch.sort(torch.randn(n_w, generator=gen, device=dev)).values

    def inputs():
        x = torch.randn((m, k), generator=gen, device=dev)
        x[:, :: max(1, k // 7)] *= 12.0  # a few outlier channels
        x = x.to(x_dtype)
        s = torch.sqrt(torch.mean(x.float() ** 2, dim=-1, keepdim=True)).clamp(min=1e-12)
        cols = n if byte_packed else n // 2
        w = torch.randint(0, 256, (k, cols), generator=gen, device=dev, dtype=torch.uint8)
        return x, s, w

    x, s, w = inputs()
    mul_form = x_dtype == torch.bfloat16
    kw = dict(byte_packed=byte_packed, mul_form=mul_form)
    y = fused_lut_gemm(x, s, w, bounds, a_book, w_book, **kw)
    ref = fused_lut_gemm_plain(x, s, w, bounds, a_book, w_book, **kw)
    if byte_packed:
        w_idx = w.long()
    else:
        w_idx = torch.stack([w & 0xF, w >> 4], dim=-1).reshape(k, -1).long()
    xf = x.float()
    if mul_form:
        a_idx = (xf[..., None] >= s[..., None] * bounds).sum(-1)
    else:
        a_idx = torch.searchsorted(bounds, (xf / s).contiguous(), right=True)
    w_deq = w_book[w_idx]
    mag = a_book[a_idx].abs() @ w_deq.abs()
    # one index on a neighbouring centroid moves its row by at least this
    flip = (a_book.diff().min() * w_deq.abs().amax(1).min()).item()
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item()
    tol = 2 * math.sqrt(k) * U32 * mag.max().item()
    ex = [t.to(dev) for t in exact_sum_inputs(m, k, n, x_dtype, byte_packed, seed=m + k + n)]
    ex_ref = fused_lut_gemm_plain(*ex, **kw)
    exact = torch.equal(fused_lut_gemm(*ex, **kw), ex_ref)
    wrong_rows = int((fused_lut_gemm(*ex, byte_packed=byte_packed, mul_form=not mul_form)
                      != ex_ref).any(1).sum())
    ok = (bool(torch.isfinite(y).all()) and err <= tol < flip and exact and wrong_rows > 0)
    x_bytes = m * k * x.element_size()
    w_bytes = w.numel()
    nbytes = x_bytes + m * 4 + w_bytes + 4 * (15 + 16 + n_w) + m * n * 4
    sets = [inputs() for _ in range(copies_for(x_bytes + w_bytes))]
    ms = cuda_ms([lambda t=t: fused_lut_gemm(t[0], t[1], t[2], bounds, a_book, w_book, **kw)
                  for t in sets], reps)
    plain_ms = cuda_ms([lambda t=t: fused_lut_gemm_plain(t[0], t[1], t[2], bounds, a_book,
                                                         w_book, **kw) for t in sets[:2]], 5)
    # yardstick only: bf16 tensor-core matmul against a pre-dequantized weight
    wd = [(t[0].to(torch.bfloat16), w_deq.to(torch.bfloat16)) for t in sets[:3]]
    lib_ms = cuda_ms([lambda t=t: torch.matmul(t[0], t[1]) for t in wd], reps)
    b_ms, b_by = bound(nbytes, 2.0 * m * n * k)
    res = dict(case=tag, M=m, K=k, N=n, x_dtype=str(x_dtype).removeprefix("torch."),
               tier="byte" if byte_packed else "nibble", max_abs_err=err, tol=tol,
               one_flip=flip, exact_sums_equal=exact, wrong_form_rows_differ=wrong_rows,
               ok=ok, kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
               bound_by=b_by)
    emit("kernel_fused_lut_gemm", **res)
    return res


def topk_case(dev, gen, m, n, k, kind, reps=100):
    import torch

    from repro_torch.kernels.topk_outlier import topk_outlier_call, topk_outlier_plain

    def inputs():
        if kind == "normal":
            x = torch.randn((m, n), generator=gen, device=dev)
        elif kind == "duplicates":
            x = torch.randint(-3, 4, (m, n), generator=gen, device=dev).float()
        else:  # all-equal rows, one with +-inf entries
            x = torch.full((m, n), 0.5, device=dev)
            x[0, 3], x[0, 7] = float("inf"), float("-inf")
        return x.contiguous()

    x = inputs()
    got = topk_outlier_call(x, k)
    want = topk_outlier_plain(x, k)
    torch.cuda.synchronize()
    ok = all(torch.equal(a, b) for a, b in zip(got, want))
    err = 0.0 if ok else float("inf")  # values and channels must match exactly
    nbytes = m * n * 4 + 4 * m * k * 4
    sets = [inputs() for _ in range(copies_for(m * n * 4))]
    ms = cuda_ms([lambda t=t: topk_outlier_call(t, k) for t in sets], reps)
    plain_ms = cuda_ms([lambda t=t: topk_outlier_plain(t, k) for t in sets[:2]], 10)
    lib_ms = cuda_ms([lambda t=t: (torch.topk(t, k), torch.topk(-t, k)) for t in sets], reps)
    comps = m * (1.5 * n + 2 * k * math.log2(n))  # Orizuru comparison count
    b_ms, b_by = bound(nbytes, comps)
    res = dict(case=f"{kind} N={n} k={k}", M=m, N=n, k=k, exact=ok, max_abs_err=err, ok=ok,
               kernel_ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    emit("kernel_topk_outlier", **res)
    return res


def attn_case(dev, gen, b, s, tag, softcap=0.0, window=0, reps=50):
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attn import paged_attn_int4, paged_attn_quant_plain
    from repro_torch.models.model import _default_codebook

    kv, g, hd, bs, max_blk, n_blocks = 8, 4, 64, 16, 64, 512
    book = _default_codebook(4, device=dev)

    def inputs():
        ki = torch.randint(0, 256, (n_blocks, bs, kv, hd // 2), generator=gen, device=dev,
                           dtype=torch.uint8)
        vi = torch.randint(0, 256, ki.shape, generator=gen, device=dev, dtype=torch.uint8)
        ks = torch.rand((n_blocks, bs, kv, 1), generator=gen, device=dev) + 0.5
        vs = torch.rand((n_blocks, bs, kv, 1), generator=gen, device=dev) + 0.5
        q = torch.randn((b, s, kv, g, hd), generator=gen, device=dev)
        ctx = torch.randint(1, max_blk * bs + 1, (b,), generator=gen, device=dev)
        ctx[-2:] = 0  # idle rows
        tables = torch.randint(0, n_blocks, (b, max_blk), generator=gen, device=dev)
        nblk = (ctx + bs - 1) // bs
        tables[torch.arange(max_blk, device=dev)[None, :] >= nblk[:, None]] = -1
        qpos = (ctx[:, None] - s + torch.arange(s, device=dev)[None, :]).clamp(min=-1)
        qpos[ctx == 0] = -1
        if s > 1:
            qpos[0, -1] = -1  # a padded cell inside a live segment
        return tuple(t.contiguous() for t in (
            q, ki, ks, vi, vs, book, tables.int(), ctx.int(), qpos.int()))

    args = inputs()
    kw = dict(softcap=softcap, window=window)
    out = paged_attn_int4(*args, **kw)
    ref = paged_attn_quant_plain(*args, **kw)
    torch.cuda.synchronize()
    live = args[8] >= 0  # rows that see at least one key (q_pos < ctx here)
    err = (out - ref).abs()[live].max().item()
    vmax = (book.abs().max() * args[4].max()).item()
    n_keys = int(args[7].max())
    # both sides are convex combinations of values; the sums differ in order
    tol = 4 * n_keys * U32 * vmax
    ok = bool(torch.isfinite(out).all()) and err <= tol
    ctx, tables = args[7].long(), args[6].long()
    nblk = (ctx + bs - 1) // bs
    used = torch.unique(tables[torch.arange(max_blk, device=dev)[None, :] < nblk[:, None]])
    kv_bytes = used.numel() * bs * kv * (hd // 2 + 4) * 2
    nbytes = 2 * args[0].numel() * 4 + kv_bytes + 4 * (tables.numel() + 2 * b + b * s) + 64
    flops = 4.0 * s * g * hd * kv * float(ctx.sum())
    sets = [inputs() for _ in range(copies_for(kv_bytes))]
    ms = cuda_ms([lambda t=t: paged_attn_int4(*t, **kw) for t in sets], reps)
    plain_ms = cuda_ms([lambda t=t: paged_attn_quant_plain(*t, **kw) for t in sets[:2]], 5)
    # yardstick only: SDPA over the same keys pre-gathered as dense bf16
    qd = args[0].permute(0, 2, 3, 1, 4).reshape(b, kv * g, s, hd).to(torch.bfloat16)
    kd = torch.randn((b, kv * g, max_blk * bs, hd), device=dev, dtype=torch.bfloat16)
    mask = (torch.arange(max_blk * bs, device=dev)[None, None, None, :]
            < ctx[:, None, None, None])
    lib_ms = cuda_ms([lambda: F.scaled_dot_product_attention(qd, kd, kd, attn_mask=mask)], reps)
    b_ms, b_by = bound(nbytes, flops)
    res = dict(case=tag, B=b, S=s, KV=kv, G=g, hd=hd, bs=bs, max_blk=max_blk,
               softcap=softcap, window=window, max_abs_err=err, tol=tol, ok=ok, kernel_ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)
    emit("kernel_paged_attn_int4", **res)
    return res


def phase_kernels(dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    gemm = [
        gemm_case(dev, gen, ROWS, 2048, 2048, bf, False, "attn/wq,wo bf16"),
        gemm_case(dev, gen, ROWS, 2048, 512, bf, False, "attn/wk,wv bf16"),
        gemm_case(dev, gen, ROWS, 2048, 16384, bf, False, "mlp/wi bf16"),
        gemm_case(dev, gen, ROWS, 8192, 2048, bf, True, "mlp/wd W8 bf16"),
        gemm_case(dev, gen, ROWS, 2048, 2048, f32, False, "attn/wq f32"),
        gemm_case(dev, gen, ROWS, 8192, 2048, f32, True, "mlp/wd W8 f32"),
        gemm_case(dev, gen, 8, 2048, 16384, bf, False, "mlp/wi decode-only bf16"),
        gemm_case(dev, gen, 5, 11008, 4096, f32, True, "unaligned K=11008 W8 f32"),
        gemm_case(dev, gen, 37, 1000, 100, bf, False, "unaligned M/K/N nibble bf16"),
    ]
    topk = [
        topk_case(dev, gen, ROWS, 2048, 10, "normal"),
        topk_case(dev, gen, ROWS, 8192, 41, "normal"),
        topk_case(dev, gen, ROWS, 2048, 10, "duplicates"),
        topk_case(dev, gen, ROWS, 2047, 10, "normal"),
        topk_case(dev, gen, 4, 2048, 10, "equal"),
    ]
    attn = [
        attn_case(dev, gen, ROWS, 1, "packed step rows"),
        attn_case(dev, gen, ROWS, 1, "window=100 softcap=30", softcap=30.0, window=100),
        attn_case(dev, gen, 18, 4, "segments S=4"),
    ]
    return {"fused_lut_gemm": (gemm, 2), "topk_outlier": (topk, 1),
            "paged_attn_int4": (attn, 0)}


# ---------------------------------------------------------------------------
# phases 4 and 5: the model
# ---------------------------------------------------------------------------

def main_spec():
    from repro_torch.core.qlinear import QLinearConfig
    from repro_torch.core.quantspec import QuantSpec

    return QuantSpec(base=QLinearConfig(detection="dynamic", outlier_frac=0.005),
                     rules=[("mlp/wd", {"w_bits": 8})], kv_bits=4, kv_dtype="float32")


def packed_step_logits(model, params, device, prompts):
    """One packed prefill step of ``prompts`` (one slot each) -> logits of
    the valid cells, float32 on the CPU."""
    import numpy as np
    import torch

    from repro_torch.serving.paged_cache import blocks_needed
    from repro_torch.serving.speculative import make_packed_fn

    bs, max_blk = 16, 8
    n = sum(len(p) for p in prompts)
    pools = model.init_caches(len(prompts), max_blk * bs, quantized=True, block_size=bs,
                              device=device)
    bt = np.full((len(prompts), max_blk), -1, np.int32)
    slot_ids, pos, tok = (np.zeros((n,), np.int32), np.zeros((n, 1), np.int32),
                          np.zeros((n, 1), np.int32))
    row, nxt = 0, 0
    for i, p in enumerate(prompts):
        nb = blocks_needed(len(p), bs)
        bt[i, :nb] = np.arange(nxt, nxt + nb)
        nxt += nb
        for j, t in enumerate(p):
            slot_ids[row], pos[row, 0], tok[row, 0] = i, j, t
            row += 1
    ctx = pos.max(axis=1) + 1
    step = make_packed_fn(model)
    conv = lambda a: torch.from_numpy(a).to(device)
    _, logits = step(params, pools, conv(bt), conv(slot_ids), conv(pos), conv(ctx), conv(tok))
    return logits[:, 0].float().cpu()


def swap_nibbles(model) -> None:
    """Swap the two weight indices of every nibble-packed byte in place (an
    involution): what a kernel that read the nibbles in the wrong order
    would compute."""
    from repro_torch.core.qlinear import QLinear

    for m in model.modules():
        if isinstance(m, QLinear) and m.qw_nbits <= 4:
            m.packed.copy_((m.packed >> 4) | (m.packed << 4))


def phase_model(dev):
    """2-layer full-width llama3_2_1b, one packed step, card vs CPU.

    A4 activation quantization is discontinuous. A last-ulp difference in a
    per-token RMS scale (reduction order), in a float32 summation order or in
    a bf16 rounding can move an activation or KV value across a codebook
    boundary; the flipped value changes its token's next inputs by a whole
    codebook step, which flips more indices downstream, so a few flips grow
    into per-token differences of several percent. The step is run in
    float32 and in bf16 for three weight and prompt seeds and, as a
    yardstick for that growth, in bf16 with the projections on the plain
    GEMM and detection routes (no LUT-GEMM or top-k kernel). The bounds,
    0.1 in float32 and 0.3 in bf16, sit between the growth measured on an
    H100 (see PERF.md) and what a gross fault gives: as a control, the card
    runs each first seed once more with the weight nibbles swapped, and that
    reading must exceed the bound. A fault that flips only a few indices
    stays inside these bounds; phase 3 holds the top-k exactly and the
    LUT-GEMM bit for bit on inputs whose sums are exact.
    """
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.qlinear import QLinear
    from repro_torch.models.model import build, quantize_model

    base = dataclasses.replace(get_config("llama3_2_1b"), n_layers=2)
    rel = lambda a, b: (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()
    bounds = {"float32": 0.1, "bfloat16": 0.3}
    seeds = (1, 2, 3)
    res = {}
    for dtype in bounds:
        cfg = dataclasses.replace(base, param_dtype=dtype, compute_dtype=dtype)
        model = build(cfg)
        runs = []
        for seed in seeds:
            t0 = time.perf_counter()
            gen = torch.Generator().manual_seed(seed)
            prompts = [torch.randint(0, base.vocab_size, (l,), generator=gen).tolist()
                       for l in (30, 21, 13, 8)]  # 72 cells, like one serving step
            qp = quantize_model(model, model.init(seed=seed, device=dev), main_spec())
            on_card = packed_step_logits(model, qp, dev, prompts)
            extra = {}
            if seed == seeds[0]:
                swap_nibbles(qp)
                swapped = packed_step_logits(model, qp, dev, prompts)
                swap_nibbles(qp)
                if dtype == "bfloat16":
                    for m in qp.modules():
                        if isinstance(m, QLinear):
                            m.cfg = dataclasses.replace(m.cfg, kernel="jnp",
                                                        detect_kernel="jnp")
                    plain_routes = packed_step_logits(model, qp, dev, prompts)
            on_cpu = packed_step_logits(model, qp.to("cpu"), "cpu", prompts)
            if seed == seeds[0]:
                extra["nibble_swap_control_rel_l2"] = rel(swapped, on_cpu)
                if dtype == "bfloat16":
                    extra["plain_routes_rel_l2"] = rel(plain_routes, on_cpu)
            runs.append(dict(seed=seed, rel_l2=rel(on_card, on_cpu),
                             finite=bool(torch.isfinite(on_card).all()),
                             argmax_agreement=(on_card.argmax(-1) == on_cpu.argmax(-1))
                             .float().mean().item(), seconds=time.perf_counter() - t0,
                             **extra))
            del qp
        res[dtype] = runs
    ok = all(r["finite"] and r["rel_l2"] <= bounds[d] for d, runs in res.items() for r in runs)
    control = {d: runs[0]["nibble_swap_control_rel_l2"] for d, runs in res.items()}
    control_ok = all(control[d] > bounds[d] for d in bounds)
    emit("model", layers=base.n_layers, d_model=base.d_model, cells=72, bounds=bounds,
         ok=ok, control_exceeds_bounds=control_ok, **res)
    return ok and control_ok


def phase_serve(dev, smi_line):
    import torch

    import repro_torch.core.kernel_routing as kr
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build as kb
    from repro_torch.models.model import build, quantize_model
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    cfg = get_config("llama3_2_1b")
    model = build(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    qp = quantize_model(model, params, main_spec())
    del params
    torch.cuda.synchronize()
    ptq_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(3)
    shared = torch.randint(0, cfg.vocab_size, (48,), generator=gen).tolist()
    prompts = []
    for i in range(16):
        n = int(torch.randint(32, 257, (1,), generator=gen))
        tail = torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
        prompts.append((shared + tail)[:n] if i % 2 else tail)
    sc = ServeConfig.from_spec(main_spec(), cache_len=1024, block_size=16, prefill_chunk=64)
    engine = ServingEngine(model, qp, sc, batch_slots=8)
    kb.reset_counts()
    kr.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = engine.stats
    launches = {k: kb.LAUNCHES[k] for k in kb.KERNELS}
    # every step runs every layer: 6 projections (each one LUT-GEMM and one
    # top-k) and one attention per layer, all on their kernels
    per_step = {"fused_lut_gemm": 6, "topk_outlier": 6, "paged_attn_int4": 1}
    expected = {k: v * cfg.n_layers * st["packed_steps"] for k, v in per_step.items()}
    plain = dict(kb.PLAIN_ON_CUDA)
    plain_routes = dict(gemm=kr.jnp_calls(), detect=kr.detect_jnp_calls(),
                        gemm_fallbacks=kr.fallback_count(),
                        detect_fallbacks=kr.detect_fallback_count())
    n_tok = sum(len(o) for o in outs)
    ok = (len(outs) == 16 and all(len(o) == 64 for o in outs)
          and all(0 <= t < cfg.vocab_size for o in outs for t in o)
          and launches == expected and not any(plain.values())
          and not any(plain_routes.values()))
    emit("serve", arch=cfg.arch_id, layers=cfg.n_layers, requests=len(outs),
         prompt_tokens=sum(len(p) for p in prompts), generated_tokens=n_tok,
         wall_s=wall, tokens_per_s=n_tok / wall, ptq_s=ptq_s,
         packed_steps=st["packed_steps"], preemptions=st["preemptions"],
         prefix_hits=st["prefix_hits"], prefix_hit_tokens=st["prefix_hit_tokens"],
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=launches, launches_per_step={k: v / st["packed_steps"]
                                               for k, v in launches.items()},
         expected_launches=expected, plain_on_cuda=plain, plain_routes=plain_routes,
         card=smi_line, ok=ok)
    phase_profile(engine, cfg.vocab_size)
    return ok, launches


def phase_profile(engine, vocab: int) -> None:
    """Where a serving step's time goes: ``torch.profiler`` over a short
    extra run (4 requests, 8 new tokens) on the engine of phase 5."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator().manual_seed(4)
    prompts = [torch.randint(0, vocab, (n,), generator=gen).tolist() for n in (40, 70, 100, 130)]
    steps0 = engine.stats["packed_steps"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(prompts, max_new_tokens=8)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    steps = engine.stats["packed_steps"] - steps0
    # kernel events only: an aten op's row repeats the time of its kernels
    rows = [(e.self_device_time_total, e.key, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    emit("profile", wall_s=wall, packed_steps=steps, ms_per_step=wall / steps * 1e3,
         device_busy_s=busy_s, device_busy_share=busy_s / wall if rows else None,
         top=[{"op": k, "device_ms": us / 1e3, "calls": c} for us, k, c in rows[:12]])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kb

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi_line = smi()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    emit("device", name=name, count=count, nvidia_smi=smi_line, torch=torch.__version__,
         cuda=torch.version.cuda)
    failures = []

    secs = kb.build_all()
    regs = [l.strip() for log in kb.BUILD_LOG.values() for l in log.splitlines()
            if "registers" in l]
    emit("build", seconds=secs, ptxas=regs)
    results = phase_kernels(dev)
    for name_k, (cases, _) in results.items():
        failures += [f"{name_k}: {c['case']}" for c in cases if not c["ok"]]
    if not phase_model(dev):
        failures.append("model check")
    ok, launches = phase_serve(dev, smi_line)
    if not ok:
        failures.append("serve")

    kernels = []
    for k in kb.KERNELS:
        cases, main_i = results[k]
        rep = cases[main_i]
        kernels.append({
            "name": k, "route": "cuda", "source": f"src/repro_torch/csrc/{k}.cu",
            "replaces": TPU_KERNELS[k], "launches": launches[k],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": rep["kernel_ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": rep["library_ms"], "shape": rep["case"],
        })
    if failures:
        print(f"chip_smoke: FAILED: {failures}", file=sys.stderr)
        return 1
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
