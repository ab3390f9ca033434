#!/usr/bin/env python3
"""Drives the PyTorch port (``src/repro_torch``) on one NVIDIA card.

Phases, each printing one JSON line:

1. device  -- the card's name and count, and what ``nvidia-smi`` reports.
2. build   -- compiles the seven CUDA kernels from ``src/repro_torch/csrc``,
              one ``nvcc`` per source, all at once.
   build_lut -- the two LUT-GEMM kernels' registers, shared memory and
              spills per instantiation, from ptxas.
3. kernels -- each kernel against its plain PyTorch version on the card, at
              llama3_2_1b's serving shapes (72 token rows = 8 decode slots +
              a 64-token prefill chunk) and a 1024-row prefill for the
              LUT-GEMMs, with times, bounds and yardsticks (every kernel also
              with its device time under the profiler); both LUT-GEMMs also
              bit for bit on inputs with exact sums, where bucketize + index
              GEMM must equal the fused kernel, and bit for bit between two
              launches. Both attention kernels also bit for bit between two
              launches, and on three more layouts per page type: the packed
              serving step as ``models/layers.py`` builds it, long-context
              decode (ctx 4096-8192) and contexts on page and split
              boundaries under a window that masks whole splits. Both
              Orizuru kernels exactly, bit for bit between two launches, also
              on rows of NaN of both signs, +-0 and +-inf (``specials``), at
              k = N and at N = 11008; the top-k, streaming and bucketize
              yardsticks with their device times too. Bucketize at A4 and
              A8 on 72 and 1024 rows, a ragged size and a view off 16-byte
              alignment, with ``Tensor.copy_`` of the same bytes as floor.
4. model   -- a 2-layer, full-width llama3_2_1b: one packed serving step on
              the card against the same step on the CPU (plain versions),
              for three seeds, on the fused route (int4 KV) and on path A
              (plain GEMM + streaming detection, bf16 KV), with a
              nibble-swapped control that must fail; path A with streaming
              and with plain detection must give equal logits on the card.
5. serve   -- the full 16-layer llama3_2_1b, quantized by the port under the
              W4A4 + W8 mlp/wd + int4 KV spec, serving 16 seeded requests;
              every projection and attention of every step must have gone
              through its kernel (launch and dispatch counts exact, no plain
              route and no plain version on a CUDA tensor), then a profiled
              extra run.
5b. serve_a -- path A: the same weights on the plain GEMM route and the
              default bf16 KV pool, the same requests and the same checks
              with the streaming and float-page attention kernels.
6. quickstart -- ``repro_torch.examples.quickstart`` on the card; its own
              checks (the index LUT-GEMM within its float32 bound of the
              factorized form at the quickstart's shape), and the index
              LUT-GEMM and bucketize kernels launched.
7. trained_parity -- the committed JAX-trained oasis_7b smoke artifact
              served by the port on the fused route with the int4 pool:
              first tokens equal JAX's, first packed step's logits within
              0.1 rel L2 of JAX's, every kernel launched, no plain route.
8. demotion -- A5/A8 activations on the kernel GEMM routes and kernel
              detection under static thresholds run on CUDA tensors as
              counted fallbacks, as JAX demotes them.

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
TF32_FLOPS = 495e12  # H100 SXM TF32 tensor cores, dense
TPU_KERNELS = {
    "fused_lut_gemm": "src/repro/kernels/lut_gemm.py:241",
    "topk_outlier": "src/repro/kernels/topk_outlier.py:195",
    "paged_attn_int4": "src/repro/kernels/paged_attn.py:117",
    "paged_attn_bf16": "src/repro/kernels/paged_attn.py:117",
    "streaming_quantize_outlier": "src/repro/kernels/topk_outlier.py:221",
    "lut_gemm": "src/repro/kernels/lut_gemm.py:192",
    "bucketize": "src/repro/kernels/bucketize.py:37",
}
ROWS = 72  # token budget of the serving phase: 8 slots + 64 prefill tokens
# (M, K, boundaries, case, offset of x in a larger buffer)
BUCKETIZE_CASES = [
    (ROWS, 2048, 15, "72x2048 A4"),
    (ROWS, 8192, 15, "72x8192 A4"),
    (ROWS, 8192, 255, "72x8192 A8"),
    (1024, 8192, 15, "1024x8192 A4"),
    (1024, 8192, 255, "1024x8192 A8"),
    (37, 2047, 15, "37x2047 A4 ragged (numel % 4 = 3)"),
    (ROWS, 2047, 15, "72x2047 A4 unaligned view", 1),
]


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


def device_ms(fns, reps: int, tries: int = 5) -> float | None:
    """Device ms per call over the same loop as ``cuda_ms``, from the
    profiler's kernel events: the kernels' own time without the gaps between
    launches. Each call launches at least one kernel, so a profile whose
    most frequent kernel has fewer than ``reps`` events lost some (the
    profiler now and then drops them); the loop is then profiled again, up
    to ``tries`` times (None if no profile saw every launch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for f in fns:
        f()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(reps):
                fns[i % len(fns)]()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        us = sum(e.self_device_time_total for e in events)
        if us > 0 and max(e.count for e in events) >= reps:
            return us / 1e3 / reps
    return None


def copies_for(nbytes: int) -> int:
    """Input copies so one cycle moves > 120 MB (2.4x the 50 MB L2)."""
    return max(1, min(32, math.ceil(120e6 / max(nbytes, 1))))


def bound(nbytes: float, flops: float, peak: float = F32_FLOPS) -> tuple[float, str]:
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def ptxas_report(log: str) -> list[dict]:
    """Registers, shared memory and spills per entry function of a
    ``-Xptxas -v`` build log."""
    import re

    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"entry": m.group(1)}
            out.append(cur)
        elif cur is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                cur["static_smem"] = int(sm.group(1)) if sm else 0
    return out


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def act_indices(x, s, bounds, mul_form):
    """Plain activation indices (int32) in the compare form of the input
    dtype: ``x >= s * b`` for bfloat16 origin, ``x / s >= b`` for float32."""
    import torch

    from repro_torch.core.quantize import bucketize_mul_form
    from repro_torch.kernels.bucketize import rank

    if mul_form:
        return bucketize_mul_form(x, s, bounds, dtype=torch.int32)
    return rank(x.float() / s, bounds)


def gemm_case(dev, gen, m, k, n, x_dtype, byte_packed, tag, fused=True, reps=50):
    """A LUT-GEMM kernel against its plain version: the fused kernel
    (bucketize in the tile) or, with ``fused=False``, the index kernel on
    plain activation indices. Two checks, then the times. (1) Gaussian
    codebooks as served: the kernel within 2 sqrt(K) u max(|a| @ |w|) of its
    plain version, the scale of float32 rounding over K terms summed in two
    orders, and asserted below the smallest change one activation index on a
    neighbouring centroid makes to its row. (2) ``exact_sum_inputs``: every
    summation order gives the same sum, so the kernel must equal its plain
    version bit for bit on activations planted on and next to the
    boundaries. There, as a control, the fused kernel run with the other
    compare form must differ; and the unfused pipeline -- the bucketize
    kernel (division form) or the mul-form indices (bfloat16), then the
    index kernel -- must equal the fused kernel bit for bit. Two launches on
    the same inputs must give the same bits (the split-K sums its partials in
    a fixed order). Bounds: the float32 one of the CUDA-core design
    (operations at 67 TFLOP/s) and the 3xTF32 one of the tensor-core design
    (three products per term at 495 TFLOP/s)."""
    import torch

    from repro_torch.core.codebook import boundaries_from_centroids
    from repro_torch.kernels.bucketize import bucketize_call
    from repro_torch.kernels.lut_gemm import (exact_sum_inputs, fused_lut_gemm,
                                              fused_lut_gemm_plain, lut_gemm, lut_gemm_plain)
    from repro_torch.models.model import _default_codebook

    a_book = _default_codebook(4, device=dev)
    bounds = boundaries_from_centroids(a_book).contiguous()
    n_w = 256 if byte_packed else 16
    w_book = torch.sort(torch.randn(n_w, generator=gen, device=dev)).values
    mul_form = x_dtype == torch.bfloat16
    fkw = dict(byte_packed=byte_packed, mul_form=mul_form)
    if fused:
        kern = lambda t: fused_lut_gemm(t[0], t[1], t[2], bounds, a_book, w_book, **fkw)
        plain = lambda t: fused_lut_gemm_plain(t[0], t[1], t[2], bounds, a_book, w_book, **fkw)
    else:
        kern = lambda t: lut_gemm(t[0], t[1], a_book, w_book, byte_packed=byte_packed)
        plain = lambda t: lut_gemm_plain(t[0], t[1], a_book, w_book, byte_packed=byte_packed)

    def inputs():
        x = torch.randn((m, k), generator=gen, device=dev)
        x[:, :: max(1, k // 7)] *= 12.0  # a few outlier channels
        x = x.to(x_dtype)
        s = torch.sqrt(torch.mean(x.float() ** 2, dim=-1, keepdim=True)).clamp(min=1e-12)
        cols = n if byte_packed else n // 2
        w = torch.randint(0, 256, (k, cols), generator=gen, device=dev, dtype=torch.uint8)
        return (x, s, w) if fused else (act_indices(x, s, bounds, mul_form), w)

    args = inputs()
    y, ref = kern(args), plain(args)
    repeat_equal = torch.equal(kern(args), y)
    a_idx = act_indices(args[0], args[1], bounds, mul_form) if fused else args[0]
    w = args[-1]
    w_idx = w.long() if byte_packed else torch.stack([w & 0xF, w >> 4], -1).reshape(k, -1).long()
    w_deq = w_book[w_idx]
    mag = a_book[a_idx.long()].abs() @ w_deq.abs()
    # one index on a neighbouring centroid moves its row by at least this
    flip = (a_book.diff().min() * w_deq.abs().amax(1).min()).item()
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item()
    tol = 2 * math.sqrt(k) * U32 * mag.max().item()
    x, s, wx, bx, ab, wb = [t.to(dev) for t in exact_sum_inputs(m, k, n, x_dtype, byte_packed,
                                                                 seed=m + k + n)]
    fused_ex = fused_lut_gemm(x, s, wx, bx, ab, wb, **fkw)
    if fused:
        ex_ref = fused_lut_gemm_plain(x, s, wx, bx, ab, wb, **fkw)
        wrong = fused_lut_gemm(x, s, wx, bx, ab, wb, byte_packed=byte_packed,
                               mul_form=not mul_form)
        checks = dict(exact_sums_equal=torch.equal(fused_ex, ex_ref),
                      wrong_form_rows_differ=int((wrong != ex_ref).any(1).sum()))
        checked = checks["exact_sums_equal"] and checks["wrong_form_rows_differ"] > 0
    else:
        ex_idx = (act_indices(x, s, bx, True) if mul_form
                  else bucketize_call((x.float() / s).contiguous(), bx))
        unfused = lut_gemm(ex_idx, wx, ab, wb, byte_packed=byte_packed)
        checks = dict(exact_sums_equal=torch.equal(unfused, lut_gemm_plain(
                          ex_idx, wx, ab, wb, byte_packed=byte_packed)),
                      unfused_equals_fused=torch.equal(unfused, fused_ex))
        checked = all(checks.values())
    ok = bool(torch.isfinite(y).all()) and err <= tol < flip and checked and repeat_equal
    in_bytes = sum(t.numel() * t.element_size() for t in args)
    nbytes = in_bytes + 4 * ((15 if fused else 0) + 16 + n_w) + m * n * 4
    sets = [inputs() for _ in range(copies_for(in_bytes))]
    kern_fns = [lambda t=t: kern(t) for t in sets]
    ms = cuda_ms(kern_fns, reps)
    dev_ms = device_ms(kern_fns, reps)
    plain_ms = cuda_ms([lambda t=t: plain(t) for t in sets[:2]], 5)
    # yardstick only: bf16 tensor-core matmul against a pre-dequantized weight
    wd = w_deq.to(torch.bfloat16)
    xd = [torch.randn((m, k), generator=gen, device=dev, dtype=torch.bfloat16) for _ in range(3)]
    lib_fns = [lambda t=t: torch.matmul(t, wd) for t in xd]
    lib_ms = cuda_ms(lib_fns, reps)
    lib_dev_ms = device_ms(lib_fns, reps)
    b_ms, b_by = bound(nbytes, 2.0 * m * n * k)
    tc_ms, tc_by = bound(nbytes, 3 * 2.0 * m * n * k, TF32_FLOPS)
    res = dict(case=tag, M=m, K=k, N=n, x_dtype=str(x_dtype).removeprefix("torch."),
               tier="byte" if byte_packed else "nibble", max_abs_err=err, tol=tol,
               one_flip=flip, **checks, repeat_equal=repeat_equal, ok=ok, kernel_ms=ms,
               kernel_device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
               library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by,
               bound_3xtf32_ms=tc_ms, bound_3xtf32_by=tc_by)
    emit("kernel_fused_lut_gemm" if fused else "kernel_lut_gemm", **res)
    return res


def special_rows(m, n, k, seed, dev):
    """Half-integer rows (runs of equal values across the k-th place on both
    sides) with, per row, up to k + 1 NaN of each sign bit, up to 3k -0.0 and
    up to k of each infinity at random channels; row 0 is all -0.0, row 1
    all NaN with the sign bit set."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    neg_nan = np.array([0xFFC00001], np.uint32).view(np.float32)[0]
    x = (rng.randint(-3, 4, (m, n)) * 0.5).astype(np.float32)
    for r in range(m):
        for v, most in ((np.nan, k + 1), (neg_nan, k + 1), (-0.0, 3 * k), (np.inf, k),
                        (-np.inf, k)):
            x[r, rng.randint(0, n, rng.randint(0, most + 1))] = v
    x[0] = -0.0
    x[1 % m] = neg_nan
    return torch.from_numpy(x).to(dev)


def same(got, want) -> bool:
    """``torch.equal`` on integers; float32 bit for bit, NaN equal to NaN."""
    import torch

    if got.dtype != torch.float32:
        return torch.equal(got, want)
    nan = got.isnan()
    return torch.equal(nan, want.isnan()) and torch.equal(got.view(torch.int32)[~nan],
                                                          want.view(torch.int32)[~nan])


def topk_case(dev, gen, m, n, k, kind, mul_form=None, reps=100):
    """Orizuru's dual top-k kernel or, with ``mul_form`` set, the streaming
    quantize + detect kernel (indices in that compare form, then the same
    top-k), equal to its plain version given the same scale: indices and
    channels exactly, values bit for bit with NaN equal to NaN, on the card
    and on the CPU; two launches must give the same bits. Kinds: ``normal``,
    ``duplicates``, ``equal`` rows (one with +-inf) and ``specials``
    (:func:`special_rows`). The plain version sorts the kernels' order key,
    so it ranks every NaN alike, above +inf, on both devices."""
    import torch

    from repro_torch.core.codebook import boundaries_from_centroids
    from repro_torch.kernels.topk_outlier import (streaming_quantize_outlier_call,
                                                  streaming_quantize_outlier_plain,
                                                  topk_outlier_call, topk_outlier_plain)
    from repro_torch.models.model import _default_codebook

    streaming = mul_form is not None
    bounds = boundaries_from_centroids(_default_codebook(4, device=dev)).contiguous()
    if streaming:
        kern = lambda t: streaming_quantize_outlier_call(t[0], t[1], bounds, k, mul_form=mul_form)
        plain = lambda t: streaming_quantize_outlier_plain(t[0], t[1], bounds.to(t[0].device),
                                                           k, mul_form=mul_form)
        # yardstick only: torch.bucketize of x / s and two torch.topk
        lib = lambda t: (torch.bucketize(t[0] / t[1], bounds, right=True), torch.topk(t[0], k),
                         torch.topk(-t[0], k))
    else:
        kern = lambda t: topk_outlier_call(t[0], k)
        plain = lambda t: topk_outlier_plain(t[0], k)
        lib = lambda t: (torch.topk(t[0], k), torch.topk(-t[0], k))

    def inputs():
        if kind == "normal":
            x = torch.randn((m, n), generator=gen, device=dev)
            if streaming:  # activations: wider, with a few outlier channels
                x = x * 2
                x[:, :: max(1, n // 7)] *= 12.0
        elif kind == "duplicates":
            x = torch.randint(-3, 4, (m, n), generator=gen, device=dev).float()
        elif kind == "specials":
            x = special_rows(m, n, k, int(torch.randint(0, 2**31, (1,), generator=gen,
                                                       device=dev)), dev)
        else:  # all-equal rows, one with +-inf entries
            x = torch.full((m, n), 0.5, device=dev)
            x[0, 3], x[0, 7] = float("inf"), float("-inf")
        if not streaming:
            return (x.contiguous(),)
        if mul_form:  # the mul form serves bfloat16 activations
            x = x.to(torch.bfloat16).float()
        s = torch.sqrt(torch.mean(torch.where(torch.isfinite(x), x, 0) ** 2, -1, keepdim=True))
        return x.contiguous(), s.clamp(min=1e-12)

    args = inputs()
    got, again, want = kern(args), kern(args), plain(args)
    want_cpu = plain(tuple(t.cpu() for t in args))
    torch.cuda.synchronize()
    exact = all(same(a, b) for a, b in zip(got, want))
    exact_cpu = all(same(a.cpu(), b) for a, b in zip(got, want_cpu))
    repeat_equal = all(same(a, b) for a, b in zip(got, again))
    ok = exact and exact_cpu and repeat_equal
    x_bytes = m * n * 4 * (2 if streaming else 1)  # streaming: x in, indices out
    sets = [inputs() for _ in range(copies_for(x_bytes))]
    ms = cuda_ms([lambda t=t: kern(t) for t in sets], reps)
    dev_ms = device_ms([lambda t=t: kern(t) for t in sets], reps)
    plain_ms = cuda_ms([lambda t=t: plain(t) for t in sets[:2]], 10)
    lib_ms = cuda_ms([lambda t=t: lib(t) for t in sets], reps)
    lib_dev_ms = device_ms([lambda t=t: lib(t) for t in sets], reps)
    ops = m * (1.5 * n + 2 * k * math.log2(n))  # Orizuru comparison count
    nbytes = x_bytes + 4 * m * k * 4
    if streaming:  # the scale, the boundaries, and the scale and compares per entry
        nbytes, ops = nbytes + m * 4 + 15 * 4, ops + m * n * (1 + 15)
    b_ms, b_by = bound(nbytes, ops)
    form = f" {'mul' if mul_form else 'div'} form" if streaming else ""
    res = dict(case=f"{kind} N={n} k={k}{form}", M=m, N=n, k=k, exact=exact,
               exact_cpu=exact_cpu, repeat_equal=repeat_equal,
               max_abs_err=0.0 if ok else float("inf"), ok=ok, kernel_ms=ms,
               kernel_device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
               library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by)
    emit("kernel_streaming_quantize_outlier" if streaming else "kernel_topk_outlier", **res)
    return res


def attn_case(dev, gen, b, s, tag, pages="int4", softcap=0.0, window=0, reps=50,
              layout="random", max_blk=64):
    """Paged attention against its plain version, over int4 K-Means pages
    (``pages="int4"``) or float pages of the torch dtype ``pages``. Both
    sides are convex combinations of the values summed in other orders, so
    within 4 n_keys u max|v|; two launches must give equal bits (the splits
    merge in a fixed order). Layouts: ``random`` tables over a shared pool
    with two idle rows (ctx = 0); ``packed``, the packed serving step of
    ``models/layers.py`` (8 decode rows with their own tables, then rows that
    share one slot's table at consecutive positions, ctx = q_pos + 1);
    ``long`` decode rows with their own tables and ctx 4096-8192; and
    ``boundary`` contexts that end on a page or on a split of the kernel's
    plan, ``window`` masking whole splits. The bound counts the keys some
    query row may see (each once), the yardstick is SDPA over dense bf16 K/V
    of the table's width, both timed by events and by the profiler."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attn import (paged_attn_bf16, paged_attn_int4,
                                                paged_attn_plain, paged_attn_quant_plain,
                                                split_plan)
    from repro_torch.models.model import _default_codebook

    kv, g, hd, bs = 8, 4, 64, 16
    n_blocks = {"random": 512, "packed": 9 * max_blk}.get(layout, b * max_blk)
    int4 = pages == "int4"
    book = _default_codebook(4, device=dev)
    kern, plain = ((paged_attn_int4, paged_attn_quant_plain) if int4
                   else (paged_attn_bf16, paged_attn_plain))
    ar_blk = torch.arange(max_blk, device=dev)

    def own_tables(ctx, slot_of_row):
        """Distinct pages per slot; row r reads slot ``slot_of_row[r]``'s
        table, cut (-1) past its context."""
        perm = torch.randperm(n_blocks, generator=gen, device=dev)
        tables = perm[:n_blocks // max_blk * max_blk].reshape(-1, max_blk)[slot_of_row]
        tables[ar_blk[None, :] >= ((ctx + bs - 1) // bs)[:, None]] = -1
        return tables

    def inputs():
        if int4:
            ki = torch.randint(0, 256, (n_blocks, bs, kv, hd // 2), generator=gen, device=dev,
                               dtype=torch.uint8)
            vi = torch.randint(0, 256, ki.shape, generator=gen, device=dev, dtype=torch.uint8)
            ks = torch.rand((n_blocks, bs, kv, 1), generator=gen, device=dev) + 0.5
            vs = torch.rand((n_blocks, bs, kv, 1), generator=gen, device=dev) + 0.5
            pool = (ki, ks, vi, vs, book)
        else:
            pool = tuple(torch.randn((n_blocks, bs, kv, hd), generator=gen, device=dev)
                         .to(pages) for _ in "kv")
        q = torch.randn((b, s, kv, g, hd), generator=gen, device=dev)
        ar_s = torch.arange(s, device=dev)[None, :]
        if layout == "random":
            ctx = torch.randint(1, max_blk * bs + 1, (b,), generator=gen, device=dev)
            ctx[-2:] = 0  # idle rows
            tables = torch.randint(0, n_blocks, (b, max_blk), generator=gen, device=dev)
            nblk = (ctx + bs - 1) // bs
            tables[ar_blk[None, :] >= nblk[:, None]] = -1
            qpos = (ctx[:, None] - s + ar_s).clamp(min=-1)
            qpos[ctx == 0] = -1
            if s > 1:
                qpos[0, -1] = -1  # a padded cell inside a live segment
        elif layout == "packed":
            dec = 8
            ctx = torch.randint(1, max_blk * bs + 1, (b,), generator=gen, device=dev)
            c0 = int(torch.randint(0, max_blk * bs - (b - dec) + 1, (1,), generator=gen,
                                   device=dev))
            ctx[dec:] = c0 + 1 + torch.arange(b - dec, device=dev)
            slot = torch.arange(b, device=dev).clamp(max=dec)
            end = ctx.clone()
            end[dec:] = ctx[-1]  # the prefill slot's table reaches its chunk's end
            tables = own_tables(end, slot)
            qpos = ctx[:, None] - 1
        else:
            if layout == "long":
                ctx = torch.randint(4096, 8193, (b,), generator=gen, device=dev)
            else:
                keys = split_plan(b, kv, max_blk, bs)[1] * bs
                ctx = torch.tensor([keys, keys + 1, keys - 1, 2 * keys, max_blk * bs, bs,
                                    max_blk * bs - 1, 3 * bs, 1, 0], device=dev)[:b]
            tables = own_tables(ctx, torch.arange(b, device=dev))
            qpos = (ctx[:, None] - s + ar_s).clamp(min=-1)
            qpos[ctx == 0] = -1
        return tuple(t.contiguous() for t in (q, *pool, tables.int(), ctx.int(), qpos.int()))

    args = inputs()
    kw = dict(softcap=softcap, window=window)
    out, ref = kern(*args, **kw), plain(*args, **kw)
    repeat_equal = torch.equal(kern(*args, **kw), out)
    torch.cuda.synchronize()
    tables, ctx, qpos = (t.long() for t in args[-3:])
    live = qpos >= 0  # rows that see at least one key (q_pos < ctx here)
    err = (out - ref).abs()[live].max().item()
    v_max = (book.abs().max() * args[4].max()) if int4 else args[2].float().abs().max()
    tol = 4 * int(ctx.max()) * U32 * v_max.item()
    ok = bool(torch.isfinite(out).all()) and err <= tol and repeat_equal
    # the keys some row may see: kpos < ctx, kpos <= q_pos, kpos > q_pos - window
    kpos = torch.arange(max_blk * bs, device=dev)
    sees = (kpos[None, None, :] < ctx[:, None, None]) & (kpos[None, None, :] <= qpos[..., None])
    if window > 0:
        sees &= kpos[None, None, :] > qpos[..., None] - window
    need = sees.any(1)  # (B, keys)
    slots = (tables.clamp(min=0)[:, kpos // bs] * bs + kpos % bs)[need]
    row_bytes = hd // 2 + 4 if int4 else hd * args[1].element_size()  # one head's K of a token
    kv_bytes = torch.unique(slots).numel() * kv * row_bytes * 2
    nbytes = (2 * args[0].numel() * 4 + kv_bytes + 4 * (tables.numel() + 2 * b + b * s)
              + (book.numel() * 4 if int4 else 0))
    flops = 4.0 * g * hd * kv * float(sees.sum())
    sets = [inputs() for _ in range(copies_for(kv_bytes))]
    kern_fns = [lambda t=t: kern(*t, **kw) for t in sets]
    ms = cuda_ms(kern_fns, reps)
    dev_ms = device_ms(kern_fns, reps)
    plain_ms = cuda_ms([lambda t=t: plain(*t, **kw) for t in sets[:2]], 5)
    # yardstick only: SDPA over the same keys pre-gathered as dense bf16
    qd = args[0].permute(0, 2, 3, 1, 4).reshape(b, kv * g, s, hd).to(torch.bfloat16)
    kd = torch.randn((b, kv * g, max_blk * bs, hd), device=dev, dtype=torch.bfloat16)
    mask = (torch.arange(max_blk * bs, device=dev)[None, None, None, :]
            < ctx[:, None, None, None])
    lib_fns = [lambda: F.scaled_dot_product_attention(qd, kd, kd, attn_mask=mask)]
    lib_ms = cuda_ms(lib_fns, reps)
    lib_dev_ms = device_ms(lib_fns, reps)
    del kd, sets
    b_ms, b_by = bound(nbytes, flops)
    splits, pps = split_plan(b, kv, max_blk, bs)
    case = tag if int4 else f"{tag} {str(pages).removeprefix('torch.')} pages"
    res = dict(case=case, B=b, S=s, KV=kv, G=g, hd=hd, bs=bs, max_blk=max_blk,
               splits=splits, pages_per_split=pps, softcap=softcap, window=window,
               max_abs_err=err, tol=tol, repeat_equal=repeat_equal, ok=ok, kernel_ms=ms,
               kernel_device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
               library_device_ms=lib_dev_ms, bound_ms=b_ms, bound_by=b_by)
    emit("kernel_paged_attn_int4" if int4 else "kernel_paged_attn_bf16", **res)
    return res


def bucketize_bounds(n_bounds: int, dev):
    """The sorted boundaries of the Gaussian codebook with n_bounds + 1 entries."""
    from repro_torch.core.codebook import boundaries_from_centroids
    from repro_torch.models.model import _default_codebook

    bits = (n_bounds + 1).bit_length() - 1
    bounds = boundaries_from_centroids(_default_codebook(bits, device=dev)).contiguous()
    assert bounds.numel() == n_bounds
    return bounds


def bucketize_inputs(gen, m, k, bounds, offset=0):
    """(m, k) activations (std 2) with +-inf, +-0, NaN and every boundary,
    ``offset`` floats into a larger buffer."""
    import torch

    buf = torch.randn(m * k + offset, generator=gen, device=bounds.device) * 2
    flat = buf[offset:]
    flat[:5] = torch.tensor([float("inf"), float("-inf"), 0.0, -0.0, float("nan")])
    flat[-bounds.numel():] = bounds
    return flat.view(m, k)


def bucketize_case(dev, gen, m, k, n_bounds, tag, offset=0, reps=100):
    """The Clustering-Unit kernel, ``torch.equal`` to its plain version on the
    card and on the CPU, over the sorted boundaries of the Gaussian codebook
    with ``n_bounds + 1`` entries (15: A4, 255: A8), on values that include
    every boundary, +-0, +-inf and NaN. ``offset`` puts x that many floats
    into a larger buffer, off its 16-byte alignment. Times: the kernel, its
    plain version, ``torch.bucketize`` (the yardstick) and ``Tensor.copy_``
    over the same 8 bytes per value, the practical floor at that size. The
    bound counts 8 bytes per value and the boundaries, and the compares a
    search needs, ceil(log2(n_bounds + 1)) per value."""
    import torch

    from repro_torch.kernels.bucketize import bucketize_call, bucketize_plain

    bounds = bucketize_bounds(n_bounds, dev)
    inputs = lambda: bucketize_inputs(gen, m, k, bounds, offset)
    x = inputs()
    got = bucketize_call(x, bounds)
    exact = torch.equal(got, bucketize_plain(x, bounds))
    exact_cpu = torch.equal(got.cpu(), bucketize_plain(x.cpu(), bounds.cpu()))
    torch.cuda.synchronize()
    ok = exact and exact_cpu
    sets = [inputs() for _ in range(copies_for(m * k * 8))]
    kern_fns = [lambda t=t: bucketize_call(t, bounds) for t in sets]
    ms = cuda_ms(kern_fns, reps)
    dev_ms = device_ms(kern_fns, reps)
    plain_ms = cuda_ms([lambda t=t: bucketize_plain(t, bounds) for t in sets[:2]], 10)
    lib_fns = [lambda t=t: torch.bucketize(t, bounds, right=True) for t in sets]
    lib_ms = cuda_ms(lib_fns, reps)
    lib_dev_ms = device_ms(lib_fns, reps)
    dst = torch.empty_like(sets[0])
    copy_dev_ms = device_ms([lambda t=t: dst.copy_(t) for t in sets], reps)
    compares = math.ceil(math.log2(n_bounds + 1))
    b_ms, b_by = bound(m * k * 8 + n_bounds * 4, m * k * float(compares))
    res = dict(case=tag, M=m, K=k, n_bounds=n_bounds, offset=offset, exact=exact,
               exact_cpu=exact_cpu, max_abs_err=0.0 if ok else float("inf"), ok=ok,
               kernel_ms=ms, kernel_device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms,
               library_device_ms=lib_dev_ms, copy_device_ms=copy_dev_ms, bound_ms=b_ms,
               bound_by=b_by)
    emit("kernel_bucketize", **res)
    return res


def phase_kernels(dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    bf, f32 = torch.bfloat16, torch.float32
    gemm_shapes = [
        (ROWS, 2048, 2048, bf, False, "attn/wq,wo bf16"),
        (ROWS, 2048, 512, bf, False, "attn/wk,wv bf16"),
        (ROWS, 2048, 16384, bf, False, "mlp/wi bf16"),
        (ROWS, 8192, 2048, bf, True, "mlp/wd W8 bf16"),
        (ROWS, 2048, 2048, f32, False, "attn/wq f32"),
        (ROWS, 8192, 2048, f32, True, "mlp/wd W8 f32"),
        (8, 2048, 16384, bf, False, "mlp/wi decode-only bf16"),
        (5, 11008, 4096, f32, True, "unaligned K=11008 W8 f32"),
        (37, 1000, 100, bf, False, "unaligned M/K/N nibble bf16"),
        (1024, 2048, 16384, bf, False, "mlp/wi prefill M=1024"),
    ]
    gemm = [gemm_case(dev, gen, *shape) for shape in gemm_shapes]
    topk = [
        topk_case(dev, gen, ROWS, 2048, 10, "normal"),
        topk_case(dev, gen, ROWS, 8192, 41, "normal"),
        topk_case(dev, gen, ROWS, 2048, 10, "duplicates"),
        topk_case(dev, gen, ROWS, 2047, 10, "normal"),
        topk_case(dev, gen, 4, 2048, 10, "equal"),
    ]
    gen_topk = torch.Generator(device=dev).manual_seed(2)  # the cases above keep their inputs
    topk += [
        topk_case(dev, gen_topk, ROWS, 2048, 10, "specials"),
        topk_case(dev, gen_topk, ROWS, 8192, 41, "specials"),
        topk_case(dev, gen_topk, 4, 512, 512, "specials", reps=20),
        topk_case(dev, gen_topk, ROWS, 11008, 55, "normal"),
    ]
    attn = {pages: [attn_case(dev, gen, b, s, tag, pages, softcap=cap, window=win)
                    for b, s, tag, cap, win in ((ROWS, 1, "packed step rows", 0.0, 0),
                                                (ROWS, 1, "window=100 softcap=30", 30.0, 100),
                                                (18, 4, "segments S=4", 0.0, 0))]
            for pages in ("int4", bf, f32)}
    gen_attn = torch.Generator(device=dev).manual_seed(1)  # the cases above keep their inputs
    for pages in ("int4", bf, f32):
        attn[pages] += [
            attn_case(dev, gen_attn, ROWS, 1, "packed layout", pages, layout="packed"),
            attn_case(dev, gen_attn, 8, 1, "long decode ctx 4096-8192", pages, layout="long",
                      max_blk=512),
            attn_case(dev, gen_attn, 10, 1, "page/split boundaries window=200", pages,
                      window=200, layout="boundary", max_blk=128),
        ]
    streaming = [
        topk_case(dev, gen, ROWS, n, k, "normal", mul)
        for mul in (True, False) for n, k in ((2048, 10), (8192, 41))
    ] + [
        topk_case(dev, gen, ROWS, 2048, 10, "duplicates", True),
        topk_case(dev, gen, ROWS, 2047, 10, "normal", False),
        topk_case(dev, gen, 4, 2048, 10, "equal", True),
    ] + [
        topk_case(dev, gen_topk, ROWS, 2048, 10, "specials", mul)
        for mul in (True, False)
    ] + [
        topk_case(dev, gen_topk, ROWS, 8192, 41, "specials", True),
        topk_case(dev, gen_topk, 4, 512, 512, "specials", False, reps=20),
        topk_case(dev, gen_topk, ROWS, 11008, 55, "normal", True),
    ]
    index_gemm = [gemm_case(dev, gen, *shape, f"{tag} indices", fused=False)
                  for *shape, tag in gemm_shapes]
    bucketize = [bucketize_case(dev, gen, *case) for case in BUCKETIZE_CASES]
    # (cases, index of the case whose numbers the kernels line carries)
    return {"fused_lut_gemm": (gemm, 2), "topk_outlier": (topk, 1),
            "paged_attn_int4": (attn["int4"], 0), "paged_attn_bf16": (attn[bf] + attn[f32], 0),
            "streaming_quantize_outlier": (streaming, 0), "lut_gemm": (index_gemm, 2),
            "bucketize": (bucketize, 0)}


# ---------------------------------------------------------------------------
# phases 4 and 5: the model
# ---------------------------------------------------------------------------

def main_spec():
    from repro_torch.core.qlinear import QLinearConfig
    from repro_torch.core.quantspec import QuantSpec

    return QuantSpec(base=QLinearConfig(detection="dynamic", outlier_frac=0.005),
                     rules=[("mlp/wd", {"w_bits": 8})], kv_bits=4, kv_dtype="float32")


def path_a_spec():
    """Path A: the same W4A4 + W8 mlp/wd + dynamic outliers, every projection
    on the plain GEMM route (detection ``auto``), the default float KV pool."""
    from repro_torch.core.qlinear import QLinearConfig
    from repro_torch.core.quantspec import QuantSpec

    return QuantSpec(base=QLinearConfig(detection="dynamic", outlier_frac=0.005, kernel="jnp"),
                     rules=[("mlp/wd", {"w_bits": 8})])


def packed_step_logits(model, params, device, prompts, kv_dtype=None):
    """One packed prefill step of ``prompts`` (one slot each) -> logits of
    the valid cells, float32 on the CPU. The KV pool is int4, or float pages
    in ``kv_dtype``."""
    import numpy as np
    import torch

    from repro_torch.serving.paged_cache import blocks_needed
    from repro_torch.serving.speculative import make_packed_fn

    bs, max_blk = 16, 8
    n = sum(len(p) for p in prompts)
    pools = model.init_caches(len(prompts), max_blk * bs, kv_dtype or torch.float32,
                              quantized=kv_dtype is None, block_size=bs, device=device)
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
    """2-layer full-width llama3_2_1b, one packed step, card vs CPU, on two
    paths that share the quantized weights: the fused route (fused LUT-GEMM,
    top-k, int4 KV pool) and path A (plain GEMM, streaming quantize +
    detect, bfloat16 KV pool).

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
    reading must exceed the bound on both paths. A fault that flips only a
    few indices stays inside these bounds; phase 3 holds the top-k and the
    streaming kernel exactly and the LUT-GEMMs bit for bit on inputs whose
    sums are exact. On the card, path A with streaming detection and with
    plain detection (quantize + stable top-k) must give equal logits: their
    indices and channels are equal by contract, and the rest is one code.
    """
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.qlinear import QLinear, with_detect_route, with_kernel_route
    from repro_torch.models.model import build, quantize_model

    base = dataclasses.replace(get_config("llama3_2_1b"), n_layers=2)
    rel = lambda a, b: (torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)).item()
    agree = lambda a, b: (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    bounds = {"float32": 0.1, "bfloat16": 0.3}
    kv_a = torch.bfloat16  # path A's pool: QuantSpec's default kv_dtype
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
            qa = with_kernel_route(qp, "jnp")  # path A: the same tensors, other routes
            on_card = packed_step_logits(model, qp, dev, prompts)
            on_card_a = packed_step_logits(model, qa, dev, prompts, kv_a)
            plain_detect_a = packed_step_logits(model, with_detect_route(qa, "jnp"), dev,
                                                prompts, kv_a)
            extra = {}
            if seed == seeds[0]:
                swap_nibbles(qp)  # qa shares the packed tensors
                swapped = packed_step_logits(model, qp, dev, prompts)
                swapped_a = packed_step_logits(model, qa, dev, prompts, kv_a)
                swap_nibbles(qp)
                if dtype == "bfloat16":
                    for m in qp.modules():
                        if isinstance(m, QLinear):
                            m.cfg = dataclasses.replace(m.cfg, kernel="jnp",
                                                        detect_kernel="jnp")
                    plain_routes = packed_step_logits(model, qp, dev, prompts)
            on_cpu = packed_step_logits(model, qp.to("cpu"), "cpu", prompts)
            on_cpu_a = packed_step_logits(model, qa.to("cpu"), "cpu", prompts, kv_a)
            if seed == seeds[0]:
                extra["nibble_swap_control_rel_l2"] = rel(swapped, on_cpu)
                extra["path_a_nibble_swap_control_rel_l2"] = rel(swapped_a, on_cpu_a)
                if dtype == "bfloat16":
                    extra["plain_routes_rel_l2"] = rel(plain_routes, on_cpu)
            runs.append(dict(seed=seed, rel_l2=rel(on_card, on_cpu),
                             finite=bool(torch.isfinite(on_card).all()
                                         and torch.isfinite(on_card_a).all()),
                             argmax_agreement=agree(on_card, on_cpu),
                             path_a_rel_l2=rel(on_card_a, on_cpu_a),
                             path_a_argmax_agreement=agree(on_card_a, on_cpu_a),
                             path_a_detect_routes_equal=torch.equal(on_card_a, plain_detect_a),
                             seconds=time.perf_counter() - t0, **extra))
            del qp, qa
        res[dtype] = runs
    ok = all(r["finite"] and r["rel_l2"] <= bounds[d] and r["path_a_rel_l2"] <= bounds[d]
             and r["path_a_detect_routes_equal"] for d, runs in res.items() for r in runs)
    control_ok = all(runs[0][key] > bounds[d] for d, runs in res.items()
                     for key in ("nibble_swap_control_rel_l2",
                                 "path_a_nibble_swap_control_rel_l2"))
    emit("model", layers=base.n_layers, d_model=base.d_model, cells=72, bounds=bounds,
         ok=ok, control_exceeds_bounds=control_ok, **res)
    return ok and control_ok


def serve_prompts(vocab: int) -> list[list[int]]:
    """16 seeded prompts of 32-256 tokens; every other one shares a 48-token prefix."""
    import torch

    gen = torch.Generator().manual_seed(3)
    shared = torch.randint(0, vocab, (48,), generator=gen).tolist()
    prompts = []
    for i in range(16):
        n = int(torch.randint(32, 257, (1,), generator=gen))
        tail = torch.randint(0, vocab, (n,), generator=gen).tolist()
        prompts.append((shared + tail)[:n] if i % 2 else tail)
    return prompts


def serve_run(phase: str, model, params, sc, per_step: dict, routes: dict, smi_line,
              extra: dict) -> tuple[bool, dict]:
    """Serve ``serve_prompts`` x 64 new tokens on 8 slots with every count
    set to 0 first. Passes when each kernel launched exactly ``per_step[k]``
    times per layer and packed step (every other kernel never), each
    dispatch route was taken exactly ``routes[r]`` times per layer and step
    (no fallback), no plain version ran on a CUDA tensor and every request
    got 64 in-vocabulary tokens. Then a profiled extra run."""
    import torch

    import repro_torch.core.kernel_routing as kr
    from repro_torch.kernels import build as kb
    from repro_torch.serving.engine import ServingEngine

    cfg = model.cfg
    prompts = serve_prompts(cfg.vocab_size)
    engine = ServingEngine(model, params, sc, batch_slots=8)
    kb.reset_counts()
    kr.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = engine.stats
    steps = st["packed_steps"]
    launches = {k: kb.LAUNCHES[k] for k in kb.KERNELS}
    expected = {k: per_step.get(k, 0) * cfg.n_layers * steps for k in kb.KERNELS}
    dispatch = dict(gemm_kernel=kr.kernel_calls(), gemm_plain=kr.jnp_calls(),
                    gemm_fallbacks=kr.fallback_count(), detect_kernel=kr.detect_kernel_calls(),
                    detect_plain=kr.detect_jnp_calls(),
                    detect_fallbacks=kr.detect_fallback_count())
    expected_dispatch = {r: routes.get(r, 0) * cfg.n_layers * steps for r in dispatch}
    plain = dict(kb.PLAIN_ON_CUDA)
    n_tok = sum(len(o) for o in outs)
    ok = (len(outs) == 16 and all(len(o) == 64 for o in outs)
          and all(0 <= t < cfg.vocab_size for o in outs for t in o)
          and launches == expected and dispatch == expected_dispatch
          and not any(plain.values()))
    emit(phase, arch=cfg.arch_id, layers=cfg.n_layers, requests=len(outs),
         prompt_tokens=sum(len(p) for p in prompts), generated_tokens=n_tok,
         wall_s=wall, tokens_per_s=n_tok / wall, ms_per_step=wall / steps * 1e3,
         packed_steps=steps, preemptions=st["preemptions"],
         prefix_hits=st["prefix_hits"], prefix_hit_tokens=st["prefix_hit_tokens"],
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches=launches, launches_per_step={k: v / steps for k, v in launches.items()},
         expected_launches=expected, dispatch=dispatch, expected_dispatch=expected_dispatch,
         plain_on_cuda=plain, card=smi_line, ok=ok, **extra)
    phase_profile(f"{phase}_profile", engine, cfg.vocab_size)
    return ok, launches


def phase_serve(dev, smi_line):
    """Phase 5: the fused route (fused LUT-GEMM + top-k kernels, int4 KV)."""
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build, quantize_model
    from repro_torch.serving.engine import ServeConfig

    model = build(get_config("llama3_2_1b"))
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    qp = quantize_model(model, params, main_spec())
    del params
    torch.cuda.synchronize()
    ptq_s = time.perf_counter() - t0
    sc = ServeConfig.from_spec(main_spec(), cache_len=1024, block_size=16, prefill_chunk=64)
    # every step runs every layer: 6 projections (each one LUT-GEMM and one
    # top-k) and one attention per layer, all on their kernels
    ok, launches = serve_run(
        "serve", model, qp, sc, {"fused_lut_gemm": 6, "topk_outlier": 6, "paged_attn_int4": 1},
        {"gemm_kernel": 6, "detect_kernel": 6}, smi_line, dict(ptq_s=ptq_s))
    return ok, launches, model, qp


def phase_serve_a(model, qp, smi_line):
    """Phase 5b, path A: phase 5's quantized weights with every projection on
    the plain GEMM route (``with_kernel_route(qp, "jnp")``, no second PTQ),
    detection left on ``auto`` (the streaming kernel on the card), and the
    default bfloat16 KV pool."""
    from repro_torch.core.qlinear import with_kernel_route
    from repro_torch.serving.engine import ServeConfig

    qa = with_kernel_route(qp, "jnp")
    sc = ServeConfig.from_spec(path_a_spec(), cache_len=1024, block_size=16, prefill_chunk=64)
    assert not sc.kv_quant and sc.cache_dtype == "bfloat16"
    # 6 projections per layer: one plain GEMM and one streaming quantize +
    # detect launch each; one float-page attention per layer
    return serve_run("serve_a", model, qa, sc,
                     {"streaming_quantize_outlier": 6, "paged_attn_bf16": 1},
                     {"gemm_plain": 6, "detect_kernel": 6}, smi_line, {})


def phase_quickstart(dev) -> tuple[bool, dict, float]:
    """Phase 6: the ported quickstart on the card. Its own checks raise; the
    index LUT-GEMM (step 3, ``ops.lut_gemm``) and the Clustering Unit
    (``ops.bucketize``) must have launched, and the index kernel's output at
    the quickstart's shape must lie within its float32 bound of the
    factorized plain form."""
    import torch

    from repro_torch.examples import quickstart
    from repro_torch.kernels import build as kb

    kb.reset_counts()
    t0 = time.perf_counter()
    got = quickstart.run(*quickstart.inputs(), dev, verbose=False)
    torch.cuda.synchronize()
    launches = dict(kb.LAUNCHES)
    plain = dict(kb.PLAIN_ON_CUDA)
    ok = (launches.get("lut_gemm", 0) > 0 and launches.get("bucketize", 0) > 0
          and not any(plain.values()) and got["err_kernel"] <= got["tol_kernel"])
    emit("quickstart", seconds=time.perf_counter() - t0, err_plain=got["err_plain"],
         err_oasis=got["err_oasis"], kernel_vs_factorized_err=got["err_kernel"],
         kernel_vs_factorized_tol=got["tol_kernel"], launches=launches, plain_on_cuda=plain,
         ok=ok)
    return ok, launches, got["err_kernel"]


def phase_trained_parity(dev) -> bool:
    """Phase 7: parity on trained weights against JAX's own tokens. The port
    loads the committed JAX-trained artifact (``tests/fixtures/
    trained_oasis_smoke``: the oasis_7b smoke byte-LM, 200 steps, W4A4 +
    W8 ``mlp/wd`` + dynamic outliers + int4 KV; ``tests/test_torch_trained.py``
    made it) on the card and serves the five byte prompts on the fused route
    with the recorded ``ServeConfig`` fields, every count set to 0 first.
    Then the JAX engine's first packed step (its recorded inputs, fresh
    pools) against JAX's logits. Passes when each fused-route kernel launched
    exactly 6 (LUT-GEMM, top-k) or 1 (attention) times per layer and step,
    no plain version ran on a CUDA tensor, the first-step rel L2 is under the
    model phase's float32 bound (0.1) and every prompt's first generated
    token is JAX's. The common prefix with JAX's 24 tokens is reported per
    prompt, not gated: the card sums in other orders, and an A4 index flip
    can move a later greedy token."""
    import numpy as np
    import torch

    import repro_torch.core.kernel_routing as kr
    from repro_torch.core.artifact import load_quantized
    from repro_torch.kernels import build as kb
    from repro_torch.serving.engine import ServeConfig, ServingEngine
    from repro_torch.serving.speculative import make_packed_fn

    fixture = ROOT / "tests" / "fixtures" / "trained_oasis_smoke"
    with np.load(fixture / "expected.npz") as z:
        exp = {k: z[k] for k in z.files}
    want = exp["tokens"].tolist()
    prompts = [list(p.encode()) for p in exp["prompts"]]
    art = load_quantized(str(fixture), device=dev)
    sc = ServeConfig.from_spec(art.spec, **json.loads(str(exp["serve_config"])))
    engine = ServingEngine(art.model, art.params, sc, batch_slots=int(exp["batch_slots"]))
    kb.reset_counts()
    kr.reset()
    got = engine.generate(prompts, max_new_tokens=len(want[0]))
    torch.cuda.synchronize()
    steps, layers = engine.stats["packed_steps"], art.model.cfg.n_layers
    per_step = {"fused_lut_gemm": 6, "topk_outlier": 6, "paged_attn_int4": 1}
    launches = {k: kb.LAUNCHES[k] for k in kb.KERNELS}
    expected = {k: per_step.get(k, 0) * layers * steps for k in kb.KERNELS}
    plain = dict(kb.PLAIN_ON_CUDA)
    fallbacks = kr.fallback_count() + kr.detect_fallback_count()
    prefix = [next((i for i, (a, b) in enumerate(zip(g, w)) if a != b), len(w))
              for g, w in zip(got, want)]

    pools = art.model.init_caches(engine.slots, sc.cache_len, sc.cache_dtype,
                                  quantized=sc.kv_quant, block_size=sc.block_size, device=dev)
    step_in = [torch.from_numpy(exp[k]).to(dev) for k in ("bt", "slot_ids", "pos", "ctx", "tok")]
    _, logits = make_packed_fn(art.model)(art.params, pools, *step_in)
    valid = torch.from_numpy(exp["pos"][:, 0] >= 0)
    on_card = logits[:, 0].float().cpu()[valid]
    ref = torch.from_numpy(exp["first_step_logits"])[:, 0][valid]
    rel = (torch.linalg.vector_norm(on_card - ref) / torch.linalg.vector_norm(ref)).item()
    agree = (on_card.argmax(-1) == ref.argmax(-1)).float().mean().item()
    ok = (launches == expected and not any(plain.values()) and fallbacks == 0
          and bool(torch.isfinite(on_card).all()) and rel < 0.1
          and all(g[0] == w[0] for g, w in zip(got, want)))
    emit("trained_parity", arch=art.model.cfg.arch_id, layers=layers,
         d_model=art.model.cfg.d_model, prompts=list(map(str, exp["prompts"])),
         new_tokens=len(want[0]), common_prefix=prefix, tokens_equal=got == want,
         first_token_equal=[g[0] == w[0] for g, w in zip(got, want)],
         first_step_rel_l2=rel, first_step_argmax_agreement=agree,
         first_step_cells=int(valid.sum()), packed_steps=steps, launches=launches,
         expected_launches=expected, fallbacks=fallbacks, plain_on_cuda=plain, ok=ok)
    return ok


def phase_demotions(dev) -> bool:
    """Phase 8: the configurations that have no kernel in either package,
    demoted to plain code on CUDA tensors as JAX demotes them: A5 and A8
    activation codebooks on the kernel GEMM routes (``pallas``, and ``auto``,
    which resolves to the kernel on the card) and kernel detection under
    static thresholds, on one llama3_2_1b-wide layer (2048 x 2048, 72 rows).
    Passes when each records the expected fallback counts, dynamic detection
    still launches the detection-only top-k kernel, no plain version of a
    kernel ran on a CUDA tensor, and the output is finite."""
    import warnings

    import torch

    import repro_torch.core.kernel_routing as kr
    from repro_torch.core.qlinear import QLinear, QLinearConfig, quantize_linear
    from repro_torch.kernels import build as kb

    gen = torch.Generator(device=dev).manual_seed(6)
    w = torch.randn((2048, 2048), generator=gen, device=dev) * 0.02
    calib = torch.randn((256, 2048), generator=gen, device=dev)
    x = torch.randn((ROWS, 2048), generator=gen, device=dev)
    cases = [  # (overrides, GEMM fallbacks, detection fallbacks, top-k launches)
        (dict(a_bits=5, detection="dynamic", kernel="pallas"), 1, 0, 1),
        (dict(a_bits=8, detection="dynamic", kernel="auto"), 1, 0, 1),
        (dict(a_bits=8, detection="static", detect_kernel="pallas"), 1, 1, 0),
        (dict(detection="static", kernel="jnp", detect_kernel="pallas"), 0, 1, 0),
    ]
    ok_all = True
    for overrides, fb, dfb, topk in cases:
        mod = QLinear(quantize_linear(w, calib, QLinearConfig(**overrides)))
        kr.reset()
        kb.reset_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # the demotions' own warnings
            y = mod(x)
        torch.cuda.synchronize()
        counts = dict(fallbacks=kr.fallback_count(), detect_fallbacks=kr.detect_fallback_count(),
                      gemm_kernel=kr.kernel_calls(), gemm_plain=kr.jnp_calls(),
                      launches=dict(kb.LAUNCHES), plain_on_cuda=dict(kb.PLAIN_ON_CUDA))
        ok = (counts["fallbacks"] == fb and counts["detect_fallbacks"] == dfb
              and counts["gemm_kernel"] == 0 and kb.LAUNCHES["topk_outlier"] == topk
              and kb.LAUNCHES["fused_lut_gemm"] == 0 and not any(kb.PLAIN_ON_CUDA.values())
              and bool(torch.isfinite(y).all()))
        emit("demotion", config=overrides, expected_fallbacks=fb,
             expected_detect_fallbacks=dfb, expected_topk_launches=topk, **counts, ok=ok)
        ok_all &= ok
    return ok_all


def phase_profile(phase: str, engine, vocab: int) -> None:
    """Where a serving step's time goes: ``torch.profiler`` over a short
    extra run (4 requests, 8 new tokens) on a serve phase's engine."""
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
    attn = [(us, c) for us, k, c in rows if "paged_attn" in k]
    emit(phase, wall_s=wall, packed_steps=steps, ms_per_step=wall / steps * 1e3,
         device_busy_s=busy_s, device_busy_share=busy_s / wall if rows else None,
         attention_device_ms_per_step=sum(us for us, _ in attn) / 1e3 / steps,
         attention_calls=sum(c for _, c in attn),
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
    emit("build_lut", **{k: ptxas_report(kb.BUILD_LOG.get(k, "")) for k in ("fused_lut_gemm",
                                                                             "lut_gemm")})
    results = phase_kernels(dev)
    for name_k, (cases, _) in results.items():
        failures += [f"{name_k}: {c['case']}" for c in cases if not c["ok"]]
    if not phase_model(dev):
        failures.append("model check")
    ok, launches, model, qp = phase_serve(dev, smi_line)
    if not ok:
        failures.append("serve")
    ok, launches_a = phase_serve_a(model, qp, smi_line)
    if not ok:
        failures.append("serve path A")
    del model, qp
    ok, launches_qs, qs_err = phase_quickstart(dev)
    if not ok:
        failures.append("quickstart")
    if not phase_trained_parity(dev):
        failures.append("trained parity")
    if not phase_demotions(dev):
        failures.append("demotions")

    # each kernel's launches on the path that runs it
    path_launches = {**{k: launches[k] for k in ("fused_lut_gemm", "topk_outlier",
                                                 "paged_attn_int4")},
                     **{k: launches_a[k] for k in ("streaming_quantize_outlier",
                                                   "paged_attn_bf16")},
                     **{k: launches_qs.get(k, 0) for k in ("lut_gemm", "bucketize")}}
    errs = {k: max(c["max_abs_err"] for c in cases) for k, (cases, _) in results.items()}
    errs["lut_gemm"] = max(errs["lut_gemm"], qs_err)  # and at its own path's shape
    kernels = []
    for k in kb.KERNELS:
        cases, main_i = results[k]
        rep = cases[main_i]
        kernels.append({
            "name": k, "route": "cuda", "source": f"src/repro_torch/csrc/{k}.cu",
            "replaces": TPU_KERNELS[k], "launches": path_launches[k], "max_abs_err": errs[k],
            "ms": rep["kernel_ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep.get("bound_3xtf32_ms", rep["bound_ms"]),
            "bound_by": rep.get("bound_3xtf32_by", rep["bound_by"]),
            "library_ms": rep["library_ms"], "shape": rep["case"],
            "device_ms": rep.get("kernel_device_ms"),
            "library_device_ms": rep.get("library_device_ms"),
        })
        if k == "bucketize":  # every case: device ms against its bound and floor
            kernels[-1]["cases"] = [
                {key: c[key] for key in ("case", "exact", "kernel_device_ms", "bound_ms",
                                         "library_device_ms", "copy_device_ms")}
                for c in cases]
    if failures:
        print(f"chip_smoke: FAILED: {failures}", file=sys.stderr)
        return 1
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
