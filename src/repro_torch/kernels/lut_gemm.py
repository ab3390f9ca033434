"""The LUT-GEMM kernels: CUDA kernel wrappers and their plain versions.

* :func:`fused_lut_gemm` replaces
  ``repro/kernels/lut_gemm.py::fused_lut_gemm_kernel_call`` (kernel
  ``repro_torch/csrc/fused_lut_gemm.cu``): raw activations in, bucketized in
  the tile. :func:`fused_lut_gemm_plain` is the port of
  ``repro/kernels/ref.py::fused_lut_gemm_ref``.
* :func:`lut_gemm` replaces ``repro/kernels/lut_gemm.py::lut_gemm_kernel_call``
  (kernel ``repro_torch/csrc/lut_gemm.cu``): precomputed activation indices
  in. :func:`lut_gemm_plain` is the port of ``ref.lut_gemm_ref`` and
  ``ref.lut_gemm_byte_ref``.

All return the UNSCALED (M, N) float32 product; the caller applies the
per-token and per-channel scales. Both kernels run one tile loop
(``csrc/lut_gemm_tile.cuh``): a block owns a strip of ``block_n`` output
columns and all token rows, walked in row tiles of ``block_m``, over a chunk
of ``block_k`` rows of K (split-K), with float32-accurate 3xTF32 products
on the warpgroup tensor-core MMA. ``blocks=(block_m, block_n, block_k)``
picks the tile; without it :func:`default_blocks` fills the card. The plain
versions ignore it.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.quantize import bucketize_mul_form
from repro_torch.kernels import build
from repro_torch.kernels.bucketize import rank

__all__ = ["fused_lut_gemm", "fused_lut_gemm_plain", "lut_gemm", "lut_gemm_plain",
           "exact_sum_inputs", "random_packed", "default_blocks", "check_blocks", "TILES",
           "STAGE_K"]

NAME = "fused_lut_gemm"
INDEX = "lut_gemm"
# (block_m, block_n) pairs the kernels instantiate (``lut_tile::with_tile``):
# token rows per tile (the warpgroup MMA's N) and columns per strip
TILES = tuple((m, n) for n in (256, 128) for m in (8, 72, 80))
STAGE_K = 32  # K rows per pipeline stage: block_k is a multiple of it
_UP, _DOWN = torch.tensor(float("inf")), torch.tensor(float("-inf"))


def _nudge(v: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """``v`` moved by ``steps`` float32 ulps (|steps| <= 3)."""
    for d in range(3):
        v = torch.where(steps > d, torch.nextafter(v, _UP), v)
        v = torch.where(steps < -d, torch.nextafter(v, _DOWN), v)
    return v


def exact_sum_inputs(m: int, k: int, n: int, x_dtype: torch.dtype, byte_packed: bool,
                     seed: int = 0, w_bits: int = 4):
    """Kernel inputs on which the float32 sum is exact and the index choice
    is as hard as it gets; returns ``(x, scale, w_packed, boundaries, a_book,
    w_book)`` on the CPU, for ``k <= 29127``. The nibble tier's weight
    codebook has ``2 ** w_bits`` entries (W3: 8), the byte tier's 256.

    Both codebooks lie on a 1/8 grid with magnitudes <= 3, so each product is
    a multiple of 1/64 of magnitude at most 9, and every partial sum over
    K <= 29127 (2^24 / (64 * 9)) stays below 2^24 such steps: any summation
    order gives the same float32 result, and a kernel must equal the plain
    version bit for bit. A quarter of the
    activations sit on ``s * b_j`` or within two ulps of it. For bfloat16 x,
    each row's scale is chosen so that ``x >= s * b_j`` and ``x / s >= b_j``
    disagree on that row's planted value: a kernel with the wrong compare
    form, an inexact division or a wrong nibble order changes an output.
    """
    from repro_torch.core.codebook import boundaries_from_centroids
    from repro_torch.models.model import _default_codebook

    assert k * 64 * 9 < 2**24, "partial sums could leave the exact float32 range"
    g = torch.Generator().manual_seed(seed)
    a_book = torch.round(_default_codebook(4) * 8) / 8
    bounds = boundaries_from_centroids(a_book).contiguous()
    n_w = 256 if byte_packed else 2**w_bits
    w_book = torch.sort(torch.round(torch.randn(n_w, generator=g).clamp(-3, 3) * 8) / 8).values
    w = random_packed(k, n, n_w, byte_packed, g)
    x = torch.randn((m, k), generator=g)
    x[:, :: max(1, k // 7)] *= 12.0  # a few outlier channels
    hug = torch.rand((m, k), generator=g) < 0.25
    steps = torch.randint(-2, 3, (m, k), generator=g)
    nonzero = bounds[bounds != 0]  # next to 0 lie subnormals, which XLA's CPU flushes
    if x_dtype == torch.bfloat16:
        b = nonzero[torch.randint(0, nonzero.numel(), (m,), generator=g)][:, None, None]
        # per row, 16 bfloat16 targets t and the scales within 3 ulps of t / b:
        # take the first pair on which the two forms disagree
        t = (b * (torch.rand((m, 16, 1), generator=g) + 0.5)).to(torch.bfloat16).float()
        cands = _nudge(t / b, torch.arange(-3, 4)[None, None, :])
        differs = ((t >= cands * b) != (t / cands >= b)).reshape(m, -1)
        pick = torch.where(differs.any(1), differs.int().argmax(1), 3)[:, None]
        s = cands.reshape(m, -1).gather(1, pick)
        t = t.expand(-1, -1, 7).reshape(m, -1).gather(1, pick)
        tb = t.to(torch.bfloat16).expand(m, k)
        near = (tb.view(torch.int16) + steps.short()).view(torch.bfloat16)  # t +- 2 ulps
        x = torch.where(hug, near, (x * s).to(torch.bfloat16))
    else:
        s = torch.rand((m, 1), generator=g) + 0.5
        j = torch.randint(0, nonzero.numel(), (m, k), generator=g)
        x = torch.where(hug, _nudge(s * nonzero[j], steps), x * s)
    return x.contiguous(), s.contiguous(), w, bounds, a_book, w_book


def random_packed(k: int, n: int, n_w: int, byte_packed: bool,
                  gen: torch.Generator) -> torch.Tensor:
    """Uniform weight indices below ``n_w`` for a (K, N) weight, packed as
    the kernels read them: (K, N) bytes, or (K, N/2) nibble pairs (low
    nibble first). Draws on ``gen`` where the device is."""
    if byte_packed or n_w == 16:
        return torch.randint(0, 256, (k, n if byte_packed else n // 2), generator=gen,
                             dtype=torch.uint8, device=gen.device)
    lo, hi = torch.randint(0, n_w, (2, k, n // 2), generator=gen, dtype=torch.uint8,
                           device=gen.device)
    return lo | (hi << 4)


def _index_product(a_idx, w_packed, a_book, w_book, byte_packed: bool) -> torch.Tensor:
    """``aBook[aIdx] @ wBook[wIdx]`` in float32."""
    if byte_packed:
        w_idx = w_packed.long()
    else:
        w_idx = torch.stack([w_packed & 0xF, w_packed >> 4], dim=-1).reshape(
            w_packed.shape[0], -1).long()
    a = a_book.float()[a_idx.long()]
    w = w_book.float()[w_idx]
    return a @ w


def lut_gemm_plain(a_idx, w_packed, a_book, w_book, *, byte_packed: bool = False) -> torch.Tensor:
    """The index GEMM over precomputed activation indices."""
    if a_idx.is_cuda:
        build.PLAIN_ON_CUDA[INDEX] += 1
    return _index_product(a_idx, w_packed, a_book, w_book, byte_packed)


def fused_lut_gemm_plain(x, scale, w_packed, boundaries, a_book, w_book, *,
                         byte_packed: bool = False, mul_form: bool = False) -> torch.Tensor:
    """Quantize-then-index-GEMM with the kernel's exact index selection."""
    if x.is_cuda:
        build.PLAIN_ON_CUDA[NAME] += 1
    if mul_form:
        a_idx = bucketize_mul_form(x, scale, boundaries, dtype=torch.int32)
    else:
        a_idx = rank(x.float() / scale, boundaries)
    return _index_product(a_idx, w_packed, a_book, w_book, byte_packed)


def _require(cond: bool, msg: str, name: str = NAME) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def default_blocks(m: int, n: int, k: int) -> tuple[int, int, int]:
    """The tile for an (M, K) x (K, N) product: the smallest row tile of 8,
    72 or 80 token rows that holds M (a packed serving step of 72 is one
    tile; more rows are walked in tiles of 80), strips of 256 columns
    (512-thread blocks, one an SM) or, for N < 1024, of 128 (256-thread
    blocks), and K split so that one wave of blocks fills the card, each
    split at least four stages (the split-K sums cost more than the blocks
    gain below that). Chosen by timing on an H100."""
    block_m = next(t for t in (8, 72, 80) if m <= t) if m <= 80 else 80
    block_n = 256 if n >= 1024 else 128
    per_sm = 1 if block_n == 256 else 2
    strips = -(-n // block_n)
    splits = max(1, min(per_sm * build.SMS // strips, k // (4 * STAGE_K)))
    block_k = -(-max(k, 1) // splits)
    return block_m, block_n, -(-block_k // STAGE_K) * STAGE_K


def check_blocks(blocks, name: str = NAME) -> tuple[int, int, int]:
    """``blocks`` as a validated ``(block_m, block_n, block_k)`` tuple."""
    _require(len(blocks) == 3, f"blocks must be (block_m, block_n, block_k), got {blocks}",
             name)
    bm, bn, bk = (int(b) for b in blocks)
    _require((bm, bn) in TILES, f"(block_m, block_n) must be one of {TILES}, got {(bm, bn)}",
             name)
    _require(bk > 0 and bk % STAGE_K == 0,
             f"block_k must be a positive multiple of {STAGE_K}, got {bk}", name)
    return bm, bn, bk


def _launch(name: str, sig: str, args: list, m: int, n: int, k: int, blocks,
            device) -> torch.Tensor:
    """Launch the C entry point ``name(*args, y, M, N, K, tile_m, tile_n,
    k_split, ws, tickets, stream)`` (``sig``: the codes of ``args`` for
    :func:`build.entry`) with the tile ``blocks`` (None:
    :func:`default_blocks`)."""
    bm, bn, bk = check_blocks(blocks, name) if blocks else default_blocks(m, n, k)
    splits = max(1, math.ceil(k / bk))
    y = torch.empty((m, n), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    ws = tickets = None
    if splits > 1:
        ws = torch.empty((splits, m, n), dtype=torch.float32, device=device)
        tickets = build.tickets(device, stream, math.ceil(n / bn))
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = build.entry(name, sig + "piiiiiippp")
    err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args), y.data_ptr(),
             m, n, k, bm, bn, bk, ptr(ws), ptr(tickets), stream)
    build.check(err, name)
    build.LAUNCHES[name] += 1
    return y


def fused_lut_gemm(x, scale, w_packed, boundaries, a_book, w_book, *,
                   byte_packed: bool = False, mul_form: bool = False,
                   blocks=None) -> torch.Tensor:
    """x (M, K) float32|bfloat16, scale (M, 1) float32, w_packed (K, N/2) or
    (K, N) uint8, boundaries (2^a - 1,), a_book (2^a,), w_book (2^w,) float32.
    A NaN activation gets index 0 in both compare forms (``kernels.bucketize``).
    ``blocks``: ``(block_m, block_n, block_k)``, see :func:`check_blocks`.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    m, k = x.shape
    n = w_packed.shape[1] * (1 if byte_packed else 2)
    _require(x.dtype in (torch.float32, torch.bfloat16), f"x dtype {x.dtype}")
    _require(w_packed.dtype == torch.uint8 and w_packed.shape[0] == k,
             f"w_packed must be uint8 with K={k} rows, got {w_packed.dtype} {tuple(w_packed.shape)}")
    _require(tuple(scale.shape) == (m, 1) and scale.dtype == torch.float32,
             f"scale must be float32 ({m}, 1), got {scale.dtype} {tuple(scale.shape)}")
    nb = boundaries.shape[0]
    _require(1 <= nb <= 15 and tuple(a_book.shape) == (nb + 1,), "a_bits must be in [1, 4]")
    _require(1 <= w_book.shape[0] <= (256 if byte_packed else 16),
             "weight codebook must have <= 16 (nibble) or <= 256 (byte) entries")
    tensors = (x, scale, w_packed, boundaries, a_book, w_book)
    _require(all(t.device == x.device for t in tensors), "inputs must share one device")
    _require(all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    _require(all(t.dtype == torch.float32 for t in (boundaries, a_book, w_book)),
             "boundaries and codebooks must be float32")
    if blocks is not None:
        check_blocks(blocks)
    if x.device.type == "cpu":
        return fused_lut_gemm_plain(x, scale, w_packed, boundaries, a_book, w_book,
                                    byte_packed=byte_packed, mul_form=mul_form)
    _require(x.is_cuda, f"unsupported device {x.device}")
    args = [x, int(x.dtype == torch.bfloat16), scale, w_packed, int(byte_packed), boundaries,
            nb, int(mul_form), a_book, w_book, w_book.shape[0]]
    return _launch(NAME, "pippipiippi", args, m, n, k, blocks, x.device)


def lut_gemm(a_idx, w_packed, a_book, w_book, *, byte_packed: bool = False,
             blocks=None) -> torch.Tensor:
    """a_idx (M, K) int32 in [0, 2^a), w_packed (K, N/2) or (K, N) uint8,
    a_book (2^a,) with a <= 8, w_book (2^w,) float32. ``blocks`` as for
    :func:`fused_lut_gemm`.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    m, k = a_idx.shape
    n = w_packed.shape[1] * (1 if byte_packed else 2)
    req = lambda cond, msg: _require(cond, msg, INDEX)
    req(a_idx.dtype == torch.int32, f"a_idx must be int32, got {a_idx.dtype}")
    req(w_packed.dtype == torch.uint8 and w_packed.shape[0] == k,
        f"w_packed must be uint8 with K={k} rows, got {w_packed.dtype} {tuple(w_packed.shape)}")
    req(a_book.dim() == 1 and 1 <= a_book.shape[0] <= 256,
        "activation codebook must have 1 to 256 entries")
    req(1 <= w_book.shape[0] <= (256 if byte_packed else 16),
        "weight codebook must have <= 16 (nibble) or <= 256 (byte) entries")
    tensors = (a_idx, w_packed, a_book, w_book)
    req(all(t.device == a_idx.device for t in tensors), "inputs must share one device")
    req(all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    req(all(t.dtype == torch.float32 for t in (a_book, w_book)), "codebooks must be float32")
    if blocks is not None:
        check_blocks(blocks, INDEX)
    if a_idx.device.type == "cpu":
        return lut_gemm_plain(a_idx, w_packed, a_book, w_book, byte_packed=byte_packed)
    req(a_idx.is_cuda, f"unsupported device {a_idx.device}")
    args = [a_idx, w_packed, int(byte_packed), a_book, a_book.shape[0], w_book, w_book.shape[0]]
    return _launch(INDEX, "ppipipi", args, m, n, k, blocks, a_idx.device)
