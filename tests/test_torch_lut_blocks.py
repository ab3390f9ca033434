"""Tile choice of the LUT-GEMM kernels: ``blocks=``, ``default_blocks`` and
``autotune_lut_blocks`` (port of ``repro/kernels/ops.py``'s block autotune).

On the CPU the wrappers run the plain versions, which ignore the tile, so
these tests hold the bookkeeping: validation, the cache and its key, and the
grid the default tile gives at the serving shapes. The kernels' results per
tile are held on the card (``tests/test_torch_gpu.py``).
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

from repro_torch.core.quantize import (fit_activation_codebook, quantize_activation,  # noqa: E402
                                       quantize_weight)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.lut_gemm import (STAGE_K, TILES, check_blocks,  # noqa: E402
                                          default_blocks, exact_sum_inputs, fused_lut_gemm,
                                          lut_gemm)


def _layer(seed: int, m: int = 8, k: int = 128, n: int = 32, w_bits: int = 4):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    return x, quantize_weight(w, w_bits), fit_activation_codebook(x, 4)


@pytest.mark.parametrize("fused", [True, False])
def test_autotune_lut_blocks_caches_winner(fused):
    x, qw, book = _layer(0)
    cands = ((80, 128, 64), (80, 256, 128))
    best = ops.autotune_lut_blocks(x, book, qw, fused=fused, candidates=cands, reps=1)
    assert best in cands
    assert ops._cached_blocks(8, 128, 32, 4, 4, fused) == best
    # the cached tile gives the same result as an explicit one
    if fused:
        y, y_best = ops.lut_gemm_fused(x, book, qw), ops.lut_gemm_fused(x, book, qw, blocks=best)
    else:
        qa = quantize_activation(x, book)
        y, y_best = ops.lut_gemm(qa, qw), ops.lut_gemm(qa, qw, blocks=best)
    np.testing.assert_array_equal(y.numpy(), y_best.numpy())
    ops._BLOCK_CACHE.clear()


def test_autotune_rejects_a_tile_the_kernels_do_not_instantiate():
    x, qw, book = _layer(1)
    with pytest.raises(ValueError, match="block_m, block_n"):
        ops.autotune_lut_blocks(x, book, qw, candidates=((64, 128, 64),), reps=1)
    assert not ops._BLOCK_CACHE


@pytest.mark.parametrize("blocks,match", [
    ((80, 64, 64), "block_m, block_n"),
    ((128, 128, 64), "block_m, block_n"),
    ((80, 128, 48), "multiple of"),
    ((80, 128, 0), "multiple of"),
    ((80, 128), "block_m, block_n, block_k"),
])
def test_wrappers_reject_bad_blocks(blocks, match):
    x, s, w, bounds, a_book, w_book = exact_sum_inputs(4, 64, 32, torch.float32, False)
    with pytest.raises(ValueError, match=match):
        fused_lut_gemm(x, s, w, bounds, a_book, w_book, blocks=blocks)
    with pytest.raises(ValueError, match=match):
        lut_gemm(torch.zeros((4, 64), dtype=torch.int32), w, a_book, w_book, blocks=blocks)


def test_plain_versions_ignore_blocks():
    x, s, w, bounds, a_book, w_book = exact_sum_inputs(5, 96, 64, torch.bfloat16, True)
    want = fused_lut_gemm(x, s, w, bounds, a_book, w_book, byte_packed=True, mul_form=True)
    for bm, bn in TILES:
        got = fused_lut_gemm(x, s, w, bounds, a_book, w_book, byte_packed=True, mul_form=True,
                             blocks=(bm, bn, STAGE_K))
        assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n", [
    (72, 8192, 2048),   # mlp/wd
    (72, 2048, 16384),  # mlp/wi
    (72, 2048, 2048),   # attn/wq, wo
    (72, 2048, 512),    # attn/wk, wv
    (8, 2048, 16384),   # decode-only step
    (1024, 2048, 16384),  # prefill
])
def test_default_blocks_fill_the_card(m, k, n):
    """At the serving shapes the default tile holds the step's token rows in
    one row tile, and gives at most one wave of blocks (132 SMs: one
    512-thread or two 256-thread blocks an SM), at least 64, with at least
    four pipeline stages per split."""
    bm, bn, bk = check_blocks(default_blocks(m, n, k))
    assert bm >= min(m, 80)
    per_sm = 1 if bn == 256 else 2
    blocks = math.ceil(n / bn) * math.ceil(k / bk)
    assert 64 <= blocks <= 132 * per_sm
    assert bk >= 4 * STAGE_K or bk >= k
