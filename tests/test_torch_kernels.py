"""PyTorch port vs JAX package: the plain versions of the three ported kernels
against the JAX Pallas kernels in interpret mode, and the wrappers' checks.

The CUDA kernels themselves run only on a card; ``tests/test_torch_gpu.py``
holds them against these plain versions there. Indices and top-k channels
must match exactly; float32 products and attention outputs within the
tolerances stated at each assert (the two sides sum in different orders).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.codebook import boundaries_from_centroids as j_bounds  # noqa: E402
from repro.kernels.lut_gemm import fused_lut_gemm_kernel_call  # noqa: E402
from repro.kernels.paged_attn import paged_attn_kernel_call  # noqa: E402
from repro.kernels.topk_outlier import topk_outlier_kernel_call  # noqa: E402
from repro.models.model import _default_codebook  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.lut_gemm import fused_lut_gemm, fused_lut_gemm_plain  # noqa: E402
from repro_torch.kernels.paged_attn import paged_attn_int4, paged_attn_quant_plain  # noqa: E402
from repro_torch.kernels.topk_outlier import topk_outlier_call, topk_outlier_plain  # noqa: E402

U32 = 2.0**-24


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def n(a):
    return np.asarray(a)


# ---------------------------------------------------------------------------
# fused quantize + LUT-GEMM
# ---------------------------------------------------------------------------

def _gemm_inputs(seed, m, k, nn, byte, x_dtype):
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, k) * 1.3).astype(np.float32)
    x[:, ::7] *= 6
    if x_dtype == "bfloat16":
        x = n(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    s = np.sqrt(np.mean(x * x, axis=-1, keepdims=True)).astype(np.float32)
    a_book = n(_default_codebook(4))
    n_w = 256 if byte else 16
    w_book = np.sort(rng.randn(n_w)).astype(np.float32)
    w = rng.randint(0, 256, (k, nn if byte else nn // 2)).astype(np.uint8)
    return x, s, w, a_book, w_book


@pytest.mark.parametrize("m,k,nn,byte,x_dtype", [
    (8, 256, 128, False, "float32"),
    (8, 256, 128, False, "bfloat16"),
    (16, 256, 64, True, "bfloat16"),
    (16, 256, 64, True, "float32"),
    (5, 200, 38, False, "float32"),     # M, K and N all ragged
    (3, 300, 20, True, "bfloat16"),     # ragged byte tier
])
def test_fused_lut_gemm_plain_matches_pallas(m, k, nn, byte, x_dtype):
    """Same scale in, unscaled product out. Tolerance: the worst-case float32
    error of two summation orders, 2 K u max(|a| @ |w|) with u = 2^-24; an
    index that selected another centroid would exceed it by orders of
    magnitude."""
    x, s, w, a_book, w_book = _gemm_inputs(k + nn, m, k, nn, byte, x_dtype)
    mul = x_dtype == "bfloat16"
    xj = jnp.asarray(x).astype(jnp.bfloat16) if mul else jnp.asarray(x)
    bj = j_bounds(jnp.asarray(a_book))
    want = n(fused_lut_gemm_kernel_call(xj, jnp.asarray(s), jnp.asarray(w), bj,
                                        jnp.asarray(a_book), jnp.asarray(w_book),
                                        byte_packed=byte, mul_form=mul, interpret=True))
    xt = t(x).to(torch.bfloat16) if mul else t(x)
    got = fused_lut_gemm_plain(xt, t(s), t(w), t(n(bj)), t(a_book), t(w_book),
                               byte_packed=byte, mul_form=mul).numpy()
    bnp = n(bj)
    a_idx = ((x[..., None] >= s[..., None] * bnp).sum(-1) if mul
             else np.searchsorted(bnp, x / s, side="right"))
    w_idx = w.astype(np.int64) if byte else np.stack([w & 15, w >> 4], -1).reshape(k, -1)
    tol = 2 * k * U32 * (np.abs(a_book[a_idx]) @ np.abs(w_book[w_idx])).max()
    assert got.shape == want.shape == (m, nn)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("m,k,nn,byte,x_dtype", [
    (16, 256, 64, False, torch.float32),
    (16, 256, 64, False, torch.bfloat16),
    (9, 300, 40, True, torch.bfloat16),
    (9, 300, 40, True, torch.float32),
])
def test_fused_lut_gemm_exact_sum_inputs(m, k, nn, byte, x_dtype):
    """On ``exact_sum_inputs`` every summation order gives the same float32
    sum, so the plain version equals JAX's kernel bit for bit, and the wrong
    compare form changes the output of most rows."""
    from repro_torch.kernels.lut_gemm import exact_sum_inputs

    x, s, w, bounds, a_book, w_book = exact_sum_inputs(m, k, nn, x_dtype, byte, seed=k)
    mul = x_dtype == torch.bfloat16
    kw = dict(byte_packed=byte)
    got = fused_lut_gemm_plain(x, s, w, bounds, a_book, w_book, mul_form=mul, **kw)
    xj = jnp.asarray(n(x.float())).astype(jnp.bfloat16) if mul else jnp.asarray(n(x))
    want = fused_lut_gemm_kernel_call(xj, *(jnp.asarray(n(a)) for a in (s, w, bounds, a_book,
                                                                        w_book)),
                                      mul_form=mul, interpret=True, **kw)
    np.testing.assert_array_equal(got.numpy(), n(want))
    if mul:
        a_idx = (x.float()[..., None] >= s[..., None] * bounds).sum(-1)
    else:
        a_idx = torch.searchsorted(bounds, x / s, right=True)
    w_idx = w.long() if byte else torch.stack([w & 15, w >> 4], -1).reshape(k, -1).long()
    exact = a_book.double()[a_idx] @ w_book.double()[w_idx]
    assert torch.equal(got.double(), exact)
    wrong = fused_lut_gemm_plain(x, s, w, bounds, a_book, w_book, mul_form=not mul, **kw)
    assert (wrong != got).any(1).sum() >= m // 2


def test_lut_gemm_fused_wrapper_scaled_matches_jax():
    """ops.lut_gemm_fused (scales applied) vs the JAX wrapper on the same
    weight: the per-token scale may differ by an ulp between the packages,
    so rtol 1e-5."""
    from repro.core.quantize import quantize_weight as jqw
    from repro.kernels import ops as jops
    from repro_torch.core.quantize import QuantizedWeight

    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 64).astype(np.float32)
    wj = jqw(jnp.asarray(rng.randn(64, 40).astype(np.float32)), nbits=4)
    book = _default_codebook(4)
    want = n(jops.lut_gemm_fused(jnp.asarray(x), book, wj))
    qw = QuantizedWeight(packed=t(n(wj.packed)), codebook=t(n(wj.codebook)),
                         scale=t(n(wj.scale)), shape=wj.shape, nbits=4)
    got = tops.lut_gemm_fused(t(x), t(n(book)), qw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# Orizuru dual top-k
# ---------------------------------------------------------------------------

def _topk_rows(kind, seed=0, m=9, nn=64):
    rng = np.random.RandomState(seed)
    if kind == "normal":
        return rng.randn(m, nn).astype(np.float32)
    if kind == "duplicates":
        return rng.randint(-2, 3, (m, nn)).astype(np.float32)
    if kind == "all_equal":
        return np.full((m, nn), -1.5, np.float32)
    if kind == "odd":
        return rng.randn(m, nn + 1).astype(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["normal", "duplicates", "all_equal", "odd"])
@pytest.mark.parametrize("k", [1, 4])
def test_topk_plain_matches_pallas_exactly(kind, k):
    x = _topk_rows(kind)
    want = topk_outlier_kernel_call(jnp.asarray(x), k, interpret=True)
    got = topk_outlier_plain(t(x), k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), n(w))


def test_topk_wrapper_outlier_set():
    x = _topk_rows("duplicates").reshape(3, 3, 64)
    outs = tops.topk_outlier(t(x), 2)
    assert outs.values.shape == outs.channels.shape == (3, 3, 4)
    assert outs.channels.dtype == torch.int32
    hv, hi, lv, li = topk_outlier_plain(t(x.reshape(9, 64)), 2)
    np.testing.assert_array_equal(outs.channels.reshape(9, 4).numpy(),
                                  torch.cat([hi, li], -1).numpy())
    assert torch.all(outs.mask == 1)


def test_topk_rejects_bad_k():
    x = t(_topk_rows("normal"))
    for k in (0, 65):
        with pytest.raises(ValueError, match="k="):
            topk_outlier_call(x, k)


# ---------------------------------------------------------------------------
# int4 paged attention
# ---------------------------------------------------------------------------

def _attn_inputs(seed, b=5, s=2, kv=2, g=3, hd=8, bs=4, max_blk=4, n_blocks=12):
    rng = np.random.RandomState(seed)
    ki = rng.randint(0, 256, (n_blocks, bs, kv, hd // 2)).astype(np.uint8)
    vi = rng.randint(0, 256, (n_blocks, bs, kv, hd // 2)).astype(np.uint8)
    ks = (rng.rand(n_blocks, bs, kv, 1) + 0.5).astype(np.float32)
    vs = (rng.rand(n_blocks, bs, kv, 1) + 0.5).astype(np.float32)
    q = rng.randn(b, s, kv, g, hd).astype(np.float32)
    ctx = rng.randint(1, max_blk * bs + 1, b).astype(np.int32)
    ctx[-1] = 0  # idle row
    tables = rng.randint(0, n_blocks, (b, max_blk)).astype(np.int32)
    nblk = (ctx + bs - 1) // bs
    tables[np.arange(max_blk)[None, :] >= nblk[:, None]] = -1
    qpos = (ctx[:, None] - s + np.arange(s)[None, :]).astype(np.int32)
    qpos[qpos < 0] = -1
    qpos[ctx == 0] = -1
    qpos[0, 0] = -1  # a padded cell inside a live segment
    book = n(_default_codebook(4))
    return q, ki, ks, vi, vs, book, tables, ctx, qpos


@pytest.mark.parametrize("softcap,window", [(0.0, 0), (5.0, 0), (0.0, 3), (7.0, 5)])
def test_paged_attn_plain_matches_pallas(softcap, window):
    """Rows that see at least one key: float32 within 1e-5 of the value
    scale (softmax sums in another order). Rows that see none (q_pos < 0)
    are meaningless in both versions and only checked to be finite."""
    args = _attn_inputs(int(softcap * 10 + window))
    q, ki, ks, vi, vs, book, tables, ctx, qpos = args
    want = n(paged_attn_kernel_call(
        jnp.asarray(q), jnp.asarray(ki), jnp.asarray(ks), jnp.asarray(vi),
        jnp.asarray(vs), jnp.asarray(book), block_tables=jnp.asarray(tables),
        ctx_lens=jnp.asarray(ctx), q_pos=jnp.asarray(qpos), softcap=softcap,
        window=window, interpret=True))
    got = paged_attn_quant_plain(*map(t, args), softcap=softcap, window=window).numpy()
    live = qpos >= 0
    assert live.sum() >= 4
    vmax = np.abs(book).max() * vs.max()
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=1e-5 * vmax)
    assert np.isfinite(got).all()


# ---------------------------------------------------------------------------
# wrappers: CPU tensors take the plain version; bad inputs raise
# ---------------------------------------------------------------------------

def test_wrappers_run_plain_on_cpu_without_launching():
    build.reset_counts()
    x, s, w, a_book, w_book = _gemm_inputs(0, 4, 64, 32, False, "float32")
    bounds = t(n(j_bounds(jnp.asarray(a_book))))
    args = (t(x), t(s), t(w), bounds, t(a_book), t(w_book))
    np.testing.assert_array_equal(fused_lut_gemm(*args).numpy(),
                                  fused_lut_gemm_plain(*args).numpy())
    xt = t(_topk_rows("normal"))
    for a, b in zip(topk_outlier_call(xt, 3), topk_outlier_plain(xt, 3)):
        assert torch.equal(a, b)
    attn = tuple(map(t, _attn_inputs(1)))
    assert torch.equal(paged_attn_int4(*attn), paged_attn_quant_plain(*attn))
    assert sum(build.LAUNCHES.values()) == 0
    assert sum(build.PLAIN_ON_CUDA.values()) == 0


def test_wrappers_reject_bad_inputs():
    x, s, w, a_book, w_book = _gemm_inputs(0, 4, 64, 32, False, "float32")
    bounds = t(n(j_bounds(jnp.asarray(a_book))))
    ok = [t(x), t(s), t(w), bounds, t(a_book), t(w_book)]
    bad_cases = [
        (0, t(x).double()),                   # x dtype
        (1, t(s)[:, 0]),                      # scale shape
        (2, t(w).int()),                      # weight dtype
        (2, t(w)[:10]),                       # weight rows != K
        (4, t(a_book)[:8]),                   # codebook / boundaries mismatch
        (0, t(x).t().contiguous().t()),       # not contiguous
    ]
    for i, bad in bad_cases:
        args = list(ok)
        args[i] = bad
        with pytest.raises((ValueError, RuntimeError)):
            fused_lut_gemm(*args)
    with pytest.raises(ValueError, match="float32"):
        topk_outlier_call(t(_topk_rows("normal")).double(), 2)
    attn = list(map(t, _attn_inputs(2)))
    for i, bad in [(0, attn[0].double()), (1, attn[1][:, :, :, :2]),
                   (5, attn[5][:8]), (6, attn[6].long()), (8, attn[8][:, :1])]:
        args = list(attn)
        args[i] = bad
        with pytest.raises(ValueError):
            paged_attn_int4(*args)
    with pytest.raises(ValueError, match="device"):
        paged_attn_int4(*[a.to("meta") for a in attn])


def test_build_paths_need_no_compiler_at_import():
    """Importing every kernel module builds nothing; sources exist."""
    src = build._CSRC
    for name in build.KERNELS:
        assert (src / f"{name}.cu").exists()
    assert build.build_dir().name == "kernels"
