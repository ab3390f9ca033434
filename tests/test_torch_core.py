"""PyTorch port vs JAX package: codebooks, quantization and outlier detection.

Inputs are made with numpy from a seed and handed to both packages. Index
outputs must match exactly given the same inputs, including the per-token
scale: ``token_scale`` itself may differ in its last ulps between XLA's and
PyTorch's reductions (checked to be within 2 ulps below), so the index checks
hand the JAX scale to both sides. Float outputs are compared with the
tolerances stated at each assert.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core.codebook as jcb  # noqa: E402
import repro.core.outlier as jol  # noqa: E402
import repro.core.quantize as jqz  # noqa: E402
from repro.models.model import _default_codebook as j_default_codebook  # noqa: E402

import repro_torch.core.codebook as tcb  # noqa: E402
import repro_torch.core.outlier as tol  # noqa: E402
import repro_torch.core.quantize as tqz  # noqa: E402
from repro_torch.models.model import _default_codebook as t_default_codebook  # noqa: E402

F32_ULP = float(np.finfo(np.float32).eps)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def n(a):
    return np.asarray(a)


def _tie_rows(rng, kind, m=6, k=64):
    if kind == "normal":
        return rng.randn(m, k).astype(np.float32)
    if kind == "duplicates":
        return rng.randint(-3, 4, (m, k)).astype(np.float32)
    if kind == "all_equal":
        return np.full((m, k), 0.25, np.float32)
    if kind == "odd":
        return rng.randn(m, k + 1).astype(np.float32)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# codebooks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbits", [2, 3, 4, 5, 6, 7, 8])
def test_default_codebook_bit_equal(nbits):
    """The int4 KV pool's codebook is not stored in artifacts: it must equal
    JAX's norm.ppf centroids bit for bit."""
    a = n(j_default_codebook(nbits)).view(np.uint32)
    b = t_default_codebook(nbits).numpy().view(np.uint32)
    np.testing.assert_array_equal(a, b)


def test_boundaries_and_assignment_exact():
    rng = np.random.RandomState(0)
    book = np.sort(rng.randn(16)).astype(np.float32)
    b_j = n(jcb.boundaries_from_centroids(jnp.asarray(book)))
    b_t = tcb.boundaries_from_centroids(t(book)).numpy()
    np.testing.assert_array_equal(b_j, b_t)
    x = np.concatenate([rng.randn(500).astype(np.float32) * 2, b_j])  # incl. exact ties
    np.testing.assert_array_equal(n(jcb.assign_via_boundaries(jnp.asarray(x), jnp.asarray(book))),
                                  tcb.assign_via_boundaries(t(x), t(book)).numpy())
    # off the exact midpoints, boundary assignment equals nearest-centroid argmin
    xr = x[:500]
    np.testing.assert_array_equal(n(jcb.assign(jnp.asarray(xr), jnp.asarray(book))),
                                  tcb.assign_via_boundaries(t(xr), t(book)).numpy())


@pytest.mark.parametrize("n_centroids", [4, 16, 256])
def test_quantile_init_and_kmeans_close(n_centroids):
    """Sort-based quantiles and bincount Lloyd steps vs jnp.quantile and the
    one-hot Lloyd step: equal to a few float32 ulps of the data scale (the
    interpolation rounds differently, and boundary assignment differs from
    argmin only on exact midpoints)."""
    rng = np.random.RandomState(1)
    x = rng.randn(3000).astype(np.float32)
    np.testing.assert_allclose(tcb.quantile_init(t(x), n_centroids).numpy(),
                               n(jcb.quantile_init(jnp.asarray(x), n_centroids)),
                               rtol=0, atol=8 * F32_ULP * 4)
    np.testing.assert_allclose(tcb.kmeans_fit(t(x), n_centroids).numpy(),
                               n(jcb.kmeans_fit(jnp.asarray(x), n_centroids)),
                               rtol=0, atol=8 * F32_ULP * 4)


def test_quantile_init_beyond_torch_quantile_limit():
    """torch.quantile refuses inputs above 2**24 elements; llama3_2_1b's
    mlp/wi has 33.5 M. The port's quantiles handle such sizes and agree
    with numpy's linear interpolation."""
    size = 2**24 + 4099
    x = torch.randn(size, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(x, 0.5)
    got = tcb.quantile_init(x, 16).numpy()
    qs = (np.arange(16) + 0.5) / 16
    want = np.quantile(np.sort(x.numpy()).astype(np.float64), qs)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------

def test_pack_unpack_exact():
    rng = np.random.RandomState(3)
    idx = rng.randint(0, 16, (5, 3, 10)).astype(np.int32)
    p_j = n(jqz.pack_int4(jnp.asarray(idx)))
    p_t = tqz.pack_int4(t(idx)).numpy()
    np.testing.assert_array_equal(p_j, p_t)
    np.testing.assert_array_equal(tqz.unpack_int4(t(p_j)).numpy(), idx)
    with pytest.raises(ValueError):
        tqz.pack_int4(t(idx[..., :3]))


@pytest.mark.parametrize("nbits", [3, 4, 8])
def test_quantize_weight(nbits):
    """Codebooks agree to float tolerance; under JAX's codebook the indices
    and packed bytes are exact; the scales are exact."""
    rng = np.random.RandomState(4 + nbits)
    w = rng.randn(48, 40).astype(np.float32)
    qj = jqz.quantize_weight(jnp.asarray(w), nbits=nbits)
    qt = tqz.quantize_weight(t(w), nbits=nbits)
    np.testing.assert_array_equal(qt.scale.numpy(), n(qj.scale))
    np.testing.assert_allclose(qt.codebook.numpy(), n(qj.codebook), rtol=0,
                               atol=8 * F32_ULP)
    wn = t(w) / qt.scale[None, :]
    idx = tcb.assign_via_boundaries(wn, t(n(qj.codebook)))
    np.testing.assert_array_equal(idx.numpy(), n(qj.indices))
    packed = tqz.pack_int4(idx) if nbits <= 4 else idx.to(torch.uint8)
    np.testing.assert_array_equal(packed.numpy(), n(qj.packed))
    qt_j = tqz.QuantizedWeight(packed=t(n(qj.packed)), codebook=t(n(qj.codebook)),
                               scale=t(n(qj.scale)), shape=qj.shape, nbits=nbits)
    np.testing.assert_array_equal(tqz.dequantize_weight(qt_j).numpy(),
                                  n(jqz.dequantize_weight(qj)))


def test_token_scale_within_two_ulps():
    """The RMS reduction runs in another order than XLA's: the scales agree
    to two float32 ulps (absmax is exact)."""
    rng = np.random.RandomState(5)
    x = rng.randn(64, 128).astype(np.float32)
    a = n(jqz.token_scale(jnp.asarray(x), "rms"))
    b = tqz.token_scale(t(x), "rms").numpy()
    assert np.all(np.abs(b - a) <= 2 * np.spacing(a))
    np.testing.assert_array_equal(tqz.token_scale(t(x), "absmax").numpy(),
                                  n(jqz.token_scale(jnp.asarray(x), "absmax")))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activation_indices_exact_given_scale(dtype):
    """Both index forms, from the same per-token scale: exact. bf16 uses the
    int8 sum of x >= s*b_i, float32 searchsorted(x / s)."""
    rng = np.random.RandomState(6)
    x = (rng.randn(32, 96) * 2).astype(np.float32)
    book = n(j_default_codebook(4))
    xj = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    qa = jqz.quantize_activation(xj, jnp.asarray(book))
    s = t(n(qa.scale))
    xt = t(n(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    b = tcb.boundaries_from_centroids(t(book))
    if dtype == "bfloat16":
        idx = tqz.bucketize_mul_form(xt, s, b)
        assert idx.dtype == torch.int8 and n(qa.idx).dtype == np.int8
    else:
        idx = tcb.assign_via_boundaries((xt / s).float(), t(book))
    np.testing.assert_array_equal(idx.numpy(), n(qa.idx))
    # the port's own quantize_activation: same indices wherever its scale
    # came out bit-equal to JAX's (rows with a last-ulp scale difference can
    # flip an index that sits on a boundary; none is asserted for them)
    qt = tqz.quantize_activation(xt, t(book))
    same = (qt.scale.numpy() == n(qa.scale))[:, 0]
    assert same.mean() > 0.5
    np.testing.assert_array_equal(qt.idx.numpy()[same], n(qa.idx)[same])
    deq_j = n(jqz.dequantize_activation(qa))
    qt_js = tqz.QuantizedActivation(idx=t(n(qa.idx)), scale=s, codebook=t(book), nbits=4)
    np.testing.assert_array_equal(tqz.dequantize_activation(qt_js).numpy(), deq_j)


# ---------------------------------------------------------------------------
# outliers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["normal", "duplicates", "all_equal", "odd"])
@pytest.mark.parametrize("k", [1, 3])
def test_detect_outliers_topk_exact_tie_order(kind, k):
    """Values and channels equal lax.top_k's, ties lowest channel first."""
    x = _tie_rows(np.random.RandomState(7), kind)
    oj = jol.detect_outliers_topk(jnp.asarray(x), k)
    ot = tol.detect_outliers_topk(t(x), k)
    np.testing.assert_array_equal(ot.channels.numpy(), n(oj.channels))
    np.testing.assert_array_equal(ot.values.numpy(), n(oj.values))
    np.testing.assert_array_equal(ot.mask.numpy(), n(oj.mask))


def test_stable_topk_tie_example():
    """torch.topk may order ties arbitrarily; the port's must not."""
    x = t(np.array([1, 3, 3, 0, 3, 0, 0], np.float32))
    _, i = tol.stable_topk(x, 3)
    assert i.tolist() == [1, 2, 4]
    _, i = tol.stable_topk(x, 3, largest=False)
    assert i.tolist() == [3, 5, 6]


@pytest.mark.parametrize("kind", ["normal", "duplicates"])
def test_detect_outliers_static_exact(kind):
    x = _tie_rows(np.random.RandomState(8), kind) * 2
    oj = jol.detect_outliers_static(jnp.asarray(x), jnp.float32(-1.5), jnp.float32(1.5), 3)
    ot = tol.detect_outliers_static(t(x), torch.tensor(-1.5), torch.tensor(1.5), 3)
    for f in ("channels", "values", "mask"):
        np.testing.assert_array_equal(getattr(ot, f).numpy(), n(getattr(oj, f)))


def _outlier_setup(seed=9, m=10, k_ch=64, n_out=24, dtype="float32"):
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, k_ch) * 1.5).astype(np.float32)
    x[:, 5] *= 8
    w = rng.randn(k_ch, n_out).astype(np.float32)
    qj = jqz.quantize_weight(jnp.asarray(w), nbits=4)
    book = j_default_codebook(4)
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    qa = jqz.quantize_activation(xj, book)
    outs = jol.detect_outliers_topk(xj.astype(jnp.float32), 2)
    qw_t = tqz.QuantizedWeight(packed=t(n(qj.packed)), codebook=t(n(qj.codebook)),
                               scale=t(n(qj.scale)), shape=qj.shape, nbits=4)
    outs_t = tol.OutlierSet(values=t(n(outs.values)), channels=t(n(outs.channels)),
                            mask=t(n(outs.mask)))
    qa_t = tqz.QuantizedActivation(idx=t(n(qa.idx)), scale=t(n(qa.scale)),
                                   codebook=t(n(book)), nbits=4)
    return qj, qa, outs, qw_t, qa_t, outs_t, book


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_outlier_residuals_exact(dtype):
    """Residuals from a full activation set and recomputed from the outlier
    values alone, each equal to JAX's given the same scale."""
    qj, qa, outs, qw_t, qa_t, outs_t, book = _outlier_setup(dtype=dtype)
    np.testing.assert_array_equal(tol.outlier_residuals(outs_t, qa_t).numpy(),
                                  n(jol.outlier_residuals(outs, qa)))
    mul = dtype == "bfloat16"
    np.testing.assert_array_equal(
        tol.outlier_residuals_direct(outs_t, qa_t.scale, t(n(book)), mul_form=mul).numpy(),
        n(jol.outlier_residuals_direct(outs, qa.scale, book, mul_form=mul)))


@pytest.mark.parametrize("route", ["gather", "scatter"])
def test_compensation_close(route):
    """Gather and scatter compensation: float32, summation order differs
    (einsum vs batched matmul): rtol 1e-5."""
    qj, qa, outs, qw_t, qa_t, outs_t, book = _outlier_setup()
    r = jol.outlier_residuals(outs, qa)
    fj = jol.compensate_gather if route == "gather" else jol.compensate_scatter
    ft = tol.compensate_gather if route == "gather" else tol.compensate_scatter
    want = n(fj(r, outs, qj))
    got = ft(t(n(r)), outs_t, qw_t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_num_outliers_matches():
    for k_ch in (64, 2048, 8192, 11008):
        assert tol.num_outliers(k_ch, 0.005) == jol.num_outliers(k_ch, 0.005)
