"""PyTorch port vs JAX package: the streaming quantize + detect kernel, the
index LUT-GEMM and the Clustering-Unit (bucketize) kernel, through their
plain versions, their ``ops`` wrappers and the plain-GEMM route of
``qlinear_apply`` with kernel detection.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do.
Indices and top-k channels and values must match exactly when both sides get
the same scale; float32 products within the summation-order tolerance stated
at each assert, and bit for bit on ``exact_sum_inputs``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.codebook import boundaries_from_centroids as j_bounds  # noqa: E402
from repro.kernels.bucketize import bucketize_kernel_call  # noqa: E402
from repro.kernels.lut_gemm import fused_lut_gemm_kernel_call, lut_gemm_kernel_call  # noqa: E402
from repro.kernels.topk_outlier import streaming_quantize_outlier_kernel_call  # noqa: E402
from repro.models.model import _default_codebook  # noqa: E402

import repro_torch.core.kernel_routing as kr  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.bucketize import bucketize_call, bucketize_plain  # noqa: E402
from repro_torch.kernels.lut_gemm import exact_sum_inputs, lut_gemm, lut_gemm_plain  # noqa: E402
from repro_torch.kernels.topk_outlier import (  # noqa: E402
    streaming_quantize_outlier_call,
    streaming_quantize_outlier_plain,
)

U32 = 2.0**-24


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def n(a):
    return np.asarray(a)


def _rows(kind, seed=0, m=9, nn=64):
    rng = np.random.RandomState(seed)
    if kind == "normal":
        return (rng.randn(m, nn) * 1.5).astype(np.float32)
    if kind == "duplicates":
        return rng.randint(-2, 3, (m, nn)).astype(np.float32)
    if kind == "equal_inf":  # all-equal rows, one of them with +-inf entries
        x = np.full((m, nn), 0.75, np.float32)
        x[0, 3], x[0, 9] = np.inf, -np.inf
        return x
    if kind == "odd":
        return (rng.randn(m, nn + 1) * 1.5).astype(np.float32)
    raise ValueError(kind)


def _scale(x):
    s = np.sqrt(np.mean(np.where(np.isfinite(x), x, 0) ** 2, axis=-1, keepdims=True))
    return np.maximum(s, 1e-12).astype(np.float32)


# ---------------------------------------------------------------------------
# streaming quantize + detect
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mul_form", [False, True])
@pytest.mark.parametrize("kind", ["normal", "duplicates", "equal_inf", "odd"])
def test_streaming_plain_matches_pallas_exactly(kind, mul_form):
    """Same scale in: indices (both compare forms), values and channels equal."""
    x = _rows(kind, seed=len(kind))
    if mul_form:  # bf16 origin
        x = n(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    s = _scale(x)
    b = n(j_bounds(_default_codebook(4)))
    want = streaming_quantize_outlier_kernel_call(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                                                  3, mul_form=mul_form, interpret=True)
    got = streaming_quantize_outlier_plain(t(x), t(s), t(b), 3, mul_form=mul_form)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), n(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_outlier_streaming_wrapper_matches_jax(dtype):
    """ops.quantize_outlier_streaming: the same QuantizedActivation (index
    dtype included) and OutlierSet as JAX's. The scales come from each
    package's own ``token_scale`` and agree within 2 ulps; on these seeded
    inputs no index sits on a boundary, so the indices agree exactly."""
    from repro.kernels import ops as jops

    x = (np.random.RandomState(5).randn(2, 6, 96) * 2).astype(np.float32)
    x[..., 11] *= 6
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    xt = t(n(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    book = _default_codebook(4)
    jqa, jout = jops.quantize_outlier_streaming(xj, book, 2)
    qa, out = tops.quantize_outlier_streaming(xt, t(n(book)), 2)
    assert str(qa.idx.dtype).removeprefix("torch.") == str(jqa.idx.dtype)
    np.testing.assert_array_equal(qa.idx.numpy(), n(jqa.idx))
    np.testing.assert_allclose(qa.scale.numpy(), n(jqa.scale), rtol=2.5e-7, atol=0)
    assert qa.nbits == jqa.nbits == 4
    np.testing.assert_array_equal(out.values.numpy(), n(jout.values))
    np.testing.assert_array_equal(out.channels.numpy(), n(jout.channels))
    np.testing.assert_array_equal(out.mask.numpy(), n(jout.mask))


def test_streaming_equals_quantize_activation_and_topk():
    """The streaming contract inside the port: the same indices and scale as
    ``quantize_activation`` and the same set as ``detect_outliers_topk``."""
    from repro_torch.core.outlier import detect_outliers_topk
    from repro_torch.core.quantize import quantize_activation

    book = t(n(_default_codebook(4)))
    for dtype in (torch.float32, torch.bfloat16):
        x = t(_rows("normal", seed=3, m=7, nn=80)).to(dtype)
        qa, out = tops.quantize_outlier_streaming(x, book, 4)
        ref = quantize_activation(x, book)
        assert qa.idx.dtype == ref.idx.dtype
        assert torch.equal(qa.idx, ref.idx) and torch.equal(qa.scale, ref.scale)
        want = detect_outliers_topk(x.float(), 4)
        assert torch.equal(out.values, want.values)
        assert torch.equal(out.channels.long(), want.channels.long())


def test_streaming_wrapper_checks():
    x, b = t(_rows("normal")), t(n(j_bounds(_default_codebook(4))))
    s = t(_scale(n(x)))
    build.reset_counts()
    got = streaming_quantize_outlier_call(x, s, b, 2)
    for a, w in zip(got, streaming_quantize_outlier_plain(x, s, b, 2)):
        assert torch.equal(a, w)
    assert sum(build.LAUNCHES.values()) == sum(build.PLAIN_ON_CUDA.values()) == 0
    for bad in [dict(x=x.double()), dict(s=s[:, 0]), dict(b=t(np.zeros(16, np.float32))),
                dict(k=0), dict(k=65)]:
        args = dict(x=x, s=s, b=b, k=2) | bad
        with pytest.raises(ValueError):
            streaming_quantize_outlier_call(args["x"], args["s"], args["b"], args["k"])
    with pytest.raises(ValueError, match="device"):
        streaming_quantize_outlier_call(x.to("meta"), s.to("meta"), b.to("meta"), 2)


# ---------------------------------------------------------------------------
# the plain-GEMM route with kernel detection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w_bits", [4, 8])
def test_qlinear_plain_gemm_streaming_route_matches_jax(w_bits, dtype):
    """kernel="jnp", detect_kernel="pallas": the streaming kernel's plain
    version on the CPU against JAX's Pallas streaming kernel (interpret
    mode). Tolerances as in tests/test_torch_qlinear.py: rtol 1e-5 for
    float32, one bf16 ulp (2^-7) for bfloat16, for the last-ulp scale
    differences between the packages."""
    from repro.core.qlinear import QLinearConfig as JCfg
    from repro.core.qlinear import qlinear_apply as j_apply
    from repro.core.qlinear import quantize_linear as j_quantize_linear
    from repro.core.quantspec import _cfg_to_json

    from repro_torch.core.qlinear import QLinearParams, qlinear_apply
    from repro_torch.core.quantize import QuantizedWeight
    from repro_torch.core.quantspec import _cfg_from_json

    cfg = JCfg(w_bits=w_bits, detection="dynamic", outlier_frac=0.02, kernel="jnp",
               detect_kernel="pallas")
    rng = np.random.RandomState(w_bits)
    p = j_quantize_linear(jnp.asarray(rng.randn(128, 48).astype(np.float32)),
                          jnp.asarray((rng.randn(64, 128) * 1.5).astype(np.float32)), cfg,
                          bias=jnp.asarray(rng.randn(48).astype(np.float32)))
    qw = QuantizedWeight(packed=t(n(p.qw.packed)), codebook=t(n(p.qw.codebook)),
                         scale=t(n(p.qw.scale)), shape=p.qw.shape, nbits=p.qw.nbits)
    tp = QLinearParams(qw=qw, act_codebook=t(n(p.act_codebook)), bias=t(n(p.bias)),
                       thr_lo=None, thr_hi=None, cfg=_cfg_from_json(_cfg_to_json(p.cfg)))
    x = (rng.randn(6, 128) * 2).astype(np.float32)
    x[:, 3] *= 5
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    xt = t(n(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    kr.reset()
    got = qlinear_apply(tp, xt)
    assert kr.jnp_calls() == 1 and kr.detect_kernel_calls() == 1
    want = n(j_apply(p, xj).astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else 2.0**-7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol * np.abs(want).max())


# ---------------------------------------------------------------------------
# index LUT-GEMM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,nn,byte", [
    (8, 256, 128, False), (16, 256, 64, True), (5, 200, 38, False), (3, 300, 20, True),
])
def test_index_lut_gemm_plain_matches_pallas(m, k, nn, byte):
    """Tolerance: 2 K u max(|a| @ |w|), the worst-case float32 error of two
    summation orders."""
    rng = np.random.RandomState(m + k)
    a_book = n(_default_codebook(4))
    w_book = np.sort(rng.randn(256 if byte else 16)).astype(np.float32)
    a_idx = rng.randint(0, 16, (m, k)).astype(np.int32)
    w = rng.randint(0, 256, (k, nn if byte else nn // 2)).astype(np.uint8)
    want = n(lut_gemm_kernel_call(*map(jnp.asarray, (a_idx, w, a_book, w_book)),
                                  byte_packed=byte, interpret=True))
    got = lut_gemm(t(a_idx), t(w), t(a_book), t(w_book), byte_packed=byte).numpy()
    w_idx = w.astype(np.int64) if byte else np.stack([w & 15, w >> 4], -1).reshape(k, -1)
    tol = 2 * k * U32 * (np.abs(a_book[a_idx]) @ np.abs(w_book[w_idx])).max()
    assert got.shape == want.shape == (m, nn)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("byte", [False, True])
def test_unfused_pipeline_equals_fused_bit_for_bit(byte):
    """On exact_sum_inputs the bucketize -> index-GEMM pipeline equals the
    fused kernel bit for bit, in the port and against JAX's kernels."""
    m, k, nn = 9, 300, 40
    x, s, w, bounds, a_book, w_book = exact_sum_inputs(m, k, nn, torch.float32, byte, seed=k)
    idx = bucketize_call((x / s).contiguous(), bounds)
    got = lut_gemm(idx, w, a_book, w_book, byte_packed=byte)
    jw, jbooks = jnp.asarray(n(w)), (jnp.asarray(n(a_book)), jnp.asarray(n(w_book)))
    want = fused_lut_gemm_kernel_call(jnp.asarray(n(x)), jnp.asarray(n(s)), jw,
                                      jnp.asarray(n(bounds)), *jbooks, byte_packed=byte,
                                      interpret=True)
    np.testing.assert_array_equal(got.numpy(), n(want))
    j_idx = bucketize_kernel_call(jnp.asarray(n(x / s)), jnp.asarray(n(bounds)), interpret=True)
    np.testing.assert_array_equal(idx.numpy(), n(j_idx))
    j_unfused = lut_gemm_kernel_call(j_idx, jw, *jbooks, byte_packed=byte, interpret=True)
    np.testing.assert_array_equal(got.numpy(), n(j_unfused))


def test_ops_lut_gemm_matches_jax():
    """ops.lut_gemm (scales applied) on JAX-quantized operands."""
    from repro.core.quantize import quantize_activation as jqa
    from repro.core.quantize import quantize_weight as jqw
    from repro.kernels import ops as jops

    from repro_torch.core.quantize import QuantizedActivation, QuantizedWeight

    rng = np.random.RandomState(4)
    x = jnp.asarray(rng.randn(2, 5, 64).astype(np.float32))
    for nbits in (4, 8):
        wj = jqw(jnp.asarray(rng.randn(64, 40).astype(np.float32)), nbits=nbits)
        qaj = jqa(x, _default_codebook(4))
        want = n(jops.lut_gemm(qaj, wj))
        qw = QuantizedWeight(packed=t(n(wj.packed)), codebook=t(n(wj.codebook)),
                             scale=t(n(wj.scale)), shape=wj.shape, nbits=nbits)
        qa = QuantizedActivation(idx=t(n(qaj.idx)), scale=t(n(qaj.scale)),
                                 codebook=t(n(qaj.codebook)), nbits=4)
        got = tops.lut_gemm(qa, qw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_index_lut_gemm_wrapper_checks():
    a_idx = torch.zeros((4, 64), dtype=torch.int32)
    w, a_book, w_book = torch.zeros((64, 16), dtype=torch.uint8), torch.ones(16), torch.ones(16)
    build.reset_counts()
    assert torch.equal(lut_gemm(a_idx, w, a_book, w_book), lut_gemm_plain(a_idx, w, a_book, w_book))
    assert sum(build.LAUNCHES.values()) == 0
    for bad in [(a_idx.long(), w, a_book, w_book), (a_idx, w[:10], a_book, w_book),
                (a_idx, w, a_book.double(), w_book), (a_idx, w, a_book, torch.ones(17))]:
        with pytest.raises(ValueError):
            lut_gemm(*bad)
    with pytest.raises(ValueError, match="device"):
        lut_gemm(*(a.to("meta") for a in (a_idx, w, a_book, w_book)))


# ---------------------------------------------------------------------------
# bucketize (the Clustering Unit)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbits", [3, 4, 8])
def test_bucketize_plain_matches_pallas_exactly(nbits):
    """Any M, K (here ragged), codebooks up to A8, values on the boundaries
    and +-inf."""
    rng = np.random.RandomState(nbits)
    book = np.sort(rng.randn(2**nbits)).astype(np.float32)
    b = n(j_bounds(jnp.asarray(book)))
    x = (rng.randn(13, 70) * 2).astype(np.float32)
    x[0, : b.shape[0] if b.shape[0] < 70 else 70] = b[:70]
    x[1, :3] = [np.inf, -np.inf, 0.0]
    want = n(bucketize_kernel_call(jnp.asarray(x), jnp.asarray(b), block_m=8, block_k=64,
                                   interpret=True))
    got = bucketize_call(t(x), t(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_ops_bucketize_matches_jax():
    from repro.kernels import ops as jops

    x = (np.random.RandomState(2).randn(3, 4, 50) * 2).astype(np.float32)
    book = _default_codebook(4)
    want = n(jops.bucketize(jnp.asarray(x), book))
    got = tops.bucketize(t(x), t(n(book)))
    assert got.shape == (3, 4, 50)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        bucketize_call(t(x[0]).double(), t(n(j_bounds(book))))
    assert torch.equal(bucketize_call(t(x[0]), t(n(j_bounds(book)))),
                       bucketize_plain(t(x[0]), t(n(j_bounds(book)))))


@pytest.mark.parametrize("kernel", ["bucketize", "streaming", "streaming mul form"])
def test_nan_gets_index_zero_as_in_the_pallas_kernels(kernel):
    """A NaN passes no boundary of the compare sum: JAX's Pallas kernels give
    it index 0, and so do the port's plain versions (``searchsorted`` alone
    would rank it last)."""
    x = _rows("normal", seed=11, m=5, nn=40)
    x[0, 2], x[3, 17] = np.nan, np.nan
    b = n(j_bounds(_default_codebook(4)))
    if kernel == "bucketize":
        want = n(bucketize_kernel_call(jnp.asarray(x), jnp.asarray(b), block_m=8, block_k=64,
                                       interpret=True))
        got = bucketize_plain(t(x), t(b))
    else:
        mul = kernel.endswith("mul form")
        s = _scale(np.where(np.isnan(x), 0, x))
        want = n(streaming_quantize_outlier_kernel_call(
            jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), 2, mul_form=mul, interpret=True)[0])
        got = streaming_quantize_outlier_plain(t(x), t(s), t(b), 2, mul_form=mul)[0]
    assert want[0, 2] == want[3, 17] == 0
    np.testing.assert_array_equal(got.numpy(), want)
