"""PyTorch port vs JAX package: the dual-branch quantized linear layer.

Layers are quantized by the JAX package (``quantize_linear`` with
calibration data) and handed to the port as numpy, so both sides apply the
same codebooks, thresholds and bias. The matrix is the one of
``tests/test_lut_routing.py``: W3/W4/W8 x dynamic|static|static_dense|none
detection x float32/bf16 inputs, on both GEMM routes (``jnp`` = the plain
factorized route, ``pallas`` = the fused route, which on CPU tensors runs the
kernels' plain versions), plus gather and scatter compensation.

Tolerances: the per-token RMS scale may differ in its last ulps between XLA
and PyTorch, which moves float32 outputs by ~1e-7 relative (rtol 1e-5 below)
and can move a bf16 output across a rounding boundary, i.e. by one bf16 ulp
(rtol 2^-7 below). A last-ulp scale difference could also flip an activation
index that sits exactly on a codebook boundary; on these seeded inputs none
does, and a flip would fail these asserts rather than be absorbed by them.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core.kernel_routing as jkr  # noqa: E402
from repro.core.qlinear import QLinearConfig as JCfg  # noqa: E402
from repro.core.qlinear import qlinear_apply as j_apply  # noqa: E402
from repro.core.qlinear import quantize_linear, with_detect_route, with_kernel_route  # noqa: E402
from repro.core.quantspec import QuantSpec as JSpec  # noqa: E402
from repro.core.quantspec import _cfg_to_json  # noqa: E402

import repro_torch.core.kernel_routing as kr  # noqa: E402
from repro_torch.core.qlinear import QLinear, QLinearConfig, QLinearParams, qlinear_apply  # noqa: E402
from repro_torch.core.quantize import QuantizedWeight  # noqa: E402
from repro_torch.core.quantspec import QuantSpec, _cfg_from_json  # noqa: E402


def t(a):
    return None if a is None else torch.from_numpy(np.array(a, copy=True))


def to_port(p) -> QLinearParams:
    qw = QuantizedWeight(packed=t(p.qw.packed), codebook=t(p.qw.codebook),
                         scale=t(p.qw.scale), shape=p.qw.shape, nbits=p.qw.nbits)
    return QLinearParams(qw=qw, act_codebook=t(p.act_codebook), bias=t(p.bias),
                         thr_lo=t(p.thr_lo), thr_hi=t(p.thr_hi),
                         cfg=_cfg_from_json(_cfg_to_json(p.cfg)))


def _layer(cfg, k=128, n=48, seed=0, bias=True):
    rng = np.random.RandomState(seed)
    w = rng.randn(k, n).astype(np.float32)
    calib = (rng.randn(64, k) * 1.5).astype(np.float32)
    b = rng.randn(n).astype(np.float32) if bias else None
    return quantize_linear(jnp.asarray(w), jnp.asarray(calib), cfg,
                           bias=None if b is None else jnp.asarray(b))


def _x(seed, m, k, dtype):
    x = (np.random.RandomState(seed).randn(m, k) * 2).astype(np.float32)
    x[:, 3] *= 5  # an outlier channel
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    return xj, t(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))


def _compare(got: torch.Tensor, want, dtype):
    assert str(got.dtype) == f"torch.{dtype}"
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    scale = np.abs(w).max()
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(g, w, rtol=2.0**-7, atol=2.0**-7 * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("detection", ["none", "dynamic", "static", "static_dense"])
@pytest.mark.parametrize("w_bits", [3, 4, 8])
def test_qlinear_matches_jax_plain_route(w_bits, detection, dtype):
    cfg = JCfg(w_bits=w_bits, detection=detection, outlier_frac=0.01, kernel="jnp",
               detect_kernel="jnp")
    p = _layer(cfg, seed=w_bits * 10 + len(detection))
    xj, xt = _x(7, 5, 128, dtype)
    _compare(qlinear_apply(to_port(p), xt), j_apply(p, xj), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("detection", ["none", "dynamic", "static", "static_dense"])
@pytest.mark.parametrize("w_bits", [4, 8])
def test_qlinear_fused_route_matches_jax_pallas(w_bits, detection, dtype):
    """The fused route (fused GEMM + detection-only top-k + residuals from
    the outlier values) against JAX's Pallas route in interpret mode."""
    cfg = JCfg(w_bits=w_bits, detection=detection, outlier_frac=0.01, kernel="pallas",
               detect_kernel="pallas")
    p = _layer(cfg, k=96, n=32, seed=w_bits + len(detection))
    xj, xt = _x(8, 4, 96, dtype)
    kr.reset()
    got = qlinear_apply(to_port(p), xt)
    assert kr.kernel_calls() == 1
    _compare(got, j_apply(p, xj), dtype)


@pytest.mark.parametrize("comp_mode", ["gather", "scatter"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_qlinear_compensation_routes(comp_mode, dtype):
    cfg = JCfg(detection="dynamic", outlier_frac=0.02, comp_mode=comp_mode,
               kernel="jnp", detect_kernel="jnp")
    p = _layer(cfg, seed=11)
    xj, xt = _x(9, 6, 128, dtype)
    kr.reset()
    _compare(qlinear_apply(to_port(p), xt.reshape(2, 3, 128)),
             j_apply(p, xj.reshape(2, 3, 128)), dtype)
    assert kr.comp_route_counts() == {comp_mode: 1}


def test_comp_mode_auto_switches_at_64_tokens():
    p = to_port(_layer(JCfg(detection="dynamic", kernel="jnp", detect_kernel="jnp")))
    kr.reset()
    for m in (64, 65):
        qlinear_apply(p, torch.randn(m, 128))
    assert kr.comp_route_counts() == {"gather": 1, "scatter": 1}


def test_a_bits_above_4_fallback_is_explicit():
    """a_bits > 4 on a requested kernel route: warned once, counted, and the
    result equals the plain route's."""
    cfg = JCfg(a_bits=5, detection="dynamic", kernel="pallas")
    p = to_port(_layer(cfg, seed=9))
    x = torch.randn(4, 128)
    kr.reset()
    kr._WARNED.clear()
    with pytest.warns(RuntimeWarning, match="falling back"):
        y = qlinear_apply(p, x)
    assert kr.fallback_count() == 1
    import dataclasses

    p_plain = dataclasses.replace(p, cfg=dataclasses.replace(p.cfg, kernel="jnp"))
    assert torch.equal(y, qlinear_apply(p_plain, x))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        qlinear_apply(p, x)
    assert kr.fallback_count() == 2


def test_static_detection_with_pallas_detect_route_is_counted_fallback():
    cfg = JCfg(detection="static", detect_kernel="pallas", kernel="jnp")
    p = to_port(_layer(cfg, seed=4))
    kr.reset()
    kr._WARNED.clear()
    with pytest.warns(RuntimeWarning, match="Orizuru"):
        qlinear_apply(p, torch.randn(3, 128))
    assert kr.detect_fallback_count() == 1


def _counts(routing) -> tuple:
    """Every routing counter of a package (the JAX or the port's module)."""
    return (dict(routing._DISPATCH), dict(routing._FALLBACKS), dict(routing._DETECT_DISPATCH),
            dict(routing._DETECT_FALLBACKS), dict(routing._COMP_ROUTES))


def _apply_both(p, xj, xt):
    """(port output, JAX output), each package's counters reset first and
    compared after; the demotions' one-time warnings are muted."""
    jkr.reset()
    kr.reset()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got, want = qlinear_apply(to_port(p), xt), j_apply(p, xj)
    assert _counts(kr) == _counts(jkr)
    return got, want


@pytest.mark.parametrize("overrides", [
    dict(a_bits=5, detection="dynamic", kernel="pallas"),
    dict(detection="static", detect_kernel="pallas", kernel="jnp"),
    dict(detection="static_dense", kernel="pallas", detect_kernel="pallas"),
])
def test_unported_kernel_paths_raise_off_the_cpu(overrides):
    """Named for when the port refused these paths off the CPU. They have no
    kernel in either package (a_bits > 4 on the fused route, kernel
    detection under static thresholds), and the port now demotes them as JAX
    does, on every device: no ``NotImplementedError``, the same dispatch,
    fallback and compensation counts as JAX, and JAX's output. The card half
    is ``tests/test_torch_gpu.py::test_qlinear_demotions_run_on_the_card``."""
    p = _layer(JCfg(**overrides), seed=4)
    xj, xt = _x(4, 3, 128, "float32")
    got, want = _apply_both(p, xj, xt)
    assert kr.fallback_count() + kr.detect_fallback_count() == 1
    _compare(got, want, "float32")


@pytest.mark.parametrize("detect_kernel", ["pallas", "jnp", "auto"])
@pytest.mark.parametrize("kernel,use_kernel", [("pallas", False), ("auto", True),
                                               ("auto", False), ("jnp", False)])
@pytest.mark.parametrize("a_bits", [5, 8])
def test_a5_a8_routes_count_and_compute_like_jax(a_bits, kernel, use_kernel, detect_kernel):
    """A5-A8 activation codebooks on every GEMM and detection route: the
    kernel routes (``pallas``, and ``auto`` where it resolves to the kernel)
    demote to the plain GEMM, counted as one fallback per call, and
    detection keeps its route (the detection-only top-k, not the streaming
    kernel, which stops at A4); every counter and the output equal JAX's."""
    cfg = JCfg(a_bits=a_bits, detection="dynamic", outlier_frac=0.01, kernel=kernel,
               use_kernel=use_kernel, detect_kernel=detect_kernel)
    p = _layer(cfg, seed=a_bits + 3)
    xj, xt = _x(a_bits, 5, 128, "float32")
    got, want = _apply_both(p, xj, xt)
    assert kr.fallback_count() == (kernel == "pallas" or use_kernel)
    assert kr.kernel_calls() == 0
    _compare(got, want, "float32")


@pytest.mark.parametrize("detection", ["static", "static_dense"])
@pytest.mark.parametrize("detect_kernel", ["pallas", "auto", "jnp"])
def test_static_detection_routes_count_like_jax(detection, detect_kernel):
    """Static thresholds have no top-k to run: ``detect_kernel="pallas"`` is a
    counted detection fallback, ``auto`` and ``jnp`` plain code, as in JAX."""
    cfg = JCfg(detection=detection, detect_kernel=detect_kernel, kernel="jnp",
               outlier_frac=0.01)
    p = _layer(cfg, seed=len(detection))
    xj, xt = _x(6, 4, 128, "float32")
    got, want = _apply_both(p, xj, xt)
    assert kr.detect_fallback_count() == (detect_kernel == "pallas")
    _compare(got, want, "float32")


def test_auto_routes_follow_the_tensor_device():
    assert kr.resolve_route("auto", device="cpu") == "jnp"
    assert kr.resolve_route("auto", device="cuda") == "pallas"
    assert kr.resolve_route("auto", use_kernel=True, device="cpu") == "pallas"
    assert kr.resolve_route("jnp", device="cuda") == "jnp"
    assert kr.resolve_detect_route("auto", device="cuda") == "pallas"
    with pytest.raises(ValueError):
        kr.resolve_route("cuda")


def test_config_validation_matches_jax():
    with pytest.raises(ValueError, match="kernel"):
        QLinearConfig(kernel="triton")
    with pytest.raises(ValueError, match="w_bits"):
        QLinearConfig(w_bits=9)
    with pytest.raises(ValueError, match="A3"):
        QLinearConfig(a_bits=3, detection="none").validate()
    QLinearConfig(a_bits=3, detection="dynamic").validate()


def test_quantspec_json_from_jax_and_resolution():
    js = JSpec(base=JCfg(detection="dynamic", outlier_frac=0.005),
               rules=[("mlp/wd", {"w_bits": 8}), ("attn/wo", "skip"),
                      ("mlp/*", {"compute_dtype": jnp.bfloat16})],
               kv_bits=4, kv_dtype="float32")
    spec = QuantSpec.from_json_dict(js.to_json_dict())
    assert spec.to_json_dict() == js.to_json_dict()
    for path in ("blocks/attn/wq", "blocks/attn/wo", "blocks/mlp/wd", "blocks/3/mlp/wi"):
        want = js.resolve(path)
        got = spec.resolve(path)
        assert (got is None) == (want is None)
        if want is not None:
            assert _cfg_to_json(want) == {k: (str(v).removeprefix("torch.")
                                              if k == "compute_dtype" else v)
                                          for k, v in got.__dict__.items()}


def test_qlinear_module_moves_and_applies():
    p = to_port(_layer(JCfg(detection="dynamic", kernel="jnp", detect_kernel="jnp")))
    mod = QLinear(p)
    x = torch.randn(2, 128)
    assert torch.equal(mod(x), qlinear_apply(p, x))
    assert {n for n, _ in mod.named_buffers()} >= {"packed", "codebook", "scale",
                                                    "act_codebook", "bias"}
    assert mod.to("cpu").packed.device.type == "cpu"


def _np_order_key(x: np.ndarray) -> np.ndarray:
    """The Orizuru order key in numpy: sign-flipped bits, -0 onto +0, every NaN last."""
    bits = x.astype(np.float32).view(np.uint32).astype(np.int64)
    bits[bits == 0x80000000] = 0
    key = np.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF, bits | 0x80000000)
    return np.where(np.isnan(x), 0xFFFFFFFF, key)


@pytest.mark.parametrize("k", [1, 3, 8, 40])
def test_plain_detection_sorts_on_the_order_key(k):
    """``stable_topk`` and the plain dual top-k equal a stable sort of the
    order key (descending for hi), values read back from x: +-0 tie to the
    lowest channel, NaN of either sign above +inf on the hi side and last on
    the lo side. On the CPU ``torch.sort`` of the values gives the same
    order; CUDA's orders NaN by their bits, which the key makes moot (the
    card half: ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` phase 3)."""
    from repro_torch.core.outlier import stable_topk
    from repro_torch.kernels.topk_outlier import topk_outlier_plain

    rng = np.random.RandomState(k)
    neg_nan = np.array([0xFFC00001], np.uint32).view(np.float32)[0]
    x = (rng.randint(-3, 4, (6, 40)) * 0.5).astype(np.float32)
    for r in range(6):
        for v in (np.nan, neg_nan, -0.0, 0.0, np.inf, -np.inf):
            x[r, rng.randint(0, 40, rng.randint(0, 5))] = v
    x[0] = -0.0
    x[1] = neg_nan
    key = _np_order_key(x)
    hi = np.argsort(-key, axis=-1, kind="stable")[:, :k]
    lo = np.argsort(key, axis=-1, kind="stable")[:, :k]
    xt = torch.from_numpy(x)
    hv, hi_t = stable_topk(xt, k, largest=True)
    lv, lo_t = stable_topk(xt, k, largest=False)
    got = topk_outlier_plain(xt, k)
    for vals, idx, want in ((hv, hi_t, hi), (lv, lo_t, lo), (got[0], got[1], hi),
                            (got[2], got[3], lo)):
        assert np.array_equal(idx.numpy(), want)
        # the values are x's own bits, a -0.0 stays -0.0 and a NaN keeps its sign
        assert np.array_equal(vals.numpy().view(np.uint32),
                              np.take_along_axis(x, want, -1).view(np.uint32))
    assert np.array_equal(torch.sort(xt, dim=-1, descending=True, stable=True).indices[:, :k]
                          .numpy(), hi)
