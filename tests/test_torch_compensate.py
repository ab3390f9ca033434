"""The sparse outlier compensation's plain version against the dense routes.

``kernels.ops.outlier_compensate`` (on CPU tensors the plain version of
``csrc/outlier_compensate.cu``) recomputes the residuals from the outlier
values and adds ``r @ W~[channels, :]`` into y; the dense routes take
``outlier_residuals_direct``'s residuals through ``compensate_gather``
(gathered weight rows) or ``compensate_scatter`` (a dense residual matrix
and the whole dequantized weight). The residuals are the same bits; only the
order of the float32 sums differs (the channel scale once after the sum,
not inside each product): rtol 1e-5 of the largest output, as
``test_torch_core.py::test_compensation_close``. The kernel itself is held
against the plain version on the card (``tests/test_torch_gpu.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them

import repro_torch.core.outlier as ol  # noqa: E402
import repro_torch.core.quantize as qz  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.outlier_compensate import (outlier_compensate_call,  # noqa: E402
                                                    random_inputs)
from repro_torch.models.model import _default_codebook  # noqa: E402

K, N, M = 128, 48, 9


def _layer(w_bits: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((K, N), generator=g)
    return qz.quantize_weight(w, nbits=w_bits, iters=5), g


def _x(g, dtype, m=M):
    x = torch.randn((m, K), generator=g) * 2
    x[:, 3] *= 5  # an outlier channel
    x[:, 100] *= 4
    return x.to(getattr(torch, dtype))


def _dense(route, outs, scale, book, qw, mul_form):
    r = ol.outlier_residuals_direct(outs, scale, book, mul_form=mul_form)
    fn = ol.compensate_gather if route == "gather" else ol.compensate_scatter
    return fn(r, outs, qw)


def _check(outs, scale, book, qw, mul_form, route):
    want = _dense(route, outs, scale, book, qw, mul_form)
    y = torch.zeros_like(want)
    got = ops.outlier_compensate(y, outs, scale, book, qw, mul_form=mul_form)
    assert got is y  # in place
    top = want.abs().max().item()
    assert top > 0
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5 * top)


@pytest.mark.parametrize("route", ["gather", "scatter"])
@pytest.mark.parametrize("detection", ["dynamic", "static"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w_bits", [3, 4, 8])
def test_plain_compensation_matches_the_dense_routes(w_bits, dtype, detection, route):
    """W3 / W4 nibble and W8 byte weights, float32 inputs (the ``v / s``
    bucket) and bfloat16 (the ``v >= s b`` bucket), dynamic detection and
    static detection, whose slots past the threshold violations are masked."""
    qw, g = _layer(w_bits, seed=w_bits * 10 + len(dtype) + len(detection))
    x = _x(g, dtype)
    book = _default_codebook(4)
    scale = qz.token_scale(x)
    k = ol.num_outliers(K, 0.03)
    if detection == "dynamic":
        outs = ol.detect_outliers_topk(x.float(), k)
    else:
        outs = ol.detect_outliers_static(x.float(), torch.tensor(-6.0), torch.tensor(6.0), k)
        assert 0 < outs.mask.sum() < outs.mask.numel()  # some slots masked, some not
    _check(outs, scale, book, qw, dtype == "bfloat16", route)


@pytest.mark.parametrize("route", ["gather", "scatter"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w_bits", [3, 4, 8])
def test_a_channel_in_both_sets_adds_twice(w_bits, dtype, route):
    """Rows of equal values put the same lowest channels in the top and the
    bottom set (ties go to the lowest channel): each slot adds its own
    residual, as the gather and the accumulating scatter do."""
    qw, g = _layer(w_bits, seed=w_bits + 40)
    x = _x(g, dtype)
    x[::2] = torch.tensor(0.75, dtype=x.dtype)
    k = ol.num_outliers(K, 0.03)
    outs = ol.detect_outliers_topk(x.float(), k)
    assert torch.equal(outs.channels[0, :k], outs.channels[0, k:])
    _check(outs, qz.token_scale(x), _default_codebook(4), qw, dtype == "bfloat16", route)


@pytest.mark.parametrize("route", ["gather", "scatter"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w_bits", [3, 4, 8])
def test_row_window_clamped_channels_add_nothing(w_bits, dtype, route):
    """A row-parallel window of the input channels, as ``qlinear_apply``
    with ``k0`` builds it: the whole row's outliers, those outside the
    window masked and their channels clamped into it, the weight's rows of
    the window; then the windows' compensations add up to the whole layer's."""
    qw, g = _layer(w_bits, seed=w_bits + 70)
    x = _x(g, dtype)
    book = _default_codebook(4)
    scale = qz.token_scale(x)
    whole = ol.detect_outliers_topk(x.float(), ol.num_outliers(K, 0.05))
    per_byte = 1 if w_bits > 4 else 2
    total = torch.zeros((M, N))
    for k0 in range(0, K, 32):
        k1 = k0 + 32
        here = ((whole.channels >= k0) & (whole.channels < k1)).float()
        outs = ol.OutlierSet(values=whole.values, mask=whole.mask * here,
                             channels=torch.clamp(whole.channels - k0, 0, k1 - k0 - 1))
        rows = qz.QuantizedWeight(packed=qw.packed[k0:k1], codebook=qw.codebook,
                                  scale=qw.scale, shape=(32, N), nbits=qw.nbits)
        assert rows.packed.shape[1] * per_byte == N
        _check(outs, scale, book, rows, dtype == "bfloat16", route)
        total += ops.outlier_compensate(torch.zeros((M, N)), outs, scale, book, rows,
                                        mul_form=dtype == "bfloat16")
    want = ops.outlier_compensate(torch.zeros((M, N)), whole, scale, book, qw,
                                  mul_form=dtype == "bfloat16")
    np.testing.assert_allclose(total.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * want.abs().max().item())


@pytest.mark.parametrize("byte_packed", [False, True])
def test_cpu_call_runs_the_plain_version_in_place(byte_packed):
    """On CPU tensors the wrapper runs the plain version: y updated in place,
    no launch and no plain-on-CUDA count; leading batch axes are flattened."""
    g = torch.Generator().manual_seed(3)
    args = random_inputs(6, 64, 32, 8, byte_packed=byte_packed, mul_form=False, gen=g)
    y0 = args["y"].clone()
    before = (dict(build.LAUNCHES), dict(build.PLAIN_ON_CUDA))
    out = outlier_compensate_call(**args)
    assert out is args["y"] and not torch.equal(out, y0)
    assert (dict(build.LAUNCHES), dict(build.PLAIN_ON_CUDA)) == before
    qw = qz.QuantizedWeight(packed=args["w_packed"], codebook=args["w_book"],
                            scale=args["w_scale"], shape=(64, 32), nbits=8 if byte_packed else 4)
    outs = ol.OutlierSet(values=args["values"], channels=args["channels"], mask=args["mask"])
    y3 = y0.clone().reshape(2, 3, 32)
    lead = ol.OutlierSet(**{f: getattr(outs, f).reshape(2, 3, 8)
                            for f in ("values", "channels", "mask")})
    got = ops.outlier_compensate(y3, lead, args["scale"].reshape(2, 3, 1), args["a_book"], qw)
    assert got is y3 and torch.equal(got.reshape(6, 32), out)


@pytest.mark.parametrize("change,match", [
    (dict(y=torch.zeros((6, 32), dtype=torch.bfloat16)), "y must be float32"),
    (dict(channels=torch.zeros((6, 8), dtype=torch.int64)), "channels must be int32"),
    (dict(mask=torch.ones((6, 7))), "mask must be"),
    (dict(scale=torch.ones((6,))), "scale must be"),
    (dict(w_packed=torch.zeros((64, 32), dtype=torch.uint8)), "w_packed must be"),
    (dict(w_book=torch.zeros(17)), "weight codebook"),
])
def test_call_refuses_what_the_kernel_does_not_take(change, match):
    args = random_inputs(6, 64, 32, 8, byte_packed=False, mul_form=True,
                         gen=torch.Generator().manual_seed(4))
    args.update(change)
    with pytest.raises(ValueError, match=match):
        outlier_compensate_call(**args)
