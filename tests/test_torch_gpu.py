"""The PyTorch port's CUDA kernels against their plain versions, on a card.

Run on a machine with an NVIDIA card (the kernels build with ``nvcc`` on
first use): ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
Without a card every test here skips. Indices and channels must match
exactly; float32 outputs within the summation-order bounds stated below,
and bit for bit on inputs where every summation order is exact.
"""

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu

U32 = 2.0**-24


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n,byte,bf16", [
    (72, 2048, 512, False, True),
    (72, 2048, 2048, False, False),
    (72, 1024, 256, True, True),
    (5, 1000, 100, False, False),
    (3, 1100, 40, True, False),
    (200, 2048, 1024, False, True),  # more token rows than one row tile
    (200, 1000, 300, True, False),
])
def test_fused_lut_gemm_kernel_vs_plain(dev, m, k, n, byte, bf16):
    from repro_torch.core.codebook import boundaries_from_centroids
    from repro_torch.kernels import build
    from repro_torch.kernels.lut_gemm import (exact_sum_inputs, fused_lut_gemm,
                                              fused_lut_gemm_plain)
    from repro_torch.models.model import _default_codebook

    g = torch.Generator(device=dev).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=g, device=dev) * 1.5
    x = x.to(torch.bfloat16) if bf16 else x
    s = x.float().square().mean(-1, keepdim=True).sqrt()
    a_book = _default_codebook(4, device=dev)
    bounds = boundaries_from_centroids(a_book).contiguous()
    w_book = torch.sort(torch.randn(256 if byte else 16, generator=g, device=dev)).values
    w = torch.randint(0, 256, (k, n if byte else n // 2), generator=g, device=dev,
                      dtype=torch.uint8)
    kw = dict(byte_packed=byte, mul_form=bf16)
    launches = build.LAUNCHES["fused_lut_gemm"]
    y = fused_lut_gemm(x, s, w, bounds, a_book, w_book, **kw)
    ref = fused_lut_gemm_plain(x, s, w, bounds, a_book, w_book, **kw)
    torch.cuda.synchronize()
    assert build.LAUNCHES["fused_lut_gemm"] == launches + 1
    # the split-K sums its partials in a fixed order: the same bits every launch
    assert torch.equal(fused_lut_gemm(x, s, w, bounds, a_book, w_book, **kw), y)
    # rounding errors of two summation orders grow like sqrt(K) u (|a| @ |w|);
    # one activation index on another centroid moves a row by far more
    step = a_book.diff().min().item() * w_book.abs().max().item()
    bound = 2 * k**0.5 * U32 * (a_book.abs().max() * w_book.abs().max() * k).item()
    assert bound < step
    assert (y - ref).abs().max().item() <= bound
    # exact sums: the kernel must equal the plain version bit for bit
    args = [a.to(dev) for a in exact_sum_inputs(m, k, n, x.dtype, byte, seed=k)]
    assert torch.equal(fused_lut_gemm(*args, **kw), fused_lut_gemm_plain(*args, **kw))


@pytest.mark.parametrize("byte", [False, True])
@pytest.mark.parametrize("blocks", [(80, 128, 512), (72, 256, 256), (80, 256, 64),
                                    (8, 128, 8192)])
def test_lut_gemm_tiles_equal_on_exact_sums(dev, blocks, byte):
    """Every tile the kernels instantiate, with and without split-K: on exact
    sums the fused kernel, bucketize + the index kernel and the plain version
    agree bit for bit."""
    from repro_torch.kernels.bucketize import bucketize_call
    from repro_torch.kernels.lut_gemm import exact_sum_inputs, fused_lut_gemm, lut_gemm

    m, k, n = 150, 2000, 768
    x, s, w, bounds, ab, wb = [t.to(dev) for t in exact_sum_inputs(m, k, n, torch.float32,
                                                                   byte, seed=7)]
    want = fused_lut_gemm(x.cpu(), s.cpu(), w.cpu(), bounds.cpu(), ab.cpu(), wb.cpu(),
                          byte_packed=byte)
    got = fused_lut_gemm(x, s, w, bounds, ab, wb, byte_packed=byte, blocks=blocks)
    assert torch.equal(got.cpu(), want)
    idx = bucketize_call((x / s).contiguous(), bounds)
    assert torch.equal(lut_gemm(idx, w, ab, wb, byte_packed=byte, blocks=blocks), got)


def _special_rows(m, n, k, seed, dev):
    """Half-integer rows (runs of equal values across the k-th place on both
    sides) with, per row, up to k + 1 NaN of each sign bit, up to 3k -0.0 and
    up to k of each infinity at random channels; row 0 is all -0.0, row 1
    all NaN with the sign bit set."""
    import numpy as np

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


def _same(got, want):
    """torch.equal on integers; float32 bit for bit, every NaN equal to every NaN."""
    if got.dtype != torch.float32:
        return torch.equal(got, want)
    nan = got.isnan()
    return torch.equal(nan, want.isnan()) and torch.equal(got.view(torch.int32)[~nan],
                                                          want.view(torch.int32)[~nan])


@pytest.mark.parametrize("m,n,k,kind", [
    (72, 2048, 10, "normal"), (72, 8192, 41, "normal"), (72, 2047, 10, "normal"),
    (16, 2048, 10, "duplicates"), (4, 512, 7, "equal"), (3, 11008, 55, "normal"),
    (72, 2048, 10, "specials"), (72, 8192, 41, "specials"), (8, 2047, 10, "specials"),
    (3, 11008, 55, "specials"), (4, 512, 512, "duplicates"), (4, 512, 512, "specials"),
    (2, 2048, 2048, "normal"),
])
def test_topk_kernel_vs_plain_exact(dev, m, n, k, kind):
    """Channels exact, values bit for bit (NaN equal to NaN), against the
    plain version on the CPU and on the card (both sort on the kernels'
    order key, so every NaN ranks alike on both devices); two launches
    bit-equal."""
    from repro_torch.kernels.topk_outlier import topk_outlier_call, topk_outlier_plain

    g = torch.Generator(device=dev).manual_seed(n + k)
    if kind == "normal":
        x = torch.randn((m, n), generator=g, device=dev)
    elif kind == "duplicates":
        x = torch.randint(-3, 4, (m, n), generator=g, device=dev).float()
    elif kind == "equal":
        x = torch.full((m, n), 0.5, device=dev)
    else:
        x = _special_rows(m, n, k, n + k, dev)
    got = topk_outlier_call(x, k)
    again = topk_outlier_call(x, k)
    for a, b, c, d in zip(got, topk_outlier_plain(x, k), topk_outlier_plain(x.cpu(), k), again):
        assert _same(a.cpu(), c) and _same(a, d)
        assert _same(a, b)


@pytest.mark.parametrize("b,s,softcap,window", [(72, 1, 0.0, 0), (9, 4, 20.0, 40)])
def test_paged_attn_kernel_vs_plain(dev, b, s, softcap, window):
    from repro_torch.kernels.paged_attn import paged_attn_int4, paged_attn_quant_plain
    from repro_torch.models.model import _default_codebook

    kv, grp, hd, bs, max_blk, nb = 8, 4, 64, 16, 16, 128
    g = torch.Generator(device=dev).manual_seed(b + s)
    u8 = dict(generator=g, device=dev, dtype=torch.uint8)
    ki = torch.randint(0, 256, (nb, bs, kv, hd // 2), **u8)
    vi = torch.randint(0, 256, (nb, bs, kv, hd // 2), **u8)
    ks = torch.rand((nb, bs, kv, 1), generator=g, device=dev) + 0.5
    vs = torch.rand((nb, bs, kv, 1), generator=g, device=dev) + 0.5
    q = torch.randn((b, s, kv, grp, hd), generator=g, device=dev)
    ctx = torch.randint(1, max_blk * bs + 1, (b,), generator=g, device=dev)
    ctx[-1] = 0
    tables = torch.randint(0, nb, (b, max_blk), generator=g, device=dev)
    ar = torch.arange(max_blk, device=dev)
    tables[ar[None, :] >= ((ctx + bs - 1) // bs)[:, None]] = -1
    qpos = (ctx[:, None] - s + torch.arange(s, device=dev)[None, :]).clamp(min=-1)
    qpos[ctx == 0] = -1
    args = (q, ki, ks, vi, vs, _default_codebook(4, device=dev), tables.int(), ctx.int(),
            qpos.int().contiguous())
    out = paged_attn_int4(*args, softcap=softcap, window=window)
    ref = paged_attn_quant_plain(*args, softcap=softcap, window=window)
    torch.cuda.synchronize()
    live = qpos >= 0
    vmax = (args[5].abs().max() * vs.max()).item()
    # convex combinations of values summed in two orders: 4 n u max|v|
    assert (out - ref).abs()[live].max().item() <= 4 * max_blk * bs * U32 * vmax
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("page_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,s,softcap,window", [(72, 1, 0.0, 0), (9, 4, 20.0, 40)])
def test_paged_attn_float_kernel_vs_plain(dev, b, s, softcap, window, page_dtype):
    from repro_torch.kernels.paged_attn import paged_attn_bf16, paged_attn_plain

    kv, grp, hd, bs, max_blk, nb = 8, 4, 64, 16, 16, 128
    g = torch.Generator(device=dev).manual_seed(b + s)
    dt = getattr(torch, page_dtype)
    pk = torch.randn((nb, bs, kv, hd), generator=g, device=dev).to(dt)
    pv = torch.randn((nb, bs, kv, hd), generator=g, device=dev).to(dt)
    q = torch.randn((b, s, kv, grp, hd), generator=g, device=dev)
    ctx = torch.randint(1, max_blk * bs + 1, (b,), generator=g, device=dev)
    ctx[-1] = 0
    tables = torch.randint(0, nb, (b, max_blk), generator=g, device=dev)
    ar = torch.arange(max_blk, device=dev)
    tables[ar[None, :] >= ((ctx + bs - 1) // bs)[:, None]] = -1
    qpos = (ctx[:, None] - s + torch.arange(s, device=dev)[None, :]).clamp(min=-1)
    qpos[ctx == 0] = -1
    args = (q, pk, pv, tables.int(), ctx.int(), qpos.int().contiguous())
    out = paged_attn_bf16(*args, softcap=softcap, window=window)
    ref = paged_attn_plain(*args, softcap=softcap, window=window)
    torch.cuda.synchronize()
    live = qpos >= 0
    vmax = pv.float().abs().max().item()
    # convex combinations of values summed in two orders: 4 n u max|v|
    assert (out - ref).abs()[live].max().item() <= 4 * max_blk * bs * U32 * vmax
    assert torch.isfinite(out).all()


def _rows(kind, m, n, k, g, dev):
    if kind == "normal":
        return torch.randn((m, n), generator=g, device=dev) * 2
    if kind == "duplicates":
        return torch.randint(-3, 4, (m, n), generator=g, device=dev).float()
    if kind == "specials":
        return _special_rows(m, n, k, n + k, dev)
    x = torch.full((m, n), 0.5, device=dev)  # all-equal rows, one with +-inf
    x[0, 3], x[0, 7] = float("inf"), float("-inf")
    return x


@pytest.mark.parametrize("mul_form", [False, True])
@pytest.mark.parametrize("m,n,k,kind", [
    (72, 2048, 10, "normal"), (72, 8192, 41, "normal"), (72, 2047, 10, "normal"),
    (16, 2048, 10, "duplicates"), (4, 512, 7, "equal"), (3, 11008, 55, "normal"),
    (72, 2048, 10, "specials"), (72, 8192, 41, "specials"), (8, 2047, 10, "specials"),
    (4, 512, 512, "duplicates"), (4, 512, 512, "specials"),
])
def test_streaming_kernel_vs_plain_exact(dev, m, n, k, kind, mul_form):
    """Indices and channels exact, values bit for bit (NaN equal to NaN),
    against the plain version on the CPU and on the card (see the top-k
    test); two launches bit-equal; one launch per call."""
    from repro_torch.core.codebook import boundaries_from_centroids
    from repro_torch.kernels import build
    from repro_torch.kernels.topk_outlier import (streaming_quantize_outlier_call,
                                                  streaming_quantize_outlier_plain)
    from repro_torch.models.model import _default_codebook

    g = torch.Generator(device=dev).manual_seed(n + k)
    x = _rows(kind, m, n, k, g, dev)
    if mul_form:  # the mul form serves bfloat16 activations
        x = x.to(torch.bfloat16).float()
    s = x.square().mean(-1, keepdim=True).sqrt().clamp(min=1e-12)
    s = torch.where(torch.isfinite(s), s, torch.ones_like(s))
    bounds = boundaries_from_centroids(_default_codebook(4, device=dev)).contiguous()
    launches = build.LAUNCHES["streaming_quantize_outlier"]
    got = streaming_quantize_outlier_call(x, s, bounds, k, mul_form=mul_form)
    torch.cuda.synchronize()
    assert build.LAUNCHES["streaming_quantize_outlier"] == launches + 1
    again = streaming_quantize_outlier_call(x, s, bounds, k, mul_form=mul_form)
    want = streaming_quantize_outlier_plain(x, s, bounds, k, mul_form=mul_form)
    want_cpu = streaming_quantize_outlier_plain(x.cpu(), s.cpu(), bounds.cpu(), k,
                                                mul_form=mul_form)
    for a, b, c, d in zip(got, want, want_cpu, again):
        assert _same(a.cpu(), c) and _same(a, d)
        assert _same(a, b)


@pytest.mark.parametrize("m,k,n,byte", [
    (72, 2048, 512, False), (72, 8192, 2048, True), (5, 1000, 100, False), (3, 1100, 40, True),
    (200, 2048, 1024, False), (200, 1001, 264, True),
])
def test_index_lut_gemm_kernel_vs_plain(dev, m, k, n, byte):
    from repro_torch.kernels.bucketize import bucketize_call
    from repro_torch.kernels.lut_gemm import (exact_sum_inputs, fused_lut_gemm, lut_gemm,
                                              lut_gemm_plain)
    from repro_torch.models.model import _default_codebook

    g = torch.Generator(device=dev).manual_seed(m + k + n)
    a_book = _default_codebook(4, device=dev)
    w_book = torch.sort(torch.randn(256 if byte else 16, generator=g, device=dev)).values
    a_idx = torch.randint(0, 16, (m, k), generator=g, device=dev, dtype=torch.int32)
    w = torch.randint(0, 256, (k, n if byte else n // 2), generator=g, device=dev,
                      dtype=torch.uint8)
    y = lut_gemm(a_idx, w, a_book, w_book, byte_packed=byte)
    ref = lut_gemm_plain(a_idx, w, a_book, w_book, byte_packed=byte)
    torch.cuda.synchronize()
    assert torch.equal(lut_gemm(a_idx, w, a_book, w_book, byte_packed=byte), y)
    bound = 2 * k**0.5 * U32 * (a_book.abs().max() * w_book.abs().max() * k).item()
    assert (y - ref).abs().max().item() <= bound
    # exact sums: bucketize kernel -> index kernel equals the fused kernel bit for bit
    x, s, wx, bounds, ab, wb = [t.to(dev) for t in exact_sum_inputs(m, k, n, torch.float32,
                                                                     byte, seed=k)]
    idx = bucketize_call((x / s).contiguous(), bounds)
    unfused = lut_gemm(idx, wx, ab, wb, byte_packed=byte)
    assert torch.equal(unfused, lut_gemm_plain(idx, wx, ab, wb, byte_packed=byte))
    assert torch.equal(unfused, fused_lut_gemm(x, s, wx, bounds, ab, wb, byte_packed=byte))


@pytest.mark.parametrize("m,k,nb,offset", [
    (72, 2048, 15, 0), (72, 8192, 15, 0), (7, 1001, 255, 0),
    (1024, 8192, 255, 0),  # A8 at prefill rows of d_ff
    (3, 1001, 7, 0), (5, 7, 31, 0), (1, 3, 15, 0),  # numel % 4 != 0, shorter than a vector
    (72, 2047, 15, 1), (9, 333, 200, 3), (4, 1026, 16, 2),  # views off x's 16-byte alignment
    (8, 2048, 15, 21), (3, 50, 255, 30),  # off a 128-byte line by more than a vector
])
def test_bucketize_kernel_vs_plain_exact(dev, m, k, nb, offset):
    """Both bodies (compare-sum to 15 boundaries, the search tree above),
    the scalar head and tail, on boundaries (duplicates count twice), +-0,
    subnormals, +-inf and NaN; ``offset`` puts x that many values into a
    larger buffer."""
    from repro_torch.kernels import build
    from repro_torch.kernels.bucketize import bucketize_call, bucketize_plain

    g = torch.Generator(device=dev).manual_seed(m + k + nb)
    x = (torch.randn(m * k + offset, generator=g, device=dev) * 2)[offset:].view(m, k)
    bounds = torch.randn(nb, generator=g, device=dev)
    bounds[nb // 3] = 0.0  # subnormals beside a 0 boundary: compared as numbers (no -ftz)
    bounds = torch.sort(bounds).values
    bounds[nb // 2:nb // 2 + 2] = bounds[nb // 2].clone()  # a duplicate boundary (nb >= 2)
    flat = x.view(-1)
    specials = torch.tensor([float("inf"), float("-inf"), 0.0, -0.0, float("nan"), -1e-45,
                             1e-45], device=dev)
    flat[:min(7, flat.numel())] = specials[:min(7, flat.numel())]
    flat[-min(nb, flat.numel()):] = bounds[:min(nb, flat.numel())]  # on the boundaries
    launches = build.LAUNCHES["bucketize"]
    got = bucketize_call(x, bounds)
    torch.cuda.synchronize()
    assert build.LAUNCHES["bucketize"] == launches + 1
    assert got.is_contiguous() and got.data_ptr() % 128 == x.data_ptr() % 128
    assert torch.equal(got, bucketize_plain(x, bounds))
    assert torch.equal(got.cpu(), bucketize_plain(x.cpu(), bounds.cpu()))


@pytest.mark.parametrize("x_off,idx_off", [(0, 1), (1, 0), (3, 2)])
def test_bucketize_kernel_scalar_path_when_offsets_differ(dev, x_off, idx_off):
    """The entry point takes any idx: where x and idx sit at other offsets
    modulo 16 bytes every value takes the scalar path, with the same ranks."""
    from repro_torch.kernels import build
    from repro_torch.kernels.bucketize import NAME, bucketize_plain

    g = torch.Generator(device=dev).manual_seed(x_off * 4 + idx_off)
    x = (torch.randn(72 * 2047 + x_off, generator=g, device=dev) * 2)[x_off:].view(72, 2047)
    x.view(-1)[:3] = torch.tensor([float("inf"), float("nan"), -0.0], device=dev)
    for nb in (15, 255):
        bounds = torch.sort(torch.randn(nb, generator=g, device=dev)).values
        idx = torch.full((x.numel() + idx_off,), -1, dtype=torch.int32, device=dev)[idx_off:]
        build.check(build.entry(NAME, "ppipqp")(x.data_ptr(), bounds.data_ptr(), nb,
                                                 idx.data_ptr(), x.numel(),
                                                 torch.cuda.current_stream().cuda_stream), NAME)
        torch.cuda.synchronize()
        assert torch.equal(idx.view(x.shape), bucketize_plain(x, bounds))


@pytest.mark.parametrize("overrides,fallbacks,detect_fallbacks,topk", [
    (dict(a_bits=5, detection="dynamic", kernel="pallas"), 1, 0, 1),
    (dict(a_bits=8, detection="dynamic", kernel="auto"), 1, 0, 1),
    (dict(a_bits=8, detection="static", kernel="auto", detect_kernel="pallas"), 1, 1, 0),
    (dict(detection="static", kernel="jnp", detect_kernel="pallas"), 0, 1, 0),
])
def test_qlinear_demotions_run_on_the_card(dev, overrides, fallbacks, detect_fallbacks, topk):
    """A5-A8 on a kernel route (``auto`` is the kernel route on the card)
    and kernel detection under static thresholds demote to plain code on
    CUDA tensors as JAX demotes them on its accelerator: counted, no plain
    version of a kernel on a CUDA tensor, and dynamic detection still on the
    top-k kernel. The output is the CPU's up to float32 summation order and
    last-ulp scale differences, which can move an index on a boundary by one
    codebook step: within 1e-2 relative L2 (a wrong route gives order 1)."""
    import warnings

    from repro_torch.core import kernel_routing as kr
    from repro_torch.core.qlinear import QLinear, QLinearConfig, quantize_linear
    from repro_torch.kernels import build

    g = torch.Generator().manual_seed(5)
    w, calib = torch.randn(256, 96, generator=g), torch.randn(128, 256, generator=g) * 1.5
    mod = QLinear(quantize_linear(w, calib, QLinearConfig(outlier_frac=0.02, **overrides)))
    x = torch.randn(6, 256, generator=g) * 2
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # the demotions' own warnings
        want = mod(x)
        kr.reset()
        build.reset_counts()
        got = mod.to(dev)(x.to(dev))
    torch.cuda.synchronize()
    assert kr.fallback_count() == fallbacks
    assert kr.detect_fallback_count() == detect_fallbacks
    assert build.LAUNCHES["topk_outlier"] == topk
    assert build.LAUNCHES["fused_lut_gemm"] == build.LAUNCHES["streaming_quantize_outlier"] == 0
    assert not any(build.PLAIN_ON_CUDA.values())
    rel = (torch.linalg.vector_norm(got.cpu() - want) / torch.linalg.vector_norm(want)).item()
    assert rel <= 1e-2


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "float32"])
def test_float_pools_and_plain_gemm_route_serve_on_the_card(dev, kv_dtype):
    """QuantSpec() defaults (float KV pools) with every projection on the
    plain GEMM route: the streaming and float-attention kernels carry it,
    with no plain version on a CUDA tensor, and the tokens equal those of the
    same engine with plain detection (the selections are equal by contract;
    everything else is the same code)."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.qlinear import QLinearConfig, with_detect_route
    from repro_torch.core.quantspec import QuantSpec
    from repro_torch.kernels import build
    from repro_torch.models.model import build as build_model
    from repro_torch.models.model import quantize_model
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    cfg = get_smoke_config("llama3_2_1b")
    model = build_model(cfg)
    spec = QuantSpec(base=QLinearConfig(detection="dynamic", outlier_frac=0.05, kernel="jnp"),
                     kv_dtype=kv_dtype)
    qp = quantize_model(model, model.init(seed=0, device=dev), spec)
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9], list(range(20, 40))]
    sc = ServeConfig.from_spec(spec, cache_len=64, block_size=8, prefill_chunk=8)
    build.reset_counts()
    got = ServingEngine(model, qp, sc, batch_slots=2).generate(prompts, max_new_tokens=6)
    assert build.LAUNCHES["streaming_quantize_outlier"] > 0
    assert build.LAUNCHES["paged_attn_bf16"] > 0
    assert not any(build.PLAIN_ON_CUDA.values())
    plain = with_detect_route(qp, "jnp")
    want = ServingEngine(model, plain, sc, batch_slots=2).generate(prompts, max_new_tokens=6)
    assert got == want


# ---------------------------------------------------------------------------
# paged attention, the split design: contexts over many splits, windows that
# mask whole splits, ctx = 0 rows, page and split boundaries, repeat launches
# ---------------------------------------------------------------------------

def _split_attn(dev, pages, b, s, ctx, *, max_blk, hd=64, grp=4, kv=8, bs=16, seed=0,
                pad_cell=False):
    """Inputs of either kernel with the given context lengths: distinct pages
    per row (a row's table is a slice of one permutation, past its context
    -1), the segment ending at ctx, and (``pad_cell``) one padded cell."""
    g = torch.Generator(device=dev).manual_seed(seed)
    nb = b * max_blk
    ctx = torch.tensor(ctx, dtype=torch.int32, device=dev)
    tables = torch.randperm(nb, generator=g, device=dev).reshape(b, max_blk)
    ar = torch.arange(max_blk, device=dev)
    tables[ar[None, :] >= ((ctx + bs - 1) // bs)[:, None]] = -1
    qpos = (ctx[:, None] - s + torch.arange(s, device=dev)[None, :]).clamp(min=-1)
    qpos[ctx == 0] = -1
    if pad_cell:
        qpos[0, -1] = -1
    q = torch.randn((b, s, kv, grp, hd), generator=g, device=dev)
    if pages == "int4":
        u8 = dict(generator=g, device=dev, dtype=torch.uint8)
        pool = (torch.randint(0, 256, (nb, bs, kv, hd // 2), **u8),
                torch.rand((nb, bs, kv, 1), generator=g, device=dev) + 0.5,
                torch.randint(0, 256, (nb, bs, kv, hd // 2), **u8),
                torch.rand((nb, bs, kv, 1), generator=g, device=dev) + 0.5)
        from repro_torch.models.model import _default_codebook
        pool = (*pool, _default_codebook(4, device=dev))
        vmax = (pool[4].abs().max() * pool[3].max()).item()
    else:
        dt = getattr(torch, pages)
        pool = tuple(torch.randn((nb, bs, kv, hd), generator=g, device=dev).to(dt)
                     for _ in "kv")
        vmax = pool[1].float().abs().max().item()
    return (q, *pool, tables.int(), ctx, qpos.int().contiguous()), vmax


def _check_split(pages, args, vmax, *, softcap=0.0, window=0):
    """Kernel vs plain on the rows that see a key (the existing tolerance
    4 n u max|v| with n the table's keys), finite everywhere, 0 on rows that
    see none, and two launches equal bit for bit."""
    from repro_torch.kernels.paged_attn import (paged_attn_bf16, paged_attn_int4,
                                                paged_attn_plain, paged_attn_quant_plain)

    kern, plain = ((paged_attn_int4, paged_attn_quant_plain) if pages == "int4"
                   else (paged_attn_bf16, paged_attn_plain))
    kw = dict(softcap=softcap, window=window)
    out, ref = kern(*args, **kw), plain(*args, **kw)
    again = kern(*args, **kw)
    torch.cuda.synchronize()
    tables, ctx, qpos = args[-3:]
    sees = (qpos >= 0) & (qpos < ctx[:, None])  # the key at q_pos itself is valid
    n_keys = tables.shape[1] * args[1].shape[1]
    assert torch.isfinite(out).all()
    assert (out - ref).abs()[sees].max().item() <= 4 * n_keys * U32 * vmax
    assert (out[~sees] == 0).all()
    assert torch.equal(out, again)


PAGES = ["int4", "bfloat16", "float32"]


@pytest.mark.parametrize("pages", PAGES)
def test_paged_attn_multi_split_contexts(dev, pages):
    from repro_torch.kernels.paged_attn import split_plan

    assert split_plan(8, 8, 128, 16)[0] > 1
    ctx = [2048, 1, 17, 1000, 1537, 0, 2047, 640]
    args, vmax = _split_attn(dev, pages, 8, 1, ctx, max_blk=128, seed=1)
    _check_split(pages, args, vmax)


@pytest.mark.parametrize("pages", PAGES)
def test_paged_attn_segments_with_padded_cell(dev, pages):
    ctx = [700, 3, 1024, 0, 256, 513, 4, 64, 901]
    args, vmax = _split_attn(dev, pages, 9, 4, ctx, max_blk=64, seed=2, pad_cell=True)
    _check_split(pages, args, vmax, softcap=20.0)


@pytest.mark.parametrize("pages", PAGES)
def test_paged_attn_window_masks_whole_splits(dev, pages):
    from repro_torch.kernels.paged_attn import split_plan

    splits, pps = split_plan(6, 8, 128, 16)
    assert splits > 2
    keys = pps * 16
    ctx = [128 * 16, 3 * keys, 3 * keys + 1, 2 * keys - 1, 100, 0]
    args, vmax = _split_attn(dev, pages, 6, 2, ctx, max_blk=128, seed=3)
    _check_split(pages, args, vmax, window=keys // 2)


@pytest.mark.parametrize("pages", PAGES)
def test_paged_attn_page_and_split_boundaries(dev, pages):
    from repro_torch.kernels.paged_attn import split_plan

    _, pps = split_plan(12, 8, 64, 16)
    keys = pps * 16
    ctx = [16, 32, keys, keys + 1, keys - 1, 2 * keys, 64 * 16, 64 * 16 - 1, 15, 1, 0, 0]
    args, vmax = _split_attn(dev, pages, 12, 1, ctx, max_blk=64, seed=4)
    _check_split(pages, args, vmax)


@pytest.mark.parametrize("pages", PAGES)
@pytest.mark.parametrize("hd,grp,s", [(16, 2, 1), (10, 3, 2), (24, 1, 4), (128, 1, 1),
                                      (256, 2, 3)])
def test_paged_attn_head_dims(dev, pages, hd, grp, s):
    """Every head-dim class of the kernel, rows that need no 16-byte copies,
    and more query rows than one pass holds."""
    ctx = [700, 0, 47, 300]
    args, vmax = _split_attn(dev, pages, 4, s, ctx, max_blk=96, hd=hd, grp=grp, kv=2, bs=8,
                             seed=hd)
    _check_split(pages, args, vmax, softcap=10.0 if s > 1 else 0.0, window=90 if s > 2 else 0)
