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
    elif kind == "zeros":  # every other row all +0.0 (a served vlm cross block's wo input)
        x = torch.randn((m, n), generator=g, device=dev)
        x[::2] = 0.0
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


@pytest.mark.parametrize("m,k,n,byte,w_bits,mul_form,y_off", [
    (304, 2560, 2560, False, 4, True, 0),  # danube attn/wq, wo: 304-row steps, 2k = 26
    (304, 2560, 640, False, 4, True, 0),  # danube attn/wk, wv
    (304, 2560, 13824, False, 4, True, 0),  # danube mlp/wi
    (304, 6912, 2560, True, 8, True, 0),  # danube mlp/wd W8, 2k = 70
    (256, 1536, 1536, False, 4, True, 0),  # granite attn/wq, wo: 256-row steps, 2k = 16
    (256, 1536, 512, False, 4, True, 0),  # granite attn/wk, wv
    (304, 2560, 2560, False, 3, False, 0),  # W3 (the draft's 8 centroids), float32 origin
    (8, 6912, 2560, True, 8, False, 0),  # decode rows, float32 origin
    (2048, 2560, 13824, False, 4, True, 0),  # a long prefill: 16-byte chunks
    (304, 2560, 640, False, 4, True, 1),  # y 4 bytes off 16-byte alignment: scalar stores
    (7, 100, 48, False, 4, True, 0),  # rows of 24 bytes: 4-byte chunks
    (9, 64, 50, False, 4, False, 0),  # rows of 25 bytes: 1-byte chunks
    (5, 100, 30, True, 8, True, 0),  # byte rows of 30
])
def test_outlier_compensate_kernel_vs_plain(dev, m, k, n, byte, w_bits, mul_form, y_off):
    """The sparse compensation kernel at the benchmark cells' shapes (and
    the other chunk widths and stores): bit for bit its plain version on the
    card and on the CPU (each product and sum rounded alone, in the same
    order; masked slots and a channel in both sets among the inputs), the
    same bits on a second launch, and within float32 summation order of the
    dense scatter route it replaces."""
    from repro_torch.core.outlier import (OutlierSet, compensate_scatter, num_outliers,
                                          outlier_residuals_direct)
    from repro_torch.core.quantize import QuantizedWeight
    from repro_torch.kernels import build
    from repro_torch.kernels.outlier_compensate import (NAME, outlier_compensate_call,
                                                        outlier_compensate_plain, random_inputs)

    g = torch.Generator(device=dev).manual_seed(m + k + n)
    t = 2 * num_outliers(k, 0.005)
    args = random_inputs(m, k, n, t, byte_packed=byte, mul_form=mul_form, gen=g, w_bits=w_bits)
    if y_off:
        args["y"] = torch.empty(m * n + y_off, device=dev)[y_off:].view(m, n).copy_(args["y"])
    y0 = args["y"].clone()
    launches = build.LAUNCHES[NAME]
    got = outlier_compensate_call(**args).clone()
    plain = outlier_compensate_plain(**{**args, "y": y0.clone()})
    cpu = outlier_compensate_plain(**{a: (v.cpu() if isinstance(v, torch.Tensor) else v)
                                      for a, v in {**args, "y": y0.clone()}.items()})
    again = outlier_compensate_call(**{**args, "y": y0.clone()})
    torch.cuda.synchronize()
    assert build.LAUNCHES[NAME] == launches + 2
    assert torch.equal(got, plain) and torch.equal(got.cpu(), cpu) and torch.equal(again, got)
    qw = QuantizedWeight(packed=args["w_packed"], codebook=args["w_book"], scale=args["w_scale"],
                         shape=(k, n), nbits=8 if byte else w_bits)
    outs = OutlierSet(values=args["values"], channels=args["channels"], mask=args["mask"])
    r = outlier_residuals_direct(outs, args["scale"], args["a_book"], mul_form=mul_form)
    dense = compensate_scatter(r, outs, qw)
    top = dense.abs().max().item()
    assert (got - y0 - dense).abs().max().item() <= 1e-5 * top


def test_outlier_compensate_kernel_replays_in_a_graph(dev):
    """Captured in a CUDA graph, the kernel adds into the captured y on every
    replay: each replay from the same y gives the eager call's bits."""
    from repro_torch.kernels.outlier_compensate import outlier_compensate_call, random_inputs

    g = torch.Generator(device=dev).manual_seed(29)
    args = random_inputs(304, 2560, 13824, 26, byte_packed=False, mul_form=True, gen=g)
    y0 = args["y"].clone()
    eager = outlier_compensate_call(**args).clone()
    buf = y0.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        outlier_compensate_call(**{**args, "y": buf})  # warm-up on the capturing stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outlier_compensate_call(**{**args, "y": buf})
    for _ in range(2):
        buf.copy_(y0)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(buf, eager)


def test_qlinear_fused_route_compensates_through_the_kernel(dev):
    """A danube-sized projection (304 bfloat16 rows, K = N = 2560, W4A4,
    dynamic outliers) on the card: ``comp_mode="auto"`` launches the
    compensation kernel once, counts ``kernel`` and runs no plain version;
    explicit ``scatter`` and ``gather`` stay dense. The three outputs agree
    within float32 summation order (rtol 1e-5 of max |y|)."""
    import dataclasses

    from repro_torch.core import kernel_routing as kr
    from repro_torch.core.qlinear import QLinearConfig, QLinearParams, qlinear_apply
    from repro_torch.core.quantize import QuantizedWeight
    from repro_torch.kernels import build
    from repro_torch.kernels.lut_gemm import random_packed
    from repro_torch.models.model import _default_codebook

    g = torch.Generator(device=dev).manual_seed(304)
    k = n = 2560
    qw = QuantizedWeight(packed=random_packed(k, n, 16, False, g),
                         codebook=torch.sort(torch.randn(16, generator=g, device=dev)).values,
                         scale=torch.rand(n, generator=g, device=dev) * 0.02 + 0.01,
                         shape=(k, n), nbits=4)
    p = QLinearParams(qw=qw, act_codebook=_default_codebook(4, device=dev), bias=None,
                      thr_lo=None, thr_hi=None, cfg=QLinearConfig(outlier_frac=0.005))
    x = torch.randn((304, k), generator=g, device=dev) * 1.5
    x[:, ::97] *= 8.0  # outlier channels
    x = x.to(torch.bfloat16)
    ys = {}
    for mode in ("auto", "scatter", "gather"):
        kr.reset()
        build.reset_counts()
        pm = dataclasses.replace(p, cfg=dataclasses.replace(p.cfg, comp_mode=mode))
        ys[mode] = qlinear_apply(pm, x, out_dtype=torch.float32)
        torch.cuda.synchronize()
        assert kr.comp_route_counts() == {"kernel" if mode == "auto" else mode: 1}
        assert build.LAUNCHES["outlier_compensate"] == (mode == "auto")
        assert not any(build.PLAIN_ON_CUDA.values())
    top = ys["scatter"].abs().max().item()
    for mode in ("auto", "gather"):
        assert (ys[mode] - ys["scatter"]).abs().max().item() <= 1e-5 * top


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


# ---------------------------------------------------------------------------
# the packed step as one CUDA graph
# ---------------------------------------------------------------------------

def _route_model(dev, route):
    """The smoke llama3_2_1b on the card, quantized W4A4 + W8 ``mlp/wd`` with
    dynamic outliers: the fused route with an int4 pool, or path A (plain
    GEMM, streaming detection) with the default bf16 pool."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.qlinear import QLinearConfig
    from repro_torch.core.quantspec import QuantSpec
    from repro_torch.models.model import build as build_model
    from repro_torch.models.model import quantize_model
    from repro_torch.serving.engine import ServeConfig

    model = build_model(get_smoke_config("llama3_2_1b"))
    if route == "fused":
        spec = QuantSpec(base=QLinearConfig(detection="dynamic", outlier_frac=0.05),
                         rules=[("mlp/wd", {"w_bits": 8})], kv_bits=4, kv_dtype="float32")
    else:
        spec = QuantSpec(base=QLinearConfig(detection="dynamic", outlier_frac=0.05,
                                            kernel="jnp"), rules=[("mlp/wd", {"w_bits": 8})])
    qp = quantize_model(model, model.init(seed=0, device=dev), spec)
    sc = ServeConfig.from_spec(spec, cache_len=64, block_size=8, prefill_chunk=8)
    return model, qp, sc


# the first prompt's prefill fills the first four steps alone: steps that
# sample nothing, so nothing waits for the card between them
GRAPH_PROMPTS = [list(range(40, 90)), list(range(1, 20)), [7, 8, 9], list(range(30, 42)),
                 list(range(1, 17))]


def _run_steps(model, qp, sc, graph: bool, n_steps: int = 6):
    """``n_steps`` packed steps of one scheduler over ``GRAPH_PROMPTS`` with
    every count set to 0 first: each step's logits, the pools after, and
    the launch and dispatch counts."""
    from repro_torch.core import kernel_routing as kr
    from repro_torch.kernels import build
    from repro_torch.serving.scheduler import Scheduler

    sched = Scheduler(model, qp, sc, slots=3, graph=graph)
    for p in GRAPH_PROMPTS:
        sched.submit(p, 8)
    build.reset_counts()
    kr.reset()
    logits, results = [], {}
    for _ in range(n_steps):
        sched.step(results)
        logits.append(sched.last_logits.clone())
    torch.cuda.synchronize()
    counts = (dict(build.LAUNCHES), dict(build.PLAIN_ON_CUDA),
              [dict(c) for c in kr.COUNTERS])
    pools = [{k: v.clone() for k, v in layer.items()} for layer in sched.pools]
    return sched, logits, pools, counts


@pytest.mark.parametrize("route", ["fused", "path_a"])
def test_graph_step_is_bit_equal_to_the_eager_step(dev, route):
    """Graph replays against eager steps on the same inputs and fresh pools:
    every step's logits and every pool tensor bit for bit (the same kernels
    on the same inputs in the same order), and the same launch and dispatch
    counts (the graph adds one captured run's counts per replay)."""
    model, qp, sc = _route_model(dev, route)
    g_sched, g_logits, g_pools, g_counts = _run_steps(model, qp, sc, graph=True)
    _, e_logits, e_pools, e_counts = _run_steps(model, qp, sc, graph=False)
    assert g_sched.graph is not None and g_sched.graph.capture_s > 0
    assert g_sched.stats["decode_steps"] > 0 and g_sched.stats["prefill_chunks"] > 0
    for g, e in zip(g_logits, e_logits):
        assert torch.equal(g, e)
    for g, e in zip(g_pools, e_pools):
        assert g.keys() == e.keys()
        for k in g:
            assert torch.equal(g[k], e[k]), k
    assert g_counts == e_counts
    assert not any(g_counts[1].values())  # no plain version on a CUDA tensor
    kernel = "fused_lut_gemm" if route == "fused" else "streaming_quantize_outlier"
    assert g_counts[0][kernel] == 6 * model.cfg.n_layers * 6
    # the fused route compensates through the sparse kernel, path A densely
    assert g_counts[0].get("outlier_compensate", 0) == (
        6 * model.cfg.n_layers * 6 if route == "fused" else 0)


def test_graph_capture_syncs_nothing(dev):
    """The warm-up and the capture of a packed step pass under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any op that
    waits for the card."""
    from repro_torch.serving.graph_step import GraphStep, packed_idle
    from repro_torch.serving.speculative import make_packed_fn

    model, qp, sc = _route_model(dev, "fused")
    pools = model.init_caches(2, 64, sc.cache_dtype, quantized=sc.kv_quant, layout="paged",
                              block_size=8, device=dev)
    pos = torch.arange(10, dtype=torch.int32, device=dev).reshape(10, 1)
    inputs = (torch.tensor([[0, 1, -1, -1], [2, -1, -1, -1]], dtype=torch.int32, device=dev),
              torch.zeros(10, dtype=torch.int32, device=dev), pos, pos[:, 0] + 1,
              (pos * 3) % 200)
    step = GraphStep(make_packed_fn(model), qp, pools, inputs, packed_idle(inputs))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits = step(pools)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert logits.shape == (10, 1, model.cfg.vocab_size) and torch.isfinite(logits).all()


def test_graph_capture_holds_off_the_garbage_collector(dev):
    """No automatic collection runs while a step is captured: a dead graph
    in a reference cycle (an engine and its telemetry's gauge callbacks form
    one) collected there would be destroyed mid-capture, which fails the
    capture. The collector runs again after it."""
    import gc

    from repro_torch.serving.graph_step import GraphStep, packed_idle
    from repro_torch.serving.speculative import make_packed_fn

    model, qp, sc = _route_model(dev, "fused")
    packed, seen = make_packed_fn(model), []

    def step_fn(params, pools, *inputs):
        seen.append((torch.cuda.is_current_stream_capturing(), gc.isenabled()))
        return packed(params, pools, *inputs)

    pools = model.init_caches(2, 64, sc.cache_dtype, quantized=sc.kv_quant, layout="paged",
                              block_size=8, device=dev)
    pos = torch.arange(10, dtype=torch.int32, device=dev).reshape(10, 1)
    inputs = (torch.tensor([[0, 1, -1, -1], [2, -1, -1, -1]], dtype=torch.int32, device=dev),
              torch.zeros(10, dtype=torch.int32, device=dev), pos, pos[:, 0] + 1,
              (pos * 3) % 200)
    logits = GraphStep(step_fn, qp, pools, inputs, packed_idle(inputs))(pools)
    torch.cuda.synchronize()
    assert seen == [(False, True), (True, False)] and gc.isenabled()
    assert torch.isfinite(logits).all()


def test_graph_pools_keep_their_addresses(dev):
    """Three replays and a copy-on-write copy leave every pool tensor where
    the graph captured it; a pool replaced by a new tensor is refused."""
    from repro_torch.serving.graph_step import pool_ptrs
    from repro_torch.serving.paged_cache import copy_blocks

    model, qp, sc = _route_model(dev, "fused")
    sched, _, _, _ = _run_steps(model, qp, sc, graph=True, n_steps=3)
    ptrs = pool_ptrs(sched.pools)
    assert ptrs == sched.graph.ptrs
    copy_blocks(sched.pools, [1], [0])
    sched.step({})
    assert pool_ptrs(sched.pools) == ptrs
    sched.pools[0]["pages_k_idx"] = sched.pools[0]["pages_k_idx"].clone()
    with pytest.raises(RuntimeError, match="in place"):
        sched.step({})


def test_fenced_graph_step_marks_its_regions(dev):
    """Under ``fence`` the packed step is captured with a marker kernel at
    each region boundary. Logits, pools and counts equal the unfenced
    graph's bit for bit; every fenced record carries the regions in marker
    order and the host phases in order; a profiled replay runs one marker
    per region, first and last, and the LUT-GEMM, top-k and attention
    kernels fall in their regions. Unfenced records carry no marks."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving.telemetry import TelemetryConfig

    model, qp, sc = _route_model(dev, "fused")
    plain = _run_steps(model, qp, sc, graph=True)
    fenced = _run_steps(model, qp, dataclasses.replace(sc, telemetry=TelemetryConfig(fence=True)),
                        graph=True)
    for a, b in zip(plain[1], fenced[1]):
        assert torch.equal(a, b)
    for a, b in zip(plain[2], fenced[2]):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert plain[3] == fenced[3]  # the same launches and dispatches
    assert not any("region_marks" in rec for rec in plain[0].telemetry.steps)
    sched = fenced[0]
    marks = sched.graph.regions.names
    recs = list(sched.telemetry.steps)
    assert len(recs) == 6 and all(rec["region_marks"] is marks for rec in recs)
    for rec in recs:
        assert [p[0] for p in rec["phases"]] == ["admit", "plan", "pack", "replay", "sample",
                                                 "commit"]
    assert set(marks) == {"other", "qlinear.main", "qlinear.detect", "qlinear.residual",
                          "qlinear.comp_dequant", "qlinear.comp_matmul", "attn.core", "head"}
    sched.submit(list(range(3, 20)), 4)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sched.step({})
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    ops = [n for _, n in sorted((e.start_ns(), e.name())
                                for e in prof.profiler.kineto_results.events()
                                if e.device_type() == cuda and not e.is_user_annotation()
                                and e.duration_ns() > 0)]
    at = [i for i, n in enumerate(ops) if "spin_kernel" in n]
    assert len(at) == len(marks)
    assert not any("Memcpy HtoD" not in n for n in ops[:at[0]])  # only the uploads first
    regions: dict[str, set] = {}
    for k, (a, b) in enumerate(zip(at, at[1:])):
        for n in ops[a + 1:b]:
            regions.setdefault(n, set()).add(marks[k])

    def regions_of(part):
        return set().union(*(r for n, r in regions.items() if part in n))

    assert regions_of("fused_lut_gemm_kernel") == {"qlinear.main"}
    assert regions_of("topk_outlier_kernel") == {"qlinear.detect"}
    assert regions_of("outlier_compensate_kernel") == {"qlinear.comp_matmul"}
    assert regions_of("paged_attn::kernel") == {"attn.core"}


@pytest.mark.parametrize("kv_quant", [True, False])
def test_ring_decode_graph_is_bit_equal_to_eager(dev, kv_quant):
    """The fixed-slot engine's decode step as a graph replay against the eager
    step, each engine on its own ring: a left-padded batch's prefill, then
    four steps' logits and every ring tensor bit for bit; a second batch of
    the same size replays the same graph (captured once)."""
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    model, qp, _ = _route_model(dev, "fused")
    sc = ServeConfig(cache_len=64, kv_quant=kv_quant, cache_dtype="float32", paged=False)
    prompts = [list(range(40, 50)), [7, 8], list(range(1, 6))]
    got = {}
    for graph in (True, False):
        eng = ServingEngine(model, qp, sc, batch_slots=3, graph=graph)
        plen = max(len(p) for p in prompts)
        pads = [plen - len(p) for p in prompts]
        caches = eng._ring_caches(pads)
        toks = torch.tensor([[0] * n + p for n, p in zip(pads, prompts)], dtype=torch.int32,
                            device=dev)
        tok, caches, _ = eng._prefill(qp, caches, {"tokens": toks})
        logits = []
        for pos in range(plen, plen + 4):
            tok, lg = eng._decode_step(caches, tok, pos)
            logits.append(lg.clone())
            tok = tok.clone()
        torch.cuda.synchronize()
        rings = [{k: v.clone() for k, v in layer.items()} for layer in eng._ring]
        tokens = eng.generate(prompts[::-1], max_new_tokens=5)
        got[graph] = (logits, rings, tokens, eng.stats["graph_capture_s"], len(eng._decode))
    for g, e in zip(got[True][0], got[False][0]):
        assert torch.equal(g, e)
    for g, e in zip(got[True][1], got[False][1]):
        for k in g:
            assert torch.equal(g[k], e[k]), k
    assert got[True][2] == got[False][2]
    assert got[True][3] > 0 and got[False][3] is None and got[True][4] == 1


def test_draft_loop_graph_is_bit_equal_to_eager(dev):
    """Two draft rounds (catch-up steps, then the loop of k + 1 forwards) as
    graph replays against the eager runner: the drafts, the draft pools and
    the launch counts equal (each replay adds one captured run's counts)."""
    from repro_torch.kernels import build
    from repro_torch.models.model import quantize_model
    from repro_torch.serving.speculative import DEFAULT_DRAFT_SPEC, DraftRunner

    model, _, _ = _route_model(dev, "fused")
    draft = quantize_model(model, model.init(seed=0, device=dev), DEFAULT_DRAFT_SPEC)
    got = {}
    for graph in (True, False):
        runner = DraftRunner(model, draft, slots=3, cache_len=64, k=3, block_size=8,
                             kv_quant=True, token_budget=8, graph=graph)
        build.reset_counts()
        contexts = [list(range(40, 60)), [7, 8, 9], list(range(1, 12))]
        rounds = []
        for _ in range(2):
            d = runner.propose([(i, i, c, 5, 3) for i, c in enumerate(contexts)])
            rounds.append(d)
            for i, c in enumerate(contexts):
                c += [5] + d[i][:i]
                runner.sync(i, len(c))
        torch.cuda.synchronize()
        got[graph] = (rounds, [{k: v.clone() for k, v in layer.items()} for layer in runner.pools],
                      dict(build.LAUNCHES), dict(build.PLAIN_ON_CUDA), runner.capture_s)
    assert got[True][0] == got[False][0]
    for g, e in zip(got[True][1], got[False][1]):
        for k in g:
            assert torch.equal(g[k], e[k]), k
    assert got[True][2] == got[False][2] and got[True][2]["fused_lut_gemm"] > 0
    assert not any(got[True][3].values())
    assert got[True][4] > 0 and got[False][4] is None


# ---------------------------------------------------------------------------
# the kernels at the shapes of the other families (h2o-danube, nemotron,
# command-r, musicgen, qwen2-moe) and the MoE layer on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,byte", [
    (72, 2560, 2560, False),   # danube wq, wo
    (72, 2560, 640, False),    # danube wk, wv
    (72, 2560, 13824, False),  # danube wi
    (72, 6912, 2560, True),    # danube wd, W8
    (72, 24576, 6144, True),   # nemotron wd, W8
    (128, 4096, 16384, False),  # falcon-mamba in_proj (8 rows x 16 cells)
    (128, 8192, 288, False),   # falcon-mamba x_proj: N no column strip divides
    (128, 256, 8192, False),   # falcon-mamba dt_proj: the smallest K, split-K stages of 32
    (128, 8192, 4096, False),  # falcon-mamba out_proj
    (256, 2560, 256, False),   # recurrentgemma wk, wv (8 rows x 32 cells)
    (256, 2560, 15360, False),  # recurrentgemma wi
    (256, 7680, 2560, True),   # recurrentgemma wd, W8
])
def test_fused_lut_gemm_at_family_shapes(dev, m, k, n, byte):
    """bf16 activations, the mul compare form: within 2 sqrt(K) u max(|a| @
    |w|) of the plain version (the scale of two summation orders, below one
    index flip), bit for bit on exact sums and across two launches."""
    _check_family_gemm(dev, m, k, n, byte)


def _check_family_gemm(dev, m, k, n, byte, zero_rows=False):
    from repro_torch.core.codebook import boundaries_from_centroids
    from repro_torch.kernels.lut_gemm import (exact_sum_inputs, fused_lut_gemm,
                                              fused_lut_gemm_plain)
    from repro_torch.models.model import _default_codebook

    g = torch.Generator(device=dev).manual_seed(k + n)
    x = torch.randn((m, k), generator=g, device=dev) * 1.5
    if zero_rows:
        x[::2] = 0.0
    x = x.to(torch.bfloat16)
    s = x.float().square().mean(-1, keepdim=True).sqrt()
    a_book = _default_codebook(4, device=dev)
    bounds = boundaries_from_centroids(a_book).contiguous()
    w_book = torch.sort(torch.randn(256 if byte else 16, generator=g, device=dev)).values
    w = torch.randint(0, 256, (k, n if byte else n // 2), generator=g, device=dev,
                      dtype=torch.uint8)
    kw = dict(byte_packed=byte, mul_form=True)
    y = fused_lut_gemm(x, s, w, bounds, a_book, w_book, **kw)
    ref = fused_lut_gemm_plain(x, s, w, bounds, a_book, w_book, **kw)
    assert torch.equal(fused_lut_gemm(x, s, w, bounds, a_book, w_book, **kw), y)
    w_idx = w.long() if byte else torch.stack([w & 0xF, w >> 4], -1).reshape(k, n).long()
    a_idx = (x.float()[..., None] >= s[..., None] * bounds).sum(-1)  # the mul form
    mag = a_book[a_idx].abs() @ w_book[w_idx].abs()
    bound = 2 * k**0.5 * U32 * mag.max().item()
    assert (y - ref).abs().max().item() <= bound
    if k <= 11008:  # above, the bound nears one index flip: exact sums decide
        assert bound < a_book.diff().min().item() * w_book[w_idx].abs().amax(1).min().item()
    args = [a.to(dev) for a in exact_sum_inputs(m, k, n, torch.bfloat16, byte, seed=k)]
    assert torch.equal(fused_lut_gemm(*args, **kw), fused_lut_gemm_plain(*args, **kw))


@pytest.mark.parametrize("n,k", [(6912, 35), (24576, 123), (4096, 20), (8192, 41), (256, 1),
                                 (2560, 13), (7680, 38)])
@pytest.mark.parametrize("kind", ["normal", "specials"])
def test_topk_at_family_widths(dev, n, k, kind):
    """Orizuru's k = round(0.005 N) on danube's d_ff and nemotron's, and on
    the recurrent families' projection inputs (falcon-mamba's 4096, 8192
    and dt_proj's 256, where k = 1; recurrentgemma's 2560 and 7680)."""
    test_topk_kernel_vs_plain_exact(dev, 72, n, k, kind)


@pytest.mark.parametrize("pages", PAGES)
@pytest.mark.parametrize("hd,grp,kv", [(80, 4, 8), (128, 6, 8), (128, 12, 8), (64, 1, 32),
                                       (128, 1, 16), (256, 10, 1)])
def test_paged_attn_family_heads(dev, pages, hd, grp, kv):
    """danube's head_dim 80 (the 128 class with masked lanes), nemotron's and
    command-r's 128 with G = 6 and 12, musicgen's G = 1 over 32 KV heads,
    qwen2-moe's G = 1 at 128 and recurrentgemma's 256 with G = 10 over one
    KV head (three passes of 4 query rows)."""
    ctx = [1024, 1, 300, 0, 777, 16, 513, 900]
    args, vmax = _split_attn(dev, pages, 8, 1, ctx, max_blk=64, hd=hd, grp=grp, kv=kv,
                             seed=hd + grp)
    _check_split(pages, args, vmax)


@pytest.mark.parametrize("pages", PAGES)
@pytest.mark.parametrize("window,ctx,heads", [
    (4096, [4200, 4800, 4096 + 17, 4500, 4799, 4111], (80, 4, 8)),  # h2o-danube
    (2048, [2300, 2600, 2048 + 17, 2400, 2599, 2063], (256, 10, 1)),  # recurrentgemma
])
def test_paged_attn_windowed_tables_with_holes(dev, pages, window, ctx, heads):
    """Decode rows past the window (danube: 4096, head_dim 80;
    recurrentgemma: 2048, head_dim 256, G = 10) whose logical tables hold -1
    for every page wholly below the window, as the scheduler's release
    leaves them: within the tolerance of the plain version, and bit-equal
    to the same call on the full tables (the window mask hides every key of
    a hole, and the splits that cover only holes merge as empty)."""
    hd, grp, kv = heads
    args, vmax = _split_attn(dev, pages, 6, 1, ctx, max_blk=2 * window // 16, hd=hd, grp=grp,
                             kv=kv, seed=5)
    tables, ctx_t, qpos = args[-3:]
    holed = tables.clone()
    ar = torch.arange(tables.shape[1], device=dev)
    holed[ar[None, :] < ((qpos[:, :1] - window + 1) // 16)] = -1
    assert (holed < 0).sum() > (tables < 0).sum()
    with_holes = (*args[:-3], holed, ctx_t, qpos)
    _check_split(pages, with_holes, vmax, window=window)
    from repro_torch.kernels.paged_attn import paged_attn_bf16, paged_attn_int4

    kern = paged_attn_int4 if pages == "int4" else paged_attn_bf16
    assert torch.equal(kern(*with_holes, window=window), kern(*args, window=window))


def test_moe_layer_is_deterministic_and_graph_equal(dev):
    """granite-moe's layer (smoke widths, 72 rows: 24 dispatch groups) on
    the card: two launches bit-equal (each token sums its k expert outputs
    in a fixed order, no atomics), equal to a CUDA graph replay of itself,
    and within 1e-5 of the range of the CPU's result."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models import moe
    from repro_torch.models.model import build as build_model

    cfg = get_smoke_config("granite_moe_3b_a800m")
    params = build_model(cfg).init(seed=3, device=dev)
    mod = params.blocks[0].moe
    x = torch.randn((72, 1, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(4),
                    device=dev)
    with torch.inference_mode():
        out, aux = moe.moe_apply(mod, x, cfg)
        again, _ = moe.moe_apply(mod, x, cfg)
        assert torch.equal(out, again)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            moe.moe_apply(mod, x, cfg)  # warm-up off the default stream
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            g_out, g_aux = moe.moe_apply(mod, x, cfg)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(g_out, out) and torch.equal(g_aux, aux)
        cpu, _ = moe.moe_apply(mod.to("cpu"), x.cpu(), cfg)
    ref = cpu.abs().max().item()
    assert (out.cpu() - cpu).abs().max().item() <= 1e-5 * ref


def test_windowed_graph_step_is_bit_equal_to_eager(dev):
    """h2o-danube's smoke config (window 16, block 8) on the fused route:
    packed steps after the release left holes, graph replays against eager
    steps, logits and pools bit for bit."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.qlinear import QLinearConfig
    from repro_torch.core.quantspec import QuantSpec
    from repro_torch.models.model import build as build_model
    from repro_torch.models.model import quantize_model
    from repro_torch.serving.engine import ServeConfig

    model = build_model(get_smoke_config("h2o_danube_1_8b"))
    spec = QuantSpec(base=QLinearConfig(detection="dynamic", outlier_frac=0.05),
                     rules=[("mlp/wd", {"w_bits": 8})], kv_bits=4, kv_dtype="float32")
    qp = quantize_model(model, model.init(seed=0, device=dev), spec)
    sc = ServeConfig.from_spec(spec, cache_len=64, block_size=8, prefill_chunk=8)
    g_sched, g_logits, g_pools, g_counts = _run_steps(model, qp, sc, graph=True, n_steps=10)
    _, e_logits, e_pools, e_counts = _run_steps(model, qp, sc, graph=False, n_steps=10)
    assert any(b < 0 for r in g_sched._running for b in r.blocks)  # holes exist
    for g, e in zip(g_logits, e_logits):
        assert torch.equal(g, e)
    for g, e in zip(g_pools, e_pools):
        for k in g:
            assert torch.equal(g[k], e[k]), k
    assert g_counts == e_counts and not any(g_counts[1].values())


# ---------------------------------------------------------------------------
# the recurrent families (falcon-mamba, recurrentgemma) on the card
# ---------------------------------------------------------------------------

def _recurrent_model(dev, arch, seg_width=4, **sc_kw):
    """``arch``'s smoke config on the card under the fused route's spec
    (int4 state and KV), its scheduler config with ``seg_width``-cell rows."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.qlinear import QLinearConfig
    from repro_torch.core.quantspec import QuantSpec
    from repro_torch.models.model import build as build_model
    from repro_torch.models.model import quantize_model
    from repro_torch.serving.engine import ServeConfig

    model = build_model(get_smoke_config(arch))
    spec = QuantSpec(base=QLinearConfig(detection="dynamic", outlier_frac=0.05),
                     rules=[("mlp/wd", {"w_bits": 8})], kv_bits=4, kv_dtype="float32")
    params = model.init(seed=0, device=dev)
    qp = quantize_model(model, params, spec)
    sc = ServeConfig.from_spec(spec, cache_len=96, block_size=8, prefill_chunk=8,
                               seg_width=seg_width, **sc_kw)
    return model, params, qp, sc


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "recurrentgemma_2b"])
def test_recurrent_graph_step_is_bit_equal_to_eager(dev, arch):
    """Packed steps of 4-cell rows (a slot's state goes once per row):
    graph replays against eager steps on fresh pools, every step's logits
    and every pool tensor -- the recurrent state and the scratch slot's
    neighbours included -- bit for bit, and the same launch counts."""
    model, _, qp, sc = _recurrent_model(dev, arch)
    g_sched, g_logits, g_pools, g_counts = _run_steps(model, qp, sc, graph=True, n_steps=8)
    _, e_logits, e_pools, e_counts = _run_steps(model, qp, sc, graph=False, n_steps=8)
    assert g_sched.stats["decode_steps"] > 0 and g_sched.graph.capture_s > 0
    for g, e in zip(g_logits, e_logits):
        assert torch.equal(g, e)
    for g, e in zip(g_pools, e_pools):
        for k in g:
            assert torch.equal(g[k], e[k]), k
    assert g_counts == e_counts and not any(g_counts[1].values())


def _state(pools, slot):
    from repro_torch.serving.paged_cache import recurrent_state_keys

    return [{k: layer[k][slot].clone() for k in recurrent_state_keys(layer)} for layer in pools]


def test_corrective_commit_and_draft_restore_equal_replayed_state(dev):
    """``k=3`` speculation on falcon-mamba's smoke config with a W3 draft,
    the target step and the draft's steps as graphs. After every partly
    accepted verify row (m of its cells consumed), the slot's state -- the
    corrective commit copied it from the step's per-cell transients --
    equals bit for bit the state an eager replay of the same step reaches
    from the state before it with the row's other cells padded (same
    shapes, so the same kernels and sums). After every rollback of the
    draft, the slot's state -- ``restore_state_slot`` copied it from the
    snapshot -- equals the state the draft held when that round's catch-up
    ended."""
    import dataclasses

    from repro_torch.models.model import quantize_model
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.paged_cache import restore_state, snapshot_state
    from repro_torch.serving.speculative import (DEFAULT_DRAFT_SPEC, SpeculativeConfig,
                                                 make_packed_fn)

    model, params, qp, sc = _recurrent_model(dev, "falcon_mamba_7b")
    draft = quantize_model(model, params, DEFAULT_DRAFT_SPEC)
    spec_sc = dataclasses.replace(sc, speculative=SpeculativeConfig(k=3))
    eng = ServingEngine(model, qp, spec_sc, batch_slots=2, draft=(model, draft))
    sched, runner = eng.scheduler, eng.scheduler.draft
    seen = {"step": None, "commits": [], "catch_up": None, "target": 0, "draft": 0}
    run_step, commit = sched._run_step, sched._commit_state

    def recorded_step(probe=False):
        # the step's inputs as the host packed them (the upload is in run_step)
        seen["step"] = ([t.to(dev, copy=True) for t in sched._in.host],
                        snapshot_state(sched.pools))
        seen["commits"] = []
        return run_step(probe)

    sched._run_step = recorded_step
    sched._commit_state = lambda *a: (seen["commits"].append(a[1:]), commit(*a))[1]
    catch_up = runner._catch_up_rows
    runner._catch_up_rows = lambda pending: (catch_up(pending),
                                             seen.update(catch_up=snapshot_state(runner.pools)))
    sync = runner.sync

    def checked_sync(slot, n_valid):
        restores = n_valid < runner.pos[slot]
        sync(slot, n_valid)
        if restores:
            for g, w in zip(_state(runner.pools, slot), seen["catch_up"]):
                for k in g:
                    assert torch.equal(g[k], w[k][slot]), k
            seen["draft"] += 1

    runner.sync = checked_sync
    packed = make_packed_fn(model)
    for p in GRAPH_PROMPTS[:2]:
        sched.submit(p, 12)
    results = {}
    while sched.step(results):
        inputs, before = seen["step"]
        for row, slot, step in seen["commits"]:
            bt, slot_ids, pos, ctx, tok = (t.clone() for t in inputs)
            pos[row, step + 1:] = -1
            ctx[row] = pos[row].max() + 1
            pools = model.init_caches(2, sc.cache_len, torch.float32, quantized=True,
                                      layout="paged", block_size=sc.block_size, device=dev)
            restore_state(pools, before)
            pools, _ = packed(qp, pools, bt, slot_ids, pos, ctx, tok)
            for g, w in zip(_state(sched.pools, slot), _state(pools, slot)):
                for k in g:
                    assert torch.equal(g[k], w[k]), k
            seen["target"] += 1
    assert seen["target"] > 0 and seen["draft"] > 0, seen
    assert sched.stats["accepted_tokens"] < sched.stats["drafted_tokens"]


@pytest.mark.parametrize("arch", ["falcon_mamba_7b", "recurrentgemma_2b"])
def test_recurrent_probed_graph_keeps_the_state(dev, arch):
    """At ``quality`` every step runs the probed graph, whose probe forward
    first puts back the state the step advanced: the tokens equal the
    unprobed graph engine's, and every step was probed."""
    import dataclasses

    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.telemetry import TelemetryConfig

    model, _, qp, sc = _recurrent_model(dev, arch)
    prompts = GRAPH_PROMPTS[:3]
    want = ServingEngine(model, qp, sc, batch_slots=2).generate(prompts, 6)
    tel = TelemetryConfig(level="quality", quality_sample_every=1, quality_shadow_every=1000)
    eng = ServingEngine(model, qp, dataclasses.replace(sc, telemetry=tel), batch_slots=2)
    assert eng.generate(prompts, 6) == want
    assert eng.scheduler.probe_graph.capture_s > 0
    assert eng.snapshot()["counters"]["numerics_probe_steps"] == eng.stats["packed_steps"]


# ---------------------------------------------------------------------------
# the vlm family (llama3_2_vision_11b): its kernel shapes and its ring step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,byte,zero_rows", [
    (8, 4096, 4096, False, False),      # wq, wo at 8 decode rows
    (8, 4096, 1024, False, False),      # wk, wv
    (8, 4096, 28672, False, False),     # wi
    (8, 14336, 4096, True, False),      # wd, W8
    (8, 4096, 4096, False, True),       # a served cross block's wo: zero rows
    (1024, 4096, 28672, False, False),  # wi at 8 x 128 prefill rows
])
def test_fused_lut_gemm_at_vlm_shapes(dev, m, k, n, byte, zero_rows):
    """llama3_2_vision_11b's projections, the checks of the family shapes."""
    _check_family_gemm(dev, m, k, n, byte, zero_rows)


@pytest.mark.parametrize("m", [8, 1024])
@pytest.mark.parametrize("n,k", [(4096, 20), (14336, 72)])
@pytest.mark.parametrize("kind", ["normal", "specials", "zeros"])
def test_topk_at_vlm_widths(dev, m, n, k, kind):
    """Orizuru's k = round(0.005 N) on the vlm's projection inputs (d 4096,
    d_ff 14336), at decode and prefill rows, and on all-zero rows."""
    test_topk_kernel_vs_plain_exact(dev, m, n, k, kind)


def _vlm_engine_model(dev):
    """The smoke vlm on the card with both gates of every cross block
    nonzero, quantized W4A4 + W8 ``mlp/wd`` with dynamic outliers (fused
    route), served on an int4 ring."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core.qlinear import QLinearConfig
    from repro_torch.core.quantspec import QuantSpec
    from repro_torch.models.model import build as build_model
    from repro_torch.models.model import quantize_model

    model = build_model(get_smoke_config("llama3_2_vision_11b"))
    params = model.init(seed=0, device=dev)
    with torch.no_grad():
        for i, blk in enumerate(params.cross_blocks):
            blk.attn.gate.fill_(0.4 + 0.1 * i)
            blk.mlp_gate.fill_(0.7 - 0.1 * i)
    spec = QuantSpec(base=QLinearConfig(detection="dynamic", outlier_frac=0.05),
                     rules=[("mlp/wd", {"w_bits": 8})], kv_bits=4, kv_dtype="float32")
    return model, quantize_model(model, params, spec)


def test_vlm_ring_decode_graph_is_bit_equal_to_eager(dev):
    """The vlm's fixed-slot decode step as a graph replay against the eager
    step, on cross caches filled with random values before the prefill: a
    left-padded batch's prefill and four steps' logits and every ring bit
    for bit; the cross caches hold exactly what was put there after every
    replay (read, never written), and the graph holds their addresses."""
    from repro_torch.serving.engine import ServeConfig, ServingEngine, image_inputs

    model, qp = _vlm_engine_model(dev)
    sc = ServeConfig(cache_len=64, kv_quant=True, cache_dtype="float32")
    prompts = [list(range(40, 50)), [7, 8], list(range(1, 6))]
    got = {}
    for graph in (True, False):
        eng = ServingEngine(model, qp, sc, batch_slots=3, graph=graph)
        assert not eng.paged
        plen = max(len(p) for p in prompts)
        pads = [plen - len(p) for p in prompts]
        caches = eng._ring_caches(pads)
        g = torch.Generator(device=dev).manual_seed(1)
        filled = []
        for layer in eng._ring:
            for key in ("ck", "cv"):
                if key in layer:
                    layer[key].copy_(torch.randn(layer[key].shape, generator=g, device=dev))
                    filled.append((layer[key], layer[key].clone(), layer[key].data_ptr()))
        toks = torch.tensor([[0] * n + p for n, p in zip(pads, prompts)], dtype=torch.int32,
                            device=dev)
        tok, caches, _ = eng._prefill(qp, caches, {"tokens": toks,
                                                   **image_inputs(model, len(prompts), dev)})
        logits = []
        for pos in range(plen, plen + 4):
            tok, lg = eng._decode_step(caches, tok, pos)
            logits.append(lg.clone())
            tok = tok.clone()
            torch.cuda.synchronize()
            for t, want, ptr in filled:
                assert torch.equal(t, want) and t.data_ptr() == ptr
        rings = [{k: v.clone() for k, v in layer.items()} for layer in eng._ring]
        got[graph] = (logits, rings, eng.stats["graph_capture_s"])
    for g_, e in zip(got[True][0], got[False][0]):
        assert torch.equal(g_, e)
    for g_, e in zip(got[True][1], got[False][1]):
        for k in g_:
            assert torch.equal(g_[k], e[k]), k
    assert got[True][2] > 0 and got[False][2] is None
