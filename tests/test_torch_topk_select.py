"""The Orizuru kernels' radix selection (``csrc/topk_select.cuh``), modelled
in numpy step by step, against the port's plain version and the JAX package.

The CUDA kernels run only on a card (``tests/test_torch_gpu.py``); this file
holds their algorithm on the CPU: the order key, the transposed shared-memory
layout with its division by a magic number, the 8-bit radix passes (one joint
histogram, then one per side, a packed two-side scan, the early stops), the
tie gather in channel order and the final order by 64-bit composites. The
model must equal ``topk_outlier_plain`` exactly (channels, and values bit for
bit) on normal, duplicate, all-equal, +-inf, +-0 and NaN rows, and the JAX
Pallas kernel in interpret mode on every row without NaN (channels exactly,
values as numbers: the Pallas kernel's zeros come out with either sign, as
its pops sum through +0.0). Two reference-side findings are pinned at the
end.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref  # noqa: E402
from repro.kernels.topk_outlier import topk_outlier_kernel_call  # noqa: E402

from repro_torch.kernels.topk_outlier import (  # noqa: E402
    MAX_N, SMEM_LIMIT, THREADS, order_key, smem_bytes, topk_outlier_plain)

U32 = 0xFFFFFFFF
NEG_NAN = np.array([0xFFC00001], np.uint32).view(np.float32)[0]  # sign bit set, a payload


def layout(n):
    """(per, stride, magic) of ``topk_select.cuh::layout``."""
    per = -(-n // THREADS)
    return per, THREADS + (1 if per >= 32 else 32 // per), (1 << 31) // per + 1


def slot(c, per, stride, magic):
    q = ((2 * c.astype(np.uint64)) * np.uint64(magic)) >> np.uint64(32)  # __umulhi(2c, magic)
    q = q.astype(np.int64)
    return (c - q * per) * stride + q


def excl_scan(v, axis=0):
    return np.cumsum(v, axis=axis) - v


def model(row, k):
    """One row through the kernel's steps: (hi_v, hi_i, lo_v, lo_i, passes)."""
    n = row.shape[0]
    keys = order_key(torch.from_numpy(row)).numpy().astype(np.uint64)
    per, stride, magic = layout(n)
    # load: key of channel c at slot(c); thread t reads its entry j at j * stride + t
    buf = np.zeros(per * stride, np.uint64)
    ch = np.arange(n)
    sl = slot(ch, per, stride, magic)
    assert np.unique(sl).size == n and sl.max() < per * stride
    buf[sl] = keys
    t, j = np.divmod(np.arange(THREADS * per), per)
    valid = t * per + j < n
    own = np.where(valid, buf[j * stride + t], 0).reshape(THREADS, per)  # own[t, j]
    np.testing.assert_array_equal(own.reshape(-1)[valid], keys)  # channel t * per + j

    # every key's low 16 bits as its sign implies (bf16-origin rows without NaN)
    short = bool(np.all((keys & 0xFFFF) == np.where(keys >> 31, 0, 0xFFFF)))
    sides = [dict(prefix=0, mask=0, need=k, all=False) for _ in range(2)]
    open_ = lambda s: not s["all"] and s["mask"] != U32
    passes = 0
    for shift in (24, 16, 8, 0):
        if not any(open_(s) for s in sides):
            break
        passes += 1
        hist = []
        for s in sides:
            grp = keys[(keys & np.uint64(s["mask"])) == s["prefix"]] if open_(s) else keys[:0]
            hist.append(np.bincount(((grp >> np.uint64(shift)) & np.uint64(0xFF)).astype(np.int64),
                                    minlength=256))
        if shift == 24:  # the joint pass: both groups are the whole row
            hist[1] = hist[0]
        packed = (hist[0] << 16) | hist[1]  # one 32-bit block scan for both sides
        incl = np.cumsum(packed)
        assert incl[-1] < 1 << 32
        above = (int(incl[-1]) >> 16) - (incl >> 16)  # hi: entries in higher bins
        below = (incl & 0xFFFF) - hist[1]  # lo: entries in lower bins
        for s, h, beyond in ((sides[0], hist[0], above), (sides[1], hist[1], below)):
            if not open_(s):
                continue
            (b,) = np.nonzero((beyond < s["need"]) & (beyond + h >= s["need"]))
            assert b.size == 1
            b = int(b[0])
            s["need"] -= int(beyond[b])
            s["all"] = bool(h[b] == s["need"])
            s["prefix"] |= b << shift
            s["mask"] |= 0xFF << shift
            if shift == 16 and short:  # the bin is one key; its low 16 bits follow its sign
                s["prefix"] |= 0 if s["prefix"] >> 31 else 0xFFFF
                s["mask"] = U32
    for s in sides:
        assert s["all"] or s["mask"] == U32  # a partial group is one exact key

    # gather: ties ranked by a block scan of per-thread counts (contiguous channels)
    sel = []
    for i, s in enumerate(sides):
        grp = np.zeros(THREADS * per, bool)
        grp[valid] = (keys & np.uint64(s["mask"])) == s["prefix"]
        grp = grp.reshape(THREADS, per)
        tie = excl_scan(grp.sum(1))[:, None] + excl_scan(grp.astype(np.int64), axis=1)
        masked = own & np.uint64(s["mask"])
        past = masked > s["prefix"] if i == 0 else masked < s["prefix"]
        take = valid.reshape(THREADS, per) & (past | (grp & (s["all"] or tie < s["need"])))
        sel.append((t * per + j).reshape(THREADS, per)[take])
        assert sel[-1].size == k
    # order: output slot = count of larger composites on the side
    out = []
    for i, c in enumerate(sel):
        key = keys[c] if i == 0 else ~keys[c] & np.uint64(U32)
        comp = (key << np.uint64(32)) | (~c.astype(np.uint64) & np.uint64(U32))
        rank = (comp[None, :] > comp[:, None]).sum(1)
        assert np.unique(rank).size == k
        chans = np.empty(k, np.int64)
        chans[rank] = c
        out += [row[chans], chans.astype(np.int32)]
    return (*out, passes)


def rows(kind, m, n, seed):
    rng = np.random.RandomState(seed)
    if kind == "normal":
        x = rng.randn(m, n)
    elif kind == "duplicates":
        x = rng.randint(-3, 4, (m, n))
    elif kind == "all_equal":
        x = np.full((m, n), 0.5)
    elif kind == "inf":
        x = rng.randint(-2, 3, (m, n)).astype(np.float64)
        x[:, ::5] = np.inf
        x[:, 2::7] = -np.inf
    elif kind == "zeros":
        x = rng.choice([-0.0, 0.0, 1.0, -1.0], (m, n), p=[0.4, 0.4, 0.1, 0.1])
    elif kind == "nan":
        x = rng.randn(m, n).astype(np.float32)
        x[:, ::6] = np.nan
        x[:, 3::11] = NEG_NAN
        x[0, :] = NEG_NAN  # a row of NaN only
    else:
        raise ValueError(kind)
    return np.ascontiguousarray(x, dtype=np.float32)


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


KINDS = ["normal", "duplicates", "all_equal", "inf", "zeros", "nan"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,k", [(300, 1), (300, 7), (257, 257), (2047, 10), (1000, 41)])
def test_model_equals_plain_exactly(kind, n, k):
    x = rows(kind, 3, n, seed=n + k)
    want = [a.numpy() for a in topk_outlier_plain(torch.from_numpy(x), k)]
    for r in range(x.shape[0]):
        got = model(x[r], k)
        for g, w in zip(got[:4], want):
            np.testing.assert_array_equal(bits(g) if g.dtype == np.float32 else g,
                                          bits(w[r]) if w.dtype == np.float32 else w[r])


# The Pallas kernel retires a popped entry as -inf (and pads odd N with an
# infinite lane), so rows with real infinities are compared while k stays
# short of them: not at k = N.
@pytest.mark.parametrize("kind,n,k", [
    (kind, n, k) for kind in ("normal", "duplicates", "all_equal", "inf", "zeros")
    for n, k in ((64, 1), (64, 4), (65, 5), (32, 32), (33, 33)) if kind != "inf" or k < n])
def test_model_equals_pallas_kernel(kind, n, k):
    x = rows(kind, 4, n, seed=k)
    want = [np.asarray(a) for a in topk_outlier_kernel_call(jnp.asarray(x), k, interpret=True)]
    for r in range(x.shape[0]):
        got = model(x[r], k)
        for g, w in zip(got[:4], want):  # values as numbers: -0.0 == +0.0
            np.testing.assert_array_equal(g, w[r])


def test_order_key_is_monotone_in_the_plain_order():
    x = np.array([np.nan, -np.inf, -1.0, -0.0, 0.0, 1e-45, -1e-45, 3.5, np.inf, NEG_NAN,
                  -3.5, 0.0, -0.0, np.float32(3.4e38)], np.float32)
    key = order_key(torch.from_numpy(x)).numpy()
    assert key.min() >= 0 and key.max() == U32
    hv, hi, lv, li = topk_outlier_plain(torch.from_numpy(x[None]), x.size)
    for chans, desc in ((hi[0].numpy(), True), (li[0].numpy(), False)):
        k = key[chans]
        assert np.all(k[:-1] >= k[1:]) if desc else np.all(k[:-1] <= k[1:])
        same = k[:-1] == k[1:]  # ties: lowest channel first
        assert np.all(chans[:-1][same] < chans[1:][same])
    assert key[3] == key[4] == key[11] == key[12]  # -0.0 ties with +0.0
    assert key[0] == key[9] == U32  # NaN of either sign


@pytest.mark.parametrize("per", [1, 2, 3, 7, 8, 31, 32, 43, 64, 100, 255, 256])
def test_slot_division_by_magic_is_exact(per):
    c = np.arange(min(per * THREADS, MAX_N + 1))
    _, stride, magic = layout(per * THREADS)
    q = ((2 * c.astype(np.uint64)) * np.uint64(magic)) >> np.uint64(32)
    np.testing.assert_array_equal(q, c // per)
    sl = slot(c, per, stride, magic)
    assert np.unique(sl).size == c.size and sl.max() < per * stride


def test_passes_stop_early_and_fit_shared_memory():
    """At the serving shapes, Gaussian rows need at most three radix passes,
    bf16-origin rows (ties at the k-th place included) and integer rows two,
    and k = N one; every shape of the port's configs fits in a block."""
    x = rows("normal", 8, 8192, seed=1) * 2
    assert max(model(r, 41)[-1] for r in x) <= 3
    assert max(model(r, 10)[-1] for r in x[:, :2048]) <= 3
    assert model(x[0, :512], 512)[-1] == 1
    bf16 = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    ties = 0
    for r in bf16:
        for n, k in ((2048, 10), (8192, 41)):
            got = model(r[:n], k)
            assert got[-1] <= 2
            ties += np.isin(r[:n], got[0][-1:]).sum() > 1  # the k-th value repeats
    assert ties > 0
    assert max(model(r, 10)[-1] for r in rows("duplicates", 4, 2048, seed=2)) <= 2
    for n, k in ((2048, 10), (8192, 41), (11008, 55), (11008, 11008), (4096, 20)):
        assert smem_bytes(n, k) <= SMEM_LIMIT
    assert smem_bytes(8192, 41) < 34 * 1024


def test_plain_nan_order_equals_lax_top_k_only_for_positive_nan():
    """Reference-side finding: on NaN with the sign bit clear the plain
    version equals ``ref.topk_outlier_ref`` (``lax.top_k``): NaN above +inf on
    the hi side, last on the lo side. ``lax.top_k`` orders by the total order,
    so a NaN with the sign bit set ranks below -inf there, while the plain
    version (and the kernels) rank every NaN alike."""
    x = np.array([[-3.0, 4.0, 1.0, -5.0, 7.0, 2.0, -1.0, np.nan],
                  [1.0, np.nan, 2.0, np.nan, np.inf, -np.inf, 0.5, np.nan]], np.float32)
    for k in (3, 6):
        got = [a.numpy() for a in topk_outlier_plain(torch.from_numpy(x), k)]
        want = [np.asarray(a) for a in ref.topk_outlier_ref(jnp.asarray(x), k)]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[3], want[3])
    x[1, 3] = NEG_NAN
    got = topk_outlier_plain(torch.from_numpy(x), 3)[1].numpy()
    want = np.asarray(ref.topk_outlier_ref(jnp.asarray(x), 3)[1])
    np.testing.assert_array_equal(got[1], [1, 3, 7])
    np.testing.assert_array_equal(want[1], [1, 7, 4])


def test_plain_signed_zero_order_is_the_pallas_kernels_not_lax_top_k():
    """Reference-side finding: ``lax.top_k`` orders -0.0 below +0.0; the
    Pallas kernel, the plain version and the kernels tie them and break the
    tie on the lowest channel."""
    x = np.array([[-0.0, 0.0, 1.0, -0.0, 0.0, 2.0, -1.0, 0.0]], np.float32)
    plain = topk_outlier_plain(torch.from_numpy(x), 6)[1].numpy()
    pallas = np.asarray(topk_outlier_kernel_call(jnp.asarray(x), 6, interpret=True)[1])
    oracle = np.asarray(ref.topk_outlier_ref(jnp.asarray(x), 6)[1])
    np.testing.assert_array_equal(plain, [[5, 2, 0, 1, 3, 4]])
    np.testing.assert_array_equal(pallas, plain)
    np.testing.assert_array_equal(oracle, [[5, 2, 1, 4, 7, 0]])
    np.testing.assert_array_equal(model(x[0], 6)[1], plain[0])
