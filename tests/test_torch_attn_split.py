"""The paged-attention kernels' split design, held in plain numpy on the CPU.

On the card both attention kernels (``csrc/paged_attn_common.cuh``) cut each
row's table into splits of whole pages, walk each split in ring slots of T
keys with one online softmax per warp over its share of every slot, merge the
four warps in warp order and then the splits in split order. Masked keys
weigh exactly 0, so a split (or a warp) that sees no valid key leaves
m = finfo(float32).min, l = 0, acc = 0. ``kernel_order`` models that order in
float32; it must agree with the plain versions and with the JAX Pallas
kernel (interpret mode) within 1e-5 max|v|, the tolerance of
``tests/test_torch_kernels.py``, produce no NaN, and give 0 on rows that see
no key. ``split_plan`` must cover each table exactly, in whole pages, from
shapes alone.
"""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attn import paged_attn_kernel_call  # noqa: E402
from repro.models.model import _default_codebook  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.paged_attn import (paged_attn_plain,  # noqa: E402
                                            paged_attn_quant_plain, split_plan)

NEG = np.float32(np.finfo(np.float32).min)
WARPS = 4


def _online(s, valid, v, slot_keys):
    """One warp's online softmax over its keys, slot by slot: (m, l, acc)."""
    m, l, acc = NEG, np.float32(0), np.zeros(v.shape[-1], np.float32)
    for lo in range(0, len(s), slot_keys):
        sl = slice(lo, lo + slot_keys)
        ss = np.where(valid[sl], s[sl], NEG)
        m_new = np.float32(max(m, ss.max(initial=NEG)))
        alpha = np.exp(np.float32(m - m_new))
        p = np.where(valid[sl], np.exp(ss - m_new), np.float32(0)).astype(np.float32)
        l = np.float32(l * alpha + p.sum(dtype=np.float32))
        acc = (acc * alpha + p @ v[sl]).astype(np.float32)
        m = m_new
    return m, l, acc


def _merge(parts):
    """Partials (m, l, acc) merged in order: exp(m_i - M) weights."""
    M = np.float32(max(p[0] for p in parts))
    w = [np.exp(np.float32(p[0] - M)) for p in parts]
    L = np.float32(sum(wi * p[1] for wi, p in zip(w, parts)))
    A = sum(wi * p[2] for wi, p in zip(w, parts)).astype(np.float32)
    return M, L, A


def kernel_order(q, k, v, ctx, qpos, *, pps, bs, softcap=0.0, window=0, slot=8):
    """q (B, S, KV, G, hd); k, v (B, keys, KV, hd) float32, gathered through
    the tables. Split i owns keys [i pps bs, (i + 1) pps bs) below the
    context; within it the walk covers the whole pages holding a key some
    row may see, in slots of ``slot`` keys, each slot's keys dealt to the
    warps in runs of slot / 4."""
    b_n, s_n, kv_n, g_n, hd = q.shape
    out = np.zeros(q.shape, np.float32)
    kpos = np.arange(k.shape[1])
    tw = slot // WARPS
    with np.errstate(under="ignore"):
        for b in range(b_n):
            n_pages = min(-(-int(ctx[b]) // bs), k.shape[1] // bs)
            n_live = max(1, -(-n_pages // pps))
            for h in range(kv_n):
                parts = {r: [] for r in range(s_n * g_n)}
                for sp in range(n_live):
                    k_end = min(int(ctx[b]), min((sp + 1) * pps, n_pages) * bs)
                    lo = np.array([max(qpos[b, s] - window + 1 if window > 0 else 0, sp * pps * bs)
                                   for s in range(s_n)])
                    hi = np.array([min(int(ctx[b]), qpos[b, s] + 1, k_end) for s in range(s_n)])
                    live = hi > lo
                    k0 = lo[live].min() // bs * bs if live.any() else 0
                    k1 = -(-hi[live].max() // bs) * bs if live.any() else 0
                    for s in range(s_n):
                        for g in range(g_n):
                            sc = (k[b, k0:k1, h] @ q[b, s, h, g]) * np.float32(hd ** -0.5)
                            if softcap > 0:
                                sc = np.float32(softcap) * np.tanh(sc / np.float32(softcap))
                            valid = (kpos[k0:k1] >= lo[s]) & (kpos[k0:k1] < hi[s])
                            warps = []
                            for w in range(WARPS):
                                idx = np.concatenate([np.arange(st + w * tw, st + (w + 1) * tw)
                                                      for st in range(0, k1 - k0, slot)] or
                                                     [np.zeros(0, int)])
                                idx = idx[idx < k1 - k0]
                                warps.append(_online(sc[idx], valid[idx], v[b, k0:k1, h][idx],
                                                     tw))
                            parts[s * g_n + g].append(_merge(warps))
                for r, pr in parts.items():
                    _, L, A = _merge(pr)
                    out[b, r // g_n, h, r % g_n] = A / max(L, np.float32(1e-30))
    return out


def _case(seed, pages, ctx, s, *, kv=2, g=2, hd=8, bs=4, max_blk=12):
    rng = np.random.RandomState(seed)
    b = len(ctx)
    n_blocks = b * max_blk
    ctx = np.asarray(ctx, np.int32)
    tables = rng.permutation(n_blocks).reshape(b, max_blk).astype(np.int32)
    tables[np.arange(max_blk)[None, :] >= ((ctx + bs - 1) // bs)[:, None]] = -1
    qpos = (ctx[:, None] - s + np.arange(s)[None, :]).astype(np.int32)
    qpos[qpos < 0] = -1
    qpos[ctx == 0] = -1
    if s > 1:
        qpos[0, -1] = -1  # a padded cell inside a live segment: it sees no key
    q = rng.randn(b, s, kv, g, hd).astype(np.float32)
    bt = np.clip(tables, 0, n_blocks - 1)
    if pages == "int4":
        ki = rng.randint(0, 256, (n_blocks, bs, kv, hd // 2)).astype(np.uint8)
        vi = rng.randint(0, 256, (n_blocks, bs, kv, hd // 2)).astype(np.uint8)
        ks = (rng.rand(n_blocks, bs, kv, 1) + 0.5).astype(np.float32)
        vs = (rng.rand(n_blocks, bs, kv, 1) + 0.5).astype(np.float32)
        book = np.asarray(_default_codebook(4), np.float32)
        deq = lambda i, sc: (book[np.stack([i & 0xF, i >> 4], -1).reshape(*i.shape[:-1], -1)]
                             * sc).astype(np.float32)
        dk, dv = deq(ki, ks), deq(vi, vs)
        storage = (ki, ks, vi, vs, book)
    else:
        dk = rng.randn(n_blocks, bs, kv, hd).astype(np.float32)
        dv = rng.randn(n_blocks, bs, kv, hd).astype(np.float32)
        storage = (dk, dv)
    gk = dk[bt].reshape(b, max_blk * bs, kv, hd)
    gv = dv[bt].reshape(b, max_blk * bs, kv, hd)
    return q, storage, tables, ctx, qpos, gk, gv


# (ctx per row, S, pps, softcap, window): pps = 2 pages of 4 keys, 8 keys a split
CASES = {
    "window masks whole splits": ([48, 40, 33, 9], 2, 2, 0.0, 5),
    "q_pos before a split's first key": ([17, 33, 25, 41], 4, 2, 0.0, 0),
    "ctx = 0 and page / split boundaries": ([8, 16, 0, 4, 32, 7], 1, 2, 0.0, 0),
    "softcap, one page a split": ([47, 20, 13], 3, 1, 7.0, 0),
    "softcap and window, one split": ([45, 30, 3], 2, 12, 5.0, 9),
}


@pytest.mark.parametrize("pages", ["int4", "float32"])
@pytest.mark.parametrize("name", list(CASES))
def test_split_order_matches_plain_and_pallas(name, pages):
    ctx, s, pps, softcap, window = CASES[name]
    q, storage, tables, ctx, qpos, gk, gv = _case(len(name), pages, ctx, s)
    got = kernel_order(q, gk, gv, ctx, qpos, pps=pps, bs=4, softcap=softcap, window=window)
    assert np.isfinite(got).all()
    t = lambda a: torch.from_numpy(np.array(a, copy=True))
    args = (t(q), *map(t, storage), t(tables), t(ctx), t(qpos))
    kw = dict(softcap=softcap, window=window)
    plain = (paged_attn_quant_plain if pages == "int4" else paged_attn_plain)(*args, **kw).numpy()
    pallas = np.asarray(paged_attn_kernel_call(
        jnp.asarray(q), *map(jnp.asarray, storage), block_tables=jnp.asarray(tables),
        ctx_lens=jnp.asarray(ctx), q_pos=jnp.asarray(qpos), interpret=True, **kw))
    kpos = np.arange(gk.shape[1])
    sees = ((kpos[None, None] < ctx[:, None, None]) & (kpos[None, None] <= qpos[..., None])
            & ((kpos[None, None] > qpos[..., None] - window) if window > 0 else True)).any(-1)
    assert sees.sum() >= 4
    vmax = np.abs(gv).max()
    np.testing.assert_allclose(got[sees], plain[sees], rtol=0, atol=1e-5 * vmax)
    np.testing.assert_allclose(got[sees], pallas[sees], rtol=0, atol=1e-5 * vmax)
    assert (got[~sees] == 0).all()


def test_merge_weighs_masked_splits_zero_and_makes_no_nan():
    """A split with no valid key (m = finfo.min, l = 0, acc = 0) beside one
    with valid keys weighs exp(finfo.min - M) = 0, for any sign of M; all
    splits masked merge to 0 through max(L, 1e-30), not to NaN."""
    empty = (NEG, np.float32(0), np.zeros(3, np.float32))
    for m in (np.float32(-30.0), np.float32(0.0), np.float32(30.0)):
        live = (m, np.float32(2.0), np.array([2.0, 4.0, -6.0], np.float32))
        with np.errstate(under="ignore"):
            M, L, A = _merge([empty, live, empty])
        assert M == m and L == 2.0
        np.testing.assert_array_equal(A / L, [1.0, 2.0, -3.0])
    M, L, A = _merge([empty, empty])
    out = A / max(L, np.float32(1e-30))
    assert np.isfinite(out).all() and (out == 0).all()


SHAPES = [(72, 8, 64, 16), (8, 8, 512, 16), (18, 8, 64, 16), (1, 1, 1, 16), (4, 2, 96, 8),
          (2, 32, 4096, 16), (3, 8, 7, 5), (1, 8, 100000, 16), (9, 8, 128, 16), (6, 8, 0, 16)]


@pytest.mark.parametrize("b,kv,max_blk,bs", SHAPES)
def test_split_plan_covers_the_table_in_whole_pages(b, kv, max_blk, bs):
    splits, pps = split_plan(b, kv, max_blk, bs)
    assert isinstance(splits, int) and isinstance(pps, int) and splits >= 1 and pps >= 1
    ranges = [(i * pps, min((i + 1) * pps, max_blk)) for i in range(splits)]
    assert all(hi > lo for lo, hi in ranges) or max_blk == 0
    covered = [p for lo, hi in ranges for p in range(lo, hi)]
    assert covered == list(range(max_blk))
    assert pps * 4 <= 2048 * 4  # the block's table in shared memory


def test_split_plan_takes_shapes_only():
    """The planner sees no tensor: its inputs are the launch's shapes and the
    card's SM count, so a launch never reads ctx_lens on the host."""
    params = inspect.signature(split_plan).parameters
    assert list(params) == ["b", "kv", "max_blk", "bs", "sms"]
    assert params["sms"].default == build.SMS
    # the serving step (72 rows, 8 heads) already fills the card: one split;
    # 8 long decode rows split their 512 pages to fill it
    assert split_plan(72, 8, 64, 16) == (1, 64)
    splits, pps = split_plan(8, 8, 512, 16)
    assert splits > 4 and splits * pps >= 512 and pps * 16 >= 256
    assert split_plan(8, 8, 512, 16, sms=264)[0] > splits
