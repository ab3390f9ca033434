"""PyTorch port vs JAX package: float (bfloat16 / float32) paged KV pools.

* The float-page paged attention's plain version against JAX's Pallas kernel
  (``_kernel_bf16``, interpret mode) on bfloat16 and float32 pages.
* The pool itself: layout, writes, copy-on-write.
* The port's ``ServingEngine`` serving a JAX artifact whose spec keeps the
  default float KV cache (``kv_bits=None``) must give the JAX engine's greedy
  tokens, for the smoke llama3_2_1b and oasis_7b, in bfloat16 and float32
  pools, with prefix sharing and copy-on-write on. Both sides round K/V to
  the pool dtype and attend in float32; a last-ulp difference could flip an
  A4 index and, through a near-tied logit, a token. On these seeded prompts
  none does, and such a flip fails the test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke_config as j_smoke  # noqa: E402
from repro.core import QLinearConfig as JCfg  # noqa: E402
from repro.core import QuantSpec as JSpec  # noqa: E402
from repro.core import quantize_model as j_quantize_model  # noqa: E402
from repro.core import save_quantized  # noqa: E402
from repro.kernels.paged_attn import paged_attn_kernel_call  # noqa: E402
from repro.models.model import build as j_build  # noqa: E402
from repro.serving.engine import ServeConfig as JServe  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.core.artifact import load_quantized  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.paged_attn import paged_attn_bf16, paged_attn_plain  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.serving import paged_cache as tpc  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServingEngine  # noqa: E402


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


def n(a):
    return np.asarray(a)


def _attn_inputs(seed, page_dtype, b=5, s=2, kv=2, g=3, hd=8, bs=4, max_blk=4, n_blocks=12):
    rng = np.random.RandomState(seed)
    cast = lambda a: n(jnp.asarray(a).astype(jnp.dtype(page_dtype)))
    pk = cast(rng.randn(n_blocks, bs, kv, hd).astype(np.float32))
    pv = cast(rng.randn(n_blocks, bs, kv, hd).astype(np.float32))
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
    return q, pk, pv, tables, ctx, qpos


def _torch_pages(a):
    """numpy (ml_dtypes bfloat16 or float32) -> torch, bit for bit."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return t(a)


@pytest.mark.parametrize("page_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("softcap,window", [(0.0, 0), (5.0, 0), (0.0, 3), (7.0, 5)])
def test_paged_attn_float_plain_matches_pallas(softcap, window, page_dtype):
    """Rows that see at least one key: float32 within 1e-5 of the value scale
    (softmax sums in another order). Rows that see none (q_pos < 0) are
    meaningless in both versions and only checked to be finite."""
    q, pk, pv, tables, ctx, qpos = _attn_inputs(int(softcap * 10 + window), page_dtype)
    want = n(paged_attn_kernel_call(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), block_tables=jnp.asarray(tables),
        ctx_lens=jnp.asarray(ctx), q_pos=jnp.asarray(qpos), softcap=softcap, window=window,
        interpret=True))
    args = (t(q), _torch_pages(pk), _torch_pages(pv), t(tables), t(ctx), t(qpos))
    assert args[1].dtype == getattr(torch, page_dtype)
    build.reset_counts()
    got = paged_attn_bf16(*args, softcap=softcap, window=window).numpy()
    assert sum(build.LAUNCHES.values()) == sum(build.PLAIN_ON_CUDA.values()) == 0
    assert np.array_equal(got, paged_attn_plain(*args, softcap=softcap, window=window).numpy())
    live = qpos >= 0
    assert live.sum() >= 4
    vmax = np.abs(pv.astype(np.float32)).max()
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=1e-5 * vmax)
    assert np.isfinite(got).all()


def test_paged_attn_float_wrapper_rejects_bad_inputs():
    args = [t(a) if i not in (1, 2) else _torch_pages(a)
            for i, a in enumerate(_attn_inputs(1, "bfloat16"))]
    for i, bad in [(0, args[0].double()), (1, args[1].half()), (2, args[2].float()),
                   (1, args[1][..., :4]), (3, args[3].long()), (5, args[5][:, :1])]:
        a = list(args)
        a[i] = bad
        with pytest.raises(ValueError):
            paged_attn_bf16(*a)
    with pytest.raises(ValueError, match="device"):
        paged_attn_bf16(*[a.to("meta") for a in args])


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, "float32"])
def test_float_pool_layout_and_write(dtype):
    """``init_paged_kv_cache`` float pages; ``_paged_write`` stores k / v in
    the pool dtype at (table[p // bs], p % bs) and drops padding, idle rows
    and unallocated blocks; ``_paged_attend`` reads them back."""
    cfg = get_smoke_config("llama3_2_1b")
    bs, kv, hd = 4, cfg.n_kv_heads, cfg.head_dim
    cache = L.init_paged_kv_cache(cfg, 6, bs, dtype)
    want_dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    assert set(cache) == {"pages_k", "pages_v"}
    assert cache["pages_k"].shape == (6, bs, kv, hd) and cache["pages_k"].dtype == want_dt
    cache["block_tables"] = torch.tensor([[3, 1, -1], [5, -1, -1]], dtype=torch.int32)
    cache["ctx_lens"] = torch.tensor([6, 2], dtype=torch.int32)
    g = torch.Generator().manual_seed(0)
    k = torch.randn((2, 9, kv, hd), generator=g)
    v = torch.randn((2, 9, kv, hd), generator=g)
    pos = torch.tensor([list(range(9)), [0, 1, -1, 2, 3, 4, 5, 6, 7]], dtype=torch.int32)
    L._paged_write(cache, k, v, pos, cache["ctx_lens"])
    pk = cache["pages_k"]
    assert torch.equal(pk[3], k[0, :4].to(want_dt))
    assert torch.equal(pk[1, :2], k[0, 4:6].to(want_dt))
    assert torch.equal(cache["pages_v"][5, :2], v[1, :2].to(want_dt))
    assert not pk[1, 2:].any() and not pk[5, 2:].any() and not pk[0].any()
    q = torch.randn((2, 1, kv, cfg.n_heads // kv, hd), generator=g)
    o = L._paged_attend(cache, q, torch.tensor([[5], [1]], dtype=torch.int32), softcap=0.0)
    assert o.shape == q.shape and torch.isfinite(o).all()


def test_copy_blocks_on_a_float_pool():
    pools = [{"pages_k": torch.arange(24, dtype=torch.bfloat16).reshape(4, 2, 1, 3),
              "pages_v": -torch.arange(24, dtype=torch.float32).reshape(4, 2, 1, 3)}]
    tpc.copy_blocks(pools, [1, 3], [0, 2])
    for key in ("pages_k", "pages_v"):
        assert torch.equal(pools[0][key][0], pools[0][key][1])
        assert torch.equal(pools[0][key][2], pools[0][key][3])


# ---------------------------------------------------------------------------
# engine: float pools, the port serves the JAX artifact token for token
# ---------------------------------------------------------------------------

def _prompts(vocab):
    """A carries a 16-token (two-block) prefix and runs long; B finishes
    fast, so D -- exactly that prefix -- is admitted while A still holds the
    blocks, aliases both and must copy the last one before writing into it."""
    rng = np.random.RandomState(2)
    shared = [int(x) for x in rng.randint(0, vocab, 16)]
    rand = lambda lo, hi: [int(x) for x in rng.randint(0, vocab, rng.randint(lo, hi))]
    prompts = [shared + rand(9, 10), rand(3, 6), rand(20, 30), list(shared), shared + rand(2, 8)]
    return prompts, [20, 2, 8, 6, 8]


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", ["llama3_2_1b", "oasis_7b"])
def test_float_pool_engine_tokens_match_jax(tmp_path, arch, kv_dtype):
    spec = JSpec(base=JCfg(detection="dynamic", outlier_frac=0.005),
                 rules=[("mlp/wd", {"w_bits": 8})], kv_bits=None, kv_dtype=kv_dtype)
    cfg = j_smoke(arch)
    jmodel = j_build(cfg)
    jparams = j_quantize_model(jmodel, jmodel.init(jax.random.PRNGKey(1)), spec)
    save_quantized(tmp_path, cfg, spec, jparams)
    kw = dict(cache_len=64, block_size=8, prefill_chunk=8)
    prompts, budgets = _prompts(cfg.vocab_size)
    jeng = JEngine(jmodel, jparams, JServe.from_spec(spec, **kw), batch_slots=3)
    want = jeng.generate(prompts, max_new_tokens=budgets)
    art = load_quantized(str(tmp_path), device="cpu")
    eng = ServingEngine(art.model, art.params, ServeConfig.from_spec(art.spec, **kw),
                        batch_slots=3)
    pool = eng.scheduler.pools[0]
    assert "pages_k_idx" not in pool and pool["pages_k"].dtype == getattr(torch, kv_dtype)
    got = eng.generate(prompts, max_new_tokens=budgets)
    assert got == want
    js, ts = jeng.stats, eng.stats
    for key in ("packed_steps", "prefill_tokens", "prefix_hits", "cow_copies"):
        assert ts[key] == js[key], key
    assert ts["prefix_hits"] > 0 and ts["cow_copies"] > 0
