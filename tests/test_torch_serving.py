"""PyTorch port vs JAX package: the block allocator and the serving engine.

* The op interpreter of ``tests/test_alloc_fuzz.py`` drives both packages'
  ``BlockAllocator`` in lockstep; every op must return the same thing (or
  raise in both) and leave identical state.
* The port's ``ServingEngine`` must produce the JAX engine's greedy tokens on
  the same artifact and prompts, with prefix sharing on and a pool small
  enough to preempt. Both sides pick the first maximal logit. A last-ulp
  scale difference could flip an A4 index and, through a near-tied logit, a
  token; on these seeded prompts none does, and such a flip fails the test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them
jax = pytest.importorskip("jax")

from repro.configs.base import get_smoke_config as j_smoke  # noqa: E402
from repro.core import QLinearConfig as JCfg  # noqa: E402
from repro.core import QuantSpec as JSpec  # noqa: E402
from repro.core import quantize_model as j_quantize_model  # noqa: E402
from repro.core import save_quantized  # noqa: E402
from repro.models.model import build as j_build  # noqa: E402
from repro.serving import paged_cache as jpc  # noqa: E402
from repro.serving.engine import ServeConfig as JServe  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

from repro_torch.core.artifact import load_quantized  # noqa: E402
from repro_torch.serving import paged_cache as tpc  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServingEngine  # noqa: E402

MAIN_SPEC = JSpec(base=JCfg(detection="dynamic", outlier_frac=0.005),
                  rules=[("mlp/wd", {"w_bits": 8})], kv_bits=4, kv_dtype="float32")


# ---------------------------------------------------------------------------
# allocator: both packages in lockstep
# ---------------------------------------------------------------------------

def _state(a):
    return (list(a._free), list(a._ref), list(a._lru), dict(a._hash_to_block),
            dict(a._block_hash), a.evictions, a.blocks_allocated, a.blocks_freed, a.n_free)


def _both(fn):
    """Call ``fn`` on each allocator; results (or exception types) must agree."""
    out = []
    for side in (0, 1):
        try:
            out.append(("ok", fn(side)))
        except ValueError as e:
            out.append(("raise", type(e)))
    assert out[0] == out[1]
    return out[0]


def _run_lockstep(n_blocks, ops):
    allocs = (jpc.BlockAllocator(n_blocks, prefix_cache=True),
              tpc.BlockAllocator(n_blocks, prefix_cache=True))
    seed = jpc.prefix_seed(pool="alloc-fuzz")
    assert seed == tpc.prefix_seed(pool="alloc-fuzz")
    live: dict[int, list[int]] = {}
    published: list[tuple[bytes, int]] = []
    next_rid, next_tok = 0, 0
    for op, x in ops:
        if op == 0:
            kind, got = _both(lambda s: allocs[s].alloc(x % 3 + 1))
            if got is not None:
                live[next_rid] = got
                next_rid += 1
        elif op == 1 and live:
            rid = sorted(live)[x % len(live)]
            ids = list(reversed(live.pop(rid)))
            _both(lambda s: allocs[s].free(ids))
        elif op == 2 and live:
            rid = sorted(live)[x % len(live)]
            _, got = _both(lambda s: allocs[s].alloc(1))
            if got is not None:
                live[rid] += got
        elif op == 3 and any(live.values()):
            holders = sorted(r for r in live if live[r])
            rid = holders[x % len(holders)]
            bid = live[rid][x % len(live[rid])]
            h = jpc.chain_hash(seed, [next_tok])
            assert h == tpc.chain_hash(seed, [next_tok])
            next_tok += 1
            kind, fresh = _both(lambda s: allocs[s].register(h, bid))
            if kind == "ok" and fresh:
                published.append((h, bid))
        elif op == 4 and published:
            h, bid = published[x % len(published)]
            _, hit = _both(lambda s: allocs[s].lookup(h))
            if hit == bid:
                _both(lambda s: allocs[s].incref(bid))
                live[next_rid] = [bid]
                next_rid += 1
        elif op == 5:
            held = {b for ids in live.values() for b in ids}
            unheld = [b for b in range(n_blocks) if b not in held]
            if unheld:
                kind, _ = _both(lambda s: allocs[s].free([unheld[x % len(unheld)]]))
                assert kind == "raise"
        elif op == 6 and live:
            rid = sorted(live)[x % len(live)]
            keep = x % (len(live[rid]) + 1)
            ids = list(live[rid])
            _, kept = _both(lambda s: allocs[s].truncate(ids, keep))
            live[rid] = kept
        elif op == 7 and live:
            rid = sorted(live)[x % len(live)]
            if live[rid]:
                first = live[rid].pop(0)
                _both(lambda s: allocs[s].free([first]))
        assert _state(allocs[0]) == _state(allocs[1])


@pytest.mark.parametrize("seed", range(5))
def test_allocator_lockstep_with_jax(seed):
    """Five seeds of the fuzz sweep's op mix, each over several pool sizes."""
    for sub in range(5):
        rng = np.random.RandomState(seed * 5 + sub)
        n_blocks = int(rng.randint(2, 13))
        ops = [(int(rng.randint(0, 8)), int(rng.randint(0, 256))) for _ in range(120)]
        _run_lockstep(n_blocks, ops)


def test_copy_blocks_in_place():
    pools = [{"pages_k_idx": torch.arange(24, dtype=torch.uint8).reshape(4, 2, 1, 3),
              "kv_codebook": torch.zeros(16)}]
    tpc.copy_blocks(pools, [1, 3], [0, 2])
    assert torch.equal(pools[0]["pages_k_idx"][0], pools[0]["pages_k_idx"][1])
    assert torch.equal(pools[0]["pages_k_idx"][2], pools[0]["pages_k_idx"][3])


# ---------------------------------------------------------------------------
# engine: the port serves the JAX artifact token for token
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    cfg = j_smoke("llama3_2_1b")
    model = j_build(cfg)
    qp = j_quantize_model(model, model.init(jax.random.PRNGKey(0)), MAIN_SPEC)
    d = tmp_path_factory.mktemp("artifact")
    save_quantized(d, cfg, MAIN_SPEC, qp)
    return str(d), model, qp


def _prompts(vocab):
    """(prompts, budgets): A carries a 16-token (two-block) prefix and runs
    long; B finishes fast, so D -- exactly that prefix -- is admitted while
    A still holds the blocks, aliases both and must copy the last one before
    writing into it (copy-on-write)."""
    rng = np.random.RandomState(1)
    shared = list(rng.randint(0, vocab, 16))
    a = shared + list(rng.randint(0, vocab, 9))
    rand = lambda lo, hi: list(rng.randint(0, vocab, rng.randint(lo, hi)))
    prompts = [a, rand(3, 6), rand(20, 30), list(shared), shared + rand(2, 8), rand(3, 30)]
    budgets = [24, 2, 10, 8, 10, 10]
    return [[int(t) for t in p] for p in prompts], budgets


@pytest.mark.parametrize("n_blocks,seg_width", [(9, 1), (0, 2)])
def test_engine_tokens_match_jax(artifact, n_blocks, seg_width):
    path, jmodel, jparams = artifact
    kw = dict(cache_len=64, block_size=8, prefill_chunk=8, n_blocks=n_blocks,
              seg_width=seg_width)
    prompts, budgets = _prompts(jmodel.cfg.vocab_size)
    jeng = JEngine(jmodel, jparams, JServe.from_spec(MAIN_SPEC, **kw), batch_slots=3)
    want = jeng.generate(prompts, max_new_tokens=budgets)
    art = load_quantized(path, device="cpu")
    eng = ServingEngine(art.model, art.params, ServeConfig.from_spec(art.spec, **kw),
                        batch_slots=3)
    got = eng.generate(prompts, max_new_tokens=budgets)
    assert got == want
    js, ts = jeng.stats, eng.stats
    for key in ("packed_steps", "decode_steps", "prefill_tokens", "prefix_hits",
                "prefix_hit_tokens", "cow_copies"):
        assert ts[key] == js[key], key
    # the JAX scheduler adds each preemption to serving_preemptions twice:
    # once in Scheduler._preempt and once in Telemetry.request_preempted
    # (repro/serving/scheduler.py:994, repro/serving/telemetry.py:573)
    assert js["preemptions"] == 2 * ts["preemptions"]
    assert ts["prefix_hits"] > 0 and ts["cow_copies"] > 0
    if n_blocks:
        assert ts["preemptions"] > 0


def test_engine_refuses_what_is_not_ported(artifact):
    path, _, _ = artifact
    art = load_quantized(path, device="cpu")
    with pytest.raises(ValueError, match="card"):  # no CUDA graph step on the CPU
        ServingEngine(art.model, art.params, ServeConfig.from_spec(art.spec, cache_len=64),
                      graph=True)
    float_pools = ServingEngine(art.model, art.params, ServeConfig(cache_len=64)).scheduler.pools
    assert float_pools[0]["pages_k"].dtype == torch.bfloat16  # QuantSpec() defaults now serve
    sc = ServeConfig.from_spec(art.spec, cache_len=64)
    assert sc.kv_quant and sc.cache_dtype == "float32"
    eng = ServingEngine(art.model, art.params, sc, batch_slots=2)
    with pytest.raises(ValueError, match="exceeds"):
        eng.generate([[1] * 60], max_new_tokens=10)
