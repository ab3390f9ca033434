"""PyTorch port vs JAX package: sliding-window serving (h2o_danube_1_8b).

The port's versions of ``tests/test_cache_policies.py``'s h2o-danube cases:
the ``windowed_paged`` policy and its helpers, paged tokens against the
ring's (and JAX's ring's) greedy tokens, preemption and speculative
identity with and without a starved pool, freed out-of-window blocks
reused under a pool smaller than the unreleased demand, and prefix sharing
off under a windowed policy. Past the window the ring is no exact
reference (its one-shot prefill overwrites keys the window still sees), so
prompts longer than the smoke window (16) are held against JAX's paged
engine instead, on float pages and on the int4 pool of a JAX-saved
artifact. Tokens are compared exactly; on these seeded prompts no
near-tied logit flips a greedy token, and one that did would fail here.
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

from repro_torch.configs.base import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core.artifact import load_quantized  # noqa: E402
from repro_torch.models.model import build, params_from_numpy  # noqa: E402
from repro_torch.serving import paged_cache as tpc  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402
from repro_torch.serving.speculative import SpeculativeConfig  # noqa: E402

ARCH = "h2o_danube_1_8b"
MAIN_SPEC = JSpec(base=JCfg(detection="dynamic", outlier_frac=0.005),
                  rules=[("mlp/wd", {"w_bits": 8})], kv_bits=4, kv_dtype="float32")


@pytest.fixture(scope="module")
def lm():
    cfg = j_smoke(ARCH)
    jm = j_build(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    model = build(t_smoke(ARCH))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), t_smoke(ARCH), device="cpu")
    return cfg, jm, jp, model, params


def _prompts(cfg, n=3, length=11):
    """Equal-length prompts no longer than the window: the ring is exact there."""
    rng = np.random.RandomState(0)
    return [[int(t) for t in rng.randint(1, cfg.vocab_size, size=length)] for _ in range(n)]


def _ring(model, params, prompts, new):
    sc = ServeConfig(cache_len=96, cache_dtype="float32", paged=False)
    return ServingEngine(model, params, sc, batch_slots=len(prompts)).generate(prompts, new)


def test_cache_policies_and_helpers():
    """Danube's layers are all ``windowed_paged`` at its window, the dense
    configs' all ``paged_kv``; the helpers give JAX's horizon and cap."""
    for arch, want in (("h2o_danube_1_8b", {"windowed_paged"}), ("oasis_7b", {"paged_kv"}),
                       ("nemotron_4_15b", {"paged_kv"}), ("granite_moe_3b_a800m",
                                                          {"paged_kv"})):
        cfg = t_smoke(arch)
        policies = build(cfg).cache_policies()
        assert len(policies) == cfg.n_layers and {p.kind for p in policies} == want
        jpol = j_build(j_smoke(arch)).cache_policies()
        assert [(p.kind, p.window) for p in policies] == [(p.kind, p.window) for p in jpol]
    assert build(t_smoke(ARCH)).cache_policies()[0].window == 16
    for kinds in ([("paged_kv", 0)], [("windowed_paged", 16)],
                  [("paged_kv", 0), ("windowed_paged", 16)],
                  [("windowed_paged", 16), ("windowed_paged", 5)], [("recurrent", 0)]):
        got = tpc.release_horizon([tpc.CachePolicy(k, w) for k, w in kinds])
        assert got == jpc.release_horizon([jpc.CachePolicy(k, w) for k, w in kinds])
    for w, bs in ((16, 16), (17, 16), (4096, 16), (100, 8)):
        assert tpc.windowed_block_cap(w, bs) == jpc.windowed_block_cap(w, bs)
    assert tpc.windowed_block_cap(4096, 16) == 257
    with pytest.raises(ValueError, match="window"):
        tpc.CachePolicy("windowed_paged")


def test_paged_matches_ring_greedy(lm):
    cfg, jm, jp, model, params = lm
    prompts = _prompts(cfg)
    ref = _ring(model, params, prompts, 24)
    jring = JEngine(jm, jp, JServe(cache_len=96, cache_dtype="float32", quantized=False,
                                   paged=False), batch_slots=3).generate(prompts, 24)
    assert ref == jring
    eng = ServingEngine(model, params, ServeConfig(cache_len=96, cache_dtype="float32"),
                        batch_slots=2)  # 3 prompts > 2 slots: queueing too
    assert eng.generate(prompts, 24) == ref
    assert eng.stats["peak_live_blocks_per_seq"] <= tpc.windowed_block_cap(16, 16)


def test_paged_preemption_identity(lm):
    """A pool that forces preemption mid-decode: the restart re-prefills the
    committed tokens and the output is unchanged."""
    cfg, _, _, model, params = lm
    prompts = _prompts(cfg)
    ref = _ring(model, params, prompts, 24)
    eng = ServingEngine(model, params, ServeConfig(cache_len=96, cache_dtype="float32",
                                                   n_blocks=5, prefix_cache=False),
                        batch_slots=3)
    assert eng.generate(prompts, 24) == ref
    assert eng.stats["preemptions"] > 0, "the pool was meant to force preemption"


def test_paged_speculative_identity(lm):
    """Danube as its own draft (a windowed draft), with and without a starved
    pool: greedy speculative tokens equal the ring's."""
    cfg, _, _, model, params = lm
    prompts = _prompts(cfg)
    ref = _ring(model, params, prompts, 24)
    for extra in ({}, {"n_blocks": 5, "prefix_cache": False}):
        eng = ServingEngine(model, params,
                            ServeConfig(cache_len=96, cache_dtype="float32",
                                        speculative=SpeculativeConfig(k=3), **extra),
                            batch_slots=3, draft=(model, params))
        assert eng.generate(prompts, 24) == ref, extra
        assert eng.stats["spec_rounds"] > 0


def test_windowed_freed_blocks_are_reused(lm):
    """Decode to three windows with a pool smaller than the unreleased
    demand: zero preemptions, so the out-of-window blocks really return to
    the allocator, and no request ever holds more than the cap."""
    cfg, _, _, model, params = lm
    prompts = _prompts(cfg, n=2, length=8)
    new = cfg.sliding_window * 3
    ref = _ring(model, params, prompts, new)
    cap = tpc.windowed_block_cap(cfg.sliding_window, 16)
    sc = ServeConfig(cache_len=128, cache_dtype="float32", n_blocks=2 * cap + 1,
                     prefix_cache=False)
    assert 2 * tpc.blocks_needed(8 + new, 16) > sc.n_blocks  # unreleased demand
    eng = ServingEngine(model, params, sc, batch_slots=2)
    assert eng.generate(prompts, new) == ref
    st = eng.stats
    assert st["preemptions"] == 0
    assert st["peak_live_blocks_per_seq"] <= cap
    assert eng.scheduler.allocator.blocks_freed > 0


def test_release_leaves_holes_in_the_logical_table(lm):
    """Mid-decode, a request past the window holds -1 holes at the front of
    its table (position p stays at table[p // bs]); its live blocks stay
    under the cap; the packed step's table buffer carries the holes as they
    are; finishing frees only live blocks (the pool is whole again)."""
    cfg, _, _, model, params = lm
    sc = ServeConfig(cache_len=128, cache_dtype="float32", block_size=4, prefill_chunk=8,
                     prefix_cache=True)
    sched = Scheduler(model, params, sc, slots=2)
    assert sched.release_window == 16 and not sched.allocator.prefix_cache
    prompt = _prompts(cfg, n=1, length=30)[0]
    sched.submit(prompt, 20)
    results = {}
    for _ in range(12):
        sched.step(results)
    r = sched._running[0]
    assert r.decoding and r.blocks[:3] == [-1, -1, -1]
    live = [b for b in r.blocks if b >= 0]
    assert 0 < len(live) <= tpc.windowed_block_cap(16, 4)
    assert (r.prefilled - 16 + 1) // 4 == r.blocks.count(-1)
    # the last step's table (filled before this step's release freed more)
    bt = [int(b) for b in sched._in.arrays()[0][r.slot, : len(r.blocks)]]
    assert bt[0] == -1 and all(b == t or t == -1 for b, t in zip(bt, r.blocks))
    sched.run()
    assert sched.allocator.n_free == sched.pcfg.n_blocks


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    cfg = j_smoke(ARCH)
    jm = j_build(cfg)
    qp = j_quantize_model(jm, jm.init(jax.random.PRNGKey(1)), MAIN_SPEC)
    d = tmp_path_factory.mktemp("swa_artifact")
    save_quantized(d, cfg, MAIN_SPEC, qp)
    return str(d), jm, qp


def _long_prompts(vocab):
    rng = np.random.RandomState(5)
    return [[int(t) for t in rng.randint(0, vocab, n)] for n in (40, 23, 57, 18, 31)]


@pytest.mark.parametrize("pool", ["float", "int4 artifact"])
def test_long_prompts_match_jax_paged_engine(lm, artifact, pool):
    """Prompts of 18-57 tokens, past the window of 16, through JAX's paged
    engine and the port's with a pool that preempts: equal tokens and
    equal packed-step, decode, prefill and live-block counters."""
    kw = dict(cache_len=96, block_size=8, prefill_chunk=8, n_blocks=20)
    if pool == "float":
        cfg, jm, jp, model, params = lm
        jsc, sc = JServe(cache_dtype="float32", **kw), ServeConfig(cache_dtype="float32", **kw)
    else:
        path, jm, jp = artifact
        art = load_quantized(path, device="cpu")
        cfg, model, params = jm.cfg, art.model, art.params
        jsc, sc = JServe.from_spec(MAIN_SPEC, **kw), ServeConfig.from_spec(art.spec, **kw)
    prompts = _long_prompts(cfg.vocab_size)
    budgets = [12, 20, 8, 16, 10]
    jeng = JEngine(jm, jp, jsc, batch_slots=3)
    want = jeng.generate(prompts, max_new_tokens=budgets)
    eng = ServingEngine(model, params, sc, batch_slots=3)
    got = eng.generate(prompts, max_new_tokens=budgets)
    assert got == want
    js, ts = jeng.stats, eng.stats
    for key in ("packed_steps", "decode_steps", "prefill_tokens",
                "peak_live_blocks_per_seq"):
        assert ts[key] == js[key], key
    assert js["preemptions"] == 2 * ts["preemptions"]  # JAX counts each twice
    assert ts["peak_live_blocks_per_seq"] <= tpc.blocks_needed(57 + 1, 8)
