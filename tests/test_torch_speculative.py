"""PyTorch port vs JAX package: greedy speculative decoding with a W3
K-Means draft.

The target is the main-path artifact (W4A4, W8 ``mlp/wd``, dynamic
outliers, int4 KV); the draft is the same weights quantized by JAX under
``DEFAULT_DRAFT_SPEC`` (W3 with a W4 ``mlp/wi`` guard, A4, int4 draft KV)
and loaded by the port, so an 8-entry weight codebook runs through the
port's fused LUT-GEMM route (its plain version here).

* ``greedy_verify`` and the config, temperature and vocabulary gates behave
  as JAX's.
* Speculative greedy tokens equal the port's non-speculative tokens and the
  JAX speculative engine's, with the same round counters (spec rounds,
  drafted / accepted / rolled-back tokens, draft dispatches, packed steps),
  under online arrivals with prefix sharing on and off, a float pool small
  enough to preempt, and an EOS inside a verify segment. JAX counts each
  preemption twice (ROADMAP queue 3); the port once. No prompt repeats one
  token: JAX's own EOS case uses [9, 9, 9, 9], whose attention outputs are
  float sums of equal values within ulps of an A4 boundary; there XLA's and
  PyTorch's summation orders flip an index, and the two packages' greedy
  tokens differ from the first one on, with or without speculation.
* Rollback frees exactly what the allocator expects under seeded random
  speculative traffic; the draft-artifact path loads the draft with the
  port's ``load_quantized``; a draft that is the target accepts everything.
* The draft's loop of ``k + 1`` forwards launches ``k + 1`` packed steps'
  worth of GEMM dispatches per round (what a captured loop replays).
"""

import dataclasses

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
from repro.serving import speculative as jspec  # noqa: E402
from repro.serving.engine import ServeConfig as JServe  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

import repro_torch.core.kernel_routing as kr  # noqa: E402
from repro_torch.core.artifact import load_quantized  # noqa: E402
from repro_torch.core.quantspec import QuantSpec  # noqa: E402
from repro_torch.serving import speculative as tspec  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serving.speculative import (DEFAULT_DRAFT_SPEC, DraftRunner,  # noqa: E402
                                             SpeculativeConfig, greedy_verify)

MAIN_SPEC = JSpec(base=JCfg(detection="dynamic", outlier_frac=0.005),
                  rules=[("mlp/wd", {"w_bits": 8})], kv_bits=4, kv_dtype="float32")
_ROUND_KEYS = ("spec_rounds", "drafted_tokens", "accepted_tokens", "rolled_back_tokens",
               "draft_steps", "packed_steps", "decode_slot_tokens", "prefix_hits", "cow_copies")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(JAX model, target params, draft params, port target, port draft,
    draft artifact directory)."""
    cfg = j_smoke("llama3_2_1b")
    model = j_build(cfg)
    params = model.init(jax.random.PRNGKey(0))
    target = j_quantize_model(model, params, MAIN_SPEC)
    draft = j_quantize_model(model, params, jspec.DEFAULT_DRAFT_SPEC)
    t_dir, d_dir = tmp_path_factory.mktemp("target"), tmp_path_factory.mktemp("draft")
    save_quantized(t_dir, cfg, MAIN_SPEC, target)
    save_quantized(d_dir, cfg, jspec.DEFAULT_DRAFT_SPEC, draft)
    return (model, target, draft, load_quantized(str(t_dir), device="cpu"),
            load_quantized(str(d_dir), device="cpu"), str(d_dir))


def _kw(**over):
    kw = dict(cache_len=64, block_size=8, prefill_chunk=4)
    return kw | over


def test_default_draft_spec_is_jax_s():
    assert DEFAULT_DRAFT_SPEC.to_json_dict() == \
        QuantSpec.from_json_dict(jspec.DEFAULT_DRAFT_SPEC.to_json_dict()).to_json_dict()


def test_draft_artifact_is_w3_with_a_w4_wi_guard(models):
    *_, draft, _ = models
    nbits = {n: m.qw_nbits for n, m in draft.params.named_modules() if hasattr(m, "qw_nbits")}
    assert {b for n, b in nbits.items() if not n.endswith("mlp.wi")} == {3}
    assert {b for n, b in nbits.items() if n.endswith("mlp.wi")} == {4}


VERIFY_CASES = [
    ([5, 6, 7, 9], [5, 6, 7], None),  # full acceptance + the bonus token
    ([5, 8, 7, 9], [5, 6, 7], None),  # the first mismatch is the correction
    ([4, 6, 7, 9], [5, 6, 7], None),
    ([3], [], None),  # k = 0: plain decode
    ([5, 0, 7, 9], [5, 0, 7], 0),  # an accepted EOS is absorbing
    ([5, 6, 7, 0], [5, 6, 7], 0),  # EOS as the bonus token
    ([2, 2, 2], [2, 2], 2),  # EOS at the first cell
]


@pytest.mark.parametrize("targets,drafts,eos", VERIFY_CASES)
def test_greedy_verify_matches_jax(targets, drafts, eos):
    got = greedy_verify(targets, drafts, eos)
    assert got == jspec.greedy_verify(targets, drafts, eos)
    assert got[:-1] == drafts[: len(got) - 1]  # committed prefix = accepted drafts


def test_greedy_verify_random_rounds_match_jax():
    rng = np.random.RandomState(0)
    for _ in range(200):
        k = int(rng.randint(0, 5))
        drafts = [int(t) for t in rng.randint(0, 4, k)]
        targets = [int(t) for t in rng.randint(0, 4, k + 1)]
        eos = int(rng.randint(0, 4)) if rng.rand() < 0.5 else None
        assert greedy_verify(targets, drafts, eos) == jspec.greedy_verify(targets, drafts, eos)


# ---------------------------------------------------------------------------
# token identity with the non-speculative engine and with JAX
# ---------------------------------------------------------------------------

SYSTEM = [3, 1, 4, 1, 5, 9, 2, 6]  # one shared full block at block_size 8
ONLINE_PROMPTS = [SYSTEM + [40 + i, 50 + i] for i in range(3)] + \
    [[(7 * i + j) % 256 or 1 for j in range(n)] for i, n in enumerate([13, 2, 9])]
ONLINE_BUDGETS = [5, 8, 3, 6, 2, 7]


def _serve_online(sched):
    """Two requests up front, the rest arriving every other step."""
    rid_of, res = {}, {}
    for i in range(2):
        rid_of[sched.submit(ONLINE_PROMPTS[i], ONLINE_BUDGETS[i], salt=i)] = i
    nxt, steps = 2, 0
    while sched.step(res) or nxt < len(ONLINE_PROMPTS):
        steps += 1
        if nxt < len(ONLINE_PROMPTS) and steps % 2 == 0:
            rid_of[sched.submit(ONLINE_PROMPTS[nxt], ONLINE_BUDGETS[nxt], salt=nxt)] = nxt
            nxt += 1
    return [res[r] for r in sorted(rid_of, key=rid_of.get)]


# name -> (ServeConfig overrides, slots, prompts, max_new_tokens, eos: prompt, index)
CASES = {
    "online, prefix cache on": (dict(), 3, None, None, None),
    "online, prefix cache off": (dict(prefix_cache=False), 3, None, None, None),
    "float pool that preempts": (dict(cache_len=32, block_size=4, n_blocks=8,
                                      prefix_cache=False, kv_quant=False,
                                      cache_dtype="float32"), 3,
                                 [[1, 2, 3, 4, 5, 6, 7], [4, 5], [6, 9, 1], [7, 8, 9, 10]],
                                 8, None),
    "EOS inside a verify segment": (dict(), 3, [[1, 2, 3], [5, 6], [9, 2, 6, 4]], 6, (0, 1)),
}


def _engines(models, overrides, slots, spec_k):
    jmodel, jtarget, jdraft, art, dart, _ = models
    spec = None if spec_k is None else SpeculativeConfig(k=spec_k)
    jsc = None if spec_k is None else jspec.SpeculativeConfig(k=spec_k)
    port = ServingEngine(art.model, art.params,
                         ServeConfig.from_spec(art.spec, speculative=spec, **_kw(**overrides)),
                         batch_slots=slots, draft=tuple(dart))
    jax_eng = JEngine(jmodel, jtarget,
                      JServe.from_spec(MAIN_SPEC, speculative=jsc, **_kw(**overrides)),
                      batch_slots=slots, draft=(jmodel, jdraft, jspec.DEFAULT_DRAFT_SPEC))
    return port, jax_eng


@pytest.mark.parametrize("case", list(CASES))
def test_speculative_tokens_match_greedy_and_jax(models, case):
    overrides, slots, prompts, n_new, eos_at = CASES[case]
    _, _, _, art, dart, _ = models
    k = 2 if "preempts" in case else 3
    base, _ = _engines(models, overrides, slots, None)
    port, jeng = _engines(models, overrides, slots, k)
    if prompts is None:  # online arrivals
        want = _serve_online(base.scheduler)
        got = _serve_online(port.scheduler)
        jgot = _serve_online(jeng.scheduler)
    else:
        eos = None
        if eos_at is not None:  # a token each prompt's free run emits early
            free = base.generate(prompts, max_new_tokens=n_new)
            eos = free[eos_at[0]][eos_at[1]]
            base, _ = _engines(models, overrides, slots, None)
        want = base.generate(prompts, max_new_tokens=n_new, eos_id=eos)
        got = port.generate(prompts, max_new_tokens=n_new, eos_id=eos)
        jgot = jeng.generate(prompts, max_new_tokens=n_new, eos_id=eos)
        if eos is not None:
            assert any(eos in row[:-1] for row in got)
            for row in got:
                assert all(t == eos for t in row[row.index(eos):]) if eos in row else True
    assert got == want
    assert got == jgot
    ts, js = port.stats, jeng.stats
    assert {key: ts[key] for key in _ROUND_KEYS} == {key: js[key] for key in _ROUND_KEYS}
    assert js["preemptions"] == 2 * ts["preemptions"]  # JAX counts each twice
    assert ts["acceptance_rate"] == js["acceptance_rate"]
    assert ts["drafted_tokens"] == ts["accepted_tokens"] + ts["rolled_back_tokens"]
    assert ts["drafted_tokens"] > 0 and ts["spec_rounds"] > 0
    if "preempts" in case:
        assert ts["preemptions"] > 0
    if case == "online, prefix cache on":
        assert ts["prefix_hit_tokens"] > 0 and ts["rolled_back_tokens"] > 0


def test_identity_draft_accepts_everything(models):
    _, _, _, art, _, _ = models
    prompts = [[1, 2, 3, 4, 5], [6, 9], [7, 8, 9, 10]]
    sc = ServeConfig.from_spec(art.spec, **_kw())
    want = ServingEngine(art.model, art.params, sc, batch_slots=3).generate(
        prompts, max_new_tokens=8)
    eng = ServingEngine(art.model, art.params,
                        ServeConfig.from_spec(art.spec, speculative=SpeculativeConfig(k=3),
                                              **_kw()),
                        batch_slots=3, draft=(art.model, art.params))
    assert eng.generate(prompts, max_new_tokens=8) == want
    st = eng.stats
    assert st["accepted_tokens"] == st["drafted_tokens"] > 0
    assert st["rolled_back_tokens"] == 0 and st["acceptance_rate"] == 1.0
    assert st["spec_rounds"] < 8 * len(prompts)


def test_rollback_keeps_the_allocator_exact(models):
    """Seeded random speculative traffic over a small pool with prefix
    sharing: after every step each block is held by exactly ``refcount``
    running requests and free + live == pool (JAX's
    ``test_spec_rollback_frees_blocks_and_invariants``)."""
    _, _, _, art, dart, _ = models
    eng = ServingEngine(art.model, art.params,
                        ServeConfig.from_spec(art.spec, speculative=SpeculativeConfig(k=2),
                                              **_kw(cache_len=16, block_size=4, n_blocks=10,
                                                    token_budget=24)),
                        batch_slots=3, draft=tuple(dart))
    sched, alloc = eng.scheduler, eng.scheduler.allocator
    rng = np.random.RandomState(0)
    results: dict[int, list[int]] = {}
    pending = 12
    while pending or sched._running or sched._queue:
        if pending and (rng.rand() < 0.5 or not (sched._running or sched._queue)):
            tail = [int(t) for t in rng.randint(1, 200, int(rng.randint(1, 6)))]
            sched.submit(([7, 7, 7, 7] if rng.rand() < 0.6 else []) + tail,
                         int(rng.randint(1, 7)))
            pending -= 1
        if sched._running or sched._queue:
            sched.step(results)
        held = [b for r in sched._running for b in r.blocks]
        for b in range(sched.pcfg.n_blocks):
            assert alloc.refcount(b) == held.count(b), b
        assert alloc.n_free + len(set(held)) == sched.pcfg.n_blocks
    assert len(results) == 12 and sched.stats["drafted_tokens"] > 0
    assert sched.stats["rolled_back_tokens"] > 0
    assert alloc.n_free == sched.pcfg.n_blocks


def test_draft_artifact_load_path(models):
    _, _, _, art, _, d_dir = models
    prompts = [[1, 2, 3, 4], [5, 6]]
    want = ServingEngine(art.model, art.params, ServeConfig.from_spec(art.spec, **_kw()),
                         batch_slots=3).generate(prompts, max_new_tokens=5)
    eng = ServingEngine(art.model, art.params, ServeConfig.from_spec(
        art.spec, speculative=SpeculativeConfig(k=2, draft_artifact=d_dir), **_kw()),
        batch_slots=3)
    assert eng.generate(prompts, max_new_tokens=5) == want
    draft = eng.scheduler.draft
    assert eng.stats["drafted_tokens"] > 0 and eng.stats["draft_steps"] == draft.steps
    assert "pages_k_idx" in draft.pools[0]  # the draft spec's int4 pool
    assert draft.capture_s is None  # eager on the CPU


def test_draft_loop_dispatches_k_plus_one_steps(models):
    """One round of one decoding request: one catch-up step for its prompt,
    then one loop of k + 1 packed forwards (6 projections per layer each),
    which a captured loop replays as one graph."""
    _, _, _, art, dart, _ = models
    k = 3
    runner = DraftRunner(dart.model, dart.params, slots=2, cache_len=32, k=k, block_size=8,
                         kv_quant=True, token_budget=8)
    kr.reset()
    drafts = runner.propose([(0, 1, [5, 6, 7], 8, k)])
    per_step = 6 * art.model.cfg.n_layers
    assert kr.kernel_calls() + kr.jnp_calls() == per_step * (1 + k + 1)
    assert runner.steps == 2 and runner.pos == [0, 3 + k + 1]
    assert len(drafts[0]) == k and all(0 <= t < 256 for t in drafts[0])
    runner.sync(1, 4)
    assert runner.pos[1] == 4
    runner.reset(1)
    assert runner.pos[1] == 0


def test_gates(models):
    _, _, _, art, dart, _ = models
    with pytest.raises(ValueError, match="k must be >= 1"):
        SpeculativeConfig(k=0)
    mk = lambda draft=tuple(dart), **kw: ServingEngine(
        art.model, art.params, ServeConfig.from_spec(
            art.spec, speculative=SpeculativeConfig(k=2), **_kw(**kw)),
        batch_slots=3, draft=draft)
    with pytest.raises(ValueError, match="draft"):
        mk(draft=None)
    with pytest.raises(ValueError, match="token_budget"):
        mk(token_budget=6)  # 6 rows < 3 slots x (k + 1)
    with pytest.raises(NotImplementedError, match="rejection-sampling"):
        mk(temperature=1.0)
    with pytest.raises(NotImplementedError, match="rejection-sampling"):
        tspec.rejection_sample()

    from repro_torch.configs.base import get_smoke_config
    from repro_torch.models.model import build

    rec = build(get_smoke_config("falcon_mamba_7b"))  # recurrent drafts are served
    runner = DraftRunner(rec, rec.init(seed=0, device="cpu"), slots=2, cache_len=16, k=2)
    assert {p.kind for p in rec.cache_policies()} == {"recurrent"}
    assert [tuple(t.shape) for t in runner._catch_in.dev] == [(2,), (2, 32), (2,), (2, 32)]

    class OtherVocab:
        cfg = dataclasses.replace(dart.model.cfg, vocab_size=128)

    with pytest.raises(ValueError, match="vocab"):
        mk(draft=(OtherVocab(), dart.params))
    assert mk().scheduler.rows == 3 * 3  # slots x (k + 1) rows, above 3 + prefill_chunk
