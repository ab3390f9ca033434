"""PyTorch port vs JAX package: serving the recurrent families
(falcon_mamba_7b, recurrentgemma_2b) through the ``recurrent`` cache policy.

The port's versions of ``tests/test_cache_policies.py``'s recurrent cases,
each also held against the JAX engine on the same numpy weights:

* the state helpers (``zero_state_slot``, ``restore_state_slot``,
  ``split_step_extras``) write what JAX's functional versions return;
* the paged scheduler, float and int4 state: greedy tokens equal JAX's
  paged engine's and the ring's, with JAX's packed-step, decode and
  prefill counters; recurrent layers hold no blocks and prefix sharing is
  off; a slot's prefill spans one row per step (``seg_width`` 3);
* preemption of the hybrid stack under a small pool replays from a zeroed
  state slot: tokens equal the ring's;
* the fixed-slot engine equals JAX's, also on prompts of unequal length,
  whose left padding enters the state in both packages (reproduced, not
  repaired);
* ``k=3`` speculation with a W3 draft of the same weights, quantized by JAX
  under ``DEFAULT_DRAFT_SPEC`` and loaded by the port: tokens equal JAX's
  speculative engine's and the port's non-speculative tokens, round
  counters equal JAX's, and partly accepted rounds ran the corrective
  commit; the engine widens ``seg_width`` to ``k + 1``;
* telemetry: the ``metrics`` counters, and at ``quality`` the probed step
  (whose probe forward restores the state it advanced) gives the tokens of
  the unprobed engine with a probe site per quantized projection.

Greedy tokens are compared exactly; on these seeded prompts no near-tied
logit flips a token, and one that did would fail here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke_config as j_smoke  # noqa: E402
from repro.core import quantize_model as j_quantize_model  # noqa: E402
from repro.core import save_quantized  # noqa: E402
from repro.models.model import build as j_build  # noqa: E402
from repro.serving import paged_cache as jpc  # noqa: E402
from repro.serving import speculative as jspec  # noqa: E402
from repro.serving.engine import ServeConfig as JServe  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

from repro_torch.configs.base import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core.artifact import load_quantized  # noqa: E402
from repro_torch.models.model import build, params_from_numpy  # noqa: E402
from repro_torch.serving import paged_cache as tpc  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import Scheduler  # noqa: E402
from repro_torch.serving.speculative import SpeculativeConfig  # noqa: E402

ARCHS = ["falcon_mamba_7b", "recurrentgemma_2b"]
_COUNTERS = ("packed_steps", "decode_steps", "prefill_tokens", "peak_live_blocks_per_seq")
_ROUNDS = ("spec_rounds", "drafted_tokens", "accepted_tokens", "rolled_back_tokens",
           "draft_steps", "packed_steps")


@pytest.fixture(scope="module", params=ARCHS)
def lm(request, tmp_path_factory):
    """(JAX model, JAX params, port model, port params, JAX W3 draft params,
    port draft artifact) for one arch."""
    arch = request.param
    jm = j_build(j_smoke(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), t_smoke(arch), device="cpu")
    jdraft = j_quantize_model(jm, jp, jspec.DEFAULT_DRAFT_SPEC)
    d = tmp_path_factory.mktemp(f"{arch}_draft")
    save_quantized(d, jm.cfg, jspec.DEFAULT_DRAFT_SPEC, jdraft)
    return jm, jp, build(t_smoke(arch)), params, jdraft, load_quantized(str(d), device="cpu")


def _prompts(cfg, n=3, length=11, lengths=None):
    rng = np.random.RandomState(0)
    lengths = lengths or [length] * n
    return [[int(t) for t in rng.randint(1, cfg.vocab_size, size=m)] for m in lengths]


def _ring(model, params, prompts, new, kv_quant=False):
    sc = ServeConfig(cache_len=96, cache_dtype="float32", kv_quant=kv_quant, paged=False)
    return ServingEngine(model, params, sc, batch_slots=len(prompts)).generate(prompts, new)


def test_state_helpers_match_jax():
    """On a hybrid pool list (a state layer, a paged layer): zeroing,
    restoring a slot and splitting the transients give JAX's trees; the
    release horizon ignores recurrent layers."""
    rng = np.random.RandomState(1)
    layers = [{"h": rng.randn(3, 4).astype(np.float32),
               "conv": rng.randn(3, 2, 4).astype(np.float32)},
              {"pages_k": rng.randn(2, 4, 1, 2).astype(np.float32)}]
    snap = [{k: (v + 1).astype(np.float32) for k, v in layer.items()} for layer in layers]
    torch_pools = lambda trees: [{k: torch.from_numpy(v.copy()) for k, v in t.items()}
                                 for t in trees]
    jax_pools = lambda trees: [{k: jnp.asarray(v) for k, v in t.items()} for t in trees]
    same = lambda t, j: all(np.array_equal(a[k].numpy(), np.asarray(b[k]))
                            for a, b in zip(t, j) for k in b)
    assert same(tpc.zero_state_slot(torch_pools(layers), 1),
                jpc.zero_state_slot(jax_pools(layers), 1))
    assert same(tpc.restore_state_slot(torch_pools(layers), torch_pools(snap), 2),
                jpc.restore_state_slot(jax_pools(layers), jax_pools(snap), 2))
    assert tpc.snapshot_state(torch_pools(layers))[1] == {}
    steps = [layers[0] | {"h_steps": np.ones((2, 3, 4), np.float32)}, layers[1]]
    tp, te = tpc.split_step_extras(torch_pools(steps))
    jp_, je = jpc.split_step_extras(jax_pools(steps))
    assert [set(x) for x in tp] == [set(x) for x in jp_]
    assert [set(x) for x in te] == [set(x) for x in je] == [{"h_steps"}, set()]
    for kinds in ([("recurrent", 0)], [("recurrent", 0), ("windowed_paged", 16)],
                  [("recurrent", 0), ("paged_kv", 0)]):
        assert tpc.release_horizon([tpc.CachePolicy(k, w) for k, w in kinds]) == \
            jpc.release_horizon([jpc.CachePolicy(k, w) for k, w in kinds])


@pytest.mark.parametrize("kv_quant", [False, True])
def test_paged_matches_jax_and_ring(lm, kv_quant):
    """3 prompts on 2 slots (queueing): the port's paged tokens equal JAX's
    paged engine's and the port's ring's, with JAX's counters; no blocks for
    a pure recurrent stack, the window's cap for the hybrid; prefix sharing
    is off on a stack that is not all ``paged_kv``."""
    jm, jp, model, params = lm[:4]
    prompts = _prompts(jm.cfg)
    kw = dict(cache_len=96, cache_dtype="float32", kv_quant=kv_quant, prefix_cache=True)
    jeng = JEngine(jm, jp, JServe(**kw), batch_slots=2)
    want = jeng.generate(prompts, 20)
    eng = ServingEngine(model, params, ServeConfig(**kw), batch_slots=2)
    assert eng.generate(prompts, 20) == want == _ring(model, params, prompts, 20, kv_quant)
    for key in _COUNTERS:
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.scheduler.allocator.prefix_cache is False
    if jm.cfg.family == "ssm":
        assert eng.stats["peak_live_blocks_per_seq"] == 0
        assert eng.scheduler.allocator.blocks_allocated == 0
    else:
        assert eng.stats["peak_live_blocks_per_seq"] <= tpc.windowed_block_cap(16, 16)


def test_segment_rows_and_preemption(lm):
    """``seg_width`` 3: a slot's prefill takes one 3-token row per step, as
    in JAX (equal packed-step counts), tokens equal the ring's. The hybrid
    on a 5-block pool preempts; the restart zeroes the slot's state and the
    tokens still equal the ring's."""
    jm, jp, model, params = lm[:4]
    prompts = _prompts(jm.cfg)
    ref = _ring(model, params, prompts, 16)
    kw = dict(cache_len=96, cache_dtype="float32", seg_width=3)
    eng = ServingEngine(model, params, ServeConfig(**kw), batch_slots=2)
    assert eng.generate(prompts, 16) == ref
    jeng = JEngine(jm, jp, JServe(**kw), batch_slots=2)
    jeng.generate(prompts, 16)
    assert eng.stats["packed_steps"] == jeng.stats["packed_steps"]
    if jm.cfg.family == "hybrid":
        eng = ServingEngine(model, params, ServeConfig(cache_len=96, cache_dtype="float32",
                                                       n_blocks=5, prefix_cache=False),
                            batch_slots=3)
        assert eng.generate(prompts, 24) == _ring(model, params, prompts, 24)
        assert eng.stats["preemptions"] > 0, "the pool was meant to force preemption"


def test_fixed_slot_engine_matches_jax(lm):
    """The fixed-slot engine with int4 state on prompts of 5-13 tokens:
    equal to JAX's tokens, left-pad pollution of the state included."""
    jm, jp, model, params = lm[:4]
    prompts = _prompts(jm.cfg, lengths=[13, 5, 9])
    kw = dict(cache_len=96, cache_dtype="float32", kv_quant=True, paged=False)
    want = JEngine(jm, jp, JServe(**kw), batch_slots=3).generate(prompts, 12)
    eng = ServingEngine(model, params, ServeConfig(**kw), batch_slots=3)
    assert eng.generate(prompts, 12) == want
    assert eng.generate(prompts, 12) == want  # the reused ring's state was zeroed


def test_speculative_matches_jax(lm):
    """``k=3`` with a W3 draft (int4 draft state): tokens equal JAX's
    speculative engine's and the non-speculative tokens, round counters equal
    JAX's; some rounds accept part of the drafts, and each of those runs the
    corrective commit at the last consumed cell."""
    jm, jp, model, params, jdraft, dart = lm
    prompts = _prompts(jm.cfg)
    kw = dict(cache_len=96, cache_dtype="float32", kv_quant=True)
    ref = ServingEngine(model, params, ServeConfig(**kw), batch_slots=3).generate(prompts, 16)
    jeng = JEngine(jm, jp, JServe(speculative=jspec.SpeculativeConfig(k=3), **kw),
                   batch_slots=3, draft=(jm, jdraft, jspec.DEFAULT_DRAFT_SPEC))
    want = jeng.generate(prompts, 16)
    eng = ServingEngine(model, params, ServeConfig(speculative=SpeculativeConfig(k=3), **kw),
                        batch_slots=3, draft=tuple(dart))
    assert eng.sc.seg_width == 4
    commits = []
    inner = eng.scheduler._commit_state
    eng.scheduler._commit_state = lambda *a: (commits.append(a[-1]), inner(*a))[1]
    assert eng.generate(prompts, 16) == want == ref
    st, jst = eng.stats, jeng.stats
    for key in _ROUNDS:
        assert st[key] == jst[key], key
    assert 0 < st["accepted_tokens"] < st["drafted_tokens"]
    assert any(0 < c < 3 for c in commits), commits  # partly accepted rounds


def test_gates(lm):
    """A recurrent verify segment wider than one row is refused by the
    scheduler (the engine widens it instead); ``telemetry="metrics"``
    counts."""
    jm, jp, model, params, _, dart = lm
    sc = ServeConfig(cache_len=96, cache_dtype="float32", seg_width=2,
                     speculative=SpeculativeConfig(k=3))
    with pytest.raises(ValueError, match="one grid row"):
        Scheduler(model, params, sc, slots=2, draft=tuple(dart))
    eng = ServingEngine(model, params, sc, batch_slots=2, draft=tuple(dart))
    assert eng.sc.seg_width == 4
    eng.generate(_prompts(jm.cfg, n=2), 6)
    snap = eng.snapshot()
    assert snap["counters"]["serving_packed_steps"] == eng.stats["packed_steps"] > 0


def test_quality_probes_restore_the_state(lm):
    """At ``quality`` every step is probed: the probe forward rewrites the
    recurrent state from the state the step found, so the tokens equal the
    ``metrics`` engine's, with one probe site per quantized projection of
    the family."""
    from repro_torch.serving.telemetry import TelemetryConfig

    jm, _, _, _, _, dart = lm
    prompts = _prompts(jm.cfg, n=2)
    kw = dict(cache_len=96, cache_dtype="float32", kv_quant=True)
    want = ServingEngine(dart.model, dart.params, ServeConfig(**kw),
                         batch_slots=2).generate(prompts, 8)
    tel = TelemetryConfig(level="quality", quality_sample_every=1, quality_shadow_every=1000)
    eng = ServingEngine(dart.model, dart.params, ServeConfig(telemetry=tel, **kw),
                        batch_slots=2)
    seen = []
    ingest = eng.scheduler._quality.ingest
    eng.scheduler._quality.ingest = lambda d: (seen.append(d), ingest(d))[1]
    assert eng.generate(prompts, 8) == want
    assert len(seen) == eng.stats["packed_steps"]
    taps = {k.split("/")[0].split(".", 1)[1] for k in seen[0]}
    assert taps == ({"mamba.in_proj", "mamba.x_proj", "mamba.dt_proj", "mamba.out_proj"}
                    if jm.cfg.family == "ssm" else
                    {"rec.lin_y", "rec.lin_x", "rglru.wa", "rglru.wx", "rec.lin_out",
                     "attn.q", "attn.k", "attn.v", "attn.o", "mlp.wi", "mlp.wd"})
