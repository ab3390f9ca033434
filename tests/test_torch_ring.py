"""PyTorch port vs JAX package: the no-cache and ring attention dispatch,
the ring-buffer KV cache and the fixed-slot engine (``paged=False``).

* ``_sdpa_flash`` (online softmax over query and key chunks) against JAX's,
  with a padded tail chunk, a window, a softcap and a per-row ``k_min``;
  ``_attn_dispatch`` takes it past 2048^2 scores when ``attn_chunk`` is set
  and the dense softmax below. Both are float32 sums in other orders than
  XLA's: 2e-6 of the largest |v| is asserted, and the dispatch is bit-equal
  to the route it picks.
* ``_cache_write`` / ``_cache_read``: slots, ``slot_pos`` and the stored
  values equal JAX's bit for bit (float and int4, a ring-aligned multi-token
  write, the ``n_w == C`` overwrite, decode past ``cache_len``). The K/V
  values lie on a 1/4 grid, so every per-token RMS is exact in any order.
* The fixed-slot engine's greedy tokens equal the JAX engine's on the same
  artifact (left-padded mixed batches, int4 and float rings, EOS), its
  counters equal JAX's, batched equals single on the float ring, ring
  equals paged on unpadded prompts, and decode past ``cache_len`` follows
  JAX's ring (logits within 1e-5 of their range, the same tokens). The trained
  fixture served one prompt per batch on the ring gives ``expected.npz``'s
  tokens in both packages.
* The ring decode step reads no tensor on the host (the guard of capture on
  the CPU).
"""

import dataclasses
import json
import pathlib

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
from repro.core.artifact import load_quantized as j_load  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.model import build as j_build  # noqa: E402
from repro.serving.engine import ServeConfig as JServe  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.core.artifact import load_quantized  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServingEngine, make_serve_step  # noqa: E402
from repro_torch.serving.speculative import SpeculativeConfig  # noqa: E402
from test_torch_graph_step import _Recorder  # noqa: E402  (the packed step's guard)

MAIN_SPEC = JSpec(base=JCfg(detection="dynamic", outlier_frac=0.005),
                  rules=[("mlp/wd", {"w_bits": 8})], kv_bits=4, kv_dtype="float32")
FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "trained_oasis_smoke"


# ---------------------------------------------------------------------------
# attention: the flash loop and the dispatch
# ---------------------------------------------------------------------------

def _qkv(seed, b, sq, sk, kv=2, g=2, hd=8):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, kv, g, hd).astype(np.float32)
    k = rng.randn(b, sk, kv, hd).astype(np.float32)
    v = rng.randn(b, sk, kv, hd).astype(np.float32)
    return q, k, v


def _close(got: torch.Tensor, want, v):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6 * np.abs(v).max())


# (Sq, Sk, q_chunk, k_chunk, window, softcap, causal, k_min)
FLASH_CASES = [
    (16, 16, 8, 8, 0, 0.0, True, None),          # whole chunks
    (13, 21, 5, 8, 0, 0.0, True, None),          # padded tail chunks on both axes
    (20, 20, 8, 6, 7, 0.0, True, None),          # a window
    (17, 17, 6, 6, 0, 30.0, True, None),         # a softcap
    (11, 19, 4, 5, 4, 20.0, True, [0, 6]),       # window, softcap and k_min
    (9, 14, 4, 4, 0, 0.0, False, None),          # not causal
]


@pytest.mark.parametrize("sq,sk,qc,kc,window,softcap,causal,k_min", FLASH_CASES)
def test_sdpa_flash_matches_jax(sq, sk, qc, kc, window, softcap, causal, k_min):
    q, k, v = _qkv(sq * 31 + sk, 2, sq, sk)
    q_pos = np.arange(sk - sq, sk, dtype=np.int32)  # queries at the end of the keys
    k_pos = np.arange(sk, dtype=np.int32)
    k_pos[3] = -1  # an empty slot
    km = None if k_min is None else np.asarray(k_min, np.int32)
    want = JL._sdpa_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(q_pos),
                          jnp.asarray(k_pos), window, causal, softcap, qc, kc,
                          k_min=None if km is None else jnp.asarray(km))
    t = torch.from_numpy
    got = L._sdpa_flash(t(q), t(k), t(v), t(q_pos), t(k_pos), window, causal, softcap, qc, kc,
                        k_min=None if km is None else t(km))
    assert got.shape == (2, sq, 2, 2, 8)
    _close(got, want, v)
    dense = L._sdpa_dense(t(q), t(k), t(v), t(q_pos), t(k_pos), window, causal, softcap,
                          k_min=None if km is None else t(km))
    _close(got, dense.numpy(), v)


@pytest.mark.parametrize("sq,attn_chunk,route", [(2049, 1024, "flash"), (2049, 0, "dense"),
                                                 (2048, 1024, "dense")])
def test_attn_dispatch_matches_jax(sq, attn_chunk, route):
    """Past 2048^2 scores with ``attn_chunk`` set the dispatch is the flash
    loop (bit-equal to calling it), else the dense softmax; either within
    tolerance of JAX's dispatch."""
    q, k, v = _qkv(sq, 1, sq, sq, kv=1, g=1, hd=8)
    pos = np.arange(sq, dtype=np.int32)
    cfg = dataclasses.replace(get_smoke_config("llama3_2_1b"), attn_chunk=attn_chunk)
    jcfg = dataclasses.replace(j_smoke("llama3_2_1b"), attn_chunk=attn_chunk)
    want = JL._attn_dispatch(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                             jnp.asarray(pos), 0, True, 0.0, jcfg)
    args = [torch.from_numpy(a) for a in (q, k, v, pos, pos)]
    got = L._attn_dispatch(*args, 0, True, 0.0, cfg)
    _close(got, want, v)
    if route == "flash":
        same = L._sdpa_flash(*args, 0, True, 0.0, attn_chunk, attn_chunk)
    else:
        same = L._sdpa_dense(*args, 0, True, 0.0)
    assert torch.equal(got, same)


def test_no_cache_forward_takes_the_flash_loop_like_jax():
    """The model's no-cache forward past 2048 tokens with ``attn_chunk``:
    logits within the model tests' tolerance (1e-5 of the range) of JAX's."""
    jcfg = dataclasses.replace(j_smoke("llama3_2_1b"), attn_chunk=1024, n_layers=1)
    jm = j_build(jcfg)
    params = jm.init(jax.random.PRNGKey(2))
    toks = np.random.RandomState(3).randint(0, jcfg.vocab_size, (1, 2050)).astype(np.int32)
    want = np.asarray(jm.apply(params, {"tokens": jnp.asarray(toks)}).logits)
    from repro_torch.models.model import build

    cfg = dataclasses.replace(get_smoke_config("llama3_2_1b"), attn_chunk=1024, n_layers=1)
    model = build(cfg)
    port = params_from_numpy(jax.tree.map(np.asarray, params), cfg, device="cpu")
    got = model.apply(port, {"tokens": torch.from_numpy(toks)}).logits
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the ring cache
# ---------------------------------------------------------------------------

def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _grid_kv(seed, b, s, kv, hd):
    """K/V on a 1/4 grid: every per-token RMS is exact in any summation order."""
    rng = np.random.RandomState(seed)
    return [(rng.randint(-8, 9, (b, s, kv, hd)) / 4).astype(np.float32) for _ in range(2)]


# (cache_len, writes as (start position, tokens)): prefill then decodes
RING_CASES = {
    "aligned prefill + decodes": (8, [(0, 5), (5, 1), (6, 1)]),
    "prefill fills the ring": (8, [(0, 8), (8, 1)]),
    "n_w == C roll": (8, [(3, 8)]),
    "prefill longer than the ring": (6, [(0, 10), (10, 1)]),
    "decode past cache_len": (5, [(0, 3)] + [(p, 1) for p in range(3, 13)]),
}


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("case", list(RING_CASES))
def test_cache_write_and_read_equal_jax(case, quantized):
    cfg = get_smoke_config("llama3_2_1b")
    c, writes = RING_CASES[case]
    kv, hd, b = cfg.n_kv_heads, cfg.head_dim, 2
    jc = JL.init_kv_cache(j_smoke("llama3_2_1b"), b, c, jnp.float32, quantized=quantized)
    tc = L.init_kv_cache(cfg, b, c, torch.float32, quantized=quantized)
    for i, (start, n) in enumerate(writes):
        k, v = _grid_kv(i, b, n, kv, hd)
        pos = np.arange(start, start + n, dtype=np.int32)
        jc = JL._cache_write(jc, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos))
        same = L._cache_write(tc, torch.from_numpy(k), torch.from_numpy(v),
                              torch.from_numpy(pos))
        assert same is tc  # written in place
        for key in tc:
            assert np.array_equal(_bits(tc[key]), _bits(jc[key])), (case, i, key)
    for got, want in zip(L._cache_read(tc, torch.float32), JL._cache_read(jc, jnp.float32)):
        assert np.array_equal(_bits(got), _bits(want))


def test_init_caches_layouts():
    from repro_torch.models import transformer

    cfg = get_smoke_config("llama3_2_1b")
    ring = transformer.init_caches(cfg, 3, 20, "float32")
    assert set(ring[0]) == {"slot_pos", "k", "v"} and ring[0]["k"].shape == (3, 20, 2, 16)
    quant = transformer.init_caches(cfg, 3, 20, quantized=True)
    assert quant[0]["k_idx"].shape == (3, 20, 2, 8) and quant[0]["kv_codebook"].shape == (16,)
    paged = transformer.init_caches(cfg, 3, 20, layout="paged", block_size=8)
    assert paged[0]["pages_k"].shape == (9, 8, 2, 16)
    swa = transformer.init_caches(dataclasses.replace(cfg, sliding_window=7), 1, 20)
    assert swa[0]["slot_pos"].shape == (7,)  # the ring clamps to the window, as JAX's
    with pytest.raises(ValueError, match="layout"):
        transformer.init_caches(cfg, 1, 8, layout="pages")


# ---------------------------------------------------------------------------
# the fixed-slot engine against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    cfg = j_smoke("llama3_2_1b")
    model = j_build(cfg)
    qp = j_quantize_model(model, model.init(jax.random.PRNGKey(0)), MAIN_SPEC)
    d = tmp_path_factory.mktemp("artifact")
    save_quantized(d, cfg, MAIN_SPEC, qp)
    return model, qp, load_quantized(str(d), device="cpu")


PROMPTS = [[1, 2, 3, 4, 5, 6, 7], [4, 5], [6], [7, 8, 9, 10], [11, 12, 13, 14, 15]]
_FALLBACK_KEYS = ("prefills", "steps", "tokens", "prompt_tokens", "pad_tokens", "pad_fraction")


@pytest.mark.parametrize("kv_quant", [True, False])
def test_fixed_slot_engine_matches_jax(artifact, kv_quant):
    """Two left-padded batches (4 + 1 prompts of 1-7 tokens): the JAX
    engine's tokens and counters. On the float ring, batched equals single in
    the port too (the check of JAX's ``test_fallback_padding_not_attended``).
    Not on the int4 ring, in either package: the left pad moves a short
    prompt's RoPE positions, and the rotated keys quantize to other indices
    (on this artifact the JAX engine's batched tokens differ from its single
    ones for two of the five prompts)."""
    jmodel, jparams, art = artifact
    kw = dict(cache_len=32, cache_dtype="float32", kv_quant=kv_quant, paged=False)
    jeng = JEngine(jmodel, jparams, JServe(**kw), batch_slots=4)
    want = jeng.generate(PROMPTS, max_new_tokens=6)
    eng = ServingEngine(art.model, art.params, ServeConfig(**kw), batch_slots=4)
    assert eng.scheduler is None and not eng.paged
    got = eng.generate(PROMPTS, max_new_tokens=6)
    assert got == want
    assert {k: eng.stats[k] for k in _FALLBACK_KEYS} == {k: jeng.stats[k] for k in _FALLBACK_KEYS}
    assert eng.stats["pad_tokens"] > 0 and eng.stats["graph_capture_s"] is None
    if not kv_quant:
        assert [eng.generate([p], max_new_tokens=6)[0] for p in PROMPTS] == got


@pytest.mark.parametrize("kv_quant", [True, False])
def test_ring_equals_paged_on_unpadded_prompts(artifact, kv_quant):
    """One prompt per batch on the ring equals the paged scheduler on all of
    them at once (JAX's ``test_paged_engine_matches_ring_engine_greedy`` and
    ``test_paged_int4_matches_ring_int4``)."""
    _, _, art = artifact
    kw = dict(cache_len=32, cache_dtype="float32", kv_quant=kv_quant, block_size=4,
              prefill_chunk=4)
    ring = ServingEngine(art.model, art.params, ServeConfig(paged=False, **kw), batch_slots=3)
    want = [ring.generate([p], max_new_tokens=5)[0] for p in PROMPTS]
    paged = ServingEngine(art.model, art.params, ServeConfig(**kw), batch_slots=3)
    assert paged.generate(PROMPTS, max_new_tokens=5) == want


def test_ring_decode_past_cache_len_matches_jax(artifact):
    """21 positions through an 8-slot ring (JAX's
    ``test_ring_wraparound_at_cache_len``): every step's logits within 1e-5
    of the range of JAX's, the same greedy tokens, and the same ``slot_pos``."""
    jmodel, jparams, art = artifact
    c, b, total = 8, 2, 21
    toks = np.random.RandomState(1).randint(0, 256, (b, total)).astype(np.int32)
    def fwd(p, t, pos, c):
        out = jmodel.apply(p, {"tokens": t}, positions=pos, caches=c)
        return out.logits, out.caches

    japply = jax.jit(fwd)
    jc = jmodel.init_caches(b, cache_len=c, dtype=jnp.float32, quantized=True)
    tc = art.model.init_caches(b, c, "float32", quantized=True, device="cpu")
    _, jc = japply(jparams, jnp.asarray(toks[:, :4]), jnp.arange(4, dtype=jnp.int32), jc)
    art.model.apply(art.params, {"tokens": torch.from_numpy(toks[:, :4])},
                    positions=torch.arange(4, dtype=torch.int32), caches=tc)
    step = make_serve_step(art.model, None)
    for pos in range(4, total):
        jl, jc = japply(jparams, jnp.asarray(toks[:, pos : pos + 1]),
                        jnp.arange(pos, pos + 1, dtype=jnp.int32), jc)
        nxt, tc, logits = step(art.params, tc, torch.from_numpy(toks[:, pos : pos + 1]),
                               torch.tensor(pos, dtype=torch.int32))
        want = np.asarray(jl[:, 0, :256])
        np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
        assert nxt.tolist() == np.argmax(want, -1).tolist()
    assert tc[0]["slot_pos"].tolist() == np.asarray(jc["slot_pos"][0]).tolist()


def test_ring_temperature_is_seeded_batch_wide(artifact):
    _, _, art = artifact
    eng = ServingEngine(art.model, art.params,
                        ServeConfig(cache_len=32, cache_dtype="float32", paged=False,
                                    temperature=0.8), batch_slots=4)
    a = eng.generate(PROMPTS, max_new_tokens=6, seed=3)
    assert a == eng.generate(PROMPTS, max_new_tokens=6, seed=3)
    assert a != eng.generate(PROMPTS, max_new_tokens=6, seed=4)
    assert all(0 <= t < 256 for row in a for t in row)
    greedy = ServingEngine(art.model, art.params,
                           ServeConfig(cache_len=32, cache_dtype="float32", paged=False),
                           batch_slots=4).generate(PROMPTS, max_new_tokens=6)
    assert a != greedy


def test_ring_eos_is_absorbing_like_jax(artifact):
    jmodel, jparams, art = artifact
    kw = dict(cache_len=32, cache_dtype="float32", kv_quant=True, paged=False)
    free = ServingEngine(art.model, art.params, ServeConfig(**kw),
                         batch_slots=4).generate(PROMPTS, max_new_tokens=6)
    eos = free[0][2]
    want = JEngine(jmodel, jparams, JServe(**kw), batch_slots=4).generate(
        PROMPTS, max_new_tokens=6, eos_id=eos)
    got = ServingEngine(art.model, art.params, ServeConfig(**kw),
                        batch_slots=4).generate(PROMPTS, max_new_tokens=6, eos_id=eos)
    assert got == want and any(eos in row for row in got)
    for row in got:
        assert len(row) == 6
        if eos in row:
            assert all(t == eos for t in row[row.index(eos):])


def test_fixed_slot_engine_refuses(artifact):
    _, _, art = artifact
    with pytest.raises(ValueError, match="card"):
        ServingEngine(art.model, art.params, ServeConfig(paged=False), graph=True)
    with pytest.raises(ValueError, match="paged scheduler"):
        ServingEngine(art.model, art.params,
                      ServeConfig(paged=False, speculative=SpeculativeConfig(k=2)),
                      draft=(art.model, art.params))
    eng = ServingEngine(art.model, art.params, ServeConfig(paged=False, cache_len=16))
    with pytest.raises(ValueError, match="per-request"):
        eng.generate([[1], [2]], max_new_tokens=[2, 3])


# ---------------------------------------------------------------------------
# the decode step reads nothing on the host
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", [True, False])
def test_ring_decode_step_records_no_syncing_op(artifact, kv_quant):
    _, _, art = artifact
    caches = art.model.init_caches(2, 8, "float32", quantized=kv_quant, device="cpu")
    caches = [c | {"pad_len": torch.tensor([0, 2], dtype=torch.int32)} for c in caches]
    step = make_serve_step(art.model, None)
    tok = torch.tensor([[3], [4]], dtype=torch.int32)
    pos = torch.tensor(11, dtype=torch.int32)
    ptrs = [v.data_ptr() for c in caches for v in c.values()]
    with _Recorder() as rec:
        nxt, out, logits = step(art.params, caches, tok, pos)
    assert rec.n_ops > 100 and not rec.bad, rec.bad
    assert [v.data_ptr() for c in out for v in c.values()] == ptrs
    assert caches[0]["slot_pos"].tolist() == [-1, -1, -1, 11, -1, -1, -1, -1]
    assert nxt.shape == (2,) and logits.shape == (2, 256)


# ---------------------------------------------------------------------------
# trained weights on the ring
# ---------------------------------------------------------------------------

def test_trained_fixture_on_the_ring_gives_the_recorded_tokens():
    """The committed JAX-trained artifact served one prompt per batch on the
    ring (int4, as its spec says) by both packages: ``expected.npz``'s
    tokens, which the paged JAX engine recorded."""
    with np.load(FIXTURE / "expected.npz") as z:
        exp = {k: z[k] for k in z.files}
    want = exp["tokens"].tolist()
    prompts = [list(p.encode()) for p in exp["prompts"]]
    kw = dict(cache_len=json.loads(str(exp["serve_config"]))["cache_len"], paged=False)
    jm, jp, jspec = j_load(str(FIXTURE))
    jeng = JEngine(jm, jp, JServe.from_spec(jspec, **kw), batch_slots=1)
    assert jeng.generate(prompts, max_new_tokens=len(want[0])) == want
    art = load_quantized(str(FIXTURE), device="cpu")
    eng = ServingEngine(art.model, art.params, ServeConfig.from_spec(art.spec, **kw),
                        batch_slots=1)
    assert eng.generate(prompts, max_new_tokens=len(want[0])) == want
    assert eng.stats["pad_tokens"] == 0 and eng.stats["prefills"] == len(prompts)
