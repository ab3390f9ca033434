"""PyTorch port vs JAX package: the vlm family (llama3_2_vision_11b) at the
smoke size (2 groups of one self block and one gated cross block).

Every check starts from JAX's initial parameters with both gates of every
cross block set to nonzero values (JAX initialises them to zero, which
makes every cross block the identity), carried across by
``params_from_numpy``, and from random ``image_embeds``.

* (a) The uncached forward, float (1e-5 of the logits' range) and on a
  JAX-saved W4A4 + W8 ``mlp/wd`` artifact (plain routes, the same bound).
* (b) A cached prefill and three decode steps on the float and int4 rings,
  each step's logits within 1e-5 of their range. This also pins a finding
  of the reference: the cached forward reads cross caches that the model's
  ``init_caches`` fills with zeros and that nothing writes, so its logits
  do not depend on ``image_embeds`` (bit-equal for zero and random ones on
  both sides) and differ from the uncached forward's.
* (c) ``ServingEngine`` picks the fixed-slot path for the family (it
  exports no cache policies) and gives the JAX engine's greedy tokens and
  counters on 3 prompts x 6 tokens, float and int4 ring.
* (d) PTQ: the projections JAX quantizes, at JAX's paths (W8 on both
  ``self_blocks/mlp/wd`` and ``cross_blocks/mlp/wd``), the gates left float,
  per layer JAX's scales and activation codebooks exactly and weight
  codebooks within the tolerance of ``test_torch_model``; with one
  synthetic calibration dict, the calibrated activation codebooks within
  1e-5 of JAX's at every path.
* (e) Artifacts both ways: the port's PTQ saved by the port is served by
  the JAX engine with the port's tokens.
* (f) Dispatches per forward: 6 GEMM and 6 detection dispatches per self
  block, 4 per cross block when its K/V come from the cache, 6 without.
* (g) Three train steps with two microbatches (``image_embeds`` split with
  the tokens): losses within 1e-5 relative, parameters within 1e-4
  relative L2 per leaf; the decay mask is JAX's rank rule on its two-level
  tree (gates (G,) not decayed, cross norms (G, d) decayed).
* (h) Capture: JAX's ``dense_apply`` taps only concrete arrays, and the
  vlm's blocks run in ``lax.scan`` bodies, so JAX records ``cross.k`` and
  ``cross.v`` alone (the image embeddings, closed over, once per trace).
  The port records every tap, in every block: its ``cross.k`` /
  ``cross.v`` are one copy of JAX's per group.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as j_config  # noqa: E402
from repro.configs.base import get_smoke_config as j_smoke  # noqa: E402
from repro.core import QLinearConfig as JCfg  # noqa: E402
from repro.core import QuantSpec as JSpec  # noqa: E402
from repro.core import calibration as jcal  # noqa: E402
from repro.core import quantize_model as j_quantize_model  # noqa: E402
from repro.core import save_quantized as j_save  # noqa: E402
from repro.core.artifact import load_quantized as j_load  # noqa: E402
from repro.models.model import build as j_build  # noqa: E402
from repro.optim import adamw as jopt  # noqa: E402
from repro.serving.engine import ServeConfig as JServe  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.train import trainer as jtr  # noqa: E402

from repro_torch.configs.base import get_config, get_smoke_config  # noqa: E402
from repro_torch.core import calibration as tcal  # noqa: E402
from repro_torch.core import kernel_routing as kr  # noqa: E402
from repro_torch.core.artifact import load_quantized, save_quantized  # noqa: E402
from repro_torch.core.qlinear import QLinear  # noqa: E402
from repro_torch.core.quantspec import QuantSpec  # noqa: E402
from repro_torch.models.model import (build, params_from_numpy, quantize_model,  # noqa: E402
                                      tree_from_params)
from repro_torch.models.multimodal import CrossBlock, VisionLM  # noqa: E402
from repro_torch.optim import adamw as topt  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServingEngine  # noqa: E402
from repro_torch.train import trainer as ttr  # noqa: E402

ARCH = "llama3_2_vision_11b"
MAIN_SPEC = JSpec(base=JCfg(detection="dynamic", outlier_frac=0.05),
                  rules=[("mlp/wd", {"w_bits": 8})], kv_bits=4, kv_dtype="float32")
PROMPTS = [[5, 9, 2, 7], [3, 11], [8]]  # 5 pad cells in one batch of 3
REL = 1e-5  # float32 sums in other orders than XLA's, against the logits' range


def _close(got, want, rel=REL):
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), w, rtol=0,
                               atol=rel * np.abs(w).max())


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module")
def setup():
    """JAX's model and its parameters with nonzero gates, the port's copy."""
    cfg = j_smoke(ARCH)
    jm = j_build(cfg)
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))
    rng = np.random.RandomState(7)
    cross = jp["cross_blocks"]
    g = cross["mlp_gate"].shape
    jp = {**jp, "cross_blocks": {**cross, "mlp_gate": jnp.asarray(rng.uniform(0.3, 0.9, g),
                                                                 jnp.float32),
                                 "attn": {**cross["attn"], "gate": jnp.asarray(
                                     rng.uniform(0.3, 0.9, g), jnp.float32)}}}
    port = params_from_numpy(jax.tree.map(np.asarray, jp), get_smoke_config(ARCH), device="cpu")
    return cfg, jm, jp, build(get_smoke_config(ARCH)), port


@pytest.fixture(scope="module")
def artifact(setup, tmp_path_factory):
    """JAX's PTQ of the gated parameters, saved by JAX and loaded by the port."""
    cfg, jm, jp, _, _ = setup
    qp = j_quantize_model(jm, jp, MAIN_SPEC)
    d = tmp_path_factory.mktemp("vlm_artifact")
    j_save(d, cfg, MAIN_SPEC, qp)
    return qp, load_quantized(str(d), device="cpu")


def _inputs(cfg, b=2, s=9, seed=0):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab_size, (b, s)).astype(np.int32)
    img = rng.randn(b, cfg.n_img_tokens, cfg.d_model).astype(np.float32)
    return tok, img


def _jbatch(tok, img):
    return {"tokens": jnp.asarray(tok), "image_embeds": jnp.asarray(img)}


def _tbatch(tok, img):
    return {"tokens": torch.from_numpy(tok), "image_embeds": torch.from_numpy(img)}


# ---------------------------------------------------------------------------
# configs, structure
# ---------------------------------------------------------------------------

def test_config_tree_and_gates(setup):
    """Copies of JAX's configs; the port's tree has JAX's leaves and shapes
    (self blocks (G, n_self, ...), cross blocks (G, ...)); the port's own
    init starts both gates at zero, as JAX's; no cache policies, no paged
    layout; the cross caches are bfloat16 zeros whatever the ring's dtype."""
    cfg, jm, jp, model, port = setup
    for t, j in ((get_smoke_config(ARCH), cfg), (get_config(ARCH), j_config(ARCH))):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    shapes = lambda tree: {k: v.shape for k, v in _flat(tree).items()}
    assert shapes(jax.tree.map(lambda t: t.numpy(), tree_from_params(port))) == shapes(jp)
    fresh = model.init(seed=0, device="cpu")
    assert isinstance(fresh, VisionLM) and len(fresh.layers()) == cfg.n_layers
    assert all(float(b.mlp_gate) == 0 and float(b.attn.gate) == 0
               for b in fresh.cross_blocks)
    assert model.cache_policies() is None and jm.cache_policies() is None
    with pytest.raises(ValueError, match="cache policies"):
        model.init_caches(2, 16, layout="paged", device="cpu")
    caches = model.init_caches(2, 16, torch.float32, quantized=True, device="cpu")
    jc = jm.init_caches(2, 16, jnp.float32, quantized=True)
    assert caches[1]["ck"].dtype == torch.bfloat16 and caches[1]["ck"].shape == \
        jc["cross"]["ck"].shape[1:]
    assert "k_idx" in caches[0] and len(caches) == cfg.n_layers


# ---------------------------------------------------------------------------
# (a) the uncached forward, (b) cached prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weights", ["float", "quantized"])
def test_uncached_forward_matches_jax(setup, artifact, weights):
    cfg, jm, jp, model, port = setup
    if weights == "quantized":
        jp, art = artifact[0], artifact[1]
        port = art.params
    tok, img = _inputs(cfg)
    want = jm.apply(jp, _jbatch(tok, img)).logits
    with torch.inference_mode():
        got = model.apply(port, _tbatch(tok, img)).logits
    assert got.shape == want.shape
    _close(got, want)


def _cached_run(apply, caches, tok, img, steps=3):
    """Prefill ``tok`` then ``steps`` decode steps feeding the argmax; the
    logits of each forward's last position."""
    s = tok.shape[1]
    out, caches = apply(tok, img, np.arange(s, dtype=np.int32), caches)
    logits = [out]
    nxt = np.asarray(out).argmax(-1).astype(np.int32)[:, None]
    for i in range(steps):
        out, caches = apply(nxt, img, np.array([s + i], np.int32), caches)
        logits.append(out)
        nxt = np.asarray(out).argmax(-1).astype(np.int32)[:, None]
    return [np.asarray(x) for x in logits]


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float", "int4"])
def test_cached_prefill_and_decode_match_jax(setup, kv_quant):
    """Prefill + 3 decode steps on the ring, float and int4: JAX's logits.
    The reference's cross caches are read and never written, so the cached
    logits are the same for zero and random ``image_embeds``, on both
    sides, and unlike the uncached forward's."""
    cfg, jm, jp, model, port = setup
    tok, img = _inputs(cfg, seed=1)

    @jax.jit
    def jstep(batch, pos, caches):
        out = jm.apply(jp, batch, positions=pos, caches=caches)
        return out.logits[:, -1], out.caches

    japply = lambda t, im, pos, caches: jstep(_jbatch(t, im), jnp.asarray(pos), caches)

    def tapply(t, im, pos, caches):
        with torch.inference_mode():
            out = model.apply(port, _tbatch(t, im), positions=torch.from_numpy(pos),
                              caches=caches)
        return out.logits[:, -1].numpy(), out.caches

    jcache = lambda: jm.init_caches(2, 24, jnp.float32, quantized=kv_quant)
    tcache = lambda: model.init_caches(2, 24, torch.float32, quantized=kv_quant, device="cpu")
    want = _cached_run(japply, jcache(), tok, img)
    got = _cached_run(tapply, tcache(), tok, img)
    for g, w in zip(got, want):
        _close(g, w)
    zero = np.zeros_like(img)
    np.testing.assert_array_equal(_cached_run(japply, jcache(), tok, zero), want)
    np.testing.assert_array_equal(_cached_run(tapply, tcache(), tok, zero), got)
    uncached = np.asarray(jm.apply(jp, _jbatch(tok, img)).logits[:, -1])
    assert np.abs(uncached - want[0]).max() > 100 * REL * np.abs(uncached).max()


# ---------------------------------------------------------------------------
# (c) the engine, (e) artifacts both ways
# ---------------------------------------------------------------------------

_FALLBACK_KEYS = ("prefills", "steps", "tokens", "prompt_tokens", "pad_tokens", "pad_fraction")


@pytest.mark.parametrize("kv_quant", [False, True], ids=["float", "int4"])
def test_engine_tokens_match_jax(setup, artifact, kv_quant):
    """The default ``ServeConfig`` (``paged=True``): both engines take the
    fixed-slot path; 3 prompts x 6 greedy tokens and the fallback counters
    equal JAX's."""
    cfg, jm, _, _, _ = setup
    qp, art = artifact
    kw = dict(cache_len=32, cache_dtype="float32", kv_quant=kv_quant)
    jeng = JEngine(jm, qp, JServe(**kw), batch_slots=4)
    want = jeng.generate(PROMPTS, max_new_tokens=6)
    eng = ServingEngine(art.model, art.params, ServeConfig(**kw), batch_slots=4)
    assert not eng.paged and eng.scheduler is None
    got = eng.generate(PROMPTS, max_new_tokens=6)
    assert got == want
    assert {k: eng.stats[k] for k in _FALLBACK_KEYS} == {k: jeng.stats[k] for k in _FALLBACK_KEYS}
    assert eng.stats["pad_tokens"] == 5 and eng.stats["prefills"] == 1
    # the rings and cross caches are the engine's, sliced per batch; the
    # cross caches still hold zeros after serving
    assert all(not c["ck"].any() and not c["cv"].any() for c in eng._ring if "ck" in c)
    with pytest.raises(ValueError, match="speculative"):
        from repro_torch.serving.speculative import SpeculativeConfig

        ServingEngine(art.model, art.params, ServeConfig(speculative=SpeculativeConfig(k=2)))


def test_port_artifact_serves_in_jax(setup, tmp_path):
    """The port's PTQ of the gated parameters, saved by the port: JAX's
    ``load_quantized`` reads it (top-level keys checked there), and JAX's
    engine gives the port engine's tokens on it; the JAX-saved artifact
    loads into the port byte for byte (scales, packed weights, gates)."""
    cfg, jm, jp, model, port = setup
    spec = QuantSpec.from_json_dict(MAIN_SPEC.to_json_dict())
    tq = quantize_model(model, port, spec)
    save_quantized(str(tmp_path / "port"), get_smoke_config(ARCH), spec, tq)
    back = j_load(str(tmp_path / "port"))
    kw = dict(cache_len=32, cache_dtype="float32", kv_quant=True)
    want = JEngine(back.model, back.params, JServe(**kw), batch_slots=4).generate(
        PROMPTS, max_new_tokens=6)
    got = ServingEngine(model, tq, ServeConfig(**kw), batch_slots=4).generate(
        PROMPTS, max_new_tokens=6)
    assert got == want
    again = load_quantized(str(tmp_path / "port"), device="cpu")
    for (n, a), (m, b) in zip(tq.state_dict().items(), again.params.state_dict().items()):
        assert n == m and torch.equal(a, b), n


# ---------------------------------------------------------------------------
# (d) PTQ
# ---------------------------------------------------------------------------

def _qlinear(mod, path):
    for part in path.split("/"):
        mod = getattr(mod, part)
    return mod


def test_ptq_paths_and_codebooks_match_jax(setup, artifact):
    cfg, jm, jp, model, port = setup
    jq = artifact[0]  # JAX's PTQ of the same parameters under the same spec
    spec = QuantSpec.from_json_dict(MAIN_SPEC.to_json_dict())
    tq = quantize_model(model, port, spec)
    n_groups = len(tq.cross_blocks)
    n_self = len(tq.self_blocks) // n_groups
    for stack, blocks in (("self_blocks", tq.self_blocks), ("cross_blocks", tq.cross_blocks)):
        for path in ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/wi", "mlp/wd"):
            grp, name = path.split("/")
            jpar = jq[stack][grp][name]
            for i, blk in enumerate(blocks):
                mod = _qlinear(blk, path)
                assert isinstance(mod, QLinear), (stack, path)
                assert mod.cfg.w_bits == jpar.cfg.w_bits == (8 if path == "mlp/wd" else 4)
                idx = divmod(i, n_self) if stack == "self_blocks" else (i,)
                np.testing.assert_array_equal(mod.scale.numpy(), np.asarray(jpar.qw.scale[idx]))
                atol = 1e-6 if mod.qw_nbits <= 4 else 1e-3  # see test_torch_model
                np.testing.assert_allclose(mod.codebook.numpy(),
                                           np.asarray(jpar.qw.codebook[idx]), rtol=0, atol=atol)
                np.testing.assert_array_equal(mod.act_codebook.numpy(),
                                              np.asarray(jpar.act_codebook[idx]))
    for blk in tq.cross_blocks:
        assert not isinstance(blk.attn.gate, QLinear) and blk.attn.gate.dtype == torch.float32
    np.testing.assert_array_equal(np.stack([b.mlp_gate.numpy() for b in tq.cross_blocks]),
                                  np.asarray(jq["cross_blocks"]["mlp_gate"]))


def test_calibrated_ptq_codebooks_match_jax(setup):
    """One synthetic calibration dict on both sides: the calibrated
    activation codebook of every path (cross projections through their
    ``cross.*`` taps) within 1e-5 of JAX's, shared by the path's layers."""
    cfg, jm, jp, model, port = setup
    rng = np.random.RandomState(3)
    d, ff = cfg.d_model, cfg.d_ff
    calib = {name: (rng.randn(96, k) * (1 + i)).astype(np.float32) for i, (name, k) in
             enumerate((("attn.q", d), ("attn.k", d), ("attn.v", d), ("attn.o", d),
                        ("cross.q", d), ("cross.k", d), ("cross.v", d), ("cross.o", d),
                        ("mlp.wi", d), ("mlp.wd", ff)))}
    jq = j_quantize_model(jm, jp, MAIN_SPEC, calib={k: jnp.asarray(v) for k, v in calib.items()})
    spec = QuantSpec.from_json_dict(MAIN_SPEC.to_json_dict())
    tq = quantize_model(model, port, spec, calib={k: torch.from_numpy(v)
                                                  for k, v in calib.items()})
    books = set()
    for stack, blocks in (("self_blocks", tq.self_blocks), ("cross_blocks", tq.cross_blocks)):
        for path in ("attn/wq", "attn/wk", "attn/wo", "mlp/wi", "mlp/wd"):
            grp, name = path.split("/")
            jbook = np.asarray(jq[stack][grp][name].act_codebook).reshape(-1, 16)
            for i, blk in enumerate(blocks):
                got = _qlinear(blk, path).act_codebook.numpy()
                np.testing.assert_allclose(got, jbook[i], rtol=1e-5, atol=1e-5)
                books.add(got.tobytes())
    # one per path, but the cross blocks' MLP taps as "mlp.*" (JAX's
    # ``mlp_apply`` tag), so it shares the self blocks' codebooks
    assert len(books) == 8


# ---------------------------------------------------------------------------
# (f) dispatches
# ---------------------------------------------------------------------------

def test_dispatches_per_forward(artifact):
    """6 GEMM and 6 detection dispatches per self block; per cross block 4
    with cached K/V (q, o, wi, wd) and 6 without (the K/V projections of the
    image embeddings)."""
    _, art = artifact
    cfg = art.model.cfg
    n_groups, n_self = cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1
    tok, img = _inputs(cfg, b=1, s=5)
    caches = art.model.init_caches(1, 16, torch.float32, quantized=True, device="cpu")
    for cached, per_cross in ((False, 6), (True, 4)):
        kr.reset()
        with torch.inference_mode():
            art.model.apply(art.params, _tbatch(tok, img), caches=caches if cached else None)
        n = n_groups * (6 * n_self + per_cross)
        assert sum(kr.dispatch_counts().values()) == n
        assert sum(kr.detect_dispatch_counts().values()) == n
    kr.reset()


# ---------------------------------------------------------------------------
# (g) training, (h) capture
# ---------------------------------------------------------------------------

def test_three_train_steps_match_jax(setup):
    """Three steps of 4 x 12 tokens and their image embeddings, two
    microbatches, from the gated parameters: the same losses and
    parameters as JAX's (module docstring)."""
    cfg, jm, jp, model, _ = setup
    port = params_from_numpy(jax.tree.map(np.asarray, jp), get_smoke_config(ARCH), device="cpu")
    tc_kw = dict(optimizer=jopt.AdamWConfig(lr=2e-3), microbatches=2, warmup_steps=2,
                 total_steps=10)
    jstep = jax.jit(jtr.make_train_step(jm, jtr.TrainConfig(**tc_kw)))
    tstep = ttr.make_train_step(model, ttr.TrainConfig(**tc_kw))
    jstate = {"params": jp, "opt": jopt.adamw_init(jp)}
    tstate = {"params": port, "opt": topt.adamw_init(dict(port.named_parameters()))}
    for i in range(3):
        tok, img = _inputs(cfg, b=4, s=13, seed=10 + i)
        jstate, jm_ = jstep(jstate, _jbatch(tok, img))
        tstate, tm_ = tstep(tstate, _tbatch(tok, img))
        np.testing.assert_allclose(tm_["loss"].item(), float(jm_["loss"]), rtol=1e-5)
    got = _flat(jax.tree.map(lambda t: t.numpy(), tree_from_params(port)))
    for k, want in _flat(jstate["params"]).items():
        assert _rel_l2(got[k], want) < 1e-4, (k, _rel_l2(got[k], want))
    mask = ttr.decay_mask(port)
    names = {p: n for n, p in port.named_parameters()}
    flags = _flat(jax.tree.map(lambda t: t.numpy(), tree_from_params(
        port, lambda p: torch.tensor(float(mask[names[p]])))))
    for k, v in _flat(jp).items():
        assert np.all(flags[k] == (v.ndim >= 2)), k
    assert not mask["cross_blocks.0.attn.gate"] and not mask["cross_blocks.0.mlp_gate"]
    assert mask["cross_blocks.0.norm1"] and mask["self_blocks.0.norm1"]


def test_capture_cross_taps_match_jax(setup):
    """JAX records ``cross.k`` and ``cross.v`` alone (module docstring); the
    port's are one copy of JAX's per group, and it records every other tap
    too."""
    cfg, jm, jp, model, port = setup
    tok, img = _inputs(cfg, seed=4)
    with jcal.capture() as jstore:
        jm.apply(jp, _jbatch(tok, img))
    with tcal.capture() as tstore, torch.inference_mode():
        model.apply(port, _tbatch(tok, img))
    jacts, tacts = jcal.captured(jstore), tcal.captured(tstore)
    assert set(jacts) == {"cross.k", "cross.v"}
    assert set(tacts) == {"attn.q", "attn.k", "attn.v", "attn.o", "cross.q", "cross.k",
                          "cross.v", "cross.o", "mlp.wi", "mlp.wd"}
    n_groups = len(port.cross_blocks)
    for name in ("cross.k", "cross.v"):
        want = np.asarray(jacts[name])
        got = tacts[name].numpy().reshape(n_groups, *want.shape)
        for g in range(n_groups):
            np.testing.assert_array_equal(got[g], want)
    assert all(isinstance(b, CrossBlock) for b in port.cross_blocks)
