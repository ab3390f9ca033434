"""PyTorch port vs JAX package: calibration and calibrated PTQ.

Activation capture (dense and Mamba stacks, every layer pooled under one
tap name), Fisher capture, ``calibrate_codebooks``, the calibrated
``quantize_model`` per projection, and a port-written calibrated artifact
served by the JAX engine.

Tolerances, each stated where it is asserted:

* captured activations: 1e-5 relative L2 per tap (float32 forwards in two
  orders; rows in the same order);
* Fisher: 1e-5 relative L2 per tap (float32 backward in two orders), with
  and without remat, against JAX's ``dense_apply`` with its tracer guard
  lifted in the test (see ``_fisher_setup``);
* activation codebooks: rtol 1e-5, atol 1e-5 (K-Means sums in two orders,
  a few ulps apart, as ``test_torch_quickstart.py`` states); static
  thresholds within one ulp (``jnp.quantile``'s linear interpolation);
* the served artifact: equal greedy tokens.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke_config as j_smoke  # noqa: E402
from repro.core import calibration as jcal  # noqa: E402
from repro.core import QLinearConfig as JCfg  # noqa: E402
from repro.core import QuantSpec as JSpec  # noqa: E402
from repro.core.artifact import load_quantized as j_load  # noqa: E402
from repro.core.artifact import save_quantized as j_save  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.model import build as j_build  # noqa: E402
from repro.models.model import quantize_model as j_quantize_model  # noqa: E402
from repro.models.model import unstack_for_capture as j_unstack  # noqa: E402
from repro.serving.engine import ServeConfig as JServe  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.train import trainer as jtr  # noqa: E402

from repro_torch.configs.base import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core import calibration as tcal  # noqa: E402
from repro_torch.core.artifact import save_quantized  # noqa: E402
from repro_torch.core.qlinear import QLinear  # noqa: E402
from repro_torch.core.quantspec import QuantSpec  # noqa: E402
from repro_torch.models.model import (build, params_from_numpy, quantize_model,  # noqa: E402
                                      unstack_for_capture)
from repro_torch.train import trainer as ttr  # noqa: E402

SPEC = JSpec(base=JCfg(detection="dynamic", outlier_frac=0.005),
             rules=[("mlp/wd", {"w_bits": 8, "detection": "static"}),
                    ("attn/wo", {"detection": "static_dense", "outlier_frac": 0.02})],
             kv_bits=4, kv_dtype="float32")


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@functools.cache
def _setup(arch: str, n_layers: int | None = None, seed: int = 0, remat: str = "none"):
    """(JAX model, JAX params, port model, port params) of a smoke config;
    ``remat`` sets the port's (JAX's unstacked capture forward has none)."""
    jcfg, tcfg = j_smoke(arch), dataclasses.replace(t_smoke(arch), remat=remat)
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        tcfg = dataclasses.replace(tcfg, n_layers=n_layers)
    jm = j_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    port = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jm, jp, build(tcfg), port


def _tokens(vocab: int, seed: int = 0, shape=(2, 12)) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(np.int32)


@functools.cache
def _captures(arch: str):
    """JAX's and the port's captures over the same two batches."""
    jm, jp, tm, port = _setup(arch)
    batches = [_tokens(jm.cfg.vocab_size, s) for s in (1, 2)]
    ju, jpu = j_unstack(jm, jp)
    with jcal.capture() as store:
        for b in batches:
            ju.apply(jpu, {"tokens": jnp.asarray(b)})
    jacts = {k: np.asarray(v) for k, v in jcal.captured(store).items()}
    tu, tpu = unstack_for_capture(tm, port)
    assert tu is tm and tpu is port  # the port's layers are never scanned
    with torch.no_grad(), tcal.capture() as store:
        for b in batches:
            tm.apply(port, {"tokens": torch.from_numpy(b)})
    return jacts, {k: v.numpy() for k, v in tcal.captured(store).items()}


@pytest.mark.parametrize("arch", ["llama3_2_1b", "falcon_mamba_7b"])
def test_capture_matches_jax(arch):
    """The same tap names; per tap every layer's rows of both batches, in
    JAX's order, within 1e-5 relative L2."""
    jacts, tacts = _captures(arch)
    assert set(tacts) == set(jacts)
    cfg = t_smoke(arch)
    for k, want in jacts.items():
        assert tacts[k].shape == want.shape, k
        assert want.shape[0] == 2 * 2 * 12 * cfg.n_layers  # batches x rows x layers pooled
        assert _rel_l2(tacts[k], want) < 1e-5, (k, _rel_l2(tacts[k], want))


def test_fisher_capture_matches_jax():
    """Taps called directly (two taps, one read twice): (dL/dx)^2 within
    1e-5 relative L2, an unused tap's Fisher zero on both sides."""
    rng = np.random.RandomState(3)
    x = rng.randn(4, 6).astype(np.float32)
    w1 = rng.randn(6, 5).astype(np.float32)
    w2 = rng.randn(5, 3).astype(np.float32)
    shapes = {"a": (4, 6), "b": (4, 5), "unused": (2,)}

    def j_loss():
        h = jnp.tanh(jcal.tap("a", jnp.asarray(x)) @ w1)
        h = jcal.tap("b", h) + jcal.tap("b", h)
        return jnp.sum(jnp.square(h @ w2))

    def t_loss():
        h = torch.tanh(tcal.tap("a", torch.from_numpy(x)) @ torch.from_numpy(w1))
        h = tcal.tap("b", h) + tcal.tap("b", h)
        return torch.sum(torch.square(h @ torch.from_numpy(w2)))

    want = jcal.fisher_capture(j_loss, shapes)
    got = tcal.fisher_capture(t_loss, shapes, device="cpu")
    assert set(got) == set(want)
    for k in ("a", "b"):
        assert got[k].dtype == torch.float32
        assert _rel_l2(got[k].numpy(), want[k]) < 1e-5, k
    assert not got["unused"].any() and not np.asarray(want["unused"]).any()


@functools.cache
def _fisher_setup():
    """Two oasis layers, a batch, the tap shapes and JAX's Fisher of every
    tap. JAX's ``dense_apply`` taps only concrete arrays, so under
    ``jax.grad`` its taps after the first perturbed one would not fire; the
    JAX side here lifts that guard (``dense_apply`` patched for this call
    only, the package unedited), so every tap of every layer is perturbed,
    as the port perturbs them."""
    jm, jp, _, _ = _setup("oasis_7b", n_layers=2)
    b = _tokens(jm.cfg.vocab_size, 5, (2, 9))
    ju, jpu = j_unstack(jm, jp)
    with jcal.capture() as store:
        ju.apply(jpu, {"tokens": jnp.asarray(b[:, :-1])})
    shapes = {k: (2, 8, v[0].shape[-1]) for k, v in store.items()}
    tc = jtr.TrainConfig(warmup_steps=1, total_steps=4)
    guarded = jlayers.dense_apply

    def dense_apply_tapping_tracers(p, x, tap_name=None):
        if tap_name is not None:
            x = jcal.tap(tap_name, x)
        return guarded(p, x)

    jlayers.dense_apply = dense_apply_tapping_tracers
    try:
        want = jax.jit(lambda: jcal.fisher_capture(
            lambda: jtr.loss_fn(ju, jpu, {"tokens": jnp.asarray(b)}, tc)[0], shapes))()
    finally:
        jlayers.dense_apply = guarded
    return b, shapes, {k: np.asarray(v) for k, v in want.items()}


def _check_fisher_through_the_model(remat: str):
    b, shapes, want = _fisher_setup()
    _, _, tm, port = _setup("oasis_7b", n_layers=2, remat=remat)
    tc = ttr.TrainConfig(warmup_steps=1, total_steps=4)
    got = tcal.fisher_capture(
        lambda: ttr.loss_fn(tm, port, {"tokens": torch.from_numpy(b)}, tc)[0],
        shapes, device="cpu")
    assert set(got) == set(want) == {"attn.q", "attn.k", "attn.v", "attn.o", "mlp.wi",
                                      "mlp.wd"}
    for k in want:
        assert want[k].any(), k
        assert _rel_l2(got[k].numpy(), want[k]) < 1e-5, (k, _rel_l2(got[k].numpy(), want[k]))
    assert all(not p.requires_grad for p in port.parameters())


def test_fisher_through_the_model():
    """Two oasis layers, every tap (q, k, v, o, wi, wd; both layers' dL/dx
    summed under one name) within 1e-5 relative L2 of JAX's (see
    ``_fisher_setup``)."""
    _check_fisher_through_the_model("none")


def test_fisher_through_the_model_under_remat():
    """The same with ``remat="block"``: each block is recomputed in the
    backward pass, after ``fisher_capture`` has reset its perturbations, so
    the recompute's taps read them only from the forward's context."""
    _check_fisher_through_the_model("block")


def test_calibrate_codebooks_matches_jax():
    """The same captured activations and Fisher weights on both sides."""
    jacts, _ = _captures("llama3_2_1b")
    rng = np.random.RandomState(7)
    fisher = {k: rng.rand(*v.shape).astype(np.float32) for k, v in jacts.items()}
    for f in (None, fisher):
        want = jcal.calibrate_codebooks(
            {k: jnp.asarray(v) for k, v in jacts.items()},
            fisher=None if f is None else {k: jnp.asarray(v) for k, v in f.items()})
        got = tcal.calibrate_codebooks(
            {k: torch.tensor(v) for k, v in jacts.items()},
            fisher=None if f is None else {k: torch.tensor(v) for k, v in f.items()})
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-5)


@functools.cache
def _calibrated(arch: str):
    """Both packages' calibrated PTQ of the same params on JAX's captures."""
    jm, jp, tm, port = _setup(arch)
    jacts, _ = _captures(arch)
    jq = j_quantize_model(jm, jp, SPEC, calib={k: jnp.asarray(v) for k, v in jacts.items()})
    spec = QuantSpec.from_json_dict(SPEC.to_json_dict())
    tq = quantize_model(tm, port, spec, calib={k: torch.tensor(v) for k, v in jacts.items()})
    return jq, tq, spec


def test_calibrated_ptq_resolves_like_jax():
    """Per projection: the resolved config, the calibrated activation
    codebook (rtol/atol 1e-5) and, under static detection, the thresholds
    (one ulp); every layer of a scanned path shares its codebook."""
    jq, tq, _ = _calibrated("llama3_2_1b")
    for i, blk in enumerate(tq.blocks):
        for grp, name in (("attn", "wq"), ("attn", "wk"), ("attn", "wo"), ("mlp", "wi"),
                          ("mlp", "wd")):
            mod = getattr(getattr(blk, grp), name)
            jpar = jq["blocks"][grp][name]
            assert isinstance(mod, QLinear)
            assert mod.cfg.detection == jpar.cfg.detection
            np.testing.assert_allclose(mod.act_codebook.numpy(), np.asarray(jpar.act_codebook[i]),
                                       rtol=1e-5, atol=1e-5)
            if mod.cfg.detection in ("static", "static_dense"):
                np.testing.assert_allclose(
                    [mod.params.thr_lo.item(), mod.params.thr_hi.item()],
                    [float(jpar.thr_lo[i]), float(jpar.thr_hi[i])], rtol=2.5e-7)
            else:
                assert mod.params.thr_lo is None and jpar.thr_lo is None
    assert tq.blocks[0].mlp.wd.cfg.detection == "static"
    assert tq.blocks[0].attn.wo.cfg.detection == "static_dense"
    # calibrated, not the structural codebook
    from repro_torch.models.model import _default_codebook
    assert not torch.equal(tq.blocks[0].attn.wq.act_codebook, _default_codebook(4))


def test_port_calibrated_artifact_serves_jax_tokens(tmp_path):
    """A port-written calibrated artifact loads in JAX's ``load_quantized``,
    and the JAX engine's greedy tokens (2 prompts x 8) equal those of the
    JAX-written artifact of the same params and captures."""
    jq, tq, spec = _calibrated("llama3_2_1b")
    cfg = t_smoke("llama3_2_1b")
    j_save(str(tmp_path / "jax"), j_smoke("llama3_2_1b"), SPEC, jq)
    save_quantized(str(tmp_path / "port"), cfg, spec, tq)
    prompts = [[5, 17, 99, 3], [200, 4, 61]]
    toks = {}
    for who in ("jax", "port"):
        model, params, jspec = j_load(str(tmp_path / who))
        eng = JEngine(model, params, JServe.from_spec(jspec, cache_len=32, block_size=8,
                                                      prefill_chunk=8), batch_slots=2)
        toks[who] = eng.generate(prompts, max_new_tokens=8)
    assert toks["port"] == toks["jax"]
    assert all(len(t) == 8 for t in toks["port"])
