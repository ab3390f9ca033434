"""PyTorch port vs JAX package: the training stack.

The data pipeline, the cosine schedule, AdamW (with JAX's weight-decay rule
on the rank of the leaf in its own tree), the chunked cross-entropy, three
train steps from JAX's initial parameters, loss gradients of the MoE, Mamba
and RG-LRU families, and the checkpointer (resume, uncommitted steps,
corruption, retention, manifest digests equal to JAX's).

Tolerances, each stated where it is asserted:

* the schedule and the pipeline are exact;
* one AdamW update on the same tree: 1e-6 relative (float32 rounding of
  the same formula in two libraries);
* the chunked CE: 2e-6 relative (float32 logsumexp in two orders);
* three training steps: loss within 1e-5 relative per step, parameters
  within 1e-4 relative L2 per leaf. AdamW's first steps move each element
  by about +-lr whatever the gradient's size, so a gradient near 0 can flip
  its sign between two summation orders and move one element by 2 lr:
  elementwise max-abs would see that, the per-leaf L2 does not;
* family gradients: 1e-4 relative L2 per leaf (float32 forward and
  backward in two orders).
"""

import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro.checkpoint import checkpointer as jckpt  # noqa: E402
from repro.configs.base import get_smoke_config as j_smoke  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models.model import build as j_build  # noqa: E402
from repro.optim import adamw as jopt  # noqa: E402
from repro.train import trainer as jtr  # noqa: E402

from repro_torch.checkpoint import checkpointer as tckpt  # noqa: E402
from repro_torch.configs.base import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.models.model import build, params_from_numpy, tree_from_params  # noqa: E402
from repro_torch.optim import adamw as topt  # noqa: E402
from repro_torch.train import trainer as ttr  # noqa: E402

TC = dict(warmup_steps=2, total_steps=10)


@pytest.fixture(scope="module")
def corpora():
    """One ByteCorpus of each package (both read the repository's files)."""
    return jpipe.ByteCorpus(), tpipe.ByteCorpus()


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


@functools.cache
def _jax_model(arch, remat="none"):
    """A smoke config's JAX model and its initial parameters (seed 0)."""
    cfg = dataclasses.replace(j_smoke(arch), remat=remat)
    model = j_build(cfg)
    return model, model.init(jax.random.PRNGKey(0))


def _port(arch, jparams, remat="none"):
    cfg = dataclasses.replace(t_smoke(arch), remat=remat)
    return build(cfg), params_from_numpy(_np_tree(jparams), cfg, device="cpu")


def _port_tree(params, values: dict | None = None) -> dict:
    """The port's params (or ``values`` keyed by parameter name) in JAX's
    layout, as numpy."""
    if values is None:
        return _flat(jax.tree.map(lambda t: t.numpy(), tree_from_params(params)))
    names = {p: n for n, p in params.named_parameters()}
    tree = tree_from_params(params, lambda p: values[names[p]].detach())
    return _flat(jax.tree.map(lambda t: t.numpy(), tree))


# ---------------------------------------------------------------------------
# data, schedule, optimizer, loss
# ---------------------------------------------------------------------------

def test_pipeline_matches_jax(corpora):
    jc, tc = corpora
    assert tc.fingerprint() == jc.fingerprint()
    np.testing.assert_array_equal(tc.tokens, jc.tokens)
    cfg = dict(seq_len=16, global_batch=4, seed=3, process_index=1, process_count=2)
    jp = jpipe.TokenPipeline(jc.tokens, jpipe.DataConfig(**cfg))
    tp = tpipe.TokenPipeline(tc.tokens, tpipe.DataConfig(**cfg))
    for _ in range(3):
        got, want = tp.next_batch(), jp.next_batch()
        assert got["tokens"].dtype == np.int32 and got["tokens"].shape == (2, 17)
        np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert tp.state() == jp.state()
    fresh = tpipe.TokenPipeline(tc.tokens, tpipe.DataConfig(**cfg))
    fresh.restore(jp.state())
    np.testing.assert_array_equal(fresh.next_batch()["tokens"], jp.next_batch()["tokens"])
    with pytest.raises(ValueError, match="mismatched seed"):
        fresh.restore({"step": 0, "seed": 4})
    np.testing.assert_array_equal(tpipe.synthetic_corpus(97, 500, seed=2),
                                  jpipe.synthetic_corpus(97, 500, seed=2))


@pytest.mark.parametrize("warmup,total,min_frac", [(100, 10_000, 0.1), (20, 30, 0.1),
                                                   (25, 60, 0.05), (0, 7, 0.0)])
def test_cosine_schedule_matches_jax(warmup, total, min_frac):
    """Computed in float32 on both sides, at every step 0 .. total + 5 (the
    first 64 and last 11 of the long schedule): the warm-up is exact; the
    cosine within one float32 ulp of cos times the base rate, because XLA's
    and PyTorch's cos round differently and ``1 + cos`` cancels near the end
    (up to 5 ulps of the rate there)."""
    steps = sorted(set(range(0, min(total, 64))) | set(range(total - 5, total + 6)))
    jf = jopt.cosine_schedule(2e-3, warmup, total, min_frac)
    tf = topt.cosine_schedule(2e-3, warmup, total, min_frac)
    got = np.array([tf(s).item() for s in steps], np.float32)
    want = np.array([float(jf(s)) for s in steps], np.float32)
    warm = np.array(steps) < warmup
    np.testing.assert_array_equal(got[warm], want[warm])
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3 * 2.0**-23)
    assert tf(3).dtype == torch.float32


def test_adamw_update_matches_jax():
    """Three updates of a tree with scanned (stacked) leaves: within 1e-6
    relative. The stacked per-layer vector (``blocks.norm``, JAX rank 2)
    decays, the final norm (rank 1) does not."""
    rng = np.random.RandomState(0)
    shapes = {"blocks": {"norm": (3, 8), "w": (3, 8, 5)}, "embed": (11, 8), "norm_f": (8,)}
    params = jax.tree.map(lambda s: jnp.asarray(rng.randn(*s).astype(np.float32)), shapes,
                          is_leaf=lambda x: isinstance(x, tuple))
    cfg = jopt.AdamWConfig(lr=1e-2, weight_decay=0.1, clip_norm=1.0)
    jstate = jopt.adamw_init(params)
    # port: one tensor per layer of a stacked leaf, as the model holds them
    names = {"['embed']": "embed", "['norm_f']": "norm_f"}
    tparams, decay = {}, {}
    for k, v in _flat(params).items():
        if k.startswith("['blocks']"):
            for i in range(v.shape[0]):
                tparams[f"blocks.{i}.{k.split(chr(39))[3]}"] = torch.tensor(v[i])
                decay[f"blocks.{i}.{k.split(chr(39))[3]}"] = v.ndim >= 2
        else:
            tparams[names[k]] = torch.tensor(v)
            decay[names[k]] = v.ndim >= 2
    assert decay["blocks.0.norm"] and not decay["norm_f"]
    tstate = topt.adamw_init(tparams)
    for step in range(3):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)),
                             params)
        flat_g = _flat(grads)
        tgrads = {}
        for k, v in flat_g.items():
            if k.startswith("['blocks']"):
                for i in range(v.shape[0]):
                    tgrads[f"blocks.{i}.{k.split(chr(39))[3]}"] = torch.tensor(v[i])
            else:
                tgrads[names[k]] = torch.tensor(v)
        lr = jopt.cosine_schedule(1e-2, 1, 10)(step + 1)
        params, jstate, jm = jopt.adamw_update(grads, jstate, params, cfg, lr)
        _, tstate, tm = topt.adamw_update(tgrads, tstate, tparams, cfg,
                                          topt.cosine_schedule(1e-2, 1, 10)(step + 1),
                                          decay=decay)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-6)
    assert tstate["step"] == int(jstate["step"]) == 3
    for key, tree in (("p", params), ("m", jstate["m"]), ("v", jstate["v"])):
        for k, want in _flat(tree).items():
            if k.startswith("['blocks']"):
                leaf = k.split(chr(39))[3]
                src = tparams if key == "p" else tstate[key]
                got = np.stack([src[f"blocks.{i}.{leaf}"].numpy() for i in range(3)])
            else:
                got = (tparams if key == "p" else tstate[key])[names[k]].numpy()
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", ["oasis_7b", "recurrentgemma_2b"])
def test_decay_mask_is_jax_rank_rule(arch):
    """``decay_mask`` decays exactly the parameters whose JAX leaf has rank
    >= 2: oasis scans its layers (per-layer norms decay), recurrentgemma
    does not (they do not)."""
    _, jparams = _jax_model(arch)
    _, port = _port(arch, jparams)
    mask = ttr.decay_mask(port)
    names = {p: n for n, p in port.named_parameters()}
    # each JAX leaf's flags, through tree_from_params (a stacked leaf holds its layers')
    flags = _flat(jax.tree.map(lambda t: t.numpy(), tree_from_params(
        port, lambda p: torch.tensor(float(mask[names[p]])))))
    jrank = {k: v.ndim for k, v in _flat(jparams).items()}
    assert set(flags) == set(jrank)
    for k, r in jrank.items():
        assert np.all(flags[k] == (r >= 2)), k
    assert any(not v for v in mask.values()) and any(mask.values())


def test_chunked_ce_matches_jax(monkeypatch):
    """A chunk (7) that does not divide the token count (2 x 9): the padded
    last chunk is masked on both sides. (ce, loss) and the gradient with
    respect to the hidden states within 2e-6 relative."""
    monkeypatch.setattr(jtr, "_CE_CHUNK", 7)
    monkeypatch.setattr(ttr, "_CE_CHUNK", 7)
    rng = np.random.RandomState(1)
    h = rng.randn(2, 9, 16).astype(np.float32)
    w = (rng.randn(16, 40) * 0.3).astype(np.float32)
    y = rng.randint(0, 40, (2, 9)).astype(np.int32)
    ce_fn = lambda hh: jtr._chunked_ce(hh, jnp.asarray(w), jnp.asarray(y), 1e-2)
    jce, jloss = jax.jit(ce_fn)(jnp.asarray(h))
    jgh = jax.jit(jax.grad(lambda hh: ce_fn(hh)[1]))(jnp.asarray(h))
    th = torch.tensor(h, requires_grad=True)
    tce, tloss = ttr._chunked_ce(th, torch.tensor(w), torch.tensor(y), 1e-2)
    (tgh,) = torch.autograd.grad(tloss, th)
    np.testing.assert_allclose([tce.item(), tloss.item()], [float(jce), float(jloss)],
                               rtol=2e-6)
    assert _rel_l2(tgh.numpy(), jgh) < 2e-6


# ---------------------------------------------------------------------------
# training parity
# ---------------------------------------------------------------------------

def _batches(corpus, n, seq_len=32, batch=4):
    pipe = jpipe.TokenPipeline(corpus.tokens, jpipe.DataConfig(seq_len, batch, seed=5))
    return [pipe.next_batch()["tokens"] for _ in range(n)]


@pytest.mark.parametrize("microbatches,remat", [(1, "none"), (2, "none"), (1, "block")],
                         ids=["1", "2", "1-remat"])
def test_three_train_steps_match_jax(corpora, microbatches, remat, monkeypatch):
    """oasis_7b smoke from JAX's initial parameters on the same batches:
    per-step loss within 1e-5 relative, parameters and both moments within
    1e-4 relative L2 per leaf (see the module docstring). ``remat="block"``
    recomputes each block in the backward pass on both sides (JAX's
    ``jax.checkpoint`` over its scanned block, the port's
    ``torch.utils.checkpoint`` per block)."""
    tc_kw = dict(optimizer=jopt.AdamWConfig(lr=2e-3), microbatches=microbatches, **TC)
    jmodel, jparams = _jax_model("oasis_7b", remat)
    tmodel, port = _port("oasis_7b", jparams, remat)
    recomputed = []  # the port's blocks that went through torch.utils.checkpoint
    monkeypatch.setattr(ttransformer, "checkpoint",
                        lambda *a, **kw: recomputed.append(1) or checkpoint(*a, **kw))
    jstep = jax.jit(jtr.make_train_step(jmodel, jtr.TrainConfig(**tc_kw)))
    tstep = ttr.make_train_step(tmodel, ttr.TrainConfig(**tc_kw))
    jstate = {"params": jparams, "opt": jopt.adamw_init(jparams)}
    tstate = {"params": port, "opt": topt.adamw_init(dict(port.named_parameters()))}
    for b in _batches(corpora[0], 3):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(b)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(b)})
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]), rtol=0,
                                   atol=2e-3 * 2.0**-23)  # the schedule's cos ulp
    assert all(not p.requires_grad for p in port.parameters())  # serving params again
    # every block of every step (and microbatch) under remat, none without
    assert len(recomputed) == (3 * microbatches * 2 if remat == "block" else 0)
    for key, want_tree, values in (("params", jstate["params"], None),
                                   ("m", jstate["opt"]["m"], tstate["opt"]["m"]),
                                   ("v", jstate["opt"]["v"], tstate["opt"]["v"])):
        got = _port_tree(port, values)
        for k, want in _flat(want_tree).items():
            assert _rel_l2(got[k], want) < 1e-4, (key, k, _rel_l2(got[k], want))


@pytest.mark.parametrize("arch", ["granite_moe_3b_a800m", "falcon_mamba_7b",
                                  "recurrentgemma_2b"])
def test_family_loss_and_grads_match_jax(corpora, arch):
    """One value-and-grad of ``loss_fn`` (the MoE adds its aux loss): loss
    within 1e-5 relative, every gradient leaf within 1e-4 relative L2."""
    tc = dict(**TC)
    jmodel, jparams = _jax_model(arch)
    tmodel, port = _port(arch, jparams)
    b = _batches(corpora[0], 1, seq_len=16, batch=2)[0]
    (jl, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jtr.loss_fn(jmodel, p, {"tokens": jnp.asarray(b)}, jtr.TrainConfig(**tc)),
        has_aux=True))(jparams)
    named = dict(port.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    tl, _ = ttr.loss_fn(tmodel, port, {"tokens": torch.from_numpy(b)}, ttr.TrainConfig(**tc))
    grads = dict(zip(named, torch.autograd.grad(tl, list(named.values()))))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    got = _port_tree(port, grads)
    for k, want in _flat(jg).items():
        assert _rel_l2(got[k], want) < 1e-4, (k, _rel_l2(got[k], want))


def test_grad_compression_is_refused(tmp_path, corpora):
    """``grad_compression`` is not refused: the step builds, the state
    carries ``compress_err`` (float32, shaped like each parameter), and a
    compressed Trainer saves it in JAX's layout and auto-resumes it bit for
    bit (nonzero after two steps)."""
    tc = ttr.TrainConfig(grad_compression=True)
    model = build(t_smoke("llama3_2_1b"))
    assert callable(ttr.make_train_step(model, tc))
    state = ttr.init_train_state(model, 0, tc, device="cpu")
    named = dict(state["params"].named_parameters())
    assert state["compress_err"].keys() == named.keys()
    for k, e in state["compress_err"].items():
        assert e.shape == named[k].shape and e.dtype == torch.float32 and not e.any()

    def trainer(ckpt_dir):
        tc = ttr.TrainConfig(optimizer=topt.AdamWConfig(lr=2e-3), checkpoint_every=2,
                             grad_compression=True, **TC)
        pipe = tpipe.TokenPipeline(corpora[1].tokens, tpipe.DataConfig(16, 4, seed=0))
        return ttr.Trainer(model, tc, pipe, ckpt_dir=ckpt_dir, seed=3, device="cpu")

    first = trainer(tmp_path)
    first.run(2, log=lambda s: None)
    saved = _state_arrays(first)
    errs = [k for k in saved if k.startswith("['state']['compress_err']")]
    assert [k.replace("compress_err", "params", 1) for k in errs] == \
        [k for k in saved if k.startswith("['state']['params']")]  # JAX's layout
    assert any(np.any(saved[k]) for k in errs)
    resumed = trainer(tmp_path)
    assert resumed.step == 2
    got = _state_arrays(resumed)
    for k in errs:
        np.testing.assert_array_equal(got[k], saved[k], err_msg=k)


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------

def _trainer(corpus, ckpt_dir=None, every=2):
    tc = ttr.TrainConfig(optimizer=topt.AdamWConfig(lr=2e-3), checkpoint_every=every, **TC)
    pipe = tpipe.TokenPipeline(corpus.tokens, tpipe.DataConfig(16, 4, seed=0))
    return ttr.Trainer(build(t_smoke("llama3_2_1b")), tc, pipe, ckpt_dir=ckpt_dir, seed=3,
                       device="cpu")


def _state_arrays(tr) -> dict:
    return {k: v for k, v in _flat(jax.tree.map(
        lambda t: t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t),
        tr.checkpoint_tree())).items()}


def test_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path, corpora):
    """4 steps straight against 2 steps, a fresh Trainer restored from the
    checkpoint, then 2 more: params, moments, step and pipeline bit-equal
    on the CPU; the restored Trainer's next batch is the uninterrupted one's."""
    straight = _trainer(corpora[1])
    straight.run(4, log=lambda s: None)
    first = _trainer(corpora[1], tmp_path)
    first.run(2, log=lambda s: None)
    resumed = _trainer(corpora[1], tmp_path)
    assert resumed.step == 2 and resumed.pipeline.state() == {"step": 2, "seed": 0}
    for k, v in _state_arrays(first).items():
        np.testing.assert_array_equal(_state_arrays(resumed)[k], v)
    resumed.run(2, log=lambda s: None)
    want, got = _state_arrays(straight), _state_arrays(resumed)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tckpt.CheckpointManager(str(tmp_path)).steps() == [2, 4]


def test_uncommitted_corrupt_and_retention(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.ones(2, dtype=torch.bfloat16), np.int32(7)], "n": 5}
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        mgr.save(tree, step=s)
    assert mgr.steps() == [2, 3]  # retention keeps the last two
    # a crash mid-write: a step without COMMIT is ignored
    (tmp_path / "step_00000009").mkdir()
    (tmp_path / "step_00000009" / "MANIFEST.json").write_text("{}")
    got = mgr.restore_latest(tree)
    assert mgr.steps() == [2, 3]
    assert torch.equal(got["a"], tree["a"]) and got["b"][0].dtype == torch.bfloat16
    assert int(got["b"][1]) == 7 and int(got["n"]) == 5
    with pytest.raises(FileNotFoundError, match="COMMIT"):
        mgr.restore(9, tree)
    # a flipped byte in the shard is detected
    raw = tmp_path / "step_00000003" / "shard_0.raw"
    blob = bytearray(raw.read_bytes())
    blob[5] ^= 0x40
    raw.write_bytes(bytes(blob))
    with pytest.raises(IOError, match="corruption"):
        mgr.restore(3, tree)
    async_mgr = tckpt.CheckpointManager(str(tmp_path / "async"), async_save=True)
    async_mgr.save(tree, step=4)
    async_mgr.wait()
    assert async_mgr.steps() == [4]


def test_manifest_digests_equal_jax(tmp_path, corpora):
    """A state carried across from JAX (parameters and nonzero moments after
    one JAX step, the data state, the step) saved by each package: the same
    leaf keys and sha256 digests, and the port restores JAX's values."""
    jmodel, jparams = _jax_model("llama3_2_1b")
    tc = jtr.TrainConfig(optimizer=jopt.AdamWConfig(lr=2e-3), **TC)
    jstate = {"params": jparams, "opt": jopt.adamw_init(jparams)}
    jstate, _ = jax.jit(jtr.make_train_step(jmodel, tc))(
        jstate, {"tokens": jnp.asarray(_batches(corpora[0], 1)[0])})
    data = {"step": 1, "seed": 0}
    jckpt.save_checkpoint(str(tmp_path / "jax"), 1, {"state": jstate, "data": data, "step": 1})

    tr = _trainer(corpora[1])
    cfg = t_smoke("llama3_2_1b")
    tr.state["params"] = params_from_numpy(_np_tree(jstate["params"]), cfg, device="cpu")
    for key in ("m", "v"):
        mod = params_from_numpy(_np_tree(jstate["opt"][key]), cfg, device="cpu")
        tr.state["opt"][key] = {n: p.data for n, p in mod.named_parameters()}
    tr.state["opt"]["step"] = 1
    tr.pipeline.restore(data)
    tr.step = 1
    tr.ckpt = tckpt.CheckpointManager(str(tmp_path / "port"))
    tr._save()
    jm = json.loads((tmp_path / "jax" / "step_00000001" / "MANIFEST.json").read_text())
    tm = json.loads((tmp_path / "port" / "step_00000001" / "MANIFEST.json").read_text())
    assert tm == jm
    back = _trainer(corpora[1], tmp_path / "port")
    assert back.step == 1 and back.state["opt"]["step"] == 1
    for k, want in _flat(jstate["opt"]["m"]).items():
        np.testing.assert_array_equal(_port_tree(back.state["params"],
                                                 back.state["opt"]["m"])[k], want)
