"""PyTorch port vs JAX package: the distribution layer, in one process.

Int8 gradient compression (blockwise quantization, the error-feedback round
trip, three compressed train steps), the fault-tolerance helpers, the
logical-axis rules, the per-cell rules and input specs, and the parameter
and cache specs of every architecture, each held against the JAX package
on the CPU. The multi-process checks (DTensor placements, the sharded train
step, ``compressed_psum``) are in ``test_torch_sharded.py``.

Tolerances, each stated where it is asserted:

* int8 values, scales and the error-feedback round trip: exact (the same
  float32 division, round half to even and clip, in JAX's order);
* the telescoping sum of 20 compressed steps: 1e-4 absolute, JAX's bound;
* three compressed train steps: loss within 1e-5 relative per step, the
  tolerance of ``test_torch_train.py``'s uncompressed steps. Parameters,
  moments and error state: per leaf, at most 5% of the elements are
  "flipped" (their error states more than 1e-3 of the leaf's max-abs
  apart), and the others are within 1e-4 relative L2, the uncompressed
  steps' tolerance. The two
  packages' float32 gradients differ in summation order, so an element
  within rounding of a half step of its block's int8 grid can round to
  neighbouring int8 values in the two: its error state then differs by a
  whole step, AdamW's first steps move it by up to 2 lr in one package and
  not the other, and its next gradients differ too. The error state is a
  difference, ``(g + e) - deq``, about a tenth of the gradient: the
  gradients' float32 differences carry into it whole, so its unflipped
  elements are held within 1e-3 relative L2;
* rules, specs, plans: exact.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core.qlinear import QLinearConfig as JQLinearConfig  # noqa: E402
from repro.core.quantspec import QuantSpec as JQuantSpec  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.distributed import collectives as jcol  # noqa: E402
from repro.distributed import fault_tolerance as jft  # noqa: E402
from repro.distributed import param_sharding as jps  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models.model import build as j_build  # noqa: E402
from repro.models.model import quantize_params as j_quantize_params  # noqa: E402
from repro.optim import adamw as jopt  # noqa: E402
from repro.train import trainer as jtr  # noqa: E402

from repro_torch.checkpoint import checkpointer as tckpt  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.core import QLinearConfig, QuantSpec  # noqa: E402
from repro_torch.distributed import collectives as tcol  # noqa: E402
from repro_torch.distributed import fault_tolerance as tft  # noqa: E402
from repro_torch.distributed import param_sharding as tps  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models.model import (build, params_from_numpy, quantize_model,  # noqa: E402
                                      tree_from_params)
from repro_torch.optim import adamw as topt  # noqa: E402
from repro_torch.train import trainer as ttr  # noqa: E402

ARCHS = tbase.list_archs()
TC = dict(warmup_steps=2, total_steps=10)


def _j_flat_specs(tree) -> dict:
    """JAX's spec tree as ``{"a/b/c": tuple}`` (paths as its own rules name them)."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(jps._names_of(p)): tuple(s) for p, s in flat}


def _t_flat_specs(tree) -> dict:
    return {k: tuple(s) for k, s in tps.flatten_specs(tree).items()}


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _leaf(n_or_shape, seed=0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (n_or_shape,) if isinstance(n_or_shape, int) else n_or_shape
    # a spread of block magnitudes, so the scales differ per block
    return (rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 2, size=shape)).astype(
        np.float32)


@pytest.mark.parametrize("shape", [1, 255, 256, 257, 1000, (37, 29), "ties"],
                         ids=str)
def test_blockwise_quantization_bit_equal_to_jax(shape):
    """int8 values and float32 scales equal JAX's bit for bit, and so does
    the dequantized leaf. ``ties``: a block whose absmax 127 makes the scale
    exactly 1, with values at half-integers (round half to even)."""
    if shape == "ties":
        x = np.zeros(256, np.float32)
        x[:9] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    else:
        x = _leaf(shape, seed=len(str(shape)))
    jq, js = jcol.quantize_blockwise(jnp.asarray(x))
    tq, ts = tcol.quantize_blockwise(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))
    back = tcol.dequantize_blockwise(tq, ts, x.shape).numpy()
    np.testing.assert_array_equal(back, np.asarray(jcol.dequantize_blockwise(jq, js, x.shape)))
    if shape == "ties":
        np.testing.assert_array_equal(tq.numpy()[0, :9], [127, 0, 2, 2, 0, -2, -2, 126, -126])


@pytest.mark.parametrize("seed,n", [(0, 100), (1, 256), (2, 1000), (3, 4097)])
def test_blockwise_quant_error_bound(seed, n):
    """The round trip is within half a quantization step of each block's
    absmax / 127 (the bound of the JAX package's own test)."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(n).astype(np.float32) * 10)
    q, s = tcol.quantize_blockwise(x)
    back = tcol.dequantize_blockwise(q, s, x.shape)
    blocks = torch.nn.functional.pad(x.abs(), (0, (-n) % 256)).reshape(-1, 256)
    tol = (blocks.amax(dim=1, keepdim=True) / 127.0).repeat(1, 256).reshape(-1)[:n]
    assert torch.all((back - x).abs() <= tol * 0.5001 + 1e-7)


def test_error_feedback_matches_jax_and_telescopes():
    """20 steps of ``compress_decompress_tree`` over a two-leaf tree: the
    sent values and the error state equal JAX's exactly every step, and the
    sum of the sent values plus the final error is the sum of the true
    gradients within 1e-4."""
    rng = np.random.default_rng(7)
    grads = [{"w": rng.standard_normal(300).astype(np.float32),
              "m": rng.standard_normal((5, 70)).astype(np.float32) * 1e-3} for _ in range(20)]
    jerr = jcol.init_error_state({k: jnp.asarray(v) for k, v in grads[0].items()})
    terr = tcol.init_error_state({k: torch.from_numpy(v) for k, v in grads[0].items()})
    sent = {k: np.zeros_like(v) for k, v in grads[0].items()}
    for g in grads:
        jsent, jerr = jcol.compress_decompress_tree({k: jnp.asarray(v) for k, v in g.items()},
                                                    jerr)
        tsent, terr = tcol.compress_decompress_tree({k: torch.from_numpy(v)
                                                     for k, v in g.items()}, terr)
        for k in g:
            np.testing.assert_array_equal(tsent[k].numpy(), np.asarray(jsent[k]))
            np.testing.assert_array_equal(terr[k].numpy(), np.asarray(jerr[k]))
            sent[k] = sent[k] + tsent[k].numpy()
    for k in sent:
        true = sum(g[k] for g in grads)
        assert np.max(np.abs(true - (sent[k] + terr[k].numpy()))) < 1e-4


def _load_jax_state(tstate: dict, jstate: dict, cfg) -> None:
    """Copy JAX's train state (params, moments, error state, step) into the
    port's, in place."""
    named = dict(tstate["params"].named_parameters())
    pairs = [(named, jstate["params"]), (tstate["opt"]["m"], jstate["opt"]["m"]),
             (tstate["opt"]["v"], jstate["opt"]["v"]),
             (tstate["compress_err"], jstate["compress_err"])]
    with torch.no_grad():
        for dest, tree in pairs:
            src = params_from_numpy(jax.tree.map(np.asarray, tree), cfg, device="cpu")
            for n, t in src.named_parameters():
                dest[n].copy_(t)
    tstate["opt"]["step"] = int(jstate["opt"]["step"])


def test_three_compressed_train_steps_match_jax():
    """llama3_2_1b smoke (2 layers) from JAX's initial parameters, three
    steps with ``grad_compression=True`` on the same batches, each step from
    JAX's state of the step before (so a rounding flip of one step is not
    compounded into the next): loss within 1e-5 relative; parameters, both
    moments and ``compress_err``: per leaf at most 5% of the elements
    flipped by a rounding step, the others within 1e-4 relative L2 (1e-3
    for the error state; the module docstring says why)."""
    cfg = jbase.get_smoke_config("llama3_2_1b")
    jmodel = j_build(cfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tcfg = tbase.get_smoke_config("llama3_2_1b")
    port = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    tc_kw = dict(optimizer=jopt.AdamWConfig(lr=2e-3), grad_compression=True, **TC)
    jstate = {"params": jparams, "opt": jopt.adamw_init(jparams),
              "compress_err": jcol.init_error_state(jparams)}
    named = dict(port.named_parameters())
    tstate = {"params": port, "opt": topt.adamw_init(named),
              "compress_err": tcol.init_error_state(named)}
    jstep = jax.jit(jtr.make_train_step(jmodel, jtr.TrainConfig(**tc_kw)))
    tstep = ttr.make_train_step(build(tcfg), ttr.TrainConfig(**tc_kw))
    pipe = jpipe.TokenPipeline(jpipe.ByteCorpus().tokens, jpipe.DataConfig(32, 4, seed=5))
    n_flipped = 0
    for i in range(3):
        if i:
            _load_jax_state(tstate, jstate, tcfg)
        b = pipe.next_batch()["tokens"]
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(b)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(b)})
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-5)
        got = ttr.train_state_tree(tstate)
        trees = {"params": (jstate["params"], got["params"]),
                 "m": (jstate["opt"]["m"], got["opt"]["m"]),
                 "v": (jstate["opt"]["v"], got["opt"]["v"]),
                 "compress_err": (jstate["compress_err"], got["compress_err"])}
        flat = {key: (jax.tree_util.tree_flatten_with_path(w)[0],
                      dict(jax.tree_util.tree_flatten_with_path(h)[0]))
                for key, (w, h) in trees.items()}
        for j, (path, err_w) in enumerate(flat["compress_err"][0]):
            err_w = np.asarray(err_w)
            err_h = flat["compress_err"][1][path].numpy()
            # a flip moves the error state by a whole int8 step, at least
            # twice its largest value; the gradients' rounding by far less
            flipped = np.abs(err_h - err_w) > 1e-3 * np.abs(err_w).max()
            n_flipped += int(flipped.sum())
            where = (i, jax.tree_util.keystr(path))
            assert flipped.mean() <= 0.05, (*where, int(flipped.sum()), err_w.size)
            for key, (flat_w, flat_h) in flat.items():
                w, h = np.asarray(flat_w[j][1]), flat_h[path].numpy()
                tol = 1e-3 if key == "compress_err" else 1e-4
                assert _rel_l2(h[~flipped], w[~flipped]) < tol, (*where, key, _rel_l2(h, w))
    assert any(np.any(np.asarray(e)) for e in jax.tree.leaves(jstate["compress_err"]))
    print(f"elements flipped by a rounding step, all leaves and steps: {n_flipped}")


# ---------------------------------------------------------------------------
# fault tolerance
# ---------------------------------------------------------------------------

_PLANS = [(s, tp, b, c, cpp) for s in (1, 7, 16, 250, 256, 511, 512, 513, 1024)
          for tp in (1, 4, 16) for b, c in ((256, 512), (1024, 256)) for cpp in (256, 64)]


def test_elastic_plan_equals_jax():
    """The plan (mesh shape and axes, global batch, note) on a grid of
    (surviving, tp, batch, chips, chips per pod), and the same ValueError
    where fewer chips than one TP group survive."""
    for args in _PLANS:
        try:
            want = jft.elastic_plan(*args)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                tft.elastic_plan(*args)
            continue
        assert dataclasses.asdict(tft.elastic_plan(*args)) == dataclasses.asdict(want), args
    with pytest.raises(ValueError, match="TP group"):
        tft.elastic_plan(3, 4, 256, 512)


def test_heartbeat_and_resumable_step_on_port_checkpoints(tmp_path):
    """``find_resumable_step`` finds the newest COMMIT-marked step that the
    port's checkpointer wrote (an uncommitted later step is skipped), as
    JAX's does on the same directory; heartbeats: a stale and a garbled file
    are not live, for both packages."""
    ck = tmp_path / "ckpt"
    assert tft.find_resumable_step(str(ck)) is None
    mgr = tckpt.CheckpointManager(str(ck))
    for step in (2, 4):
        mgr.save({"w": torch.ones(3)}, step=step)
    (ck / "step_00000006").mkdir()  # a crash mid-write: no COMMIT
    assert tft.find_resumable_step(str(ck)) == 4 == jft.find_resumable_step(str(ck))

    hb = tmp_path / "hb"
    for host in (0, 1, 2):
        tft.Heartbeat(str(hb), host).beat(step=10 + host)
    old = json.loads((hb / "heartbeat_1.json").read_text())
    (hb / "heartbeat_1.json").write_text(json.dumps({**old, "t": time.time() - 120}))
    (hb / "heartbeat_3.json").write_text("{not json")
    assert json.loads((hb / "heartbeat_2.json").read_text())["step"] == 12
    assert tft.Heartbeat.live_hosts(str(hb)) == [0, 2] == jft.Heartbeat.live_hosts(str(hb))
    assert tft.Heartbeat.live_hosts(str(hb), stale_after_s=1e6) == [0, 1, 2]


# ---------------------------------------------------------------------------
# rules, cells, shapes
# ---------------------------------------------------------------------------

_LOGICAL = [("batch", "seq", "d_model"), ("batch", "seq_sp", "d_model"),
            ("batch", "seq", "kv_heads", None, None), ("dispatch_groups", "experts", None, None),
            (None, "vocab"), (), ("unknown", None)]


def test_rules_and_spec_for_equal_jax():
    """The rule tables, ``spec_for`` under each table and under the active
    rules (``use_rules``), entry for entry."""
    assert tsh.DEFAULT_RULES == jsh.DEFAULT_RULES
    assert tsh.MULTI_POD_RULES == jsh.MULTI_POD_RULES
    for rules in (tsh.DEFAULT_RULES, tsh.MULTI_POD_RULES):
        for axes in _LOGICAL:
            assert tuple(tsh.spec_for(*axes, rules=rules)) == \
                tuple(jsh.spec_for(*axes, rules=rules))
            with tsh.use_rules(rules), jsh.use_rules(rules):
                assert tsh.active_rules() is rules
                assert tuple(tsh.spec_for(*axes)) == tuple(jsh.spec_for(*axes))
    assert tsh.active_rules() is None and tsh.active_mesh() is None


def test_constrain_without_mesh_is_the_identity():
    """With rules active and no mesh, ``constrain`` and ``replicate`` leave a
    plain tensor as it is (the same object); without rules too; a local
    site (``run_local``) just calls its function on it."""
    x = torch.randn(2, 3, 4)
    assert tsh.constrain(x, "batch", "seq", "d_ff") is x
    with tsh.use_rules(tsh.DEFAULT_RULES):
        assert tsh.constrain(x, "batch", "seq", "d_ff") is x
        assert tsh.constrain(x, None, None, None) is x
        assert tsh.replicate(x) is x
        assert tsh.run_local(lambda t: t * 2, x, dims=(0,)).equal(x * 2)


def test_cells_equal_jax():
    """``SHAPES``, ``list_archs``, the mesh constants, and per (arch, shape,
    mesh): ``make_rules`` (with and without a shardable batch, with and
    without sequence parallelism), ``skip_reason``, ``runnable`` and
    ``input_specs`` (shapes and dtype names)."""
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    assert tbase.list_archs() == jbase.list_archs()
    assert tbase.list_archs(assigned_only=True) == jbase.list_archs(assigned_only=True)
    assert tmesh.MODEL_AXIS_SIZE == jmesh.MODEL_AXIS_SIZE
    for mp in (False, True):
        assert tmesh.batch_axes_for(mp) == jmesh.batch_axes_for(mp)
        assert tspecs._batch_shards(mp) == jspecs._batch_shards(mp)
    for arch in ARCHS:
        tcfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
        for name, shape in jbase.SHAPES.items():
            tshape = tbase.SHAPES[name]
            for mp in (False, True):
                for shardable in (False, True):
                    for sp in (False, True):
                        kw = dict(batch_shardable=shardable, seq_parallel=sp,
                                  seq_len=shape.seq_len)
                        assert tspecs.make_rules(tcfg, mp, **kw) == \
                            jspecs.make_rules(jcfg, mp, **kw), (arch, name, mp, kw)
            assert tspecs.skip_reason(tcfg, tshape) == jspecs.skip_reason(jcfg, shape)
            assert tspecs.runnable(tcfg, tshape) == jspecs.runnable(jcfg, shape)
            got = {k: (v.shape, str(v.dtype).removeprefix("torch."))
                   for k, v in tspecs.input_specs(tcfg, tshape).items()}
            want = {k: (tuple(v.shape), str(v.dtype))
                    for k, v in jspecs.input_specs(jcfg, shape).items()}
            assert got == want, (arch, name)


def test_make_mesh_checks_the_world_size():
    """Without a process group the world is one rank: a (2, 2) or the
    production mesh is refused before any device is touched."""
    with pytest.raises(ValueError, match="needs 4 ranks"):
        tmesh.make_mesh((2, 2), ("data", "model"), "cpu")
    with pytest.raises(ValueError, match="needs 256 ranks"):
        tmesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        tmesh.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="differ in length"):
        tmesh.make_mesh((2, 2), ("data",), "cpu")


# ---------------------------------------------------------------------------
# parameter and cache specs
# ---------------------------------------------------------------------------

def _trees(arch):
    """(JAX float shapes, JAX quantized shapes, the port's float model, the
    port's quantized JAX-layout tree) of a smoke config."""
    jmodel = j_build(jbase.get_smoke_config(arch))
    jf = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0)))
    jq = jax.eval_shape(lambda p: j_quantize_params(
        p, JQuantSpec(base=JQLinearConfig(detection="none"))), jf)
    tmodel = build(tbase.get_smoke_config(arch))
    port = tmodel.init(0, device="cpu")
    tq = tree_from_params(quantize_model(tmodel, port,
                                         QuantSpec(base=QLinearConfig(detection="none"))))
    return jf, jq, port, tq


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch):
    """``build_param_specs`` leaf by leaf against JAX's, on the float and the
    quantized tree (``packed``, ``scale``, codebooks), with model_size 4 and
    16, with and without FSDP over ("data",) in 4 shards; and
    ``parameter_specs`` gives every float parameter its leaf's spec without
    the stack axes."""
    jf, jq, port, tq = _trees(arch)
    tf = tps.param_shapes(port)
    for model_size in (4, 16):
        for fsdp in ({}, dict(fsdp_axes=("data",), fsdp_shards=4)):
            for jtree, ttree in ((jf, tf), (jq, tq)):
                want = _j_flat_specs(jps.build_param_specs(jtree, model_size, **fsdp))
                got = _t_flat_specs(tps.build_param_specs(ttree, model_size, **fsdp))
                assert got == want, (arch, model_size, fsdp)
            per_param = tps.parameter_specs(port, tps.build_param_specs(tf, model_size))
            assert per_param.keys() == dict(port.named_parameters()).keys()
            for name, p in port.named_parameters():
                assert len(per_param[name]) == p.ndim, name


def test_a_spec_sharding_a_stack_axis_raises():
    """A spec that shards the layer axis of a scanned leaf cannot be carried
    by per-layer parameters: ``parameter_specs`` names the leaf and raises."""
    port = build(tbase.get_smoke_config("llama3_2_1b")).init(0, device="cpu")
    specs = tps.build_param_specs(tps.param_shapes(port), 4)
    specs["blocks"]["norm1"]["scale"] = tsh.P("data", None)
    with pytest.raises(ValueError, match="blocks/norm1/scale"):
        tps.parameter_specs(port, specs)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_jax(arch):
    """``build_cache_specs`` on JAX's cache shape trees (float and int4, ring
    layout), batch over ("data",) in 2 or 16 shards, model_size 4 and 16."""
    cfg = jbase.get_smoke_config(arch)
    jmodel = j_build(cfg)
    for quantized in (False, True):
        if quantized and cfg.family == "vlm":
            continue  # the vlm's caches are float only, in both packages
        shapes = jax.eval_shape(lambda: jmodel.init_caches(16, 32, jnp.bfloat16, quantized))
        for shards, model_size in ((2, 4), (16, 16), (16, 4)):
            kw = dict(kv_heads=cfg.n_kv_heads, ssm_state=cfg.ssm_state)
            want = _j_flat_specs(jps.build_cache_specs(shapes, ("data",), shards, model_size,
                                                       **kw))
            got = _t_flat_specs(tps.build_cache_specs(shapes, ("data",), shards, model_size,
                                                      **kw))
            assert got == want, (arch, quantized, shards, model_size)


def test_port_imports_no_jax():
    """The port's distribution and launch modules import neither ``jax`` nor
    the JAX package."""
    root = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch")
    for sub in ("distributed", "launch"):
        for f in sorted(os.listdir(os.path.join(root, sub))):
            if f.endswith(".py"):
                src = open(os.path.join(root, sub, f)).read()
                for bad in ("import jax", "from jax", "import repro.", "from repro."):
                    assert bad not in src, (sub, f, bad)
