"""The port's sharded train and serving steps on 4 gloo ranks (CPU), held
against its single-process steps.

One launch of 4 worker processes (this file run as a script, one PyTorch
thread each, a free localhost port) on a (2, 2) ("data", "model") mesh
serves the whole file; each test reads what rank 0 recorded. The rules are
those of the JAX package's own distribution test (model axis 2 here), the
configs its three: ``llama3_2_1b``, ``granite_moe_3b_a800m`` with
``moe_dispatch_groups=2`` and ``falcon_mamba_7b``, smoke sizes, two
microbatches, a (4, 17) batch.

The single-process port step is held against JAX's by
``test_torch_train.py`` and ``test_torch_distributed.py``, so the chain
reaches JAX.

Tolerances: the sharded loss within 1e-5 relative of the single-process
one, every parameter within 1e-5 relative L2 -- DTensor reduces partial
sums across ranks in another order. The error state of a compressed step:
at most 1% of each leaf's elements "flipped" (more than 1e-3 of the leaf's
max-abs apart: a gradient element within rounding of a half step of its
block's int8 grid rounds to neighbouring values in the two runs, and its
error differs by a whole step), the others within 1e-3 relative L2: the
error, ``(g + e) - deq``, is about a tenth of the gradient, and the
gradients' float32 differences carry into it whole.
``compressed_psum`` exactly equal to a numpy model of the protocol and
within ``n_ranks * scale`` of the true sum; checkpoint digests equal.

Serving (``SERVE_CASES``: the 2-layer llama, the llama with one KV head,
whose ring caches shard head_dim, and the 2-layer granite, quantized): one
prefill and three decode steps with float and int4 caches, and a
static_dense prefill, give the single process's tokens exactly and logits
within 1e-5 relative L2. A train step of the one-KV-head llama (its KV
head repeated for the sharded query heads) within the train step's
tolerances; and each rank's routed-expert matmul FLOPs, counted by
``launch.roofline.analyze_step``, are exactly 1/data of the single
process's.
"""

import copy
import dataclasses
import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ARCHS = ("llama3_2_1b", "granite_moe_3b_a800m", "falcon_mamba_7b")
RULES = {"batch": "data", "seq": None, "seq_sp": None, "d_model": None,
         "heads_flat": "model", "kv_heads": None, "d_ff": "model", "vocab": "model",
         "experts": None, "dispatch_groups": "data", "d_inner": "model", "state": None}
WORLD = 4
PSUM_SIZES = (1000, 300)


def _psum_input(rank: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(100 * rank + n)
    return (rng.standard_normal(n) * 10.0 ** rng.uniform(-2, 1, size=n)).astype(np.float32)


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp(min=1e-30))


def _worker(rank: int, port: int, out: pathlib.Path) -> None:
    """One rank: every check, in the same order on every rank (the
    collectives must match); rank 0 writes ``results.json``."""
    import torch.distributed as dist

    from repro_torch.checkpoint.checkpointer import CheckpointManager
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.distributed.collectives import compressed_psum
    from repro_torch.distributed.param_sharding import (build_param_specs, param_shapes,
                                                        parameter_specs)
    from repro_torch.distributed.sharding import placements_for, use_rules
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import build
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import (TrainConfig, init_train_state, make_train_step,
                                           shard_batch, shard_train_state, train_state_tree)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=WORLD)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    res: dict = {"steps": {}}
    for arch in ARCHS:
        cfg = dataclasses.replace(get_smoke_config(arch), moe_dispatch_groups=2)
        model = build(cfg)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 17), dtype=torch.int32,
                                         generator=torch.Generator().manual_seed(1))}
        for comp in (False, True):
            tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), microbatches=2,
                             grad_compression=comp)
            step = make_train_step(model, tc)
            state = init_train_state(model, 0, tc, device="cpu")
            single = copy.deepcopy(state)
            _, m1 = step(single, batch)
            want_placements = {
                k: placements_for(s, mesh) for k, s in parameter_specs(
                    state["params"], build_param_specs(param_shapes(state["params"]), 2)
                ).items()}
            shard_train_state(state, mesh, model_size=2)
            with use_rules(RULES, mesh):
                _, m2 = step(state, shard_batch(batch, mesh, "data"))
            ref = dict(single["params"].named_parameters())
            rec = {"loss_single": float(m1["loss"]), "loss_sharded": float(m2["loss"].full_tensor()),
                   "param_rel_l2": {}, "placements_ok": {}, "sharded_params": 0}
            for k, p in state["params"].named_parameters():
                rec["param_rel_l2"][k] = _rel_l2(p.full_tensor(), ref[k])
                rec["placements_ok"][k] = tuple(p.placements) == tuple(want_placements[k])
                rec["sharded_params"] += any(not pl.is_replicate() for pl in p.placements)
            if comp:
                rec["err_flipped"], rec["err_rel_l2"] = {}, {}
                for k, e in state["compress_err"].items():
                    got, want = e.full_tensor(), single["compress_err"][k]
                    flipped = (got - want).abs() > 1e-3 * want.abs().max()
                    rec["err_flipped"][k] = float(flipped.float().mean())
                    rec["err_rel_l2"][k] = _rel_l2(got[~flipped], want[~flipped])
            res["steps"][f"{arch}/{int(comp)}"] = rec
    # a checkpoint of the sharded (compressed) llama state, and the same
    # state's single-process save
    cfg = get_smoke_config("llama3_2_1b")
    tc = TrainConfig(grad_compression=True)
    state = init_train_state(build(cfg), 0, tc, device="cpu")
    tree = {"state": train_state_tree(state), "step": 0}
    if rank == 0:
        CheckpointManager(str(out / "single")).save(tree, step=0)
    shard_train_state(state, mesh, model_size=2)
    CheckpointManager(str(out / "sharded")).save({"state": train_state_tree(state), "step": 0},
                                                 step=0)
    res["serve"] = _serving_checks(mesh)
    res["expanded"] = _expanded_heads_step(mesh)
    res["moe_flops"] = _moe_expert_flops(mesh)
    res["psum"] = {}
    for n in PSUM_SIZES:
        got = compressed_psum(torch.from_numpy(_psum_input(rank, n)))
        res["psum"][str(n)] = got.numpy().tolist()
    dist.barrier()
    if rank == 0:
        (out / "results.json").write_text(json.dumps(res))
    dist.destroy_process_group()


SERVE_CASES = {"llama": ("llama3_2_1b", {}), "llama_kv1": ("llama3_2_1b", {"n_kv_heads": 1}),
               "granite": ("granite_moe_3b_a800m", {"moe_dispatch_groups": 2})}
SERVE_BATCH, SERVE_PROMPT, SERVE_CACHE, DECODE_STEPS = 4, 8, 16, 3


def _serving_checks(mesh) -> dict:
    """One prefill and three decode steps of each ``SERVE_CASES`` config,
    quantized (dynamic detection) with float and int4 KV caches, single
    process against sharded (params by ``build_param_specs``, caches by
    ``build_cache_specs``, tokens on "data"); and a static_dense prefill
    (the prefill cells' detection). Returns per case the tokens and the
    worst logits' relative L2 of each step."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.core import QLinearConfig, QuantSpec
    from repro_torch.distributed.param_sharding import (build_cache_specs, build_param_specs,
                                                        cache_tree, distribute_caches,
                                                        distribute_params)
    from repro_torch.distributed.sharding import (distribute_replicated, placements_for,
                                                  use_rules)
    from repro_torch.models.model import build, quantize_model, tree_from_params
    from repro_torch.serving.engine import ServeConfig, make_prefill_step, make_serve_step

    out = {}
    for case, (arch, over) in SERVE_CASES.items():
        cfg = dataclasses.replace(get_smoke_config(arch), **over)
        model = build(cfg)
        params = model.init(0, device="cpu")
        prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), dtype=torch.int32,
                               generator=torch.Generator().manual_seed(2))
        for det in ("dynamic", "static_dense"):
            qp = quantize_model(model, params, QuantSpec(base=QLinearConfig(detection=det)))
            for kv_quant in (False, True):
                if det == "static_dense" and kv_quant:
                    continue
                sc = ServeConfig(cache_len=SERVE_CACHE, kv_quant=kv_quant)
                steps = DECODE_STEPS if det == "dynamic" else 0
                runs = []
                for sharded in (False, True):
                    p = copy.deepcopy(qp)
                    caches = model.init_caches(SERVE_BATCH, SERVE_CACHE, torch.float32, kv_quant,
                                               device="cpu")
                    put = lambda t, spec: t
                    rules = None
                    if sharded:
                        distribute_params(p, build_param_specs(tree_from_params(p), 2), mesh)
                        cspecs = build_cache_specs(cache_tree(caches, cfg), "data", 2, 2,
                                                   kv_heads=cfg.n_kv_heads,
                                                   ssm_state=cfg.ssm_state)
                        caches = distribute_caches(caches, cfg, cspecs, mesh)
                        put = lambda t, spec: distribute_replicated(
                            t, mesh, placements_for(spec, mesh))
                        rules = RULES
                    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
                    with use_rules(rules, mesh if sharded else None):
                        tok, caches, logits = make_prefill_step(model, sc)(
                            p, caches, {"tokens": put(prompt, ("data", None))})
                        seq = [(full(tok).tolist(), full(logits))]
                        serve = make_serve_step(model, sc)
                        for i in range(steps):
                            tok, caches, logits = serve(
                                p, caches, put(full(tok)[:, None], ("data", None)),
                                put(torch.tensor(SERVE_PROMPT + i, dtype=torch.int32), ()))
                            seq.append((full(tok).tolist(), full(logits)))
                    runs.append(seq)
                (single, sharded) = runs
                out[f"{case}/{det}/{int(kv_quant)}"] = {
                    "tokens_single": [t for t, _ in single],
                    "tokens_sharded": [t for t, _ in sharded],
                    "logits_rel_l2": [_rel_l2(b[1], a[1]) for a, b in zip(single, sharded)],
                }
    return out


def _expanded_heads_step(mesh) -> dict:
    """A train step of the 2-layer llama with one KV head (the model axis
    of 2 does not divide it: each KV head is repeated for its query heads,
    which are sharded), sharded against single-process."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.models.model import build
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import (TrainConfig, init_train_state, make_train_step,
                                           shard_batch, shard_train_state)

    cfg = dataclasses.replace(get_smoke_config("llama3_2_1b"), n_kv_heads=1)
    model = build(cfg)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 17), dtype=torch.int32,
                                     generator=torch.Generator().manual_seed(3))}
    tc = TrainConfig(optimizer=AdamWConfig(lr=1e-3), microbatches=2)
    step = make_train_step(model, tc)
    state = init_train_state(model, 0, tc, device="cpu")
    single = copy.deepcopy(state)
    _, m1 = step(single, batch)
    shard_train_state(state, mesh, model_size=2)
    with use_rules(RULES, mesh):
        _, m2 = step(state, shard_batch(batch, mesh, "data"))
    ref = dict(single["params"].named_parameters())
    return {"loss_single": float(m1["loss"]), "loss_sharded": float(m2["loss"].full_tensor()),
            "param_rel_l2": {k: _rel_l2(p.full_tensor(), ref[k])
                             for k, p in state["params"].named_parameters()}}


def _moe_expert_flops(mesh) -> dict:
    """Matmul FLOPs of the routed experts (``models/moe.py``'s ``_routed``)
    in one granite forward of the (4, 16) batch, counted by
    ``analyze_step``: single-process (what each rank computed when the
    experts ran replicated) and one rank's share of the sharded forward."""
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.distributed.param_sharding import (build_param_specs, distribute_params,
                                                        param_shapes)
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.launch.roofline import analyze_step
    from repro_torch.models.model import build
    from repro_torch.train.trainer import shard_batch

    cfg = dataclasses.replace(get_smoke_config("granite_moe_3b_a800m"), moe_dispatch_groups=4)
    model = build(cfg)
    params = model.init(0, device="cpu")
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 16), dtype=torch.int32,
                                     generator=torch.Generator().manual_seed(4))}
    fwd = lambda p, b: model.apply(p, b).logits
    expert = lambda a: sum(f for src, f in a["flops_by_source"].items()
                           if src.endswith("moe.py:_routed"))
    with torch.no_grad():
        single = analyze_step(fwd, params, batch)
        distribute_params(params, build_param_specs(param_shapes(params), 2), mesh)
        with use_rules(RULES, mesh):
            sharded = analyze_step(fwd, params, shard_batch(batch, mesh, "data"))
    return {"single": expert(single), "sharded": expert(sharded), "data": 2}


@pytest.fixture(scope="module")
def results(tmp_path_factory) -> dict:
    out = tmp_path_factory.mktemp("sharded")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(filter(None, [src, os.environ.get("PYTHONPATH")]))}
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(port), str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), "\n".join(log[-3000:] for log in logs)
    return {"out": out, **json.loads((out / "results.json").read_text())}


@pytest.mark.parametrize("comp", [False, True], ids=["plain", "compressed"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_single_process(results, arch, comp):
    """Loss within 1e-5 relative; every parameter within 1e-5 relative L2 of
    the single-process step; compressed, every error state at most 1%
    flipped and otherwise within 1e-3 relative L2."""
    rec = results["steps"][f"{arch}/{int(comp)}"]
    np.testing.assert_allclose(rec["loss_sharded"], rec["loss_single"], rtol=1e-5)
    worst = max(rec["param_rel_l2"].items(), key=lambda kv: kv[1])
    assert worst[1] < 1e-5, worst
    if comp:
        worst = max(rec["err_flipped"].items(), key=lambda kv: kv[1])
        assert worst[1] <= 0.01, worst
        worst = max(rec["err_rel_l2"].items(), key=lambda kv: kv[1])
        assert worst[1] < 1e-3, worst


@pytest.mark.parametrize("arch", ARCHS)
def test_placements_are_the_param_specs(results, arch):
    """Each parameter's DTensor placements are those of its
    ``build_param_specs`` leaf (after the step too), and the model axis
    really shards some of them."""
    for comp in (0, 1):
        rec = results["steps"][f"{arch}/{comp}"]
        assert all(rec["placements_ok"].values()), \
            [k for k, ok in rec["placements_ok"].items() if not ok]
        assert rec["sharded_params"] > 0


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_sharded_serving_steps_equal_single_process(results, case):
    """The prefill and three decode steps, sharded on the (2, 2) mesh
    (quantized projections split by columns or by input channels, caches
    on batch rows and KV heads or head_dim, float and int4), give the
    single process's tokens at every step, and logits within 1e-5 relative
    L2: the sharded steps sum the row-parallel projections' partial sums
    and the factorized products over other splits, in another order. A
    static_dense prefill (the prefill cells' detection) likewise."""
    runs = {k: v for k, v in results["serve"].items() if k.startswith(case + "/")}
    assert len(runs) == 3
    for key, rec in runs.items():
        assert rec["tokens_sharded"] == rec["tokens_single"], key
        assert max(rec["logits_rel_l2"]) < 1e-5, (key, rec["logits_rel_l2"])


def test_sharded_step_with_expanded_kv_heads(results):
    """A train step where the model axis does not divide the KV heads (each
    repeated for its query heads) equals the single-process one: loss within
    1e-5 relative, every parameter within 1e-5 relative L2."""
    rec = results["expanded"]
    np.testing.assert_allclose(rec["loss_sharded"], rec["loss_single"], rtol=1e-5)
    worst = max(rec["param_rel_l2"].items(), key=lambda kv: kv[1])
    assert worst[1] < 1e-5, worst


def test_moe_expert_flops_are_split_over_data(results):
    """Each rank of the sharded granite forward counts 1/data of the routed
    experts' matmul FLOPs that the single process (and each rank of a
    replicated dispatch) counts: the dispatch groups are split over "data"."""
    rec = results["moe_flops"]
    assert rec["single"] > 0
    assert rec["sharded"] * rec["data"] == rec["single"]


def test_compressed_psum_is_the_protocol(results):
    """``compressed_psum`` over 4 ranks equals a numpy model of JAX's
    protocol exactly (shared per-block scale from the max of the ranks'
    absmax, int8 round half to even, int32 sum, one dequantization) and is
    within ``n_ranks * scale`` of the true sum."""
    for n in PSUM_SIZES:
        xs = [_psum_input(r, n) for r in range(WORLD)]
        pad = (-n) % 256
        blocks = [np.pad(x, (0, pad)).reshape(-1, 256) for x in xs]
        amax = np.max([np.abs(b).max(axis=1, keepdims=True) for b in blocks], axis=0)
        scale = np.maximum(amax, np.float32(1e-12)) / np.float32(127.0)
        q = [np.clip(np.rint(b / scale), -127, 127).astype(np.int8) for b in blocks]
        total = np.sum([v.astype(np.int32) for v in q], axis=0)
        want = (total.astype(np.float32) * scale).reshape(-1)[:n]
        got = np.asarray(results["psum"][str(n)], np.float32)
        np.testing.assert_array_equal(got, want)
        bound = np.repeat(WORLD * scale, 256, axis=1).reshape(-1)[:n]
        assert np.all(np.abs(got - np.sum(xs, axis=0)) <= bound)


def test_sharded_checkpoint_has_the_single_process_digests(results):
    """Rank 0's save of a sharded (compressed) llama train state, gathered to
    the whole logical leaves, has the single-process save's leaf keys and
    digests; no other rank wrote a shard."""
    manifests = [json.loads((results["out"] / d / "step_00000000" / "MANIFEST.json").read_text())
                 for d in ("sharded", "single")]
    assert manifests[0] == manifests[1]
    assert any("compress_err" in k for k in manifests[0]["leaves"])
    assert sorted(p.name for p in (results["out"] / "sharded" / "step_00000000").iterdir()) == \
        ["COMMIT", "MANIFEST.json", "shard_0.json", "shard_0.raw"]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), pathlib.Path(sys.argv[3]))
