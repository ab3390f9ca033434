"""The port's step analysis and H100 roofline (``repro_torch.launch``),
held against known counts and against JAX's ``analyze_hlo``.

* JAX's scan test graph (``tests/test_system.py``), written as a loop:
  exactly 2 * 8 * 64 * 64 * 6 matmul FLOPs.
* On a fake 4-rank (2, 2) mesh (a subprocess: a process group left in a
  test worker would leak into its next file): a DTensor matmul counts the
  local product once, a known ``redistribute`` the bytes of its
  all-gather on its mesh dim, and the terms follow ``HW``'s rates.
* A smoke llama's float train step and float prefill count JAX's
  ``analyze_hlo`` dot FLOPs exactly. For an untied head (nemotron) the
  train step counts one product more than JAX: the CE chunk's logits,
  which the port computes in the forward and again in the checkpointed
  chunk's backward, and which XLA computes once.
* ``dryrun`` on one smoke cell of each kind on the fake (16, 16) mesh, then
  ``report`` and ``profile_comms`` on its output (subprocesses).
* The link rates: with 8 cards a host, every dim of the production meshes
  spans hosts.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_smoke_config as j_smoke  # noqa: E402
from repro.launch.roofline import analyze_hlo  # noqa: E402
from repro.models.model import build as j_build  # noqa: E402
from repro.serving.engine import ServeConfig as JServeConfig  # noqa: E402
from repro.serving.engine import make_prefill_step as j_prefill  # noqa: E402
from repro.train.trainer import TrainConfig as JTrainConfig  # noqa: E402
from repro.train.trainer import init_train_state as j_init_state  # noqa: E402
from repro.train.trainer import make_train_step as j_train_step  # noqa: E402

from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.launch.roofline import (HW, analyze_step, link_bandwidth,  # noqa: E402
                                         roofline_terms)
from repro_torch.models.model import build  # noqa: E402
from repro_torch.serving.engine import ServeConfig, make_prefill_step  # noqa: E402
from repro_torch.train.trainer import (TrainConfig, init_train_state,  # noqa: E402
                                       make_train_step)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCH, SEQ, PROMPT, CACHE = 4, 16, 8, 16


def _run(code: str, *args, timeout=240) -> subprocess.CompletedProcess:
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(filter(None, [str(ROOT / "src"),
                                                       os.environ.get("PYTHONPATH")]))}
    return subprocess.run([sys.executable, *(["-c", code] if code else []), *args], env=env,
                          capture_output=True, text=True, timeout=timeout, cwd=ROOT)


def test_scan_graph_counts_exactly():
    """JAX's analyzer test graph: six (8, 64) @ (64, 64) products in a
    loop, where XLA needs the scan's trip count to weight its body."""
    w, x = torch.randn(6, 64, 64), torch.randn(8, 64)

    def f(w, x):
        c = x
        for i in range(w.shape[0]):
            c = torch.tanh(c @ w[i])
        return c.sum()

    a = analyze_step(f, w, x)
    assert a["matmul_flops"] == 2 * 8 * 64 * 64 * 6
    assert a["flops_by_op"] == {"mm": 2 * 8 * 64 * 64 * 6}
    assert a["argument_bytes"] == (6 * 64 * 64 + 8 * 64) * 4
    assert a["collective_bytes"] == 0


_FAKE_MESH = textwrap.dedent("""
    import json, torch
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed.sharding import distribute_replicated
    from repro_torch.launch.dryrun import init_fake_world
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.roofline import analyze_step, roofline_terms
    init_fake_world(4)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    a = distribute_replicated(torch.randn(64, 128), mesh, [Shard(0), Replicate()])
    b = distribute_replicated(torch.randn(128, 256), mesh, [Replicate(), Shard(1)])
    mm = analyze_step(lambda p, q: p @ q, a, b)
    gather = analyze_step(lambda p: p.redistribute(mesh, [Replicate(), Replicate()]), a)
    print(json.dumps({"mm": mm, "gather": gather,
                      "gather_roofline": roofline_terms(gather).as_dict()}))
    torch.distributed.destroy_process_group()
""")


@pytest.fixture(scope="module")
def fake_mesh() -> dict:
    r = _run(_FAKE_MESH)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_dtensor_matmul_counts_the_local_product_once(fake_mesh):
    """(64, 128) rows on "data" @ (128, 256) columns on "model": each rank
    computes (32, 128) @ (128, 128); the global product that DTensor runs
    on fake tensors to learn its output shape is not counted."""
    mm = fake_mesh["mm"]
    assert mm["matmul_flops"] == 2 * 32 * 128 * 128
    assert mm["collective_bytes"] == 0
    assert mm["mesh"] == {"shape": [2, 2], "axes": ["data", "model"]}
    assert mm["argument_bytes"] == (32 * 128 + 128 * 128) * 4


def test_redistribute_collective_bytes(fake_mesh):
    """Shard(0) on "data" -> Replicate: one all-gather over "data" of the
    rank's (32, 128) float32 rows, 16384 bytes; its term is those bytes at
    NVLink's rate (the (2, 2) mesh's "data" dim, stride 2, lies within the
    4 ranks of one host)."""
    g = fake_mesh["gather"]
    assert g["collective_breakdown"] == {"all_gather": 32 * 128 * 4}
    assert g["collective_bytes_by_dim"] == {"data": 32 * 128 * 4}
    assert [(c["op"], c["dim"], c["count"]) for c in g["collectives"]] == \
        [("all_gather", "data", 1)]
    assert g["output_bytes"] == 64 * 128 * 4
    rr = fake_mesh["gather_roofline"]
    assert rr["collective_s"] == pytest.approx(32 * 128 * 4 / HW().nvlink_bw, rel=1e-12)


def test_link_rates_follow_the_hosts():
    """Row-major ranks, 8 cards a host: a dim whose group fits in a host is
    NVLink, else inter-host; the production meshes' dims all span hosts."""
    hw = HW()
    single = {"shape": [16, 16], "axes": ["data", "model"]}
    multi = {"shape": [2, 16, 16], "axes": ["pod", "data", "model"]}
    for mesh in (single, multi):
        for dim in mesh["axes"]:
            assert link_bandwidth(mesh, dim) == hw.inter_host_bw
    small = {"shape": [4, 2], "axes": ["data", "model"]}
    assert link_bandwidth(small, "model") == hw.nvlink_bw
    assert link_bandwidth(small, "data") == hw.nvlink_bw
    assert link_bandwidth({"shape": [2, 8], "axes": ["data", "model"]}, "data") == \
        hw.inter_host_bw
    terms = roofline_terms({"matmul_flops": hw.peak_flops, "argument_bytes": 0,
                            "output_bytes": 0, "peak_bytes": 0, "collective_bytes": 5e10,
                            "collective_bytes_by_dim": {"model": 5e10}, "mesh": single})
    assert (terms.compute_s, terms.collective_s, terms.bottleneck) == (1.0, 1.0, "compute")


def _jax_train_flops(arch: str) -> float:
    jm = j_build(j_smoke(arch))
    state = jax.eval_shape(lambda: j_init_state(jm, jax.random.PRNGKey(0), JTrainConfig()))
    batch = {"tokens": jax.ShapeDtypeStruct((BATCH, SEQ + 1), jnp.int32)}
    hlo = jax.jit(j_train_step(jm, JTrainConfig())).lower(state, batch).compile().as_text()
    return analyze_hlo(hlo)["dot_flops"]


def _port_train(arch: str) -> dict:
    model = build(get_smoke_config(arch))
    state = init_train_state(model, 0, TrainConfig(), device="cpu")
    return analyze_step(make_train_step(model, TrainConfig()), state,
                        {"tokens": torch.zeros((BATCH, SEQ + 1), dtype=torch.int32)})


def test_smoke_llama_train_and_prefill_flops_equal_jax():
    """Float train step (4 x 16 tokens) and float prefill (4 x 8 into a
    ring of 16): the port's matmul FLOPs equal the dot FLOPs of JAX's
    compiled HLO exactly; no product is computed on one side only."""
    assert _port_train("llama3_2_1b")["matmul_flops"] == _jax_train_flops("llama3_2_1b")
    jm = j_build(j_smoke("llama3_2_1b"))
    params = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    caches = jax.eval_shape(lambda: jm.init_caches(BATCH, CACHE, jnp.float32, False))
    batch = {"tokens": jax.ShapeDtypeStruct((BATCH, PROMPT), jnp.int32)}
    hlo = jax.jit(j_prefill(jm, JServeConfig(cache_len=CACHE))).lower(
        params, caches, batch).compile().as_text()
    model = build(get_smoke_config("llama3_2_1b"))
    got = analyze_step(make_prefill_step(model, ServeConfig(cache_len=CACHE)),
                       model.init(0, device="cpu"),
                       model.init_caches(BATCH, CACHE, torch.float32, False, device="cpu"),
                       {"tokens": torch.zeros((BATCH, PROMPT), dtype=torch.int32)})
    assert got["matmul_flops"] == analyze_hlo(hlo)["dot_flops"]


def test_untied_head_counts_the_recomputed_ce_logits():
    """nemotron (untied head): the port counts exactly one (tokens x d) @
    (d x vocab) product more than JAX, the CE chunk's logits recomputed in
    its checkpointed backward, and both CE-chunk call paths carry it."""
    cfg = get_smoke_config("nemotron_4_15b")
    port = _port_train("nemotron_4_15b")
    extra = 2 * BATCH * SEQ * cfg.d_model * cfg.vocab_padded
    assert port["matmul_flops"] - _jax_train_flops("nemotron_4_15b") == extra
    ce = [f for src, f in port["flops_by_source"].items() if src.endswith("_ce_chunk")]
    assert sorted(ce) == [extra, extra]


def test_dryrun_and_report_on_smoke_cells(tmp_path):
    """``dryrun --smoke`` on one cell of each kind (llama train, prefill,
    decode) on the fake (16, 16) mesh: each ``ok`` with its fields, then
    ``report`` renders both tables and ``profile_comms`` the top
    collectives of the saved trace."""
    out = tmp_path / "dryrun"
    r = _run("", "-m", "repro_torch.launch.dryrun", "--arch", "llama3_2_1b", "--shape",
             "train_4k", "--shape", "prefill_32k", "--shape", "decode_32k", "--mesh",
             "single", "--smoke", "--save-trace", "--out", str(out), timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "3 ok, 0 failed" in r.stdout, r.stdout[-3000:]
    for shape, kind in (("train_4k", "train"), ("prefill_32k", "prefill"),
                        ("decode_32k", "decode")):
        rec = json.loads((out / f"llama3_2_1b__{shape}__single__smoke.json").read_text())
        assert rec["status"] == "ok" and rec["kind"] == kind and rec["mesh"] == [16, 16]
        assert set(rec["memory_analysis"]) >= {"per_device_hbm_bytes", "fits_80GB"}
        assert rec["step_analysis"]["matmul_flops"] > 0 and rec["trace_s"] >= 0
        assert rec["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    # the report reads the untagged names; copy the cells under them
    plain = tmp_path / "plain"
    plain.mkdir()
    for f in out.glob("*__smoke.json"):
        (plain / f.name.replace("__smoke", "")).write_text(f.read_text())
    rep = _run("", "-m", "repro_torch.launch.report", "--dir", str(plain))
    assert rep.returncode == 0, rep.stderr[-3000:]
    assert "| llama3_2_1b | ok / ?: " in rep.stdout  # the matrix: one row per arch
    assert "| llama3_2_1b | train_4k | " in rep.stdout  # the roofline: one per cell
    assert "### Roofline (single-pod 16x16" in rep.stdout and "inter-host" in rep.stdout
    prof = _run("", "-m", "repro_torch.launch.profile_comms",
                str(out / "llama3_2_1b__train_4k__single__smoke.collectives.json"), "5")
    assert prof.returncode == 0, prof.stderr[-3000:]
    assert "top-5 total" in prof.stdout and "all_" in prof.stdout
