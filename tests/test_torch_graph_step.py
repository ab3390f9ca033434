"""PyTorch port vs JAX package: what the packed step needs to run as one
CUDA graph, temperature sampling and the kernel-route environment overrides.

* ``_paged_write`` sends the cells it must drop to a scratch block past the
  pages (JAX drops them with an out-of-bounds index): the visible pools
  equal JAX's bit for bit with padded cells, cells past ``ctx`` and an
  unallocated table entry, for int4 and float pages. The K/V values lie on a
  1/4 grid, so every per-token RMS is exact in any summation order.
* The packed step reads no tensor on the host and copies none to the
  device: under a dispatch mode that records aten ops, none of the ops that
  sync or lift a host tensor appear (the guard of capture on the CPU). At
  the telemetry levels off, metrics, trace and metrics with ``fence`` each
  step records the same ops, and a whole run the same ops apart from the
  spans' profiler ranges (the counterpart of JAX's identical jaxprs): the
  region boundaries add none.
* ``rope_apply`` is bit-equal to its former formula.
* ``StepCounts``: one recorded run added N times gives N eager runs' counts.
* Temperature: ``jax.random.categorical(sub, l / T)`` is ``argmax(l / T +
  gumbel(sub))``; a port engine fed that noise gives the JAX engine's
  sampled tokens. The port's own noise is seeded per request.
* ``REPRO_LUT_KERNEL``, ``REPRO_TOPK_KERNEL`` and ``REPRO_PAGED_KERNEL``
  resolve ``auto`` as in JAX.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

import repro.core.kernel_routing as jkr  # noqa: E402
from repro.configs.base import get_smoke_config as j_smoke  # noqa: E402
from repro.core import QLinearConfig as JCfg  # noqa: E402
from repro.core import QuantSpec as JSpec  # noqa: E402
from repro.core import quantize_model as j_quantize_model  # noqa: E402
from repro.core import save_quantized  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.model import build as j_build  # noqa: E402
from repro.serving.engine import ServeConfig as JServe  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

import repro_torch.core.kernel_routing as kr  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.core.artifact import load_quantized  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serving.graph_step import StepCounts, pool_ptrs  # noqa: E402
from repro_torch.serving.speculative import make_packed_fn  # noqa: E402
from repro_torch.serving.telemetry import TelemetryConfig  # noqa: E402

MAIN_SPEC = JSpec(base=JCfg(detection="dynamic", outlier_frac=0.005),
                  rules=[("mlp/wd", {"w_bits": 8})], kv_bits=4, kv_dtype="float32")
FLOAT_SPEC = JSpec(base=JCfg(detection="dynamic", outlier_frac=0.005),
                   rules=[("mlp/wd", {"w_bits": 8})])
T = 0.7


def _bits(a) -> np.ndarray:
    """Raw bits of a numpy / JAX array or a torch tensor, for exact compares."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# the paged write: invalid cells go to the scratch block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pages", ["int4", "bfloat16", "float32"])
def test_paged_write_with_invalid_cells_equals_jax(pages):
    cfg = get_smoke_config("llama3_2_1b")
    n_blocks, bs, kv, hd = 6, 4, cfg.n_kv_heads, cfg.head_dim
    quantized = pages == "int4"
    dtype = "float32" if quantized else pages
    port = L.init_paged_kv_cache(cfg, n_blocks, bs, dtype, quantized)
    jax_cache = JL.init_paged_kv_cache(j_smoke("llama3_2_1b"), n_blocks, bs,
                                       jnp.dtype(dtype), quantized)
    # row 0: position 4 lies past ctx 4; row 1: table entry 1 is unallocated
    # and the last cell is padding; row 2: three padded cells; row 3: idle
    bt = np.array([[3, 1, -1], [5, -1, -1], [0, 2, 4], [-1, -1, -1]], np.int32)
    pos = np.array([[0, 1, 2, 3, 4], [2, 3, 4, 5, -1], [8, 9, -1, -1, -1],
                    [-1, -1, -1, -1, -1]], np.int32)
    ctx = np.array([4, 6, 10, 0], np.int32)
    rng = np.random.RandomState(0)
    k = (rng.randint(-8, 9, (4, 5, kv, hd)) / 4).astype(np.float32)
    v = (rng.randint(-8, 9, (4, 5, kv, hd)) / 4).astype(np.float32)
    k[..., 0] = v[..., 0] = 1.0  # no all-zero token
    port |= {"block_tables": torch.from_numpy(bt), "ctx_lens": torch.from_numpy(ctx)}
    jax_cache |= {"block_tables": jnp.asarray(bt), "ctx_lens": jnp.asarray(ctx)}
    L._paged_write(port, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos),
                   port["ctx_lens"])
    want = JL._paged_write(jax_cache, jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                           jax_cache["ctx_lens"])
    keys = [key for key in port if key.startswith("pages_")]
    assert keys and set(keys) == {key for key in want if key.startswith("pages_")}
    for key in keys:
        assert port[key].shape == want[key].shape, key
        np.testing.assert_array_equal(_bits(port[key]), _bits(want[key]), err_msg=key)
    assert port[keys[0]].any()  # the valid cells were written
    # the dropped cells went to the scratch block past the pages
    assert L._cells_with_scratch(port[keys[0]])[n_blocks * bs].any()


def test_paged_write_refuses_a_pool_without_scratch_block():
    cfg = get_smoke_config("llama3_2_1b")
    cache = L.init_paged_kv_cache(cfg, 3, 4, "float32")
    cache = {key: t.clone() for key, t in cache.items()}  # pages only, no scratch
    cache |= {"block_tables": torch.zeros((1, 1), dtype=torch.int32),
              "ctx_lens": torch.ones((1,), dtype=torch.int32)}
    x = torch.zeros((1, 1, cfg.n_kv_heads, cfg.head_dim))
    with pytest.raises(ValueError, match="scratch"):
        L._paged_write(cache, x, x, torch.zeros((1, 1), dtype=torch.int32), cache["ctx_lens"])


# ---------------------------------------------------------------------------
# the step syncs nothing and lifts no host tensor
# ---------------------------------------------------------------------------

_SYNCING = {torch.ops.aten.nonzero.default, torch.ops.aten._local_scalar_dense.default,
            torch.ops.aten.masked_select.default, torch.ops.aten.lift_fresh.default}


class _Recorder(TorchDispatchMode):
    """Records every aten op that would stop a capture: a host sync, a host
    tensor made inside the step, or an index by a boolean mask."""

    def __init__(self):
        super().__init__()
        self.bad: list[str] = []
        self.ops: list[str] = []

    @property
    def n_ops(self) -> int:
        return len(self.ops)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        if func in _SYNCING:
            self.bad.append(str(func))
        if func.overloadpacket in (torch.ops.aten.index, torch.ops.aten.index_put_,
                                   torch.ops.aten.index_put):
            idx = args[1] if len(args) > 1 else kwargs.get("indices", ())
            if any(i is not None and i.dtype == torch.bool for i in idx):
                self.bad.append(f"{func} with a boolean index")
        return func(*args, **(kwargs or {}))


def _step_inputs(slots=3, max_blk=4, rows=6, s=2):
    """A packed step with a decode row, a prefill segment and padded cells."""
    bt = np.full((slots, max_blk), -1, np.int32)
    bt[0, :2], bt[1, :3] = [4, 1], [0, 2, 5]
    slot_ids = np.array([0, 1, 1, 1, 0, 0], np.int32)
    pos = np.full((rows, s), -1, np.int32)
    pos[0, 0] = 9  # decode
    pos[1], pos[2], pos[3, 0] = [0, 1], [2, 3], 4  # prefill of 5 tokens
    tok = (np.arange(rows * s, dtype=np.int32).reshape(rows, s) * 7) % 200
    ctx = pos.max(axis=1) + 1
    return [torch.from_numpy(a) for a in (bt, slot_ids, pos, ctx, tok)]


@pytest.mark.parametrize("kv_quant", [True, False])
def test_packed_step_records_no_syncing_op(tmp_path, kv_quant):
    cfg = j_smoke("llama3_2_1b")
    spec = MAIN_SPEC if kv_quant else FLOAT_SPEC
    jmodel = j_build(cfg)
    save_quantized(tmp_path, cfg, spec, j_quantize_model(jmodel, jmodel.init(
        jax.random.PRNGKey(0)), spec))
    art = load_quantized(str(tmp_path), device="cpu")
    sc = ServeConfig.from_spec(art.spec, cache_len=64, block_size=8)
    pools = art.model.init_caches(3, 64, sc.cache_dtype, quantized=sc.kv_quant, layout="paged",
                                  block_size=8, device="cpu")
    step = make_packed_fn(art.model)
    inputs = _step_inputs()
    with _Recorder() as rec:
        out_pools, logits = step(art.params, pools, *inputs)
    assert rec.n_ops > 100 and not rec.bad, rec.bad
    assert logits.shape == (6, 2, cfg.vocab_size) and torch.isfinite(logits).all()
    assert pool_ptrs(out_pools) == pool_ptrs(pools)


def test_packed_step_ops_equal_at_off_metrics_and_trace(tmp_path):
    """Telemetry wraps no step code: every packed step of a short run, op
    by op, is the same at off, metrics, trace and metrics with ``fence``
    (whose region boundaries add no op) and holds no op that syncs or
    lifts a host tensor; the whole run's aten ops are the same too, apart
    from the profiler ranges (``profiler.*``) the spans open."""
    cfg = j_smoke("llama3_2_1b")
    jmodel = j_build(cfg)
    save_quantized(tmp_path, cfg, MAIN_SPEC, j_quantize_model(jmodel, jmodel.init(
        jax.random.PRNGKey(0)), MAIN_SPEC))
    art = load_quantized(str(tmp_path), device="cpu")
    prompts = [[1, 2, 3, 4, 5], [6, 7], [8, 9, 10]]

    def run(level):
        eng = ServingEngine(art.model, art.params,
                            ServeConfig.from_spec(art.spec, cache_len=64, block_size=8,
                                                  prefill_chunk=4, telemetry=level),
                            batch_slots=2)
        sched, steps = eng.scheduler, []
        inner = sched._packed_fn

        def recorded(*args):
            with _Recorder() as rec:
                out = inner(*args)
            steps.append((rec.ops, rec.bad))
            return out

        sched._packed_fn = recorded
        with _Recorder() as whole:
            out = eng.generate(prompts, max_new_tokens=4)
        return out, steps, [op for op in whole.ops if not op.startswith("profiler.")]

    fenced = TelemetryConfig(level="metrics", fence=True)
    runs = [run(level) for level in ("off", "metrics", "trace", fenced)]
    assert runs[0][0] == runs[1][0] == runs[2][0] == runs[3][0]
    assert len(runs[0][1]) > 3 and runs[0][1] == runs[1][1] == runs[2][1] == runs[3][1]
    assert not any(bad for _, bad in runs[0][1])
    assert runs[0][2] == runs[1][2] == runs[2][2] == runs[3][2]


def test_rope_apply_is_bit_equal_to_the_former_formula():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 5, 2, 4, 64), generator=g).to(torch.bfloat16)
    positions = torch.randint(0, 9000, (3, 5), generator=g, dtype=torch.int32)
    for theta in (10000.0, 500000.0):
        half = x.shape[-1] // 2
        exps = -torch.arange(half, dtype=torch.float32) / half
        freq = torch.pow(torch.tensor(theta, dtype=torch.float32), exps)
        ang = (positions.float()[..., None] * freq).reshape(3, 5, 1, 1, half)
        sin, cos = torch.sin(ang), torch.cos(ang)
        xf1, xf2 = x[..., :half].float(), x[..., half:].float()
        want = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)
        assert torch.equal(L.rope_apply(x, positions, theta).view(torch.int16),
                           want.view(torch.int16))


def test_step_counts_replays_equal_eager_steps(tmp_path):
    """The bookkeeping a graph step uses: one recorded run, added N times,
    gives every counter what N eager runs give (here the CPU step stands in
    for the capture; its dispatch counters are what a replay would skip)."""
    cfg = j_smoke("llama3_2_1b")
    jmodel = j_build(cfg)
    save_quantized(tmp_path, cfg, MAIN_SPEC, j_quantize_model(jmodel, jmodel.init(
        jax.random.PRNGKey(0)), MAIN_SPEC))
    art = load_quantized(str(tmp_path), device="cpu")
    pools = art.model.init_caches(3, 64, "float32", quantized=True, layout="paged", block_size=8,
                                  device="cpu")
    step = make_packed_fn(art.model)
    inputs = _step_inputs()
    snapshot = lambda: [dict(c) for c in StepCounts.counters()]
    build.reset_counts()
    kr.reset()
    for _ in range(3):
        step(art.params, pools, *inputs)
    eager = snapshot()
    build.reset_counts()
    kr.reset()
    counts = StepCounts()
    with counts.record():
        step(art.params, pools, *inputs)
    assert all(not c for c in snapshot())  # the recorded run is taken back off
    assert any(counts.delta)
    for _ in range(3):
        counts.add()
    assert snapshot() == eager
    assert kr.kernel_calls() + kr.jnp_calls() == 3 * 6 * cfg.n_layers


# ---------------------------------------------------------------------------
# temperature sampling
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    cfg = j_smoke("llama3_2_1b")
    model = j_build(cfg)
    qp = j_quantize_model(model, model.init(jax.random.PRNGKey(0)), MAIN_SPEC)
    d = tmp_path_factory.mktemp("artifact")
    save_quantized(d, cfg, MAIN_SPEC, qp)
    return str(d), model, qp


def _prompts(vocab):
    rng = np.random.RandomState(5)
    shared = [int(x) for x in rng.randint(0, vocab, 16)]
    rand = lambda lo, hi: [int(x) for x in rng.randint(0, vocab, rng.randint(lo, hi))]
    prompts = [shared + rand(4, 9), rand(3, 6), rand(10, 20), list(shared), rand(3, 12)]
    return prompts, [12, 3, 8, 6, 9]


def _jax_noise(seed: int):
    """A stand-in for the port's ``_gumbel``: JAX's noise for the request's
    key, split once per sample as ``Scheduler._sample`` splits it (a fresh
    engine's request ids are the prompts' indices, JAX's salts)."""
    keys: dict[int, jax.Array] = {}

    def gumbel(r, vocab):
        key = keys.get(r.rid, jax.random.PRNGKey(seed * 100_003 + r.rid))
        keys[r.rid], sub = jax.random.split(key)
        return torch.from_numpy(np.array(jax.random.gumbel(sub, (vocab,), jnp.float32)))

    return gumbel


def test_categorical_is_argmax_of_gumbel_noise():
    """The premise of the parity test below, for this JAX version."""
    rng = np.random.RandomState(0)
    logits = jnp.asarray(rng.randn(6, 256).astype(np.float32) * 3)
    key = jax.random.PRNGKey(11)
    for row in logits:
        key, sub = jax.random.split(key)
        want = int(jax.random.categorical(sub, row / T))
        got = int(jnp.argmax(row / T + jax.random.gumbel(sub, row.shape, jnp.float32)))
        assert got == want


@pytest.mark.parametrize("seg_width", [1, 2])
def test_temperature_tokens_match_jax_on_jax_noise(artifact, seg_width):
    path, jmodel, jparams = artifact
    kw = dict(cache_len=64, block_size=8, prefill_chunk=8, seg_width=seg_width,
              temperature=T)
    prompts, budgets = _prompts(jmodel.cfg.vocab_size)
    jeng = JEngine(jmodel, jparams, JServe.from_spec(MAIN_SPEC, **kw), batch_slots=3)
    want = jeng.generate(prompts, max_new_tokens=budgets, seed=7)
    art = load_quantized(path, device="cpu")
    eng = ServingEngine(art.model, art.params, ServeConfig.from_spec(art.spec, **kw),
                        batch_slots=3)
    eng.scheduler._gumbel = _jax_noise(7)
    assert eng.generate(prompts, max_new_tokens=budgets, seed=7) == want
    greedy = JEngine(jmodel, jparams, JServe.from_spec(MAIN_SPEC, **(kw | {"temperature": 0})),
                     batch_slots=3).generate(prompts, max_new_tokens=budgets)
    assert greedy != want  # the noise moved some token


def test_temperature_is_seeded_per_request(artifact):
    """The port's own noise: the same seed gives the same tokens however the
    steps are packed and on a second run; another seed gives other tokens."""
    path, jmodel, _ = artifact
    art = load_quantized(path, device="cpu")
    prompts, budgets = _prompts(jmodel.cfg.vocab_size)

    def run(seg_width, seed):
        sc = ServeConfig.from_spec(art.spec, cache_len=64, block_size=8, prefill_chunk=8,
                                   seg_width=seg_width, temperature=T)
        eng = ServingEngine(art.model, art.params, sc, batch_slots=3)
        return eng.generate(prompts, max_new_tokens=budgets, seed=seed)

    first = run(1, 3)
    assert [len(o) for o in first] == budgets
    assert run(2, 3) == first and run(1, 3) == first
    assert run(1, 4) != first


def test_pools_keep_their_tensors_through_copy_on_write(artifact):
    path, jmodel, _ = artifact
    art = load_quantized(path, device="cpu")
    sc = ServeConfig.from_spec(art.spec, cache_len=64, block_size=8, prefill_chunk=8,
                               n_blocks=7)
    eng = ServingEngine(art.model, art.params, sc, batch_slots=3)
    ptrs = pool_ptrs(eng.scheduler.pools)
    prompts, budgets = _prompts(jmodel.cfg.vocab_size)
    eng.generate(prompts, max_new_tokens=budgets)
    assert eng.stats["cow_copies"] > 0 and eng.stats["preemptions"] > 0
    assert pool_ptrs(eng.scheduler.pools) == ptrs
    assert eng.stats["graph_capture_s"] is None  # the CPU runs the step eagerly


# ---------------------------------------------------------------------------
# the route overrides
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh_env(monkeypatch):
    """Both packages read the route variables again; their first readings
    are forgotten afterwards, so no other test sees them."""
    kr.reset_env()
    monkeypatch.setattr(jkr, "_AUTO_DEFAULT", None)
    monkeypatch.setattr(jkr, "_DETECT_AUTO_DEFAULT", None)
    monkeypatch.setattr(JL, "_USE_PAGED_KERNEL", None)
    yield monkeypatch
    kr.reset_env()


@pytest.mark.parametrize("value", [None, "", "auto", " AUTO ", "0", "off", "False", "1",
                                   "on", "pallas"])
def test_route_overrides_resolve_like_jax(fresh_env, value):
    for var in ("REPRO_LUT_KERNEL", "REPRO_TOPK_KERNEL", "REPRO_PAGED_KERNEL"):
        if value is None:
            fresh_env.delenv(var, raising=False)
        else:
            fresh_env.setenv(var, value)
    build.reset_counts()
    lut, topk = kr.resolve_route("auto", device="cpu"), kr.resolve_detect_route("auto", "cpu")
    paged = kr.resolve_paged_route("cpu")
    assert lut == jkr.resolve_route("auto")
    assert topk == jkr.resolve_detect_route("auto")
    assert paged == ("pallas" if JL._paged_kernel_enabled() else "jnp")
    forced = value is not None and value.strip().lower() not in ("", "auto")
    assert (lut == "pallas") == (forced and value.strip().lower() not in ("0", "off", "false"))
    # explicit routes ignore the variables; the first reading is kept
    assert kr.resolve_route("jnp") == "jnp" and kr.resolve_detect_route("pallas") == "pallas"
    fresh_env.setenv("REPRO_LUT_KERNEL", "0" if lut == "pallas" else "1")
    assert kr.resolve_route("auto", device="cpu") == lut
    assert not build.PLAIN_ON_CUDA  # a CPU tensor's plain route is no demotion


def test_paged_override_takes_the_plain_version(fresh_env, artifact):
    """``REPRO_PAGED_KERNEL=1`` on the CPU runs the kernel wrapper, which
    runs the plain version for a CPU tensor: the same logits either way."""
    path, _, _ = artifact
    art = load_quantized(path, device="cpu")
    step = make_packed_fn(art.model)
    got = []
    for value in ("0", "1"):
        fresh_env.setenv("REPRO_PAGED_KERNEL", value)
        kr.reset_env()
        pools = art.model.init_caches(3, 64, "float32", quantized=True, layout="paged",
                                      block_size=8, device="cpu")
        got.append(step(art.params, pools, *_step_inputs())[1])
    assert torch.equal(got[0], got[1])
