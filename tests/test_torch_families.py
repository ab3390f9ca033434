"""PyTorch port vs JAX package: the dense variants, audio and MoE families.

For each of the six configs this slice ports (h2o_danube_1_8b,
nemotron_4_15b, command_r_plus_104b, musicgen_large, granite_moe_3b_a800m,
qwen2_moe_a2_7b) the same numpy parameters go through JAX and the port at
the smoke size: float logits and MoE aux losses, quantized logits through a
JAX-saved artifact, the port's own PTQ and ``save_quantized`` read back by
JAX's ``load_quantized``, incremental decode against a full forward, and
one short serve on each engine (paged, ring, speculative). Unit cases hold
LayerNorm with a bias, sinusoidal positions at -1, squared ReLU, tanh GeLU
against ``jax.nn.gelu`` and the parallel block's order against JAX's
functions.

Tolerances: float32 logits within 1e-5 of the logit range (summation order
and last-ulp differences give ~1e-7 relative); quantized logits the same
(an A4 index flipped by a last-ulp scale difference would exceed it, and
none does on these seeds); the elementwise pieces within 2 float32 ulps of
their magnitude (``exp``, ``tanh`` and the reductions' orders), LayerNorm
within 1e-6; incremental decode within 1e-5 of the range (other summation
lengths, the same math).
"""

import dataclasses

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
from repro.core import save_quantized as j_save  # noqa: E402
from repro.core.artifact import load_quantized as j_load  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.model import build as j_build  # noqa: E402

from repro_torch.configs.base import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.configs.base import list_archs  # noqa: E402
from repro_torch.core.artifact import load_quantized, save_quantized  # noqa: E402
from repro_torch.core.qlinear import QLinear  # noqa: E402
from repro_torch.core.quantspec import QuantSpec  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import build, params_from_numpy, quantize_model  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServingEngine  # noqa: E402
from repro_torch.serving.speculative import SpeculativeConfig  # noqa: E402

ARCHS = ["h2o_danube_1_8b", "nemotron_4_15b", "command_r_plus_104b", "musicgen_large",
         "granite_moe_3b_a800m", "qwen2_moe_a2_7b"]
MAIN_SPEC = JSpec(base=JCfg(detection="dynamic", outlier_frac=0.005),
                  rules=[("mlp/wd", {"w_bits": 8})], kv_bits=4, kv_dtype="float32")
U32 = 2.0**-24


def _tokens(cfg, seed=0, shape=(2, 21)):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size, shape).astype(np.int32)


def _jax(arch, seed=0):
    cfg = j_smoke(arch)
    jm = j_build(cfg)
    return cfg, jm, jm.init(jax.random.PRNGKey(seed))


def _close(got: torch.Tensor, want, rel=1e-5):
    w = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), w, rtol=0, atol=rel * np.abs(w).max())


def _port(arch, jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), t_smoke(arch), device="cpu")


# ---------------------------------------------------------------------------
# configs and entry points
# ---------------------------------------------------------------------------

def test_configs_are_copies_and_other_families_refused():
    for arch in ARCHS:
        assert arch in list_archs()
        assert dataclasses.asdict(t_smoke(arch)) == dataclasses.asdict(j_smoke(arch))
        from repro_torch.configs.base import get_config
        from repro.configs.base import get_config as j_config
        assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_config(arch))
    # every family is ported now: check_ported refuses what neither package
    # has (here a norm), and accepts the vlm config
    cfg = dataclasses.replace(t_smoke("llama3_2_1b"), norm="group")
    with pytest.raises(NotImplementedError, match="norm 'group'"):
        build(cfg)
    assert build(t_smoke("llama3_2_vision_11b")).cfg.family == "vlm"


# ---------------------------------------------------------------------------
# whole models: float, quantized, saved by the port, incremental
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_float_logits_and_aux_match_jax(arch):
    cfg, jm, jp = _jax(arch, seed=1)
    tok = _tokens(cfg)
    want = jm.apply(jp, {"tokens": jnp.asarray(tok)})
    with torch.inference_mode():
        got = build(t_smoke(arch)).apply(_port(arch, jp), {"tokens": torch.from_numpy(tok)})
    assert got.logits.shape == want.logits.shape
    _close(got.logits, want.logits)
    if cfg.family == "moe":
        np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss), rtol=1e-6)
    else:
        assert got.aux_loss is None and want.aux_loss is None


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_artifact_both_ways(tmp_path, arch):
    """A JAX-saved artifact loads into the port and gives JAX's logits; the
    port's own PTQ of the same float weights quantizes the same projections
    (the router, shared gate and expert arrays stay float) and its
    ``save_quantized`` loads in JAX's ``load_quantized`` with the port's
    logits."""
    cfg, jm, jp = _jax(arch, seed=2)
    qp = j_quantize_model(jm, jp, MAIN_SPEC)
    j_save(tmp_path / "jax", cfg, MAIN_SPEC, qp)
    art = load_quantized(str(tmp_path / "jax"), device="cpu")
    tok = _tokens(cfg, seed=3, shape=(3, 9))
    want = jm.apply(qp, {"tokens": jnp.asarray(tok)}).logits
    with torch.inference_mode():
        got = art.model.apply(art.params, {"tokens": torch.from_numpy(tok)}).logits
    _close(got, want)

    spec = QuantSpec.from_json_dict(MAIN_SPEC.to_json_dict())
    model = build(t_smoke(arch))
    tq = quantize_model(model, _port(arch, jp), spec)
    quantized = {n for n, m in tq.named_modules() if isinstance(m, QLinear)}
    jpaths = {n.replace("/", ".") for n in _qlinear_paths(qp)}
    assert {_scan_path(n) for n in quantized} == jpaths
    if cfg.family == "moe":
        assert all(not isinstance(b.moe.router, QLinear) for b in tq.blocks)
        assert tq.blocks[0].moe.wi.dtype == torch.float32
        if cfg.n_shared_experts:
            assert isinstance(tq.blocks[0].moe.shared.wi, QLinear)
            assert not isinstance(tq.blocks[0].moe.shared_gate, QLinear)
    save_quantized(str(tmp_path / "port"), t_smoke(arch), spec, tq)
    back = j_load(str(tmp_path / "port"))
    want = back.model.apply(back.params, {"tokens": jnp.asarray(tok)}).logits
    with torch.inference_mode():
        got = model.apply(tq, {"tokens": torch.from_numpy(tok)}).logits
    _close(got, want)


def _qlinear_paths(tree, path=""):
    from repro.core.qlinear import QLinearParams

    if isinstance(tree, QLinearParams):
        yield path
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _qlinear_paths(v, f"{path}/{k}" if path else k)


def _scan_path(name: str) -> str:
    """``blocks.0.attn.wq`` -> ``blocks.attn.wq`` (JAX's stacked path)."""
    parts = name.split(".")
    return ".".join(p for i, p in enumerate(parts) if not (i == 1 and p.isdigit()))


@pytest.mark.parametrize("arch", ARCHS)
def test_incremental_decode_matches_full_forward(arch):
    """A 9-token prefill on the ring cache, then one token at a time: each
    step's logits equal the full forward's at that position."""
    cfg, _, jp = _jax(arch, seed=4)
    model, params = build(t_smoke(arch)), _port(arch, jp)
    tok = torch.from_numpy(_tokens(cfg, seed=5, shape=(2, 14)))
    with torch.inference_mode():
        full = model.apply(params, {"tokens": tok}).logits
        caches = model.init_caches(2, 32, torch.float32, device="cpu")
        out = model.apply(params, {"tokens": tok[:, :9]},
                          positions=torch.arange(9, dtype=torch.int32), caches=caches)
        steps = [out.logits[:, -1]]
        for p in range(9, 14):
            out = model.apply(params, {"tokens": tok[:, p : p + 1]},
                              positions=torch.tensor([p], dtype=torch.int32),
                              caches=out.caches)
            steps.append(out.logits[:, -1])
    _close(torch.stack(steps[:-1], 1), full[:, 8:13].numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_every_engine_serves(arch):
    """The paged scheduler (int4 pool), the fixed-slot ring and greedy
    speculation (the model as its own draft) serve each config; the ring
    and speculation give the paged engine's tokens on prompts within every
    window."""
    cfg, _, jp = _jax(arch, seed=6)
    model, params = build(t_smoke(arch)), _port(arch, jp)
    rng = np.random.RandomState(7)
    prompts = [[int(t) for t in rng.randint(1, cfg.vocab_size, 9)] for _ in range(3)]
    kw = dict(cache_len=48, cache_dtype="float32")
    paged = ServingEngine(model, params, ServeConfig(**kw), batch_slots=2).generate(prompts, 6)
    ring = ServingEngine(model, params, ServeConfig(paged=False, **kw),
                         batch_slots=3).generate(prompts, 6)
    spec = ServingEngine(model, params, ServeConfig(speculative=SpeculativeConfig(k=2), **kw),
                         batch_slots=2, draft=(model, params)).generate(prompts, 6)
    int4 = ServingEngine(model, params, ServeConfig(kv_quant=True, **kw),
                         batch_slots=2).generate(prompts, 6)
    assert paged == spec and len(int4) == 3 and all(len(o) == 6 for o in int4)
    if cfg.family != "moe":  # a MoE batch's capacity depends on its token count
        assert ring == paged


def test_quality_probe_sites_match_jax(tmp_path):
    """The ``quality`` level on a JAX-saved qwen2-moe artifact, every step
    probed: the port's probe sites are JAX's letter for letter (the shared
    experts under ``shared_mlp``; the routed experts are float products, no
    site), and the tokens equal JAX's."""
    arch = "qwen2_moe_a2_7b"
    from repro.serving.engine import ServeConfig as JServe
    from repro.serving.engine import ServingEngine as JEngine
    from repro.serving.telemetry import TelemetryConfig as JTel

    from repro_torch.serving.telemetry import TelemetryConfig

    cfg, jm, jp = _jax(arch, seed=9)
    qp = j_quantize_model(jm, jp, MAIN_SPEC)
    j_save(tmp_path, cfg, MAIN_SPEC, qp)
    art = load_quantized(str(tmp_path), device="cpu")
    q = dict(level="quality", quality_sample_every=1, quality_shadow_every=1000)
    kw = dict(cache_len=32, block_size=8, prefill_chunk=8)
    prompts = [[3, 1, 4, 1, 5, 9], [2, 6, 5, 3, 5]]
    got = {}
    for side, eng in (("port", ServingEngine(art.model, art.params, ServeConfig.from_spec(
                          art.spec, telemetry=TelemetryConfig(**q), **kw), batch_slots=2)),
                      ("jax", JEngine(jm, qp, JServe.from_spec(MAIN_SPEC, telemetry=JTel(**q),
                                                                **kw), batch_slots=2))):
        probes = []
        ingest = eng.scheduler._quality.ingest
        eng.scheduler._quality.ingest = lambda p, ingest=ingest: (probes.append(p),
                                                                  ingest(p))[1]
        got[side] = (eng.generate(prompts, max_new_tokens=3), probes)
    assert got["port"][0] == got["jax"][0]
    sites = lambda probes: sorted({k.rpartition("/")[0] for k in probes[0]})
    assert sites(got["port"][1]) == sites(got["jax"][1])
    taps = ["attn.q", "attn.k", "attn.v", "attn.o", "shared_mlp.wi", "shared_mlp.wd"]
    assert sites(got["port"][1]) == [f"{i:03d}.{t}" for i, t in enumerate(taps * 2)]


# ---------------------------------------------------------------------------
# the new pieces, unit by unit
# ---------------------------------------------------------------------------

def test_layer_norm_with_bias_matches_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 64) * 3 + 1.5).astype(np.float32)
    scale, bias = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    want = JL.norm_apply({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                         jnp.asarray(x), "layer")
    got = L.norm_apply(torch.from_numpy(scale), torch.from_numpy(x), "layer",
                       torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # bfloat16 input: reduced in float32, one rounding at the end, as JAX
    xb = torch.from_numpy(x).bfloat16()
    got_b = L.norm_apply(torch.from_numpy(scale), xb, "layer", torch.from_numpy(bias))
    want_b = JL.norm_apply({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                           jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), "layer")
    assert got_b.dtype == torch.bfloat16
    diff = np.abs(got_b.float().numpy() - np.asarray(want_b.astype(jnp.float32)))
    assert diff.max() <= 2.0**-8 * np.abs(np.asarray(want_b.astype(jnp.float32))).max()
    with pytest.raises(ValueError, match="norm"):
        L.norm_apply(torch.from_numpy(scale), torch.from_numpy(x), "batch")


def test_sinusoidal_positions_match_jax():
    pos = np.array([[-1, 0, 1, 7, 4095], [3, -1, -1, 100, 9]], np.int32)
    want = np.asarray(JL.sinusoidal_positions(jnp.asarray(pos), 64))
    got = L.sinusoidal_positions(torch.from_numpy(pos), 64).numpy()
    assert got.shape == (2, 5, 64) and np.isfinite(got).all()
    # sin / cos of arguments up to 4095: within a few ulps of the argument
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * 4095 * U32)
    # position -1 is an ordinary row: [sin(-f) | cos(-f)]
    f = np.exp(-np.log(10_000.0) * np.arange(32) / 32)
    np.testing.assert_allclose(got[0, 0], np.concatenate([np.sin(-f), np.cos(-f)]),
                               rtol=0, atol=4 * U32)


@pytest.mark.parametrize("act", ["relu2", "gelu_plain", "gelu", "silu"])
def test_activations_match_jax(act):
    rng = np.random.RandomState(1)
    h = (rng.randn(4, 6, 32) * 3).astype(np.float32)
    got = L.act_apply(torch.from_numpy(h), act).numpy()
    hj = jnp.asarray(h)
    if act == "relu2":
        want = jnp.square(jax.nn.relu(hj))
    elif act == "gelu_plain":
        want = jax.nn.gelu(hj)  # the tanh approximation, JAX's default
    else:
        gate, up = jnp.split(hj, 2, axis=-1)
        want = (jax.nn.silu(gate) if act == "silu" else jax.nn.gelu(gate)) * up
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=4 * U32 * np.abs(want).max())
    if act == "gelu_plain":  # the exact erf GeLU is measurably another function
        exact = torch.nn.functional.gelu(torch.from_numpy(h)).numpy()
        assert np.abs(exact - want).max() > 100 * U32 * np.abs(want).max()


@pytest.mark.parametrize("arch", ["command_r_plus_104b", "nemotron_4_15b"])
def test_block_matches_jax_block(arch):
    """One block against JAX's ``_block_apply``: command-r's parallel block
    ``(x + attn(n)) + mlp(n)`` without norm2, nemotron's sequential
    LayerNorm block; LayerNorm scales and biases drawn at random so that
    they matter."""
    cfg, _, jp = _jax(arch, seed=8)
    rng = np.random.RandomState(9)
    tree = jax.tree.map(np.asarray, jp)
    blocks = tree["blocks"]
    for key in ("norm1", "norm2"):
        if key in blocks:
            for leaf in ("scale", "bias"):
                blocks[key][leaf] = rng.randn(*blocks[key][leaf].shape).astype(np.float32)
    assert ("norm2" in blocks) != cfg.parallel_blocks
    port = params_from_numpy(tree, t_smoke(arch), device="cpu")
    x = rng.randn(2, 7, cfg.d_model).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)
    p0 = jax.tree.map(lambda a: jnp.asarray(a[0]), blocks)
    want, _ = jtf._block_apply(p0, jnp.asarray(x), cfg, jnp.asarray(pos), None)
    with torch.inference_mode():
        got, _, aux = port.blocks[0](torch.from_numpy(x), t_smoke(arch),
                                     torch.from_numpy(pos), None)
    assert aux is None
    _close(got, want)
