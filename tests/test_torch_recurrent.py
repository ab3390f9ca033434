"""PyTorch port vs JAX package: the recurrent families' blocks and models
(falcon_mamba_7b, recurrentgemma_2b) at the smoke size.

* The scans: the int4 recurrence (``_ssm_scan_q``) gives JAX's indices
  exactly and its scales and float states to float32 rounding, given the
  same ``h0``, ``a``, ``bx`` and codebook; the chunked float scan crosses a
  chunk boundary within 1e-6 of the state range (JAX's associative scan
  combines in another tree); the conv tails and ``_take_final`` equal
  JAX's; the state quantizer gives JAX's indices, its per-vector RMS
  scales within 2^-22 of their range (the mean's sum order moves one by an
  ulp), and dequantizes JAX's indices and scales to JAX's values exactly.
* One Mamba block and one RG-LRU block in every layout -- no cache, ring
  float and int4, packed float and int4 (rows in another slot order, a
  short row, an all-pad row) -- on the same numpy inputs and state: the
  block output within 1e-5 of its range, float state and conv tails (the
  in-projection's outputs) within 2e-5, int4 state indices exactly, the
  ``*_steps`` transients alike, and the all-pad row's slot untouched (its
  write goes to the scratch slot).
* Whole models: float logits within 1e-5 of the range, a JAX-saved W4A4
  artifact with int4 state served through the port's paged step within the
  same bound (its state indices exactly, conv tails within 2e-5), the
  port's PTQ saved and read back by JAX, policies and
  parameter shapes equal to JAX's, and a ``vlm`` without cross-attention
  groups refused.
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
from repro.core import quantize_model as j_quantize_model  # noqa: E402
from repro.core import save_quantized as j_save  # noqa: E402
from repro.core.artifact import load_quantized as j_load  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import mamba as jmamba  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models.model import build as j_build  # noqa: E402
from repro.serving.speculative import make_packed_fn as j_packed_fn  # noqa: E402

from repro_torch.configs.base import get_config, get_smoke_config, list_archs  # noqa: E402
from repro_torch.core.artifact import load_quantized, save_quantized  # noqa: E402
from repro_torch.core.quantspec import QuantSpec  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba, rglru  # noqa: E402
from repro_torch.models.model import (build, params_from_numpy, quantize_model,  # noqa: E402
                                      tree_from_params)
from repro_torch.serving.speculative import make_packed_fn  # noqa: E402

ARCHS = ["falcon_mamba_7b", "recurrentgemma_2b"]
SPEC = JSpec(base=JCfg(detection="dynamic", outlier_frac=0.005), kv_bits=4, kv_dtype="float32")
LAYOUTS = ["none", "ring", "ring_q", "packed", "packed_q"]


def _close(got, want, rel=1e-5):
    w = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), w, rtol=0,
                               atol=rel * max(np.abs(w).max(), 1e-30))


@pytest.fixture(scope="module", params=ARCHS)
def lm(request):
    arch = request.param
    cfg = j_smoke(arch)
    jm = j_build(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), get_smoke_config(arch),
                               device="cpu")
    return arch, cfg, jm, jp, build(get_smoke_config(arch)), params


# ---------------------------------------------------------------------------
# the scans and small pieces
# ---------------------------------------------------------------------------

def _codebook():
    from repro.models.model import _default_codebook

    return np.asarray(_default_codebook(4))


@pytest.mark.parametrize("shape", [(3, 9, 16, 4), (2, 7, 32)])
def test_quantized_scan_indices_equal_jax(shape):
    """The int4 recurrence on the same h0, a, bx and codebook: indices
    exactly JAX's, scales and float states within float32 rounding (Mamba's
    (B, S, di, N) and RG-LRU's (B, S, di) states)."""
    rng = np.random.RandomState(3)
    a = rng.uniform(0.5, 1.0, shape).astype(np.float32)
    bx = rng.randn(*shape).astype(np.float32)
    h0 = rng.randn(shape[0], *shape[2:]).astype(np.float32)
    book = _codebook()
    jh, jidx, jsc = jmamba._ssm_scan_q(jnp.asarray(a), jnp.asarray(bx), jnp.asarray(h0),
                                       jnp.asarray(book))
    th, tidx, tsc = mamba._ssm_scan_q(torch.from_numpy(a), torch.from_numpy(bx),
                                      torch.from_numpy(h0), torch.from_numpy(book))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tsc.numpy(), jsc, 2**-22)
    _close(th.numpy(), jh, 2**-22)


def test_float_scan_across_chunks():
    """256 tokens: two chunks of 128, the log-step scan inside each against
    JAX's associative scan, within 1e-6 of the state range; a length that no
    chunk divides raises, as in JAX."""
    rng = np.random.RandomState(4)
    a = rng.uniform(0.8, 1.0, (2, 256, 8, 4)).astype(np.float32)
    bx = (rng.randn(2, 256, 8, 4) * 0.1).astype(np.float32)
    h0 = rng.randn(2, 8, 4).astype(np.float32)
    jys, jh = jmamba._ssm_scan(jnp.asarray(a), jnp.asarray(bx), jnp.asarray(h0))
    tys, th = mamba._ssm_scan(*(torch.from_numpy(v) for v in (a, bx, h0)))
    _close(tys.numpy(), jys, 1e-6)
    _close(th.numpy(), jh, 1e-6)
    with pytest.raises(ValueError, match="divisible"):
        mamba._ssm_scan(torch.zeros(1, 200, 2), torch.zeros(1, 200, 2), torch.zeros(1, 2))


def test_conv_tails_take_final_and_state_quantizer():
    rng = np.random.RandomState(5)
    tail0 = rng.randn(3, 3, 6).astype(np.float32)
    xs = rng.randn(3, 5, 6).astype(np.float32)
    np.testing.assert_array_equal(
        mamba._packed_conv_tails(torch.from_numpy(tail0), torch.from_numpy(xs), 4).numpy(),
        np.asarray(jmamba._packed_conv_tails(jnp.asarray(tail0), jnp.asarray(xs), 4)))
    n_valid = np.array([5, 0, 2])
    steps = rng.randn(3, 5, 2, 4).astype(np.float32)
    np.testing.assert_array_equal(
        mamba._take_final(torch.from_numpy(steps), torch.from_numpy(n_valid)).numpy(),
        np.asarray(jmamba._take_final(jnp.asarray(steps), jnp.asarray(n_valid))))
    h = (rng.randn(4, 16, 8) * 3).astype(np.float32)
    book = _codebook()
    ji, js = JL.state_quantize(jnp.asarray(h), jnp.asarray(book))
    ti, ts = L.state_quantize(torch.from_numpy(h), torch.from_numpy(book))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(ts.numpy(), js, 2**-22)  # the RMS's sum order: an ulp apart
    ji, js = np.asarray(ji), np.asarray(js)
    np.testing.assert_array_equal(
        L.state_dequantize(torch.from_numpy(ji), torch.from_numpy(js),
                           torch.from_numpy(book)).numpy(),
        np.asarray(JL.state_dequantize(jnp.asarray(ji), jnp.asarray(js), jnp.asarray(book))))


# ---------------------------------------------------------------------------
# one block in every layout
# ---------------------------------------------------------------------------

def _block_fns(arch):
    """(JAX block fn, port block fn, index of a recurrent layer)."""
    if arch == "falcon_mamba_7b":
        return jmamba._block_apply, mamba.block_apply, 0
    return jrglru._rec_block_apply, rglru.rec_block_apply, 0


def _state_arrays(cfg, rows, quantized, rng):
    """Random numpy state for ``rows`` slots (int4: random indices, positive
    scales), shaped as ``mamba.state_cache`` makes it."""
    di = cfg.d_inner or cfg.d_model
    h = (di, cfg.ssm_state) if cfg.family == "ssm" else (di,)
    conv = rng.randn(rows, cfg.ssm_conv - 1, di).astype(np.float32)
    if not quantized:
        return {"h": rng.randn(rows, *h).astype(np.float32), "conv": conv}
    return {"h_idx": rng.randint(0, 256, (rows, *h[:-1], h[-1] // 2)).astype(np.uint8),
            "h_scale": rng.uniform(0.1, 2.0, (rows, *h[:-1], 1)).astype(np.float32),
            "conv": conv}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_block_matches_jax(lm, layout):
    arch, cfg, jm, jp, model, params = lm
    jfn, tfn, i = _block_fns(arch)
    jblock = (jax.tree.map(lambda a: a[i], jp["blocks"]) if isinstance(jp["blocks"], dict)
              else jp["blocks"][i])
    tblock = params.blocks[i]
    rng = np.random.RandomState(7)
    quantized = layout.endswith("_q")
    packed = layout.startswith("packed")
    b, s = 3, 5
    x = rng.randn(b, s, cfg.d_model).astype(np.float32)
    positions = np.arange(s, dtype=np.int32)
    jcache = tcache = None
    if layout != "none":
        rows = 4 if packed else b
        st = _state_arrays(cfg, rows, quantized, rng)
        di = cfg.d_inner or cfg.d_model
        tcache = mamba.state_cache(rows, di, cfg.ssm_state if cfg.family == "ssm" else None,
                                   cfg.ssm_conv, torch.float32, quantized, "cpu")
        for k, v in st.items():
            tcache[k].copy_(torch.from_numpy(v))
        jcache = {k: jnp.asarray(v) for k, v in st.items()}
        if quantized:
            jcache["state_codebook"] = jnp.asarray(_codebook())
        if packed:  # rows in another slot order; a short row; an all-pad row
            slots = np.array([2, 0, 3], np.int32)
            positions = np.stack([np.arange(10, 10 + s), np.r_[np.arange(3, 5), [-1] * 3],
                                  np.full(s, -1)]).astype(np.int32)
            jcache["token_slots"] = jnp.asarray(slots)
            tcache = tcache | {"token_slots": torch.from_numpy(slots)}
    before = None if tcache is None else {k: v.clone() for k, v in tcache.items()}
    jx, jc = jax.jit(jfn, static_argnums=2)(jblock, jnp.asarray(x), cfg, jcache,
                                            jnp.asarray(positions))
    tx, tc = tfn(tblock, torch.from_numpy(x), cfg, tcache, torch.from_numpy(positions))
    _close(tx.numpy(), jx)
    if layout == "none":
        assert jc is None and tc is None
        return
    for k, v in jc.items():
        if k in ("token_slots", "state_codebook"):
            continue
        got = tc[k].numpy()
        if "idx" in k:
            np.testing.assert_array_equal(got, np.asarray(v), err_msg=k)
        else:
            _close(got, v, 2e-5)
    assert set(tc) - {"token_slots", "state_codebook"} == \
        set(jc) - {"token_slots", "state_codebook"}
    if packed:  # slot 1 has no row: untouched (the all-pad row wrote the scratch slot)
        for k in ("conv", "h_idx" if quantized else "h"):
            assert torch.equal(tc[k][1], before[k][1])


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

def test_configs_policies_and_entry_points():
    """Copies of JAX's configs; the expanded pattern and policies are
    JAX's; parameter shapes equal JAX's tree; ssm and hybrid build, a vlm
    without cross-attention groups is refused."""
    for arch in ARCHS:
        assert arch in list_archs()
        for t, j in ((get_smoke_config(arch), j_smoke(arch)), (get_config(arch), j_config(arch))):
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            assert t.expanded_pattern() == j._pattern_expanded()
        assert get_smoke_config(arch).expanded_pattern() == (
            jrglru.expanded_pattern(j_smoke(arch)) if arch == "recurrentgemma_2b" else ())
        jm, tm = j_build(j_smoke(arch)), build(get_smoke_config(arch))
        assert [(p.kind, p.window) for p in tm.cache_policies()] == \
            [(p.kind, p.window) for p in jm.cache_policies()]
        jshapes = jax.tree.map(lambda a: tuple(a.shape),
                               jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0))))
        tshapes = jax.tree.map(lambda t: tuple(t.shape),
                               tree_from_params(tm.init(seed=0, device="cpu")))
        assert tshapes == jshapes
    assert {p.kind for p in build(get_smoke_config("recurrentgemma_2b")).cache_policies()} == \
        {"recurrent", "windowed_paged"}
    vlm = dataclasses.replace(get_smoke_config("falcon_mamba_7b"), family="vlm")
    with pytest.raises(NotImplementedError, match="vlm"):
        build(vlm)


def test_float_logits_match_jax(lm):
    arch, cfg, jm, jp, model, params = lm
    tok = np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 21)).astype(np.int32)
    want = jax.jit(lambda p, t: jm.apply(p, {"tokens": t}).logits)(jp, jnp.asarray(tok))
    got = model.apply(params, {"tokens": torch.from_numpy(tok)}).logits
    _close(got.numpy(), want)
    assert bool(torch.isfinite(model.apply(model.init(seed=3, device="cpu"),
                                           {"tokens": torch.from_numpy(tok)}).logits).all())


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Per arch: (JAX model, JAX quantized params, port artifact) of a
    JAX-saved W4A4 / int4-state artifact."""
    out = {}
    for arch in ARCHS:
        cfg = j_smoke(arch)
        jm = j_build(cfg)
        qp = j_quantize_model(jm, jm.init(jax.random.PRNGKey(1)), SPEC)
        d = tmp_path_factory.mktemp(f"{arch}_artifact")
        j_save(d, cfg, SPEC, qp)
        out[arch] = (jm, qp, load_quantized(str(d), device="cpu"))
    return out


def _packed_inputs(cfg, slots=3, max_blk=8):
    """One packed step: a 4-token prefill row, a 2-token row, an all-pad row."""
    rng = np.random.RandomState(2)
    bt = np.arange(slots * max_blk, dtype=np.int32).reshape(slots, max_blk)
    slot_ids = np.array([1, 0, 2], np.int32)
    pos = np.array([[0, 1, 2, 3], [0, 1, -1, -1], [-1] * 4], np.int32)
    ctx = pos.max(1) + 1
    tok = rng.randint(0, cfg.vocab_size, pos.shape).astype(np.int32)
    return bt, slot_ids, pos, ctx, tok


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_artifact_packed_step_matches_jax(artifacts, arch):
    """A JAX-saved artifact (W4A4 projections, int4 state and KV) through
    one packed step of each package: logits within 1e-5 of the range, state
    indices and conv tails exactly equal."""
    jm, qp, art = artifacts[arch]
    cfg = jm.cfg
    inputs = _packed_inputs(cfg)
    jpools = jm.init_caches(3, 64, jnp.float32, quantized=True, layout="paged",
                            block_size=8, n_blocks=24)
    jpools, jlog, _ = jax.jit(j_packed_fn(jm))(qp, jpools, *(jnp.asarray(v) for v in inputs))
    tpools = art.model.init_caches(3, 64, torch.float32, quantized=True, layout="paged",
                                   block_size=8, n_blocks=24, device="cpu")
    tpools, tlog = make_packed_fn(art.model)(art.params, tpools,
                                             *(torch.from_numpy(v) for v in inputs))
    _close(tlog.numpy(), jlog)
    jl = [jax.tree.map(lambda a, i=i: a[i], jpools) for i in range(cfg.n_layers)] \
        if isinstance(jpools, dict) else jpools
    for jlayer, tlayer in zip(jl, tpools):
        if "h_idx" in tlayer:
            np.testing.assert_array_equal(tlayer["h_idx"].numpy(), np.asarray(jlayer["h_idx"]))
            _close(tlayer["conv"].numpy(), jlayer["conv"], 2e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_ptq_read_by_jax(tmp_path, arch):
    """The port quantizes the recurrent projections (in_proj .. out_proj,
    lin_* and the gates) and saves; JAX's ``load_quantized`` reads the
    artifact and its float logits equal the port's within 1e-5."""
    cfg = j_smoke(arch)
    jp = j_build(cfg).init(jax.random.PRNGKey(2))
    model = build(get_smoke_config(arch))
    params = params_from_numpy(jax.tree.map(np.asarray, jp), get_smoke_config(arch),
                               device="cpu")
    spec = QuantSpec.from_json_dict(SPEC.to_json_dict())
    qp = quantize_model(model, params, spec)
    names = {n.rsplit(".", 1)[-1] for n, m in qp.named_modules() if type(m).__name__ == "QLinear"}
    want = {"in_proj", "x_proj", "dt_proj", "out_proj"} if arch == "falcon_mamba_7b" else \
        {"lin_y", "lin_x", "w_a", "w_x", "lin_out", "wq", "wk", "wv", "wo", "wi", "wd"}
    assert names == want
    save_quantized(str(tmp_path), model.cfg, spec, qp)
    jm, jqp, _ = j_load(str(tmp_path))
    tok = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    _close(model.apply(qp, {"tokens": torch.from_numpy(tok)}).logits.numpy(),
           jax.jit(lambda p, t: jm.apply(p, {"tokens": t}).logits)(jqp, jnp.asarray(tok)))
