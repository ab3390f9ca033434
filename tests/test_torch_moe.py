"""PyTorch port vs JAX package: the MoE layer and the MoE models' serving.

``models/moe.py`` against ``repro/models/moe.py`` on the same numpy inputs:
the dispatch group count and capacity (which decide the result), the
sort-based dispatch (expert inputs, slots, kept flags and weights equal,
exactly), the combine and the whole layer with its Switch aux loss, with
and without overflow (a capacity factor of 0.25 forces it) and at token
counts that 32 does not divide; router ties go to the lowest expert, as
``lax.top_k`` breaks them; the layer is bit-equal across calls. Then the
packed scheduler and the fixed-slot ring serve granite-moe and qwen2-moe
from a JAX-saved artifact with JAX's greedy tokens.

Tolerances: the combine sums each token's k outputs in JAX's order, so it
is held within one float32 ulp of the magnitude (XLA may fuse the weight
multiply); the whole layer within 1e-5 of its range (float32 products
summed in other orders); the aux loss within 1e-6 relative.
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
from repro.core import save_quantized  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.model import build as j_build  # noqa: E402
from repro.serving.engine import ServeConfig as JServe  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

from repro_torch.configs.base import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.core.artifact import load_quantized  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.model import params_from_numpy  # noqa: E402
from repro_torch.serving.engine import ServeConfig, ServingEngine  # noqa: E402

MOE_ARCHS = ["granite_moe_3b_a800m", "qwen2_moe_a2_7b"]
MAIN_SPEC = JSpec(base=JCfg(detection="dynamic", outlier_frac=0.005),
                  rules=[("mlp/wd", {"w_bits": 8})], kv_bits=4, kv_dtype="float32")
U32 = 2.0**-24


def _layer(arch, seed=0, **overrides):
    """(JAX cfg, port cfg, JAX moe params of layer 0, port MoE module)."""
    cfg = dataclasses.replace(j_smoke(arch), **overrides)
    tcfg = dataclasses.replace(t_smoke(arch), **overrides)
    jp = j_build(cfg).init(jax.random.PRNGKey(seed))
    p0 = jax.tree.map(lambda a: a[0], jp["blocks"]["moe"])
    tree = jax.tree.map(np.asarray, jp)
    port = params_from_numpy(tree, tcfg, device="cpu")
    return cfg, tcfg, p0, port.blocks[0].moe


def _x(cfg, b, s, seed=1):
    return np.random.RandomState(seed).randn(b, s, cfg.d_model).astype(np.float32)


def _jax_groups(t, cfg):
    """JAX's group rule, as ``repro/models/moe.py::_moe_apply`` writes it."""
    g = max(1, min(cfg.moe_dispatch_groups, t))
    while t % g:
        g -= 1
    return g


def test_groups_and_capacity_match_jax():
    for arch in MOE_ARCHS:
        for cf in (0.25, 1.25, 2.0):
            cfg = dataclasses.replace(j_smoke(arch), capacity_factor=cf)
            tcfg = dataclasses.replace(t_smoke(arch), capacity_factor=cf)
            for t in (1, 2, 7, 31, 32, 33, 64, 72, 97, 264, 1000, 1024):
                g = tmoe.dispatch_groups(t, tcfg)
                assert g == _jax_groups(t, cfg) and t % g == 0
                assert tmoe.moe_capacity(t // g, tcfg) == jmoe.moe_capacity(t // g, cfg)
    full = t_smoke("granite_moe_3b_a800m")
    assert tmoe.dispatch_groups(72, full) == 24  # the packed step's 72 rows
    assert tmoe.dispatch_groups(33, full) == 11


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("cf,shape", [(2.0, (2, 16)), (2.0, (3, 11)), (0.25, (2, 37)),
                                      (0.25, (1, 97))])
def test_dispatch_and_combine_match_jax(arch, cf, shape):
    """Per group: JAX's ``_dispatch_group`` and ``_combine_group`` (vmapped)
    against the port's batched ``_dispatch`` / ``_combine`` on the same
    routing; then the whole layer and its aux loss."""
    cfg, tcfg, p0, mod = _layer(arch, capacity_factor=cf)
    x = _x(cfg, *shape)
    t = shape[0] * shape[1]
    g = tmoe.dispatch_groups(t, tcfg)
    tg, k, e = t // g, cfg.experts_per_token, cfg.n_experts
    cap = tmoe.moe_capacity(tg, tcfg)
    xg = x.reshape(g, tg, -1)
    gates, topw, topi = tmoe.route(torch.from_numpy(xg), mod.router.w, k)
    jg = jax.nn.softmax(jnp.asarray(xg) @ p0["router"]["w"], axis=-1)
    jw, ji = jax.lax.top_k(jg, k)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(ji))
    # the router product sums d terms in another order than XLA's
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), rtol=1e-5, atol=0)

    ein, slot, st, keep, sw, order = tmoe._dispatch(torch.from_numpy(xg), topi, topw, e, cap)
    j_ein, j_slot, j_st, j_keep, j_sw = jax.vmap(
        lambda xx, ii, ww: jmoe._dispatch_group(xx, ii, ww, e, cap, jnp.float32))(
            jnp.asarray(xg), jnp.asarray(topi.numpy()), jnp.asarray(topw.numpy()))
    np.testing.assert_array_equal(ein.numpy(), np.asarray(j_ein))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(j_slot))
    np.testing.assert_array_equal(st.numpy(), np.asarray(j_st))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(j_keep))
    np.testing.assert_array_equal(sw.numpy(), np.asarray(j_sw))
    overflow = int((~keep).sum())
    if cf < 1:
        assert overflow > 0, "the small capacity factor was meant to overflow"
    else:
        assert overflow == 0

    eo = np.random.RandomState(2).randn(g, e * cap, cfg.d_model).astype(np.float32)
    got = tmoe._combine(torch.from_numpy(eo), slot, keep, sw, order, topi, torch.float32)
    want = jax.vmap(lambda ee, sl, tt, kk, ww: jmoe._combine_group(ee, sl, tt, kk, ww, tg,
                                                                   jnp.float32))(
        jnp.asarray(eo), j_slot, j_st, j_keep, j_sw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=U32 * np.abs(np.asarray(want)).max())

    out, aux = tmoe.moe_apply(mod, torch.from_numpy(x), tcfg)
    j_out, j_aux = jmoe._moe_apply(p0, jnp.asarray(x), cfg)
    w = np.asarray(j_out)
    np.testing.assert_allclose(out.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
    np.testing.assert_allclose(float(aux), float(j_aux), rtol=1e-6)
    again, _ = tmoe.moe_apply(mod, torch.from_numpy(x), tcfg)
    assert torch.equal(out, again)


def test_router_ties_go_to_the_lowest_expert():
    """Equal gates: the stable descending sort picks experts in index order
    among equals, as ``lax.top_k`` does."""
    cfg = j_smoke("granite_moe_3b_a800m")
    rng = np.random.RandomState(3)
    w = rng.randn(cfg.d_model, 4).astype(np.float32)
    # 8 experts as pairs of equal columns, one pair per column of w, and a
    # zero router whose gates all tie
    router = np.repeat(w, 2, axis=1)[:, [1, 0, 3, 2, 5, 4, 7, 6]]
    x = rng.randn(5, cfg.d_model).astype(np.float32)
    for rw in (router, np.zeros_like(router)):
        for k in (1, 2, 3, 8):
            _, _, topi = tmoe.route(torch.from_numpy(x), torch.from_numpy(rw), k)
            gates = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(rw), axis=-1)
            _, ji = jax.lax.top_k(gates, k)
            np.testing.assert_array_equal(topi.numpy(), np.asarray(ji))
    _, _, topi = tmoe.route(torch.from_numpy(x), torch.zeros((cfg.d_model, 8)), 3)
    assert topi.tolist() == [[0, 1, 2]] * 5


@pytest.fixture(scope="module", params=MOE_ARCHS)
def artifact(request, tmp_path_factory):
    cfg = j_smoke(request.param)
    jm = j_build(cfg)
    qp = j_quantize_model(jm, jm.init(jax.random.PRNGKey(0)), MAIN_SPEC)
    d = tmp_path_factory.mktemp(request.param)
    save_quantized(d, cfg, MAIN_SPEC, qp)
    return str(d), jm, qp


def _prompts(vocab):
    rng = np.random.RandomState(11)
    return [[int(t) for t in rng.randint(0, vocab, n)] for n in (13, 5, 22, 9, 17)]


def test_packed_scheduler_tokens_match_jax(artifact):
    """The int4-pool packed scheduler, 3 slots and a pool that preempts:
    the port's greedy tokens and step counters are JAX's. Padded rows of
    each packed step are routed and take capacity in both."""
    path, jm, qp = artifact
    kw = dict(cache_len=48, block_size=8, prefill_chunk=8, n_blocks=9)
    prompts, budgets = _prompts(jm.cfg.vocab_size), [8, 12, 6, 10, 7]
    jeng = JEngine(jm, qp, JServe.from_spec(MAIN_SPEC, **kw), batch_slots=3)
    want = jeng.generate(prompts, max_new_tokens=budgets)
    art = load_quantized(path, device="cpu")
    eng = ServingEngine(art.model, art.params, ServeConfig.from_spec(art.spec, **kw),
                        batch_slots=3)
    assert eng.generate(prompts, max_new_tokens=budgets) == want
    for key in ("packed_steps", "decode_steps", "prefill_tokens", "prefix_hits"):
        assert eng.stats[key] == jeng.stats[key], key


def test_ring_tokens_match_jax(artifact):
    """The fixed-slot ring: left-padded batches of 3 on the int4 ring, each
    batch's pad tokens routed as in JAX."""
    path, jm, qp = artifact
    kw = dict(cache_len=48, paged=False)
    prompts = _prompts(jm.cfg.vocab_size)
    jeng = JEngine(jm, qp, JServe.from_spec(MAIN_SPEC, **kw), batch_slots=3)
    want = jeng.generate(prompts, max_new_tokens=8)
    art = load_quantized(path, device="cpu")
    eng = ServingEngine(art.model, art.params, ServeConfig.from_spec(art.spec, **kw),
                        batch_slots=3)
    assert eng.generate(prompts, max_new_tokens=8) == want
