"""PyTorch port vs JAX package: the launch tooling's per-cell setups.

For every architecture, ``ModelConfig.n_params`` and ``n_active_params``
equal JAX's. For every assigned (arch x shape) cell that ``skip_reason``
lets run, at the full configurations on the single-pod mesh, the port's
``build_cell`` gives (through its JAX-layout mapping: ``train_state_tree``,
``tree_from_params``, ``cache_tree``) JAX's ``build_cell(...).args`` leaf for
leaf in shape and dtype, JAX's ``in_specs`` entry for entry (with JAX's FSDP
threshold, half of a 16 GB TPU, passed in) and JAX's ``meta``. Both sides
only trace shapes: JAX under ``jax.eval_shape``, the port on fake tensors.
Exact throughout.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # test workers share the cores: more threads oversubscribe them
jax = pytest.importorskip("jax")

from repro.configs import base as jbase  # noqa: E402
from repro.distributed import param_sharding as jps  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.distributed import param_sharding as tps  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models.model import tree_from_params  # noqa: E402
from repro_torch.train.trainer import train_state_tree  # noqa: E402

ASSIGNED = tbase.list_archs(assigned_only=True)
JAX_TPU_HBM = 16e9  # JAX's FSDP threshold is n_params * 14 / 16 > 8e9: half of this


def _dtype(d) -> str:
    return str(d).removeprefix("torch.")


def _jax_leaves(tree, is_leaf=None) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {"/".join(jps._names_of(p)): v for p, v in flat}


def _port_layout(setup) -> tuple:
    """The port's arguments in JAX's tree layout."""
    cfg = setup.cfg
    if setup.meta["kind"] == "train":
        state, batch = setup.args
        return train_state_tree(state), batch
    params, caches, *rest = setup.args
    return (tree_from_params(params), tps.cache_tree(caches, cfg), *rest)


@pytest.mark.parametrize("arch", tbase.list_archs())
def test_param_counts_equal_jax(arch):
    tcfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
    assert tcfg.n_params == jcfg.n_params
    assert tcfg.n_active_params == jcfg.n_active_params
    smoke_t, smoke_j = tbase.get_smoke_config(arch), jbase.get_smoke_config(arch)
    assert (smoke_t.n_params, smoke_t.n_active_params) == \
        (smoke_j.n_params, smoke_j.n_active_params)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_cells_equal_jax_build_cell(arch):
    """Every runnable shape of ``arch`` on the single mesh: args leaf for
    leaf (shape and dtype), in_specs entry for entry, meta."""
    cfg = tbase.get_config(arch)
    for shape in tbase.SHAPES:
        if tspecs.skip_reason(cfg, tbase.SHAPES[shape]):
            with pytest.raises(ValueError, match="skipped"):
                tspecs.build_cell(arch, shape, False)
            continue
        want = jspecs.build_cell(arch, shape, False)
        got = tspecs.build_cell(arch, shape, False, hbm_bytes=JAX_TPU_HBM)
        assert got.meta == want.meta, (arch, shape)
        assert got.rules == want.rules, (arch, shape)
        jl = {k: (tuple(v.shape), _dtype(v.dtype)) for k, v in _jax_leaves(want.args).items()}
        tl = {"/".join(k): (tuple(v.shape), _dtype(v.dtype))
              for k, v in tps._flatten(_port_layout(got))}
        assert tl.keys() == jl.keys(), (arch, shape, sorted(tl.keys() ^ jl.keys())[:10])
        bad = {k: (tl[k], jl[k]) for k in jl if tl[k] != jl[k]}
        assert not bad, (arch, shape, bad)
        is_spec = lambda x: isinstance(x, jax.sharding.PartitionSpec)
        js = {k: tuple(v) for k, v in _jax_leaves(want.in_specs, is_spec).items()}
        ts = {k: tuple(v) for k, v in tps.flatten_specs(list(got.in_specs)).items()}
        assert ts == js, (arch, shape, {k: (ts.get(k), js.get(k)) for k in js
                                        if ts.get(k) != js[k]})


def test_fsdp_threshold_is_half_the_card():
    """At the H100's 80 GB the FSDP rule shards the state of the cells whose
    14 bytes a parameter over the model axis pass 40 GB; at JAX's 16 GB
    those past 8 GB. The specs differ exactly where the rule's choice does."""
    for arch in ASSIGNED:
        cfg = tbase.get_config(arch)
        per_device = cfg.n_params * 14 / 16
        h100 = tspecs.build_cell(arch, "train_4k", False)
        tpu = tspecs.build_cell(arch, "train_4k", False, hbm_bytes=JAX_TPU_HBM)
        fsdp = lambda s: any("data" in str(v) for v in
                             tps.flatten_specs(s.in_specs[0]["params"]).values())
        assert fsdp(h100) == (per_device > 40e9), arch
        assert fsdp(tpu) == (per_device > 8e9), arch
