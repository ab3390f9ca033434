"""Parameter and cache sharding specs (port of
``repro/distributed/param_sharding.py``), and their DTensor placements.

Column-parallel projections shard their output dim on "model"; row-parallel
ones (the projections back to d_model) shard their input (contraction) dim,
so each block's TP pattern is the classic column -> row pair with one
all-reduce. Divisibility against the model-axis size is checked per actual
dim: a dim that does not divide stays replicated. Quantized trees follow the
same rules (``packed`` and ``scale`` as their projection, codebooks
replicated).

The specs are computed on the JAX-layout tree of the port's model
(``models.model.tree_from_params``; :func:`param_shapes` gives it on the
meta device), so they compare with JAX's leaf by leaf. :func:`parameter_specs`
maps each leaf to the port's ``nn.Parameter``s: a stacked leaf of a scanned
config, ``(L, ...)`` or the vlm's ``(G, n_self, ...)``, is one parameter per
layer, and each takes the leaf's spec without its stack axes.
:func:`distribute_params` then replaces every parameter (and every buffer
of a ``QLinear``, the quantized leaves) in place by a DTensor with those
placements. The caches go the same way: :func:`cache_tree` gives the
port's per-layer caches in JAX's layout for :func:`build_cache_specs`, and
:func:`distribute_caches` places them.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.qlinear import QLinear, QLinearParams
from repro_torch.core.quantize import QuantizedWeight
from repro_torch.distributed.sharding import (P, PartitionSpec, distribute_replicated,
                                              placements_for)
from repro_torch.models.model import tree_from_params

__all__ = ["build_param_specs", "build_cache_specs", "flatten_specs", "param_shapes",
           "leaf_parameters", "parameter_specs", "distribute_params", "cache_tree",
           "distribute_caches"]

# parent linear name -> "col" (shard last dim) | "row" (shard first matrix dim)
_COL = {
    "wq", "wk", "wv", "wi", "in_proj", "dt_proj", "lin_y", "lin_x",
    "w_a", "w_x", "head",
}
_ROW = {"wo", "wd", "out_proj", "lin_out", "x_proj"}
_REPLICATED = {"router", "shared_gate", "norm1", "norm2", "norm", "norm_f"}

# vector params sharded on "model" when divisible (all live on d_inner)
_VEC_MODEL = {"conv_b", "dt_bias", "D", "lambda"}

_QLINEAR_FIELDS = ("qw", "act_codebook", "bias", "thr_lo", "thr_hi")
_QWEIGHT_FIELDS = ("packed", "codebook", "scale")


def _flatten(tree, names: tuple = (), into_quantized: bool = True):
    """(path names, leaf) pairs of a JAX-layout tree: dict keys, ``[i]`` for
    list items, and the data fields of ``QLinearParams`` / ``QuantizedWeight``
    as JAX's pytree registrations name them (None fields dropped)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], (*names, str(k)), into_quantized)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, (*names, f"[{i}]"), into_quantized)
    elif isinstance(tree, (QLinearParams, QuantizedWeight)):
        if into_quantized:
            fields = _QLINEAR_FIELDS if isinstance(tree, QLinearParams) else _QWEIGHT_FIELDS
            for f in fields:
                if getattr(tree, f) is not None:
                    yield from _flatten(getattr(tree, f), (*names, f), into_quantized)
    elif tree is not None:
        yield names, tree


def _map(tree, fn, names: tuple = ()):
    """``tree`` with every leaf ``fn(names, leaf)``; quantized parameters
    become dicts of their data fields."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, (*names, str(k))) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn, (*names, f"[{i}]")) for i, v in enumerate(tree)]
    if isinstance(tree, (QLinearParams, QuantizedWeight)):
        fields = _QLINEAR_FIELDS if isinstance(tree, QLinearParams) else _QWEIGHT_FIELDS
        return {f: _map(getattr(tree, f), fn, (*names, f)) for f in fields
                if getattr(tree, f) is not None}
    return fn(names, tree)


def flatten_specs(spec_tree) -> dict[str, PartitionSpec]:
    """``{"a/b/c": spec}`` of a spec tree (a spec is a leaf, not a tuple node)."""
    out = {}

    def walk(t, names):
        if isinstance(t, PartitionSpec):
            out["/".join(names)] = t
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, (*names, str(k)))
        else:
            for i, v in enumerate(t):
                walk(v, (*names, f"[{i}]"))

    walk(spec_tree, ())
    return out


def _div(dim: int, mesh_axis_size: int):
    return dim % mesh_axis_size == 0


def _leaf_spec(names: tuple, shape, model_size: int) -> PartitionSpec:
    ndim = len(shape)
    axes: list = [None] * ndim

    parent = None
    for n in reversed(names):
        if n in _COL or n in _ROW or n in _REPLICATED:
            parent = n
            break

    last = names[-1] if names else ""

    def set_axis(i: int):
        if _div(shape[i], model_size):
            axes[i] = "model"

    if last == "table" and ndim >= 2:  # embedding (V, d): shard vocab
        set_axis(ndim - 2)
    elif parent in _REPLICATED:
        pass
    elif last in ("w",):
        if parent in _COL and ndim >= 1:
            set_axis(ndim - 1)
        elif parent in _ROW and ndim >= 2:
            set_axis(ndim - 2)
    elif last == "b":
        if parent in _COL and ndim >= 1:
            set_axis(ndim - 1)
    elif last == "packed":  # QuantizedWeight indices (K, N//2)
        if parent in _COL:
            set_axis(ndim - 1)
        elif parent in _ROW and ndim >= 2:
            set_axis(ndim - 2)
    elif last == "scale" and parent is not None:  # per-out-channel scales (N,)
        if parent in _COL:
            set_axis(ndim - 1)
    elif last in ("codebook", "act_codebook", "thr_lo", "thr_hi"):
        pass
    elif last == "conv_w" and ndim >= 2:  # (cw, di)
        set_axis(ndim - 1)
    elif last == "A_log" and ndim >= 2:  # (di, N)
        set_axis(ndim - 2)
    elif last in _VEC_MODEL and ndim >= 1:
        set_axis(ndim - 1)
    # the MoE's raw expert arrays: wi (E, d, 2f) and wd (E, f, d)
    elif last == "wi" and ndim >= 3:
        set_axis(ndim - 1)
    elif last == "wd" and ndim >= 3:
        set_axis(ndim - 2)

    return P(*axes)


def build_param_specs(params_shapes, model_size: int = 16, fsdp_axes=None,
                      fsdp_shards: int = 1):
    """Spec tree mirroring ``params_shapes`` (any leaves with ``.shape``; a
    quantized parameter becomes a dict of its data fields).

    ``fsdp_axes``: optional DP mesh axes for ZeRO-3-style parameter
    sharding: after the TP assignment, the largest remaining unsharded dim
    of each >= 2-D leaf that ``fsdp_shards`` divides is sharded over them."""

    def one(names, leaf):
        shape = tuple(leaf.shape)
        spec = _leaf_spec(names, shape, model_size)
        if fsdp_axes is not None and len(shape) >= 2:
            axes = list(spec) + [None] * (len(shape) - len(spec))
            cands = [(shape[i], i) for i in range(len(shape))
                     if axes[i] is None and shape[i] % fsdp_shards == 0 and shape[i] > 1]
            if cands:
                _, i = max(cands)
                axes[i] = fsdp_axes
            spec = P(*axes)
        return spec

    return _map(params_shapes, one)


def build_cache_specs(cache_shapes, batch_axes, batch_shards: int, model_size: int = 16,
                      kv_heads: int = 0, ssm_state: int = 0):
    """Specs for KV / SSM caches: the batch dim on the DP axes, kv-heads or
    d_inner on "model" when divisible, slot positions and codebooks
    replicated.

    Cache leaf base ranks (without leading scan-stack dims):
      k/v (B, C, KV, hd) | *_idx (B, C, KV, hd/2) | *_scale (B, C, KV, 1)
      mamba h (B, di, N) | rglru h (B, di) | conv (B, cw-1, di)
    """

    def spec(names, leaf):
        last = names[-1]
        shape = tuple(leaf.shape)
        axes: list = [None] * len(shape)
        if last in ("slot_pos", "kv_codebook"):
            return P(*axes)
        kv_like = last in ("k", "v", "ck", "cv", "k_idx", "v_idx", "k_scale", "v_scale")
        if kv_like:
            base_rank = 4
        elif last == "conv":
            base_rank = 3
        elif last == "h":
            base_rank = 3 if (ssm_state and shape[-1] == ssm_state) else 2
        else:
            return P(*axes)
        b_dim = len(shape) - base_rank
        if (b_dim >= 0 and batch_axes is not None and batch_shards > 1
                and shape[b_dim] % batch_shards == 0):
            axes[b_dim] = batch_axes
        if kv_like:
            kv_dim = len(shape) - 2
            if kv_heads and kv_heads % model_size == 0 and shape[kv_dim] == kv_heads:
                axes[kv_dim] = "model"
            elif last in ("k", "v", "ck", "cv", "k_idx", "v_idx") and _div(shape[-1], model_size):
                # kv heads that do not divide the model axis: shard head_dim
                # instead, or the cache replicates across the model axis
                axes[-1] = "model"
        else:
            di_dim = len(shape) - 2 if (last == "h" and base_rank == 3) else len(shape) - 1
            if _div(shape[di_dim], model_size):
                axes[di_dim] = "model"
        return P(*axes)

    return _map(cache_shapes, spec)


def param_shapes(params: nn.Module) -> dict:
    """The JAX-layout tree of ``params`` on the meta device: shapes and
    dtypes only, stacked as the config scans them, nothing allocated."""
    return tree_from_params(params, lambda p: torch.empty(p.shape, dtype=p.dtype, device="meta"))


def _named_leaves(params: nn.Module) -> list[tuple[str, torch.Tensor]]:
    """The model's parameters, then the buffers of its ``QLinear`` modules
    (the quantized leaves), by name."""
    out = list(params.named_parameters())
    for mname, m in params.named_modules():
        if isinstance(m, QLinear):
            out += [(f"{mname}.{b}", t) for b, t in m.named_buffers(recurse=False)]
    return out


def leaf_parameters(params: nn.Module) -> dict[str, tuple[tuple[int, ...], list[str]]]:
    """``{JAX leaf path "a/b/c": (stack shape, tensor names)}`` for the
    leaves of the port's model (a quantized one's ``QLinear`` buffers too,
    ``.../wq/qw/packed``): a stacked leaf of a scanned config holds its
    layers' tensors in the stack's row-major order (its stack shape
    ``(L,)`` or the vlm's ``(G, n_self)``); an unstacked leaf holds one
    tensor, stack shape ``()``."""
    leaves = _named_leaves(params)
    index = {id(t): i for i, (_, t) in enumerate(leaves)}
    idx_tree = tree_from_params(params, lambda t: torch.tensor(index[id(t)]))
    return {"/".join(path): (tuple(idx.shape), [leaves[i][0] for i in idx.reshape(-1).tolist()])
            for path, idx in _flatten(idx_tree)}


def parameter_specs(params: nn.Module, specs) -> dict[str, PartitionSpec]:
    """``{tensor name: spec}`` for every parameter of the port's model (and
    ``QLinear`` buffer), from a spec tree of :func:`build_param_specs` over
    its :func:`param_shapes`. A stacked leaf's spec loses its stack axes; a
    spec that shards a stack axis raises, naming the leaf."""
    flat = flatten_specs(specs)
    out = {}
    for key, (stack, names) in leaf_parameters(params).items():
        spec, k = flat[key], len(stack)
        if any(a is not None for a in spec[:k]):
            raise ValueError(f"spec {spec!r} of {key} shards a stack axis of a scanned "
                             "leaf; the port's per-layer parameters cannot take it")
        for n in names:
            out[n] = P(*spec[k:])
    return out


def distribute_params(params: nn.Module, specs, mesh) -> nn.Module:
    """Replace each parameter (and ``QLinear`` buffer) of ``params`` in place
    by a DTensor on ``mesh`` with the placements of its spec (parameters
    ``requires_grad=False``, as the port builds them). Every rank must hold
    the same values (the seeded init): each keeps its own slice. Returns
    ``params``."""
    for name, spec in parameter_specs(params, specs).items():
        prefix, _, leaf = name.rpartition(".")
        mod = params.get_submodule(prefix) if prefix else params
        t = getattr(mod, leaf)
        d = distribute_replicated(t.data, mesh, placements_for(spec, mesh))
        if leaf in mod._buffers:
            mod._buffers[leaf] = d
        else:
            setattr(mod, leaf, nn.Parameter(d, requires_grad=False))
    return params


def cache_tree(caches: list[dict], cfg) -> dict | list:
    """The port's per-layer caches (a list of dicts) in the JAX package's
    layout, as meta tensors of the stacked shapes: one dict of ``(L, ...)``
    leaves for a scanned config, the vlm's ``{"self": (G, n_self, ...),
    "cross": (G, ...)}``, and the list itself (as meta tensors) otherwise."""
    meta = lambda t, stack=(): torch.empty((*stack, *t.shape), dtype=t.dtype, device="meta")
    stacked = lambda layers, stack: {k: meta(v, stack) for k, v in layers[0].items()}
    if cfg.family == "vlm":
        per = cfg.cross_attn_every
        groups = cfg.n_layers // per
        return {"self": stacked(caches, (groups, per - 1)),
                "cross": stacked(caches[per - 1 :: per], (groups,))}
    if cfg.scan_layers:
        return stacked(caches, (len(caches),))
    return [{k: meta(v) for k, v in layer.items()} for layer in caches]


def distribute_caches(caches: list[dict], cfg, specs, mesh) -> list[dict]:
    """The caches as DTensors on ``mesh`` with the placements of their
    leaves' specs, a spec tree of :func:`build_cache_specs` over
    :func:`cache_tree` (stack axes dropped; they are never sharded). Every
    rank must hold the same values: each keeps its own slice."""
    if cfg.family == "vlm":
        per = cfg.cross_attn_every
        layer_specs = [specs["cross"] if i % per == per - 1 else specs["self"]
                       for i in range(len(caches))]
    elif cfg.scan_layers:
        layer_specs = [specs] * len(caches)
    else:
        layer_specs = specs
    out = []
    for layer, sp in zip(caches, layer_specs):
        placed = {}
        for k, t in layer.items():
            spec = sp[k][len(sp[k]) - t.ndim:]
            placed[k] = distribute_replicated(t, mesh, placements_for(spec, mesh))
        out.append(placed)
    return out
