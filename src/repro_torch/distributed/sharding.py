"""Logical-axis sharding rules (port of ``repro/distributed/sharding.py``).

Model code names the dimensions of its tensors with *logical* axes
("batch", "seq", "d_model", "heads_flat", "d_ff", "vocab", "experts", ...).
A rule set maps logical axes to mesh axes; :func:`constrain` applies it
only when a rule set is active, so the CPU tests and serving, which run
with no rules, pay one context lookup and nothing else.

On DTensors: :func:`constrain` redistributes a DTensor to the placements
that the rules give on its mesh (JAX's ``with_sharding_constraint``), and
:func:`replicate` gathers one to ``Replicate`` on every mesh dimension. A
plain tensor passes both unchanged. ``use_rules(rules, mesh)`` also makes
the mesh active and runs its body under DTensor's implicit replication, so
the tensors a forward makes for itself (positions, masks, RoPE tables)
count as replicated; PyTorch carries that flag to autograd's backward
threads.

Rule sets are data, so a sharding strategy changes without touching the
model code (moving "seq_sp" between None and "model" toggles sequence
parallelism).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

__all__ = [
    "DEFAULT_RULES",
    "MULTI_POD_RULES",
    "PartitionSpec",
    "P",
    "active_mesh",
    "active_rules",
    "constrain",
    "distribute_replicated",
    "gather_dim",
    "placements_for",
    "replicate",
    "run_local",
    "spec_for",
    "use_rules",
]


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (replicated), a mesh-axis name,
    or a tuple of mesh-axis names (sharded over their product, the first
    one major). JAX's ``PartitionSpec``, entry for entry: a tuple of one
    name is that name, as JAX normalises it."""

    def __new__(cls, *axes):
        norm = lambda a: a[0] if isinstance(a, (tuple, list)) and len(a) == 1 else (
            tuple(a) if isinstance(a, list) else a)
        return super().__new__(cls, tuple(norm(a) for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec

# Single-pod mesh ("data", "model"). Megatron-style TP over "model", DP over
# "data". "seq" unsharded by default; SP rules override per shape.
DEFAULT_RULES: dict[str, object] = {
    "batch": "data",
    "seq": None,
    "seq_sp": None,  # residual-stream seq dim; "model" enables Megatron SP
    "d_model": None,
    "heads_flat": "model",  # flattened H * head_dim projection outputs
    "kv_heads": "model",
    "d_ff": "model",
    "vocab": "model",
    "experts": "model",
    "dispatch_groups": "data",
    "d_inner": "model",  # SSM / LRU inner channels
    "state": None,
}

# Multi-pod mesh ("pod", "data", "model"): DP spans pod x data.
MULTI_POD_RULES: dict[str, object] = {**DEFAULT_RULES, "batch": ("pod", "data")}

_CTX: contextvars.ContextVar[tuple] = contextvars.ContextVar("repro_torch_sharding",
                                                             default=(None, None))


def active_rules() -> dict | None:
    return _CTX.get()[0]


def active_mesh():
    """The ``DeviceMesh`` given to the innermost :func:`use_rules`, or None."""
    return _CTX.get()[1]


@contextlib.contextmanager
def use_rules(rules: dict | None, mesh=None):
    """Make ``rules`` (and ``mesh``) active for the body. With a mesh, the
    body runs under DTensor's implicit replication of plain tensors."""
    token = _CTX.set((rules, mesh))
    try:
        with implicit_replication() if mesh is not None else contextlib.nullcontext():
            yield
    finally:
        _CTX.reset(token)


def spec_for(*logical_axes: str | None, rules: dict | None = None) -> PartitionSpec:
    """PartitionSpec for a tensor whose dims carry these logical names."""
    r = rules if rules is not None else (active_rules() or {})
    return P(*[r.get(a) if a is not None else None for a in logical_axes])


def placements_for(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each mesh
    dimension that a tensor dimension ``d`` names, ``Replicate()`` on the
    others and on every mesh dimension of size 1 (its one rank holds the
    whole dim either way, and DTensor would redistribute a shard of one). A
    tensor dimension sharded over several mesh axes must name them in the
    mesh's order (JAX's major-to-minor order is DTensor's then)."""
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh needs named dimensions (mesh_dim_names)")
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec!r} names mesh axis {a!r}; the mesh has {names}")
            if out[names.index(a)] != Replicate():
                raise ValueError(f"spec {spec!r} names mesh axis {a!r} twice")
            if mesh.size(names.index(a)) > 1:
                out[names.index(a)] = Shard(d)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec!r}: axes {axes} are not in the mesh's order {names}")
    return out


def distribute_replicated(t: torch.Tensor, mesh, placements) -> DTensor:
    """``t``, the whole tensor and the same on every rank (the port's seeded
    init, a batch every rank drew), as a DTensor with ``placements``: each
    rank keeps its own slice, with no communication."""
    full = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    out = full.redistribute(mesh, placements)
    local = out.to_local()
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        # a slice of t: the shard owns its bytes, so the rank does not keep t whole
        out = DTensor.from_local(local.clone(), mesh, placements, run_check=False,
                                 shape=out.shape, stride=out.stride())
    return out


def replicate(x: torch.Tensor) -> torch.Tensor:
    """Force full replication (an explicit all-gather of a sharded operand).

    Unlike :func:`constrain` (which skips all-None specs), this is
    deliberate: used where gathering a small operand is cheaper than
    reducing a large partial result (the MoE expert weights), or where
    DTensor has no sharding rule for the next op."""
    if active_rules() is None or not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, [Replicate()] * mesh.ndim)


def gather_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor with its tensor dim ``dim`` whole on every rank: a shard of
    that dim is gathered and a partial sum reduced, every other placement
    kept. For an op along ``dim`` that DTensor has no working rule for. A
    plain tensor passes unchanged."""
    if not isinstance(x, DTensor):
        return x
    d = dim % x.ndim
    keep = [Replicate() if (isinstance(p, Shard) and p.dim == d) or p.is_partial() else p
            for p in x.placements]
    return x if keep == list(x.placements) else x.redistribute(x.device_mesh, keep)


def run_local(fn, x: torch.Tensor, *args, dims: tuple[int, ...]):
    """``fn(x, *args)`` on each rank's own slices of its DTensor arguments,
    sharded only on the tensor dims ``dims`` (the same in every argument;
    every other dim gathered first); the result, shaped like ``x``, comes
    back in those placements. For an op that is independent along ``dims``
    (attention per batch row and KV head) where DTensor's own rules fail.
    Without a DTensor ``x``, just ``fn(x, *args)``."""
    if not isinstance(x, DTensor):
        return fn(x, *args)
    mesh = x.device_mesh
    keep = [p if isinstance(p, Shard) and p.dim in dims else Replicate() for p in x.placements]
    local = lambda a: a.redistribute(mesh, keep).to_local() if isinstance(a, DTensor) else a
    out = fn(local(x), *map(local, args)).contiguous()
    stride = torch.empty(x.shape, device="meta").stride()
    return DTensor.from_local(out, mesh, keep, run_check=False, shape=x.shape, stride=stride)


def constrain(x: torch.Tensor, *logical_axes: str | None) -> torch.Tensor:
    """Redistribute a DTensor iff a rule set is active and at least one axis
    resolves to a mesh axis. An all-None spec would force replication: with
    no opinion, the placements are left to the ops."""
    rules = active_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    spec = spec_for(*logical_axes, rules=rules)
    if all(a is None for a in spec):
        return x
    placements = placements_for(spec, x.device_mesh)
    if tuple(placements) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)
