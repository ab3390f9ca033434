"""Per-device step analysis and the H100 roofline (port of
``repro/launch/roofline.py``).

JAX parses compiled HLO and weights each computation by its while-loop
trip count, because XLA's ``cost_analysis`` counts a scan body once. Eager
PyTorch dispatches every iteration, so here a ``TorchDispatchMode``
(:func:`analyze_step`) watches one call of the step and records, per
device:

* **matmul FLOPs** of ``mm``, ``bmm``, ``addmm``, ``baddbmm`` and the
  convolutions, with ``torch.utils.flop_counter``'s formulas. Only local
  ops count: an op on DTensors is handed on to DTensor, whose local ops come
  back through the mode, and the ops DTensor runs to propagate global
  shapes (``ShardingPropagator._propagate_tensor_meta_non_cached``) are
  skipped. ``FlopCounterMode`` over DTensors counts those as well;
* **collective bytes** of every ``_c10d_functional`` all-reduce,
  all-gather, reduce-scatter and all-to-all: the input's bytes, the mesh
  dimension the op ran over and the Python call path that issued it (what
  the HLO's ``op_name`` metadata was for ``profile_hlo``);
* **argument, output and peak live bytes**: every storage of the
  arguments and every storage an op returns is live until its last
  reference goes (a weakref finalizer on the storage). The counterpart of
  XLA's ``memory_analysis``: temps are the peak less the arguments.

On fake tensors (``FakeTensorMode``) nothing is allocated, so a full-size
cell is analysed on the CPU. Composite ops that reach the mode whole
(inference mode) are counted by their parts, as ``FlopCounterMode`` counts
them. Memory inside one aten call that no op returns (cuBLAS workspaces)
is not seen.

Terms (per device):

    compute    = matmul FLOPs / peak bf16 FLOP/s
    memory     = (args + outputs + 2 x (peak - args)) / HBM bandwidth
    collective = sum over mesh dims of bytes / that dim's link bandwidth

**Topology.** The meshes keep JAX's shapes, ``(16, 16)`` and ``(2, 16,
16)``, with ranks in row-major order, 8 cards a host (a DGX H100). A mesh
dimension whose ranks span more than one host runs at the inter-host
rate; one inside a host at NVLink's. With 8 cards a host, every dimension
of these meshes spans hosts: "model" (16 consecutive ranks) crosses two,
"data" (stride 16) sixteen. A mesh shaped for 8-card hosts is not built.
"""

from __future__ import annotations

import dataclasses
import math
import sys
import threading
import time
import weakref
from collections import defaultdict

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

__all__ = ["HW", "analyze_step", "link_bandwidth", "roofline_terms", "RooflineResult",
           "MATMUL_OPS"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W)."""

    peak_flops: float = 989e12  # bf16 tensor cores, dense
    hbm_bw: float = 3.35e12  # HBM3, B/s
    hbm_bytes: float = 80e9  # HBM3 capacity
    # NVLink 4: 900 GB/s per card both ways, 450 GB/s each way, among the 8
    # cards of a host (NVSwitch)
    nvlink_bw: float = 450e9
    # between hosts: one 400 Gb/s ConnectX-7 NIC per card (DGX H100), 50 GB/s
    inter_host_bw: float = 50e9
    cards_per_host: int = 8


aten = torch.ops.aten
# the ops whose FLOPs count, by overload packet (``flop_registry``'s keys)
MATMUL_OPS = (aten.mm, aten.bmm, aten.addmm, aten.baddbmm, aten.convolution,
              aten._convolution, aten.convolution_backward)
_COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
_COMPOSITE = torch._C.DispatchKey.CompositeImplicitAutograd
_SOURCE_DEPTH = 4  # innermost frames of the port named in a call path


def _collective_kind(func) -> str | None:
    ns = func.namespace
    if ns not in ("_c10d_functional", "c10d_functional"):
        return None
    name = func._overloadpacket.__name__
    return next((c for c in _COLLECTIVES if name.startswith(c)), None)


def _call_path() -> str:
    """The innermost frames of the port's own code (not this package's),
    outermost first: ``models/layers.py:attention_apply > ...``."""
    names = []
    f = sys._getframe(2)
    while f is not None and len(names) < _SOURCE_DEPTH:
        fn = f.f_code.co_filename
        i = fn.rfind("repro_torch/")
        if i >= 0 and "repro_torch/launch/" not in fn:
            names.append(f"{fn[i + len('repro_torch/'):]}:{f.f_code.co_name}")
        f = f.f_back
    return " > ".join(reversed(names)) or "?"


# torch's dispatch machinery, between an op's caller and the mode
_DISPATCH_FILES = ("torch/_ops.py", "torch/utils/_python_dispatch.py", "torch/_subclasses/",
                   "torch/_compile.py", "torch/_dynamo/", "torch/utils/_stats.py",
                   "torch/_decomp/", "torch/_refs/", "torch/_prims")


def _made_by_dtensor() -> bool:
    """Whether the op being dispatched was called by DTensor's own code."""
    f = sys._getframe(2)
    while f is not None and any(d in f.f_code.co_filename for d in _DISPATCH_FILES):
        f = f.f_back
    return f is not None and ("torch/distributed/tensor/" in f.f_code.co_filename
                              or "torch/distributed/_local_tensor" in f.f_code.co_filename)


def _tensors(tree):
    """Every tensor in ``tree`` (dicts, lists, tuples, a module's parameters
    and buffers); a DTensor and then its local tensor."""
    from torch.distributed.tensor import DTensor

    stack = [tree]
    while stack:
        t = stack.pop()
        if isinstance(t, torch.nn.Module):
            stack.extend(t.parameters())
            stack.extend(t.buffers())
        elif isinstance(t, torch.Tensor):
            yield t
            if isinstance(t, DTensor):
                stack.append(t.to_local())
        elif isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)


def _storages(tree) -> dict[int, torch.UntypedStorage]:
    """The distinct storages of the plain tensors in ``tree`` (a DTensor's
    local tensor), by identity."""
    from torch.distributed.tensor import DTensor

    return {id(st): st for st in (t.untyped_storage() for t in _tensors(tree)
                                  if not isinstance(t, DTensor))}


class _ShapePropagation:
    """While DTensor runs an op on fake tensors only to learn its global
    output shape, the analysis counts nothing: patches
    ``ShardingPropagator._propagate_tensor_meta_non_cached`` to raise a
    per-thread flag around it. (Its fake mode is an infra mode, below this
    user mode on the stack, so those ops come here first.)"""

    flag = threading.local()

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        self.cls = ShardingPropagator
        self.orig = ShardingPropagator.__dict__["_propagate_tensor_meta_non_cached"]
        orig, flag = self.orig, self.flag

        def wrapped(prop, op_schema):
            depth = getattr(flag, "depth", 0)
            flag.depth = depth + 1
            try:
                return orig(prop, op_schema)
            finally:
                flag.depth = depth

        ShardingPropagator._propagate_tensor_meta_non_cached = wrapped
        return self

    def __exit__(self, *exc):
        self.cls._propagate_tensor_meta_non_cached = self.orig

    @classmethod
    def active(cls) -> bool:
        return getattr(cls.flag, "depth", 0) > 0


class _StepAnalysis(TorchDispatchMode):
    def __init__(self, group_dims: dict[str, str], fake):
        super().__init__()
        self.group_dims, self.fake = group_dims, fake
        self.flops_by_op: dict[str, float] = defaultdict(float)
        self.flops_by_source: dict[str, float] = defaultdict(float)
        self.collectives: dict[tuple, list] = {}
        self.live = self.peak = 0
        self.n_ops = 0
        self.seen: set[int] = set()
        self.lock = threading.Lock()

    def track(self, st: torch.UntypedStorage) -> None:
        """Count ``st`` live until it is freed."""
        key = id(st)
        if key in self.seen:
            return
        n = st.nbytes()
        with self.lock:
            self.seen.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._freed, key, n)

    def _freed(self, key: int, n: int) -> None:
        with self.lock:
            self.seen.discard(key)
            self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if any(isinstance(a, DTensor) for a in flat):
            return NotImplemented  # DTensor runs it; its local ops come back here
        if _ShapePropagation.active():
            return func(*args, **kwargs)
        if func.namespace == "aten" and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), _COMPOSITE):
            # a composite op reaches the mode whole where autograd is off
            # (inference mode): count its parts, as FlopCounterMode does
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        if not any(isinstance(a, torch.Tensor) for a in flat):  # a factory
            if _made_by_dtensor():
                # a tensor DTensor makes for its own planning (shard offsets,
                # read back with .tolist()): a real one, not counted
                return func(*args, **kwargs)
            if self.fake is not None:  # the step's own: fake, as its arguments
                with self.fake:
                    out = func(*args, **kwargs)
            else:
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        self.n_ops += 1
        packet = func._overloadpacket
        if packet in MATMUL_OPS:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops_by_op[packet.__name__] += flops
            self.flops_by_source[_call_path()] += flops
        kind = _collective_kind(func)
        if kind is not None:
            tensors = [a for a in flat if isinstance(a, torch.Tensor)]
            nbytes = sum(t.numel() * t.element_size() for t in tensors)
            group = next((a for a in flat if isinstance(a, str) and a in self.group_dims), None)
            key = (kind, self.group_dims.get(group, "?"), _call_path(), nbytes)
            self.collectives.setdefault(key, [0])[0] += 1
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and not isinstance(t, DTensor):
                self.track(t.untyped_storage())
        return out


def _mesh_of(args):
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import active_mesh

    if active_mesh() is not None:
        return active_mesh()
    return next((t.device_mesh for t in _tensors(args) if isinstance(t, DTensor)), None)


def analyze_step(fn, *args, mesh=None) -> dict:
    """Call ``fn(*args)`` once under the analysis and return, per device:
    ``matmul_flops`` (with ``flops_by_op`` and ``flops_by_source``, the
    call path of each product), ``collective_bytes`` (with
    ``collective_breakdown`` by op, ``collective_bytes_by_dim`` by mesh
    dimension and ``collectives``, one row per op, dimension, call path and
    size with its count), ``argument_bytes``, ``output_bytes``,
    ``peak_bytes`` (arguments included), ``temp_bytes`` (the peak less
    the arguments), ``mesh`` (shape and dimension names, or None), ``n_ops``
    and ``seconds``. ``mesh``: default the active rules' mesh or the mesh of
    a DTensor argument. With fake arguments the step's own factory calls
    (``torch.zeros``, ``torch.arange``) make fake tensors of their mode;
    DTensor's planning tensors stay real and uncounted."""
    mesh = mesh if mesh is not None else _mesh_of(args)
    group_dims = {}
    if mesh is not None:
        for i, name in enumerate(mesh.mesh_dim_names or range(mesh.ndim)):
            group_dims[mesh.get_group(i).group_name] = str(name)
    arg_st = _storages(args)
    fake = next((t.fake_mode for t in _tensors(args) if isinstance(t, FakeTensor)), None)
    mode = _StepAnalysis(group_dims, fake)
    for st in arg_st.values():
        mode.track(st)
    arg_bytes = mode.live
    t0 = time.perf_counter()
    with _ShapePropagation(), mode:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    out_bytes = sum(st.nbytes() for k, st in _storages(out).items() if k not in arg_st)
    coll = [{"op": k[0], "dim": k[1], "source": k[2], "bytes": k[3], "count": c[0]}
            for k, c in mode.collectives.items()]
    breakdown, by_dim = defaultdict(float), defaultdict(float)
    for c in coll:
        breakdown[c["op"]] += c["bytes"] * c["count"]
        by_dim[c["dim"]] += c["bytes"] * c["count"]
    return {
        "matmul_flops": float(sum(mode.flops_by_op.values())),
        "flops_by_op": dict(mode.flops_by_op),
        "flops_by_source": dict(mode.flops_by_source),
        "collective_bytes": float(sum(breakdown.values())),
        "collective_breakdown": dict(breakdown),
        "collective_bytes_by_dim": dict(by_dim),
        "collectives": sorted(coll, key=lambda c: -c["bytes"] * c["count"]),
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "peak_bytes": mode.peak,
        "temp_bytes": mode.peak - arg_bytes,
        "mesh": None if mesh is None else {"shape": list(mesh.shape),
                                           "axes": list(mesh.mesh_dim_names or ())},
        "n_ops": mode.n_ops,
        "seconds": seconds,
    }


def link_bandwidth(mesh: dict | None, dim: str, hw: HW = HW()) -> float:
    """B/s of one mesh dimension's link: NVLink when its ranks lie on one
    host (row-major ranks, ``hw.cards_per_host`` a host), else the
    inter-host rate. A dimension the analysis could not name counts as
    inter-host."""
    if mesh is None or dim not in mesh["axes"]:
        return hw.inter_host_bw
    i = mesh["axes"].index(dim)
    stride = math.prod(mesh["shape"][i + 1:])
    within = stride * mesh["shape"][i] <= hw.cards_per_host
    return hw.nvlink_bw if within else hw.inter_host_bw


@dataclasses.dataclass
class RooflineResult:
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    flops: float
    mem_bytes: float
    coll_bytes: float
    collective_s_by_dim: dict

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(analysis: dict, hw: HW = HW()) -> RooflineResult:
    """The three per-device terms of one analysed step (see the module
    docstring) and the largest of them."""
    flops = analysis["matmul_flops"]
    args = analysis["argument_bytes"]
    mem_bytes = args + analysis["output_bytes"] + 2 * (analysis["peak_bytes"] - args)
    by_dim = {d: b / link_bandwidth(analysis["mesh"], d, hw)
              for d, b in analysis["collective_bytes_by_dim"].items()}
    terms = {
        "compute": flops / hw.peak_flops,
        "memory": mem_bytes / hw.hbm_bw,
        "collective": sum(by_dim.values()),
    }
    return RooflineResult(
        compute_s=terms["compute"], memory_s=terms["memory"], collective_s=terms["collective"],
        bottleneck=max(terms, key=terms.get), flops=flops, mem_bytes=mem_bytes,
        coll_bytes=analysis["collective_bytes"], collective_s_by_dim=by_dim,
    )
