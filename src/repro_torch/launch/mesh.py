"""Production mesh definition (port of ``repro/launch/mesh.py``).

A function, not a module-level constant, so importing this module touches
no process group. The shapes are the JAX package's: ``(16, 16)`` as
("data", "model") -- 16-way Megatron TP within a pod row, 16-way DP across
-- and a leading "pod" axis for cross-pod data parallelism, ``(2, 16,
16)``. The meshes are ``torch.distributed`` ``DeviceMesh``es over the
initialised process group, one rank per device.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

__all__ = ["make_production_mesh", "make_mesh", "batch_axes_for", "MODEL_AXIS_SIZE"]

MODEL_AXIS_SIZE = 16


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...],
              device_type: str = "cuda") -> DeviceMesh:
    """A named ``DeviceMesh`` of ``shape`` over the initialised process
    group, whose world size must be the shape's product. ``device_type`` is
    ``"cuda"`` unless the caller names ``"cpu"`` (gloo)."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks; the process "
                         f"group has {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def batch_axes_for(multi_pod: bool):
    """Mesh axes carrying the global batch (DP spans pods x data rows)."""
    return ("pod", "data") if multi_pod else ("data",)
