"""Production meshes (counterpart of ``repro.launch.mesh``).

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the default process group, with the reference's axis names:

  single pod   : 16 x 16 = 256 ranks,  axes ("data", "model")
  multi-pod    : 2 x 16 x 16 = 512,    axes ("pod", "data", "model")

All constructors are FUNCTIONS, and importing this module joins no group:
the caller joins one first (NCCL on cards; gloo, or torch's fake backend
for the dry-run, with ``device_type="cpu"``).  The device type is
``"cuda"`` unless the caller names ``"cpu"``; a ``"cuda"`` mesh without a
card raises, nothing falls back to the CPU.

``axis_sizes`` and ``axis_names`` read a DeviceMesh or any stand-in with
the reference mesh's ``shape`` (a dict) and ``axis_names``, so the spec
rules of ``launch.sharding`` run on a described mesh with no group at all.
"""
from __future__ import annotations

import math
from typing import Optional

import torch.distributed as dist

from ..core.rng import check_device
from ..models.pshard import axis_names, axis_sizes

__all__ = ["SINGLE_POD", "MULTI_POD", "make_production_mesh",
           "make_host_mesh", "make_elastic_mesh", "dp_axes",
           "model_axis_size", "axis_sizes", "axis_names"]

SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh spans the ranks of a process group: call "
                           "torch.distributed.init_process_group first")
    return dist.get_world_size()


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], device_type: str):
    """A DeviceMesh of ``shape`` over ranks ``0 .. prod(shape) - 1`` of the
    default group (every rank of the group must call it)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    check_device(device_type)
    n = math.prod(shape)
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    n = math.prod(shape)
    world = _world()
    if world < n:
        raise RuntimeError(
            f"mesh {shape} needs {n} devices, found {world} — the dry-run "
            f"joins torch's fake process group with world_size=512 before "
            f"it builds a mesh")
    return _mesh(shape, axes, device_type)


def make_host_mesh(model: Optional[int] = None, *, device_type="cuda"):
    """Largest (data, model) mesh on the ranks of the current group: used by
    tests and the laptop-scale examples.  ``model`` defaults to the largest
    power of two up to 4 that divides the world."""
    n = _world()
    if model is None:
        model = 1
        while model * 2 <= n and n % (model * 2) == 0 and model * 2 <= 4:
            model *= 2
    data = n // model
    return _mesh((data, model), ("data", "model"), device_type)


def make_elastic_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
                      device_type="cuda"):
    """Mesh for a re-planned (post-failure) topology over the first
    ``prod(shape)`` ranks (see ``runtime.plan_elastic_mesh``).  Ranks past
    them hold the mesh object but no coordinate in it."""
    if math.prod(shape) > _world():
        raise RuntimeError(f"mesh {shape} needs {math.prod(shape)} ranks, "
                           f"the group has {_world()}")
    return _mesh(tuple(shape), tuple(axes), device_type)


def dp_axes(mesh) -> tuple[str, ...]:
    """The data-parallel (batch) axes of a production mesh."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def model_axis_size(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)
