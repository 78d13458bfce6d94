"""Guarded sharding hints for model internals (counterpart of
``repro.models.pshard``).

``hint(x, axis_or_None, ...)`` lays ``x`` out on the active mesh (the one
``use_mesh`` set, the counterpart of the reference's ``with mesh:``) and
does nothing without one, so a single-device run is untouched.  Axes the
mesh lacks, or that do not divide the dim, are dropped, and an axis is
used once (the earlier slot wins): one call site serves every mesh shape.

A layout is a SPEC: one entry per tensor dim, each a mesh-axis name, a
tuple of names, or None, as the reference's ``PartitionSpec``.
``placements`` turns it into DTensor placements, one per mesh dim: a dim
split over ``("pod", "data")`` is ``Shard(d)`` on both of those mesh dims,
and DTensor splits a dim sharded over several mesh dims major to minor in
mesh order, JAX's order for a tuple in mesh order (a tuple out of mesh
order raises).

Under a mesh, ``hint`` redistributes a DTensor, and distributes a plain
tensor (a carry made with ``torch.zeros``, the same on every rank) by
taking this rank's block of it, through ``DTensor.from_local`` so that a
gradient flows back.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Union

import torch

from ..kernels.common import is_dtensor

__all__ = ["Axis", "dp_axes", "use_mesh", "current_mesh", "hint",
           "axis_names", "axis_sizes",
           "placements", "resolve_spec", "is_dtensor",
           "distribute", "split_evenly", "contiguous_grad", "pad_dim",
           "wrap", "as_dtensor",
           "compute_params"]

Axis = Union[str, tuple, None]

# The axes a BATCH dim shards over.  Default: pod+data.  The RandLR
# gradient-compression path takes its gradients per pod, so inside it
# batch dims shard over "data" only: it narrows this contextvar
# (launch/steps.py).
_DP_AXES: contextvars.ContextVar[tuple] = contextvars.ContextVar(
    "dp_axes", default=("pod", "data"))
_MESH: contextvars.ContextVar = contextvars.ContextVar("mesh", default=None)


@contextlib.contextmanager
def dp_axes(axes: tuple):
    tok = _DP_AXES.set(tuple(axes))
    try:
        yield
    finally:
        _DP_AXES.reset(tok)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh for the block (``None`` clears it)."""
    tok = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


def current_mesh():
    return _MESH.get()


def axis_names(mesh) -> tuple[str, ...]:
    """A mesh's axis names, major to minor: a ``DeviceMesh``'s, or those
    of a stand-in with the reference mesh's ``axis_names``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` (the reference mesh's ``shape``)."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(axis_names(mesh), shape))


def _names_sizes(mesh):
    return axis_names(mesh), axis_sizes(mesh)


def resolve_spec(mesh, shape, axes) -> tuple:
    """The reference's ``hint`` rule on ``shape``: ``"dp"`` resolved,
    absent or non-dividing axes dropped, each axis used once."""
    names, sizes = _names_sizes(mesh)
    axes = tuple(_DP_AXES.get() if a == "dp" else a for a in axes)
    used: set = set()

    def ok(dim: int, ax):
        if ax is None:
            return None
        group = ax if isinstance(ax, tuple) else (ax,)
        # an axis may appear once per spec: earlier (batch) slots win,
        # e.g. fsdp mode routes `model` into the dp axes
        group = tuple(a for a in group if a in names and a not in used)
        if not group:
            return None
        size = 1
        for a in group:
            size *= sizes[a]
        if dim % size:
            return None
        used.update(group)
        return group if len(group) > 1 else group[0]

    return tuple(ok(d, a) for d, a in zip(shape, axes))


def placements(spec, mesh) -> tuple:
    """DTensor placements (one per mesh dim) of ``spec``."""
    from torch.distributed.tensor import Replicate, Shard
    names, _ = _names_sizes(mesh)
    out = [Replicate()] * len(names)
    for dim, ax in enumerate(spec):
        if ax is None:
            continue
        group = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes {group} of dim {dim} "
                             f"are not in the mesh's order {names}")
        for i in idx:
            if not out[i].is_replicate():
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} "
                                 f"used twice")
            out[i] = Shard(dim)
    return tuple(out)


def _local_block(x: torch.Tensor, mesh, pl) -> torch.Tensor:
    """This rank's block of ``x`` under placements ``pl`` (even splits)."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(pl):
        if p.is_shard():
            x = x.chunk(mesh.size(i), p.dim)[coord[i]]
    return x


def wrap(local: torch.Tensor, mesh, pl, shape) -> torch.Tensor:
    """Each rank's ``local`` as one DTensor of placements ``pl`` and the
    global ``shape`` (contiguous), differentiably and with no check."""
    from torch.distributed.tensor import DTensor
    shape = torch.Size(shape)
    stride, step = [], 1
    for n in reversed(shape):
        stride.insert(0, step)
        step *= max(n, 1)
    return DTensor.from_local(local, mesh, pl, run_check=False, shape=shape,
                              stride=tuple(stride))


def as_dtensor(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` itself if a DTensor, else a plain tensor (the same on every
    rank) as a replicated DTensor on ``mesh``."""
    if is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def distribute(x: torch.Tensor, mesh, pl) -> torch.Tensor:
    """A plain tensor, the same on every rank, as a DTensor of placements
    ``pl``, differentiably; a block that is a part of ``x`` is a copy, so
    the whole can be freed."""
    from torch.distributed.tensor import DTensor
    block = _local_block(x, mesh, pl)
    if block.numel() != x.numel():
        block = block.clone()
    return DTensor.from_local(block, mesh, pl, run_check=False)


def hint(x: torch.Tensor, *axes: Axis) -> torch.Tensor:
    """Lay ``x`` (ndim == len(axes)) out on the active mesh.

    The token ``"dp"`` resolves to the current data-parallel axes
    (("pod", "data") by default)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    spec = resolve_spec(mesh, x.shape, axes)
    if all(s is None for s in spec):
        return x
    pl = placements(spec, mesh)
    if is_dtensor(x):
        if tuple(x.placements) == pl:
            return x
        return x.redistribute(mesh, pl)
    return distribute(x, mesh, pl)


def split_evenly(x: torch.Tensor, dim: int, units: int) -> torch.Tensor:
    """``x`` with its dim ``dim`` split over the mesh only as far as it
    splits into whole ``units`` (heads before a reshape to heads): a
    DTensor whose mesh axes on that dim do not divide ``units`` has them
    replicated.  A plain tensor is returned as it is."""
    if not is_dtensor(x):
        return x
    dim %= x.dim()
    mesh = x.device_mesh
    n = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            n *= mesh.size(i)
    if units % n == 0:
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(mesh, [Replicate() if p.is_shard(dim) else p
                                 for p in x.placements])


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if not is_dtensor(g):
            return g.contiguous()
        # DTensor.contiguous() reads the global strides alone
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(g.to_local().contiguous(), g.device_mesh,
                                  g.placements, run_check=False,
                                  shape=g.shape, stride=g.stride())


def contiguous_grad(x: torch.Tensor) -> torch.Tensor:
    """``x``, with its gradient made contiguous on the way back.  DTensor
    judges a view by the global strides, and a gradient that a permute
    left non-contiguous in its local shard then fails the view that
    follows; this sits between the two.  A plain tensor passes as it
    is."""
    return _ContiguousGrad.apply(x) if is_dtensor(x) else x


@contextlib.contextmanager
def compute_params(module, skip: tuple = ()):
    """Within the block, ``module``'s DTensor parameters (but those under a
    name in ``skip``) are gathered over the mesh axes the batch is split
    on (the current dp axes), as FSDP does: a weight keeps its tensor
    parallel split over `model` in mode ``"tp"`` and is whole in
    ``"fsdp"``, whose dp axes include `model`.  The gathers are
    differentiable (their gradient is the reduce-scatter) and, inside a
    recomputed block, are made again in the backward.  Without a mesh, or
    with nothing to gather, the block runs on the module as it is."""
    if current_mesh() is None:
        yield
        return
    from torch.distributed.tensor import Replicate
    dp = set(_DP_AXES.get())
    swap = {}
    for name, p in module.named_parameters():
        if not is_dtensor(p) or name.split(".", 1)[0] in skip:
            continue
        mesh = p.device_mesh
        names = axis_names(mesh)
        pl = tuple(Replicate() if q.is_shard() and names[i] in dp
                   and mesh.size(i) > 1 else q
                   for i, q in enumerate(p.placements))
        if pl != tuple(p.placements):
            swap[name] = p.redistribute(mesh, pl)
    if not swap:
        yield
        return
    from torch.nn.utils.stateless import _reparametrize_module
    with _reparametrize_module(module, swap):
        yield


def pad_dim(t: torch.Tensor, dim: int, amount: int) -> torch.Tensor:
    """``t`` with ``amount`` zeros appended along ``dim``; a DTensor on its
    local shards, that dim made whole first (DTensor's own pad fails on a
    laid-out tensor)."""
    dim %= t.dim()
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, amount]
    if not is_dtensor(t):
        return torch.nn.functional.pad(t, pad)
    t = split_evenly(t, dim, 1)
    shape = list(t.shape)
    shape[dim] += amount
    return wrap(torch.nn.functional.pad(t.to_local(), pad), t.device_mesh,
                t.placements, shape)
