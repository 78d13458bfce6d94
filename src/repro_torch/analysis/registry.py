"""Entry-point registry: engines declare WHAT the analyzer runs
(counterpart of ``repro.analysis.registry``).

Each engine module registers its public entry points at import time
(bottom-of-module hook) as an :class:`EntryPoint`: a ``build(device)``
thunk returning ``(fn, args)``, a call the dataflow pass makes EAGERLY
once under its recorders (:mod:`repro_torch.analysis.dataflow`), at
production-representative shapes on ``device``, plus the entry's declared
invariants: an :class:`OverlapSpec` for the double-buffered-collectives
contract, ``max_collective_elems`` for the no-replicated-blowup contract
and ``max_host_syncs`` for the host-transfer budget.  This module imports
no engine, so engines can depend on it without cycles; the analyzer
imports the engines, never the reverse.

Distributed entries run on the process group ``torch.distributed``'s
default group (``dist.group.WORLD``), which the caller has initialized:
the CLI joins a one-rank group (gloo on the CPU, NCCL on a card).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

__all__ = ["OverlapSpec", "EntryPoint", "register", "entry_points", "get",
           "load_entry_points", "ENGINE_MODULES"]


@dataclass(frozen=True)
class OverlapSpec:
    """Declares an entry's double-buffered-collectives invariant.

    ``norm_shape`` identifies the pivot-norm all-reduces: every
    ``all_reduce`` of a tensor of this shape.  ``deflate`` picks the
    matcher of the trailing-update events: ``'panel_apply'`` (a call of
    the stage-B kernel wrapper ``panel_apply`` from ``core.qr_dist``) or
    ``'sub'`` (a tensor subtraction whose result has ``deflate_shape``,
    ``-1`` a wildcard dim: the gram oracle's deflation).  With
    ``expect_overlap=True`` the rule requires panel ``p+1``'s norm
    all-reduce to be issued (``async_op=True``) before panel ``p``'s
    deflation and waited on after it; a deflation that emits the exact
    norms (``panel_apply(..., emit_norms=True)``, a recompute panel) is
    exempt.  ``False`` flips it into a positive control: the rule must
    DETECT the serialization, proving the recorder sees what it claims.
    """
    norm_shape: tuple
    deflate: str                    # 'panel_apply' | 'sub'
    deflate_shape: tuple = ()       # required when deflate == 'sub'
    expect_overlap: bool = True
    min_panels: int = 2             # fewer matched deflations => control-failed


@dataclass(frozen=True)
class EntryPoint:
    """One entry: ``build(device) -> (fn, args)`` plus declared contracts.

    ``max_collective_elems``: collectives producing an output with MORE
    elements than this are replicated-blowup findings; ``None`` skips the
    rule.  ``max_host_syncs``: the host synchronizations (scalar reads;
    device-to-host copies on a card) the call may make by design, e.g.
    one a panel for the blocked engine's orthonormality check.  ``tags``
    are free-form markers (``'control'``, ``'distributed'``) surfaced in
    the report; a ``'distributed'`` entry needs the default process group.
    """
    name: str
    build: Callable
    overlap: Optional[OverlapSpec] = None
    max_collective_elems: Optional[int] = None
    max_host_syncs: int = 0
    tags: tuple = ()


_REGISTRY: dict = {}

# Imported (in order) by load_entry_points to trigger the registration
# hooks; keep in sync with the engine modules that call register().
ENGINE_MODULES = (
    "repro_torch.core.rid",
    "repro_torch.core.qr",
    "repro_torch.core.qr_dist",
    "repro_torch.core.distributed",
    "repro_torch.stream.rid_stream",
)


def register(name: str, build: Optional[Callable] = None, *,
             overlap: Optional[OverlapSpec] = None,
             max_collective_elems: Optional[int] = None,
             max_host_syncs: int = 0, tags: tuple = ()):
    """Register an entry point; usable directly or as a decorator on the
    build thunk.  Re-registering a name is an error (it would silently
    shadow a contract)."""
    def _do(b):
        if name in _REGISTRY:
            raise ValueError(f"duplicate analysis entry point {name!r}")
        _REGISTRY[name] = EntryPoint(
            name=name, build=b, overlap=overlap,
            max_collective_elems=max_collective_elems,
            max_host_syncs=max_host_syncs, tags=tuple(tags))
        return b
    return _do if build is None else _do(build)


def entry_points() -> tuple:
    return tuple(_REGISTRY[k] for k in sorted(_REGISTRY))


def get(name: str) -> EntryPoint:
    return _REGISTRY[name]


def load_entry_points() -> tuple:
    """Import every engine module (running their registration hooks) and
    return the full registry."""
    import importlib
    for mod in ENGINE_MODULES:
        importlib.import_module(mod)
    return entry_points()
