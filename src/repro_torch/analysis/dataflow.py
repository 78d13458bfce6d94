"""Dataflow rules over one eager call of each registered entry point
(counterpart of ``repro.analysis.jaxpr``).

The reference traces every entry to a jaxpr and reasons over dependency
cones.  PyTorch runs eagerly, so here the entry runs ONCE for real under
recorders that log, in issue order, what the reference reads off the
trace:

  * a ``TorchDispatchMode`` logs every operator with the dtypes and
    devices of its inputs and outputs;
  * the collective recorder swaps ``torch.distributed``'s collectives
    (and the ``wait`` of the work handles they return) and the stage-B
    kernel wrapper ``panel_apply`` that ``core.qr_dist`` calls, as the
    reference swaps ``pl.pallas_call`` to capture kernel launches.

Rules:

  ``dataflow.collective-overlap``    panel ``p+1``'s pivot-norm
                                     all-reduce is not in flight across
                                     panel ``p``'s deflation: issued after
                                     it, or waited on before it (the
                                     double-buffered-collectives
                                     invariant of ``core/qr_dist.py``).
  ``dataflow.replicated-collective`` a collective materializes more
                                     elements than the entry's budget
                                     (the l x n replication hazard).
  ``dataflow.dtype-promotion``       an operator produces f64/c128 in an
                                     entry called with <= 32-bit inputs,
                                     or ``_to_copy`` turns a complex
                                     tensor real (imaginary part dropped).
  ``dataflow.host-transfer``         more host synchronizations than the
                                     entry declares: scalar reads
                                     (``aten._local_scalar_dense``) and,
                                     on a card, device-to-host copies.
  ``dataflow.control-failed``        the entry could not be built or run,
                                     the structures an ``OverlapSpec``
                                     names were not found, or a positive
                                     control did not trip.

Eager order is exact where the reference's cones are conservative: the
issue, the deflation and the wait are logged in the order the host
program issues them, which is the order the rule is about.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from ..core.rng import check_device
from ..obs import trace as obs_trace
from .registry import EntryPoint, OverlapSpec
from .report import Finding

__all__ = ["Event", "Recording", "record", "run_entry", "analyze_entry",
           "check_collective_overlap", "check_replicated_collective",
           "check_dtype_promotion", "check_host_transfer"]

_WIDE = (torch.float64, torch.complex128)
_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                "reduce_scatter_tensor", "all_to_all_single", "broadcast")


@dataclass
class Event:
    """One logged event.  ``kind``: 'op' (an operator), 'collective' (its
    ``name``, output ``numel`` and ``shape``, ``async_op``), 'wait' (of
    collective ``ref``) or 'apply' (a ``panel_apply`` call; ``recompute``
    when it emits the exact norms)."""
    kind: str
    name: str
    shape: tuple = ()
    numel: int = 0
    dtypes: tuple = ()
    in_dtypes: tuple = ()
    async_op: bool = False
    ref: int = -1
    recompute: bool = False
    d2h: bool = False


@dataclass
class Recording:
    events: list = field(default_factory=list)

    def add(self, ev: Event) -> int:
        self.events.append(ev)
        return len(self.events) - 1


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


class _OpLog(TorchDispatchMode):
    def __init__(self, rec: Recording):
        super().__init__()
        self.rec = rec

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        ins = list(_tensors(args))
        outs = list(_tensors(out))
        d2h = False
        if name == "_to_copy" and ins and outs:
            d2h = ins[0].device.type == "cuda" and outs[0].device.type == "cpu"
        elif name == "copy_" and len(ins) >= 2:
            d2h = ins[0].device.type == "cpu" and ins[1].device.type == "cuda"
        self.rec.add(Event(
            "op", name, shape=tuple(outs[0].shape) if outs else (),
            dtypes=tuple(t.dtype for t in outs),
            in_dtypes=tuple(t.dtype for t in ins), d2h=d2h))
        return out


class _Work:
    """A collective's work handle whose ``wait`` is logged."""

    def __init__(self, work, rec: Recording, ref: int):
        self._work, self._rec, self._ref = work, rec, ref

    def wait(self, *args, **kwargs):
        self._rec.add(Event("wait", "wait", ref=self._ref))
        return self._work.wait(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._work, name)


def _collective(real, name: str, rec: Recording):
    def call(*args, **kwargs):
        outs = list(_tensors(args[0])) if args else []
        numel = sum(t.numel() for t in outs)
        shape = tuple(outs[0].shape) if len(outs) == 1 else \
            (len(outs),) + tuple(outs[0].shape) if outs else ()
        async_op = bool(kwargs.get("async_op", False))
        ref = rec.add(Event("collective", name, shape=shape, numel=numel,
                            async_op=async_op))
        work = real(*args, **kwargs)
        return _Work(work, rec, ref) if async_op and work is not None \
            else work
    return call


@contextlib.contextmanager
def record():
    """Log operators, collectives (with their waits) and ``panel_apply``
    calls of ``core.qr_dist`` while the context is open."""
    from ..core import qr_dist
    rec = Recording()
    saved = {name: getattr(dist, name) for name in _COLLECTIVES
             if hasattr(dist, name)}
    real_apply = qr_dist.panel_apply

    def apply(*args, **kwargs):
        rec.add(Event("apply", "panel_apply",
                      recompute=bool(kwargs.get("emit_norms", False))))
        return real_apply(*args, **kwargs)

    try:
        for name, real in saved.items():
            setattr(dist, name, _collective(real, name, rec))
        qr_dist.panel_apply = apply
        with _OpLog(rec):
            yield rec
    finally:
        for name, real in saved.items():
            setattr(dist, name, real)
        qr_dist.panel_apply = real_apply


@dataclass(frozen=True)
class RunEntry:
    """An entry point and the recording of its one call."""
    entry: EntryPoint
    recording: Recording
    inputs_32: bool

    @property
    def name(self):
        return self.entry.name


def run_entry(entry: EntryPoint, device="cuda") -> RunEntry:
    """Build ``entry`` on ``device`` (the card unless it names the CPU) and
    call it once under the recorders, with an obs tracer installed: the
    engines' spans are live, so the host-sync budget holds with them."""
    device = check_device(device)
    fn, args = entry.build(device)
    floats = [t for t in _tensors(args)
              if t.dtype.is_floating_point or t.dtype.is_complex]
    inputs_32 = all(t.element_size() <= 4 for t in floats)
    with record() as rec, obs_trace.tracing():
        fn(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return RunEntry(entry=entry, recording=rec, inputs_32=inputs_32)


# ------------------------------------------------------------------- rules

def _deflations(events, spec: OverlapSpec) -> list:
    """(position, event) of the trailing-update events ``spec`` names."""
    if spec.deflate == "panel_apply":
        return [(i, e) for i, e in enumerate(events) if e.kind == "apply"]
    if spec.deflate == "sub":
        want = tuple(spec.deflate_shape)
        return [(i, e) for i, e in enumerate(events)
                if e.kind == "op" and e.name == "sub"
                and len(e.shape) == len(want)
                and all(w == -1 or s == w for s, w in zip(e.shape, want))]
    raise ValueError(f"unknown deflate matcher {spec.deflate!r}; expected "
                     f"'panel_apply' or 'sub'")


def check_collective_overlap(run: RunEntry) -> list:
    """The double-buffered-collectives rule (module docstring)."""
    spec = run.entry.overlap
    if spec is None:
        return []
    events = run.recording.events
    waits = {e.ref: i for i, e in enumerate(events) if e.kind == "wait"}
    norms = [(i, waits.get(i, math.inf) if e.async_op else i)
             for i, e in enumerate(events)
             if e.kind == "collective" and e.name == "all_reduce"
             and e.shape == tuple(spec.norm_shape)]
    defls = _deflations(events, spec)
    if len(defls) < spec.min_panels or len(norms) < spec.min_panels + 1:
        return [Finding(
            "dataflow.control-failed", run.name, "structures-not-found",
            f"matched {len(norms)} norm all_reduces (shape "
            f"{spec.norm_shape}) and {len(defls)} deflations (matcher "
            f"{spec.deflate!r}); need >= {spec.min_panels + 1} and >= "
            f"{spec.min_panels} — the overlap check would be vacuous")]
    findings = []
    if spec.expect_overlap:
        # norms[0] is the prologue; norms[p+1] selects panel p+1's pivots
        # and must be in flight across panel p's deflation.
        for p in range(min(len(defls), len(norms) - 1)):
            pos, ev = defls[p]
            if ev.recompute:
                continue
            issued, waited = norms[p + 1]
            if not issued < pos < waited:
                findings.append(Finding(
                    "dataflow.collective-overlap", run.name, f"panel-{p}",
                    f"the norm all_reduce selecting panel {p + 1}'s pivots "
                    f"(issued at event {issued}, waited at {waited}) is not "
                    f"in flight across panel {p}'s deflation (event {pos}): "
                    f"the all-reduce serializes behind the trailing "
                    f"update"))
        # Positive control: panel 1's reduce (norms[2]) cannot be issued
        # before panel 0's deflation, else the log is not program order.
        if len(norms) > 2 and norms[2][0] < defls[0][0]:
            findings.append(Finding(
                "dataflow.control-failed", run.name, "order-positive-control",
                "panel 1's norm all_reduce was logged before panel 0's "
                "deflation — the recorder is not following the program"))
    elif norms[1][0] > defls[0][0] or norms[1][1] < defls[0][0]:
        pass      # serialization detected, as declared
    else:
        findings.append(Finding(
            "dataflow.control-failed", run.name, "serialization-not-detected",
            "entry is declared serialized (expect_overlap=False) but its "
            "first norm all_reduce is in flight across the first deflation "
            "— the recorder failed its positive control"))
    return findings


def check_replicated_collective(run: RunEntry) -> list:
    """Collectives materializing more elements than the entry's budget."""
    budget = run.entry.max_collective_elems
    if budget is None:
        return []
    findings, hits = [], set()
    for e in run.recording.events:
        if e.kind != "collective" or e.numel <= budget:
            continue
        key = f"{e.name}-{'x'.join(map(str, e.shape))}"
        if key in hits:
            continue
        hits.add(key)
        findings.append(Finding(
            "dataflow.replicated-collective", run.name, key,
            f"{e.name} materializes shape {e.shape} ({e.numel} elems) per "
            f"rank, over the entry's declared budget of {budget} elems"))
    return findings


def _dname(dtype) -> str:
    return str(dtype).replace("torch.", "")


def check_dtype_promotion(run: RunEntry) -> list:
    """f64/c128 produced in an entry called with <= 32-bit inputs; complex
    tensors turned real by ``_to_copy``."""
    findings, hits = [], set()
    for e in run.recording.events:
        if e.kind != "op":
            continue
        if run.inputs_32:
            for dt in e.dtypes:
                key = f"wide-{e.name}-{_dname(dt)}"
                if dt in _WIDE and key not in hits:
                    hits.add(key)
                    findings.append(Finding(
                        "dataflow.dtype-promotion", run.name, key,
                        f"{e.name} produces {_dname(dt)} (shape {e.shape}) "
                        f"in an entry called with <= 32-bit inputs — a "
                        f"silent upcast doubles the bytes and runs at the "
                        f"f64 rate"))
        if e.name == "_to_copy" and e.in_dtypes and e.dtypes \
                and e.in_dtypes[0].is_complex and not e.dtypes[0].is_complex:
            key = (f"complex-truncation-{_dname(e.in_dtypes[0])}-to-"
                   f"{_dname(e.dtypes[0])}")
            if key not in hits:
                hits.add(key)
                findings.append(Finding(
                    "dataflow.dtype-promotion", run.name, key,
                    f"_to_copy drops the imaginary part "
                    f"({_dname(e.in_dtypes[0])} -> {_dname(e.dtypes[0])}); "
                    f"use .real explicitly if the truncation is intended"))
    return findings


def host_syncs(run: RunEntry) -> dict:
    """Host synchronizations of the call, by kind."""
    counts: dict = {}
    for e in run.recording.events:
        kind = ("_local_scalar_dense" if e.kind == "op"
                and e.name == "_local_scalar_dense" else
                "device-to-host" if e.d2h else None)
        if kind:
            counts[kind] = counts.get(kind, 0) + 1
    return counts


def check_host_transfer(run: RunEntry) -> list:
    counts = host_syncs(run)
    budget = run.entry.max_host_syncs
    total = sum(counts.values())
    if total <= budget:
        return []
    return [Finding(
        "dataflow.host-transfer", run.name, kind,
        f"{n} {kind} ({total} host synchronizations in all) against the "
        f"entry's declared {budget}: a host sync on the device hot path")
        for kind, n in sorted(counts.items())]


ENTRY_RULES = (check_collective_overlap, check_replicated_collective,
               check_dtype_promotion, check_host_transfer)


def analyze_entry(entry: EntryPoint, device="cuda") -> list:
    """Run one registered entry under the recorders and every rule, on the
    card unless ``device`` names the CPU (no card raises)."""
    device = check_device(device)
    if "distributed" in entry.tags and not dist.is_initialized():
        return [Finding("dataflow.control-failed", entry.name, "no-group",
                        "entry needs the default process group and none is "
                        "initialized (the CLI joins a one-rank group)")]
    try:
        run = run_entry(entry, device)
    except Exception as e:      # an entry that cannot even run gates CI
        return [Finding("dataflow.control-failed", entry.name, "run-error",
                        f"entry failed to run: {type(e).__name__}: {e}")]
    findings = []
    for rule in ENTRY_RULES:
        findings.extend(rule(run))
    return findings
