"""Multi-pod dry-run on torch's fake process group (counterpart of
``repro.launch.dryrun``): shows that the distribution config is coherent.

For every (architecture x input shape) cell and both production meshes
(16x16 single pod, 2x16x16 multi-pod), this process joins the fake
backend (``world_size=512``: no peer exists, collectives return at once),
builds a ``"cpu"`` DeviceMesh, and runs the cell's step ONCE under
``FakeTensorMode``: every tensor is a shape and a dtype, nothing is
allocated and nothing is computed.  What one rank (every rank does the
same) would run is recorded through a dispatch mode that sees the local
shards' ops under DTensor:

  * ``flops`` -- ``torch.utils.flop_counter``'s formulas over the local
    ops (the flash op by its own formula, ``kernels.flash.flash_flops``);
  * ``peak_bytes_per_device`` -- the most bytes of live local storage
    during the step (the state included), beside the H100's 80 GB, and
    ``peak_by_origin``, those bytes by the op that made them; and
    ``param_bytes`` / ``grad_bytes`` / ``opt_bytes`` per device;
  * ``bytes_accessed`` -- each local op's operand and result bytes (views,
    allocations and metadata queries move nothing and are not counted),
    the counterpart of XLA's ``bytes accessed``;
  * ``collective_bytes`` by kind (the result bytes of each collective,
    functional or c10d's in-place ones, the reference's HLO measure) and
    ``collective_total``;
  * ``interpod_bytes`` -- the bytes of collectives whose group spans pods,
    and ``interhost_bytes`` those whose group spans hosts of
    ``CARDS_PER_HOST`` cards (NVLink within a host, the network beyond:
    ``benchmarks.roofline``'s link terms).

The flash op's fake kernel gives its output's shape alone, so no S x S
scores are counted as the kernel's memory.

The reference lowers a scan over superblocks, whose body XLA's cost
analysis counts once, and extrapolates affinely over the depth
(``dryrun.py:177-226``).  Eager counting here sees every layer, so there
is nothing to extrapolate: the full-depth numbers stand under the
reference's plain keys.  The numbers come from the fake backend, not
from a device.

Artifacts land in ``experiments/dryrun_torch/<arch>_<shape>_<mesh>.json``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
      --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      [--mesh pod|multipod|both]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import ALIASES, ARCHS, get_config
from .mesh import axis_names, make_production_mesh
from .shapes import SHAPES, ShapeCase, cell_applicable

__all__ = ["ARTIFACT_DIR", "H100_HBM_BYTES", "CARDS_PER_HOST", "run_cell",
           "measure_cell", "join_fake_group"]

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "experiments", "dryrun_torch")
H100_HBM_BYTES = 80e9
# Cards an NVLink domain joins (an HGX / DGX H100 host).
CARDS_PER_HOST = 8
_WORLD = 512
_COLLECTIVES = {"all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_reduce": "all-reduce",
                "all_to_all_single": "all-to-all",
                "broadcast": "broadcast",
                # c10d's in-place ops (``dist.all_gather`` and the like)
                "allgather_": "all-gather",
                "_allgather_base_": "all-gather",
                "allreduce_": "all-reduce",
                "reduce_scatter_": "reduce-scatter",
                "_reduce_scatter_base_": "reduce-scatter",
                "alltoall_": "all-to-all",
                "alltoall_base_": "all-to-all",
                "broadcast_": "broadcast"}


def join_fake_group(world: int = _WORLD) -> None:
    """Join torch's fake backend as rank 0 of ``world`` (no peers: the
    collectives return at once), unless a group is joined already."""
    if dist.is_initialized():
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=0, world_size=world,
                            store=FakeStore())


class _Meter:
    """A dispatch mode over the local ops (DTensor ops are let through to
    DTensor first, as ``CommDebugMode`` does): FLOPs, bytes accessed, live
    storage bytes and its peak, collective bytes by kind, across pods
    (groups of ``chips_per_pod`` ranks) and across hosts
    (``CARDS_PER_HOST``).

    ``answer``, if given, answers the host's reads of a tensor's value
    (``int()``, ``bool()``, ``.item()``: ``aten._local_scalar_dense``),
    which fake tensors cannot: it takes the tensor and returns the value.
    ``flop_formulas`` adds formulas by op packet to torch's registry."""

    def __init__(self, chips_per_pod: int, *, answer=None,
                 flop_formulas=None):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        from torch.distributed.tensor import DTensor
        meter = self
        registry = {**flop_registry, **(flop_formulas or {})}
        read = torch.ops.aten._local_scalar_dense.default

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                kwargs = kwargs or {}
                if func is read and answer is not None:
                    return answer(args[0])
                out = func(*args, **kwargs)
                meter._op(func, args, kwargs, out, registry)
                return out

        self.mode = Mode()
        self.chips_per_pod = chips_per_pod
        self.flops = 0
        self.bytes = 0
        self.live: dict = {}
        self.cur = self.peak = 0
        self._at_peak: list = []
        self.coll: dict = {}
        self.interpod = self.interhost = 0
        self._spanning: dict = {}
        self._moves: dict = {}
        self.paused = self.excluded = 0

    def __enter__(self):
        # DTensor's sharding propagation runs each new op once on fake
        # tensors of the GLOBAL shapes to learn the output's metadata;
        # those runs are not the rank's work and are not counted.
        # ``excluded`` counts them: a step of DTensor ops with none means
        # propagation took another path than this patch, and
        # ``measure_cell`` raises rather than count those runs as the
        # rank's.
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        orig = ShardingPropagator._propagate_tensor_meta_non_cached
        meter = self

        def paused(prop, op_schema):
            meter.excluded += meter.paused == 0
            meter.paused += 1
            try:
                return orig(prop, op_schema)
            finally:
                meter.paused -= 1

        self._restore = (ShardingPropagator, orig)
        ShardingPropagator._propagate_tensor_meta_non_cached = paused
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        cls, orig = self._restore
        cls._propagate_tensor_meta_non_cached = orig
        return self.mode.__exit__(*exc)

    def track(self, t: torch.Tensor, origin: str = "state") -> None:
        """Count ``t``'s storage as live until it is freed; ``origin`` is
        the op that made it.  A ``meta`` tensor holds no memory."""
        if t.device.type == "meta":
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        nb = st.nbytes()
        self.live[key] = (st._weak_ref(), nb, origin)
        self.cur += nb
        if self.cur > self.peak:
            self._sweep()
            if self.cur > self.peak:
                self.peak = self.cur
                self._at_peak = [(o, n) for _, n, o in self.live.values()]

    def _sweep(self) -> None:
        for key, (ref, nb, _) in list(self.live.items()):
            if torch.UntypedStorage._expired(ref):
                torch.UntypedStorage._free_weak_ref(ref)
                del self.live[key]
                self.cur -= nb

    def reset_peak(self) -> None:
        self._sweep()
        self.peak = self.cur
        self._at_peak = [(o, n) for _, n, o in self.live.values()]

    def peak_by_origin(self, top: int = 12) -> dict:
        """The live bytes at the peak by the op that made them (the
        state as ``"state"``), the ``top`` largest."""
        by: dict = {}
        for origin, nb in self._at_peak:
            by[origin] = by.get(origin, 0) + nb
        return dict(sorted(by.items(), key=lambda kv: -kv[1])[:top])

    def _spans(self, group, size: int) -> bool:
        """Whether ``group`` (a functional collective's group name, or the
        process group a c10d op was given) spans blocks of ``size``
        consecutive ranks (pods, hosts)."""
        if isinstance(group, torch.ScriptObject):
            group = dist.ProcessGroup.unbox(group)
        if isinstance(group, dist.ProcessGroup):
            group = group.group_name
        key = (group, size)
        if key not in self._spanning:
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            ranks = dist.get_process_group_ranks(
                _resolve_process_group(group))
            self._spanning[key] = len({r // size for r in ranks}) > 1
        return self._spanning[key]

    def _op(self, func, args, kwargs, out, registry) -> None:
        from torch.utils._pytree import tree_leaves
        if self.paused:
            return
        packet = func._overloadpacket
        formula = registry.get(packet)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        name = getattr(packet, "__name__", str(packet))
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        moves = self._moves.get(func)
        if moves is None:
            moves = self._moves[func] = _moves_data(func, name)
        if moves:
            self.bytes += _nbytes(args) + _nbytes(kwargs.values()) + \
                _nbytes(outs)
        kind = _COLLECTIVES.get(name)
        if kind is not None and "c10d" in str(packet):
            nb = sum(t.numel() * t.element_size() for t in outs)
            self.coll[kind] = self.coll.get(kind, 0) + nb
            names = [a.name for a in func._schema.arguments]
            key = "group_name" if "group_name" in names else "process_group"
            group = (args[names.index(key)] if key in names[:len(args)]
                     else kwargs.get(key))
            if group is not None:
                self.interpod += nb * self._spans(group, self.chips_per_pod)
                self.interhost += nb * self._spans(group, CARDS_PER_HOST)
        for t in outs:
            self.track(t, name)


def _moves_data(func, name: str) -> bool:
    """Whether ``func`` reads or writes elements: not a view, not an
    allocation (``empty`` and the like: nothing written), not a ``prim``
    query of a tensor's metadata (``prim.device``)."""
    return not (func.is_view or func.namespace == "prim"
                or name.startswith(("empty", "new_empty")))


def _nbytes(items) -> int:
    """Bytes of the tensors among ``items`` and in their lists."""
    total = 0
    for t in items:
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, (list, tuple)):
            total += _nbytes(t)
    return total


def _local_bytes(tensors) -> int:
    from torch.distributed.tensor import DTensor
    total = 0
    for t in tensors:
        loc = t.to_local() if isinstance(t, DTensor) else t
        total += loc.numel() * loc.element_size()
    return total


def measure_cell(cfg, case: ShapeCase, mesh, *, compress: bool = False,
                 mode: str = "tp") -> dict:
    """Run one cell's step once on ``mesh`` under ``FakeTensorMode`` and
    return what ``_Meter`` saw, per device."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..models import init_caches, init_params
    from ..optim import CompressorConfig
    from .sharding import distribute_params, lay_out_caches
    from .steps import (TrainConfig, init_train_state, lay_out,
                        make_train_step, sharded_decode_step,
                        sharded_prefill)
    B, S = case.global_batch, case.seq_len
    tok = torch.int32
    sizes = dict(zip(axis_names(mesh), mesh.shape))
    per_pod = math.prod(mesh.shape) // sizes.get("pod", 1)
    with FakeTensorMode(allow_non_fake_inputs=True), \
            _Meter(per_pod) as meter:
        batch = {"tokens": torch.zeros((B, S), dtype=tok)}
        if cfg.encdec:
            batch["frames"] = torch.zeros(
                (B, cfg.n_frontend_tokens, cfg.d_model), dtype=torch.bfloat16)
        if case.kind == "train":
            base, _, suffix = mode.partition("+")
            tcfg = TrainConfig(
                compress=CompressorConfig() if compress else None,
                sharding_mode=base, cast_params=(suffix == "cast"))
            state = init_train_state(0, cfg, tcfg, device="cpu", mesh=mesh)
            params = list(state.params.parameters())
            opt = (list(state.opt.mu.values()) + list(state.opt.nu.values())
                   + [e for e in state.ef.values() if e.dim()])
            batch["labels"] = torch.zeros((B, S), dtype=tok)
            step = make_train_step(cfg, tcfg, mesh=mesh)
            for t in params + opt:
                meter.track(t.to_local() if hasattr(t, "to_local") else t)
            meter.reset_peak()
            step(state, batch)
            grad_bytes = _local_bytes(params)
        else:
            if case.kind == "prefill":
                fn, pshard, _, _ = sharded_prefill(cfg, mesh, B, S)
            else:
                fn, pshard, c_shard = sharded_decode_step(cfg, mesh, B, S)
            model = distribute_params(init_params(0, cfg, device="cpu"),
                                      mesh, cfg, shardings=pshard)
            params = list(model.parameters())
            opt = []
            grad_bytes = 0
            if case.kind == "prefill":
                fn_args = (model, batch)
            else:
                # (made as the decode step will use them: inference tensors)
                with torch.inference_mode():
                    caches = lay_out_caches(
                        init_caches(cfg, B, S, device="cpu"), c_shard,
                        lay_out)
                fn_args = (model, torch.zeros((B, 1), dtype=tok),
                           torch.full((B,), S - 1, dtype=torch.int64),
                           caches)
            for t in params:
                meter.track(t.to_local())
            meter.reset_peak()
            fn(*fn_args)
        meter._sweep()
    if meter.excluded == 0:
        raise RuntimeError("the meter left out no sharding propagation: "
                           "DTensor's propagator was not patched, so its "
                           "global-shape runs would count as the rank's")
    coll = dict(sorted(meter.coll.items()))
    return {
        "flops": float(meter.flops),
        "bytes_accessed": float(meter.bytes),
        "peak_bytes_per_device": int(meter.peak),
        "param_bytes_per_device": _local_bytes(params),
        "grad_bytes_per_device": int(grad_bytes),
        "opt_bytes_per_device": _local_bytes(opt),
        "collective_bytes": coll,
        "collective_total": float(sum(coll.values())),
        "interpod_bytes": float(meter.interpod),
        "interhost_bytes": float(meter.interhost),
        "propagations_excluded": meter.excluded,
        "peak_by_origin": meter.peak_by_origin(),
        "hbm_bytes_per_device": H100_HBM_BYTES,
        "fits_h100": bool(meter.peak <= H100_HBM_BYTES),
    }


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             compress: bool = False, save: bool = True, mode: str = "tp",
             cfg=None, case: ShapeCase = None, mesh=None) -> dict:
    """One cell's record (``status`` ok / skipped / error), saved as JSON
    under ``ARTIFACT_DIR``.  ``cfg``, ``case`` and ``mesh`` override the
    arch's config, the shape's case and the production mesh (tests run
    SMOKE configs on small meshes)."""
    arch = ALIASES.get(arch, arch)        # normalize artifact naming
    cfg = cfg or get_config(arch)
    case = case or SHAPES[shape_name]
    ok, reason = cell_applicable(cfg, shape_name)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "compress": compress, "mode": mode, "backend": "fake"}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    t0 = time.time()
    try:
        join_fake_group()
        if mesh is None:
            mesh = make_production_mesh(multi_pod=(mesh_kind == "multipod"),
                                        device_type="cpu")
        rec["mesh_shape"] = list(mesh.shape)
        rec["mesh_axes"] = list(axis_names(mesh))
        rec.update(status="ok", **measure_cell(cfg, case, mesh,
                                               compress=compress, mode=mode))
        rec["seconds"] = round(time.time() - t0, 1)
    except Exception as e:
        rec.update(status="error", seconds=round(time.time() - t0, 1),
                   error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    if save:
        os.makedirs(ARTIFACT_DIR, exist_ok=True)
        suffix = ("_rcomp" if compress else "") + \
            (f"_{mode}" if mode != "tp" else "")
        fn = os.path.join(ARTIFACT_DIR,
                          f"{arch}_{shape_name}_{mesh_kind}{suffix}.json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def format_record(rec: dict) -> str:
    line = (f"{rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:9s} "
            f"{rec['status']:8s}")
    if rec["status"] == "ok":
        coll = ", ".join(f"{k} {v / 1e9:.3f} GB"
                         for k, v in rec["collective_bytes"].items())
        line += (f" {rec['seconds']:7.1f}s  flops={rec['flops']:.3e}  "
                 f"peak {rec['peak_bytes_per_device'] / 1e9:.2f} GB of "
                 f"{H100_HBM_BYTES / 1e9:.0f} GB (H100)  "
                 f"coll={rec['collective_total'] / 1e9:.2f} GB [{coll}]")
    elif rec["status"] == "error":
        line += f"  {rec['error'][:110]}"
    else:
        line += f"  ({rec['reason'][:70]})"
    return line


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--compress", action="store_true",
                    help="run the RandLR-compressed train step")
    ap.add_argument("--mode", default="tp", choices=["tp", "fsdp", "tp+cast"])
    ap.add_argument("--cell", action="append", default=[],
                    metavar="ARCH:SHAPE:MESH",
                    help="run these cells instead of the grid (repeatable)")
    ap.add_argument("--jsonl", action="store_true",
                    help="print each record as one JSON line after its "
                         "summary line")
    args = ap.parse_args(argv)

    archs = ARCHS if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    cells = ([tuple(c.split(":")) for c in args.cell] if args.cell else
             [(a, s, m) for a in archs for s in shapes for m in meshes])

    n_bad = 0
    for arch, shape, mk in cells:
        rec = run_cell(arch, shape, mk, compress=args.compress,
                       mode=args.mode)
        n_bad += rec["status"] == "error"
        print(format_record(rec), flush=True)
        if args.jsonl:
            print(json.dumps(rec), flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 1 if n_bad else 0


if __name__ == "__main__":
    sys.exit(main())
