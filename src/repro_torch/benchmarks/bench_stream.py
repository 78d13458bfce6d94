"""The streamed ID's scaling: peak device memory against the input's
size and the overlap of the host -> device copies with the accumulation
on one device, and the sharded stream's weak scaling over ranks
(counterpart of the JAX harness's ``bench_stream``).

    python -m repro_torch.benchmarks.bench_stream [--full] [--sharded]
        [--device cuda|cpu] [--json PATH]

Host-resident f32 matrices of growing ``m`` (``n = 512``, ``k = 48``,
``chunk_rows = 512``; ``--full`` adds ``m = 131072``) go through
``rid_streamed`` from an ``ArraySource``; one row each:

  bench = "stream_scaling": m, n, k, chunk_rows, input_bytes,
  peak_device_bytes (``torch.cuda.max_memory_allocated`` over the call,
  reset before it), live_peak_bytes (``obs.metrics.MeteredSource``: the
  most ``live_device_bytes`` at a chunk read), acc_bytes (the l x n
  accumulator), h2d_bytes, wall_pipelined_s, wall_serialized_s (the
  ``rid_streamed`` root span's duration, ``overlap=True`` / ``False``),
  overlap_efficiency (serialized / pipelined);

then, at the largest ``m`` under deep tracing (every phase synchronized),
``bench = "stream_phases"`` rows: each phase's summed span seconds beside
``model_time_s``, its least time on an H100 SXM (NVIDIA's data sheet):
the copies over one direction of PCIe Gen5 x16 (64 GB/s), the
accumulation and the QR by the larger of f32 FFMA operations over 67
TFLOP/s and bytes over 3.35 TB/s; the gather runs on the host (None).

On a card the run asserts that the largest input exceeds the peak device
memory it was decomposed in, and that the peak stays flat across the
sweep (within 2x).  On the CPU (``--device cpu``) the device fields are
None and the times are the CPU's: a check of the harness, not a
measurement.  Rows go to stdout and, with ``--json PATH``, to that file.

``--sharded`` runs ``stream_sharded_sweep``: the file-backed sharded
stream (``rid_streamed(..., group=)``) at world sizes 1, 2, 4, 8 up to the
group's, ``n = 256 * world`` (each rank keeps 256 columns), ``m = 8192``
(16384 with ``--full``), ``k = 48``, ``chunk_rows = 512``, f32 from a
``FileSource`` over a ``.npy`` in a temporary directory; one row each:

  bench = "stream_sharded": ndev, m, n, k, chunk_rows, on_disk_bytes,
  wall_s (the root span, after a warm-up call), peak_device_bytes (the
  ranks' ``max_memory_allocated`` over the call, above what each held
  before it, summed), peak_per_device_bytes (the largest rank's),
  acc_shard_bytes (the l x n/world accumulator shard,
  the same in every row by construction).

On a card it asserts that every file exceeds the device memory it was
decomposed in and that the per-device peak stays flat (within 2x) as
ranks and columns grow together.  The CLI joins the group ``torchrun``
describes (``WORLD_SIZE``, one rank a card, ``LOCAL_RANK``'s), or else a
one-rank group.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..core.rng import check_device
from ..obs import MeteredSource, tracing
from ..stream import ArraySource, FileSource, rid_streamed
from .bench_error import one_rank_group
from .common import append_json_rows, cli_parser, emit

__all__ = ["SWEEP_MS", "FULL_MS", "stream_sweep", "stream_sharded_sweep",
           "main"]

N, K, CHUNK_ROWS = 512, 48, 512
SWEEP_MS = (8192, 16384, 32768)
FULL_MS = SWEEP_MS + (131072,)
# H100 SXM figures for model_time_s: PCIe Gen5 x16 one way, HBM3, f32 FFMA.
PCIE_BYTES_PER_S, HBM_BYTES_PER_S, PEAK_F32 = 64e9, 3.35e12, 67e12


def _root_dur(tracer, name: str = "rid_streamed") -> float:
    return next(s.dur for s in tracer.spans if s.name == name)


def _span_sum(tracer, name: str) -> float:
    return sum(s.dur or 0.0 for s in tracer.spans if s.name == name)


def _phase_rows(tr, *, m, n, k, l, chunk_rows) -> list[dict]:
    """Each phase's summed deep-traced span seconds beside its H100
    model time."""
    fbytes = 4                                   # the f32 sweep
    model = {
        "h2d": m * n * fbytes / PCIE_BYTES_PER_S,
        "accumulate": max(2.0 * m * n * l / PEAK_F32,
                          m * n * fbytes / HBM_BYTES_PER_S),
        "qr_interp": max(4.0 * l * n * k / PEAK_F32,
                         l * n * fbytes / HBM_BYTES_PER_S),
        "gather": None,                          # on the host
    }
    spans = {"h2d": "stream.h2d", "accumulate": "stream.accumulate",
             "qr_interp": "stream.qr_interp", "gather": "stream.gather"}
    return [{"bench": "stream_phases", "m": m, "n": n, "k": k,
             "chunk_rows": chunk_rows, "phase": ph,
             "wall_s": _span_sum(tr, spans[ph]), "model_time_s": model[ph]}
            for ph in model]


def stream_sweep(*, full: bool = False, device="cuda",
                 json_path=None) -> list[dict]:
    """The sweep's rows (module docstring)."""
    dev = check_device(device)
    cuda = dev.type == "cuda"
    ms = FULL_MS if full else SWEEP_MS
    l = 2 * K
    rows, phase_rows = [], []
    for m in ms:
        A = torch.from_numpy(np.asarray(
            np.random.default_rng(3).standard_normal((m, N)), np.float32))
        src = MeteredSource(ArraySource(A, CHUNK_ROWS))
        rid_streamed(1, src, K, device=dev)              # warm-up
        if cuda:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        with tracing() as tr:
            rid_streamed(1, src, K, device=dev)
        peak = torch.cuda.max_memory_allocated(dev) if cuda else None
        with tracing() as tr_ser:
            rid_streamed(1, src, K, device=dev, overlap=False)
        wall_pipe, wall_ser = _root_dur(tr), _root_dur(tr_ser)
        rows.append({
            "bench": "stream_scaling", "device": str(dev), "m": m, "n": N,
            "k": K, "chunk_rows": CHUNK_ROWS,
            "input_bytes": m * N * A.element_size(),
            "peak_device_bytes": peak,
            "live_peak_bytes": src.peak_bytes if cuda else None,
            "acc_bytes": l * N * 4,
            "h2d_bytes": tr.metrics.counter("stream.h2d_bytes").value,
            "wall_pipelined_s": wall_pipe, "wall_serialized_s": wall_ser,
            "overlap_efficiency": wall_ser / wall_pipe})
        if m == ms[-1]:
            with tracing(deep=True) as tr_deep:
                rid_streamed(1, src, K, device=dev)
            phase_rows = _phase_rows(tr_deep, m=m, n=N, k=K, l=l,
                                     chunk_rows=CHUNK_ROWS)
        del A, src
    emit(rows, header=f"streamed ID on {dev}: peak device memory against "
                      f"the input's size; copies overlapped")
    emit(phase_rows, header="streamed ID phases (deep tracing, largest m) "
                            "beside their H100 model time")
    if json_path:
        append_json_rows(json_path, rows + phase_rows)
    if cuda:
        last = rows[-1]
        assert last["input_bytes"] > last["peak_device_bytes"], \
            (last["input_bytes"], last["peak_device_bytes"])
        peaks = [r["peak_device_bytes"] for r in rows]
        assert max(peaks) < 2 * min(peaks), \
            f"peak device memory grows with m: {peaks}"
    return rows + phase_rows


# The sharded sweep: columns a rank, rows (--full: FULL_SHARDED_M).
N0, SHARDED_M, FULL_SHARDED_M = 256, 8192, 16384
SHARDED_WORLDS = (1, 2, 4, 8)


def stream_sharded_sweep(group, *, full: bool = False, device="cuda",
                         json_path=None) -> list[dict]:
    """Weak scaling of the file-backed sharded stream over ``group`` (the
    default group when it has more than one rank: the smaller worlds run
    on groups made from its first ranks); every rank calls it.  Returns
    the rows (module docstring) on rank 0, ``[]`` elsewhere."""
    dev = check_device(device)
    cuda = dev.type == "cuda"
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    granks = dist.get_process_group_ranks(group)
    m = FULL_SHARDED_M if full else SHARDED_M
    l = 2 * K
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        for ndev in (d for d in SHARDED_WORLDS if d <= world):
            sub = group if ndev == world else dist.new_group(granks[:ndev])
            if rank >= ndev:
                continue
            n = N0 * ndev
            path = os.path.join(tmp, f"a_{ndev}.npy")
            np.save(path, np.asarray(
                np.random.default_rng(3).standard_normal((m, n)), np.float32))
            with FileSource(path, CHUNK_ROWS) as src:
                rid_streamed(1, src, K, group=sub, device=dev)   # warm-up
                if cuda:
                    torch.cuda.synchronize(dev)
                    held = torch.cuda.memory_allocated(dev)
                    torch.cuda.reset_peak_memory_stats(dev)
                with tracing() as tr:
                    rid_streamed(1, src, K, group=sub, device=dev)
            peak = per_dev = None
            if cuda:
                mine = torch.cuda.max_memory_allocated(dev) - held
                both = torch.tensor([mine, mine], dtype=torch.int64,
                                    device=dev)
                dist.all_reduce(both[:1], group=sub)
                dist.all_reduce(both[1:], op=dist.ReduceOp.MAX, group=sub)
                peak, per_dev = both.tolist()
            rows.append({
                "bench": "stream_sharded", "device": str(dev), "ndev": ndev,
                "m": m, "n": n, "k": K, "chunk_rows": CHUNK_ROWS,
                "on_disk_bytes": os.path.getsize(path),
                "wall_s": _root_dur(tr), "peak_device_bytes": peak,
                "peak_per_device_bytes": per_dev,
                "acc_shard_bytes": l * (n // ndev) * 4})
            os.remove(path)
    if rank:
        return []
    emit(rows, header=f"sharded file-backed streamed ID on {dev}: weak "
                      f"scaling (ranks x columns; flat per-device memory)")
    if json_path:
        append_json_rows(json_path, rows)
    if cuda:
        for r in rows:
            assert r["on_disk_bytes"] > r["peak_device_bytes"], r
        per_dev = [r["peak_per_device_bytes"] for r in rows]
        assert max(per_dev) < 2 * min(per_dev), \
            f"per-device peak grows with the ranks: {per_dev}"
    return rows


@contextlib.contextmanager
def _cli_group(device):
    """``(group, device)``: the group ``torchrun`` describes (one rank a
    card) or a one-rank group (``bench_error.one_rank_group``)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        with one_rank_group(device) as group:
            yield group, check_device(device)
        return
    dev = check_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://",
                            timeout=datetime.timedelta(seconds=300))
    try:
        yield dist.group.WORLD, dev
    finally:
        dist.destroy_process_group()


def main(argv=None) -> None:
    ap = cli_parser("The streamed ID's peak device memory against m, and "
                    "its copy/accumulate overlap; --sharded: the sharded "
                    "stream's weak scaling")
    ap.add_argument("--sharded", action="store_true",
                    help="the file-backed sharded sweep (n grows with the "
                         "ranks) instead of the one-device m sweep")
    args = ap.parse_args(argv)
    if args.sharded:
        with _cli_group(args.device) as (group, dev):
            stream_sharded_sweep(group, full=args.full, device=dev,
                                 json_path=args.json)
    else:
        stream_sweep(full=args.full, device=args.device,
                     json_path=args.json)


if __name__ == "__main__":
    main()
