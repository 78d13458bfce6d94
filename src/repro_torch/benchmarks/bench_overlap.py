"""How much of the host -> device traffic the streamed ID's pipeline hides
(counterpart of the JAX harness's ``bench_overlap``).

    python -m repro_torch.benchmarks.bench_overlap [--full]
        [--device cuda|cpu] [--json PATH] [--out DIR] [--gate]
        [--margin 0.25]

The same f32 matrix (``m = 16384``, 65536 with ``--full``; ``n = 512``,
``k = 48``, ``chunk_rows = 512``) goes through ``rid_streamed`` twice under
tracing: ``overlap=True`` and ``overlap=False``.  In the serialized run
every ``stream.accumulate`` span waits for the device, so the summed
``stream.h2d`` and ``stream.accumulate`` spans are exposed time; in the
pipelined run the accumulation's spans are dispatch and the kernels run
under the next chunk's copy.  ``overlap_report`` turns the pair into

  hidden_fraction = clamp((exposed_serial - exposed_pipelined)
                          / min(sum h2d_serial, sum accumulate_serial), 0, 1)

beside both walls and their ratio: one ``bench = "stream_overlap"`` row
(stdout, ``--json``).  ``--gate`` exits 1 when the fraction falls below
``--margin``; ``--out DIR`` writes both JSONL traces, the report and the
first run's progress status.  On the CPU the numbers are the CPU's (a
check of the harness, not a measurement).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..core.rng import check_device
from ..obs import ProgressReporter, tracing
from ..stream import ArraySource, rid_streamed
from .common import append_json_rows, emit

__all__ = ["overlap_report", "overlap_gate", "main"]

N, K, CHUNK_ROWS = 512, 48, 512
M, FULL_M = 16384, 65536


def _phase_sum(tracer, name: str) -> float:
    return sum(s.dur or 0.0 for s in tracer.spans if s.name == name)


def overlap_report(pipelined, serialized) -> dict:
    """The hidden fraction of a pipelined / serialized trace pair of one
    job (module docstring), with both phases' sums and walls."""
    h2d_s = _phase_sum(serialized, "stream.h2d")
    acc_s = _phase_sum(serialized, "stream.accumulate")
    h2d_p = _phase_sum(pipelined, "stream.h2d")
    acc_p = _phase_sum(pipelined, "stream.accumulate")
    exposed_s, exposed_p = h2d_s + acc_s, h2d_p + acc_p
    denom = min(h2d_s, acc_s)
    hidden = (max(0.0, min(1.0, (exposed_s - exposed_p) / denom))
              if denom > 0 else 0.0)
    wall_p = _phase_sum(pipelined, "rid_streamed")
    wall_s = _phase_sum(serialized, "rid_streamed")
    return {"h2d_serial_s": h2d_s, "accumulate_serial_s": acc_s,
            "h2d_pipelined_s": h2d_p, "accumulate_pipelined_s": acc_p,
            "exposed_serial_s": exposed_s, "exposed_pipelined_s": exposed_p,
            "hidden_fraction": hidden, "wall_pipelined_s": wall_p,
            "wall_serialized_s": wall_s,
            "speedup": wall_s / wall_p if wall_p > 0 else float("inf")}


def overlap_gate(*, full: bool = False, device="cuda", json_path=None,
                 out_dir=None, margin: float = 0.25,
                 gate: bool = False) -> list[dict]:
    dev = check_device(device)
    m = FULL_M if full else M
    A = torch.from_numpy(np.asarray(
        np.random.default_rng(7).standard_normal((m, N)), np.float32))
    src = ArraySource(A, CHUNK_ROWS)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    def path(name):
        return os.path.join(out_dir, name) if out_dir else None
    progress = None if out_dir is None else \
        ProgressReporter(path("progress.json"))
    # Warm-up of both schedules (the first also writes the progress file,
    # whose fsyncs stay out of the timed runs).
    rid_streamed(1, src, K, progress=progress, device=dev)
    rid_streamed(1, src, K, overlap=False, device=dev)
    with tracing(jsonl=path("trace_pipelined.jsonl")) as tr_pipe:
        rid_streamed(1, src, K, overlap=True, device=dev)
    with tracing(jsonl=path("trace_serialized.jsonl")) as tr_ser:
        rid_streamed(1, src, K, overlap=False, device=dev)

    rep = overlap_report(tr_pipe, tr_ser)
    row = {"bench": "stream_overlap", "device": str(dev), "m": m, "n": N,
           "k": K, "chunk_rows": CHUNK_ROWS, "gate_margin": margin, **rep}
    emit([row], header="measured host->device hidden fraction: pipelined "
                       "vs serialized trace pair")
    if json_path:
        append_json_rows(json_path, [row])
    if out_dir:
        with open(path("overlap_report.json"), "w") as f:
            json.dump(row, f, indent=2, sort_keys=True)
    hidden = rep["hidden_fraction"]
    if gate and hidden < margin:
        print(f"OVERLAP GATE FAILED: hidden fraction {hidden:.3f} < margin "
              f"{margin} (exposed serialized {rep['exposed_serial_s']:.4f} "
              f"s, pipelined {rep['exposed_pipelined_s']:.4f} s)",
              file=sys.stderr)
        sys.exit(1)
    return [row]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="append the stream_overlap row to this JSON list")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="write the traces, the report and the progress "
                         "status here")
    ap.add_argument("--gate", action="store_true",
                    help="exit 1 if the hidden fraction is below --margin")
    ap.add_argument("--margin", type=float, default=0.25)
    args = ap.parse_args(argv)
    overlap_gate(full=args.full, device=args.device, json_path=args.json,
                 out_dir=args.out, margin=args.margin, gate=args.gate)


if __name__ == "__main__":
    main()
