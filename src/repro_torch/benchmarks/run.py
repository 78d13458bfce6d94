"""The port's benchmark harness (counterpart of the JAX harness's
``benchmarks/run.py``): one section a paper table or figure.

  PYTHONPATH=src python -m repro_torch.benchmarks.run --device cpu \\
      [--full] [--skip-scaling] [--bench-json PATH]

``SMALL_GRID`` by default, the paper's grid with ``--full``; ``--device``
is ``cuda`` unless ``cpu`` is named.  The rows go to ``--bench-json``
(default ``BENCH_torch.json``, gitignored), deleted first so each run
starts a fresh record; the JAX harness's ``BENCH_scaling.json`` is never
written or deleted.  The roofline section renders only if dry-run
records exist (``repro_torch.launch.dryrun`` writes them).
"""
from __future__ import annotations

import contextlib
import json
import os
import sys
import time

from .common import RECORD, check_record, cli_parser

__all__ = ["section", "main", "model_accuracy_rows", "analysis_rows"]


def section(title: str):
    print(f"\n{'=' * 72}\n== {title}\n{'=' * 72}", flush=True)


class _RowGuard:
    """No silent caps: every enabled bench section must APPEND rows to the
    JSON record.  A section that runs green while writing nothing is worse
    than one that fails.  Each ``expect_rows`` block counts the record's
    rows before and after; sections that added none are named, and
    ``fail_if_empty`` exits nonzero listing all of them."""

    def __init__(self, bench_json: str):
        self.bench_json = bench_json
        self.empty: list[str] = []

    def _count(self) -> int:
        if not self.bench_json or not os.path.exists(self.bench_json):
            return 0
        with open(self.bench_json) as f:
            return len(json.load(f))

    @contextlib.contextmanager
    def expect_rows(self, title: str):
        if not self.bench_json:        # no record: nothing to audit
            yield
            return
        before = self._count()
        yield
        if self._count() <= before:
            self.empty.append(title)

    def fail_if_empty(self) -> None:
        if self.empty:
            print(f"\nSILENT-EMPTY BENCH SECTIONS (no rows appended to "
                  f"{self.bench_json}): {self.empty}", file=sys.stderr)
            sys.exit(1)


def _exec_procs(device: str, want: list[int]) -> str:
    """The rank counts ``--exec`` can run: ``want`` on the CPU (gloo
    ranks), the cards there are on ``cuda`` (one rank a card)."""
    if device == "cpu":
        return ",".join(map(str, want))
    import torch
    have = torch.cuda.device_count()
    return ",".join(map(str, [p for p in want if p <= have] or [1]))


def main(argv=None):
    ap = cli_parser("The port's benchmark harness: one section a paper "
                    "table or figure")
    ap.add_argument("--skip-scaling", action="store_true",
                    help="skip the subprocess-heavy Figures 1-2 sections")
    ap.add_argument("--bench-json", default=RECORD,
                    help="the run's machine-readable record (never "
                         "BENCH_scaling.json, the JAX harness's)")
    args = ap.parse_args(argv)
    if args.json:
        ap.error("the harness writes --bench-json; --json is the bench "
                 "modules' flag")
    flags = (["--full"] if args.full else []) + ["--device", args.device]
    t0 = time.time()

    if args.bench_json:
        check_record(args.bench_json)
        if os.path.exists(args.bench_json):
            os.remove(args.bench_json)     # fresh record per harness run
    js = ["--json", args.bench_json] if args.bench_json else []
    guard = _RowGuard(args.bench_json)

    from . import (bench_error, bench_overlap, bench_qr, bench_scaling,
                   bench_sketch, bench_stream, bench_total, bench_tsolve,
                   roofline)

    section("Table 1: total RID runtime (phases)")
    bench_total.main(flags)
    section("Table 2: sketch / FFT phase by backend")
    bench_sketch.main(flags)
    title = "Table 3: Gram-Schmidt phase + fused panel-step sweep"
    section(title)
    with guard.expect_rows(title):
        bench_qr.main(flags + js)
    section("Table 4: factorization of R")
    bench_tsolve.main(flags)
    section("Table 5: ||A - BP||_2 + eq.(3) bound")
    bench_error.main(flags)
    title = "eq.(3) verification grid (known spectra) + width calibration"
    section(title)
    with guard.expect_rows(title):
        bench_error.main(flags + ["--grid", *js])
    title = "Streaming RID: flat device residency vs input size"
    section(title)
    with guard.expect_rows(title):
        bench_stream.main(flags + js)
    title = "Runtime overlap gate: measured H2D-hidden fraction"
    section(title)
    with guard.expect_rows(title):
        bench_overlap.main(flags + js + ["--gate"])
    if not args.skip_scaling:
        dev = ["--device", args.device]
        title = "Figures 1-2: modeled parallel scaling"
        section(title)
        with guard.expect_rows(title):
            bench_scaling.main(["--procs", "4,8,16,32,64,128",
                                "--rows", "1,6", *dev, *js])
        title = "Figures 1-2 at the paper's full sizes (counted only)"
        section(title)
        with guard.expect_rows(title):
            bench_scaling.main(["--procs", "4,8,16,32,64,128",
                                "--rows", "0,6", "--paper", *dev, *js])
        title = "Weak scaling: panel-parallel QRCP vs gather-and-replicate"
        section(title)
        with guard.expect_rows(title):
            for impl in ("blocked", "panel_parallel"):
                bench_scaling.main(["--procs",
                                    _exec_procs(args.device, [4, 8, 16]),
                                    "--rows", "1", "--weak", "--exec",
                                    "--qr-impl", impl, *dev, *js])
        title = "Strong scaling, executed: measured wall vs roofline model"
        section(title)
        with guard.expect_rows(title):
            bench_scaling.main(["--procs", _exec_procs(args.device, [4, 8]),
                                "--rows", "1", "--exec", *dev, *js])
        if args.bench_json:
            print(f"\nwrote {args.bench_json}")
    title = "Model accuracy: measured wall_s / modeled roofline seconds"
    section(title)
    with guard.expect_rows(title):
        model_accuracy_rows(args.bench_json)
    title = "Static analysis: contract findings + measured kernel residency"
    section(title)
    with guard.expect_rows(title):
        analysis_rows(args.bench_json, args.device)
    section("Roofline (from dry-run records)")
    roofline.main([])
    guard.fail_if_empty()
    print(f"\nbenchmarks completed in {time.time() - t0:.0f}s")


def model_accuracy_rows(bench_json: str):
    """Post-pass over the accumulated bench record: every row carrying
    BOTH a measured ``wall_s`` and a roofline ``model_time_s`` yields a
    ``bench = "model_accuracy"`` row with their ratio.  The model uses the
    H100 SXM5's published constants (67 TFLOP/s f32, 3.35 TB/s HBM3,
    NVLink 450 GB/s, 50 GB/s a card beyond a host: ``scaling_worker.H100``),
    so on the CPU the ratio is far above 1 by design and tracks the
    constant of proportionality across PRs; on an H100 it says how close
    one rank comes to its roofline."""
    from .common import append_json_rows, emit

    if not bench_json or not os.path.exists(bench_json):
        return
    with open(bench_json) as f:
        rows = json.load(f)
    acc = []
    for r in rows:
        wall, model = r.get("wall_s"), r.get("model_time_s")
        if wall is None or not model or model <= 0:
            continue
        phase = r.get("phase") or f"rid.{r.get('mode', 'strong')}"
        acc.append({"bench": "model_accuracy", "phase": phase,
                    "qr_impl": r.get("qr_impl", ""),
                    "procs": r.get("procs", 1), "m": r.get("m"),
                    "n": r.get("n"), "wall_s": wall,
                    "model_time_s": model, "ratio": wall / model})
    emit(acc, "measured / modeled seconds (H100 constants)")
    if acc:
        append_json_rows(bench_json, acc)


def analysis_rows(bench_json: str, device: str = "cuda"):
    """Run the ``repro_torch.analysis`` passes on ``device`` and append
    their summary to the bench record: the finding counts plus the kernel
    pass's measured residency (info findings).  The distributed entries
    need a process group: the caller's, or a one-rank group joined here
    for the call."""
    import torch.distributed as dist

    from ..analysis.runner import run_all
    from .bench_error import one_rank_group
    from .common import append_json_rows, emit

    with (contextlib.nullcontext() if dist.is_initialized()
          else one_rank_group(device)):
        report = run_all(device=device)
    summary = [{"bench": "analysis",
                "subjects": sum(len(s) for s in report.subjects.values()),
                "findings": len(report.findings),
                "errors": len(report.errors())}]
    residency = [{"bench": "analysis_residency", "package": f.subject,
                  "detail": f.message}
                 for f in report.findings if f.rule == "kernels.residency"]
    emit(summary, "repro_torch.analysis summary")
    if residency:
        emit(residency, "measured kernel residency (info findings)")
    if bench_json:
        append_json_rows(bench_json, summary + residency)


if __name__ == "__main__":
    main(sys.argv[1:])
