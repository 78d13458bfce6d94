"""CLI: ``python -m repro_torch.analysis`` — run every pass, write the
JSON report, diff against the suppression baseline (counterpart of
``python -m repro.analysis``).

    python -m repro_torch.analysis [--device cuda|cpu] [--fail-on-new]
        [--update-baseline] [--no-controls] [--report PATH]

``--device`` defaults to ``cuda``: the dataflow entries run on the card
and the kernel pass holds every contract's declared launches to the C
side; without a card that stops with an error.  ``--device cpu`` is the
lane for a host without one (and for CI): the static checks, the entries
on the CPU.  The CLI joins a one-rank process group for the distributed
entries (gloo on the CPU, NCCL on a card) and destroys it before it
exits.

Exit status (with ``--fail-on-new``, the CI mode): nonzero iff an
error-severity finding is NOT in the baseline.  Fixed findings leave
stale baseline entries behind; those are listed so the baseline only
ratchets toward empty (``--update-baseline`` rewrites it from the
current run — review the diff before committing it).
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import sys
import tempfile

import torch
import torch.distributed as dist

from ..core.rng import check_device
from .report import (BASELINE_PATH, diff_against_baseline, load_baseline,
                     save_baseline)
from .runner import run_all


@contextlib.contextmanager
def one_rank_group(device: torch.device):
    """A one-rank default process group on a file store in a temporary
    directory (gloo for the CPU, NCCL for a card), destroyed on exit."""
    backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=300))
        try:
            yield
        finally:
            dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="analysis: dataflow rules, kernel contracts, AST lint, "
                    "positive controls")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the entries run and the kernels are held "
                         "(default: cuda, which needs a card)")
    ap.add_argument("--report", default="ANALYSIS_report.json",
                    help="where to write the JSON report")
    ap.add_argument("--baseline", default=str(BASELINE_PATH),
                    help="suppression baseline (checked in)")
    ap.add_argument("--fail-on-new", action="store_true",
                    help="exit nonzero on findings missing from the "
                         "baseline (the CI gate)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from this run's findings")
    ap.add_argument("--no-controls", action="store_true",
                    help="skip the planted-bug control pass")
    args = ap.parse_args(argv)
    try:
        device = check_device(args.device)
    except RuntimeError as exc:
        print(f"python -m repro_torch.analysis: {exc}", file=sys.stderr)
        return 2
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())

    with one_rank_group(device):
        report = run_all(device=device, controls=not args.no_controls)
    report.write(args.report)

    baseline = load_baseline(args.baseline)
    new, suppressed, stale = diff_against_baseline(report, baseline)

    for name in report.passes_run:
        print(f"pass {name}: {len(report.subjects.get(name, []))} subjects")
    print(f"findings: {len(report.findings)} total, "
          f"{len(report.errors())} errors "
          f"({len(suppressed)} baselined, {len(new)} new)")
    for f in new:
        print(f"  NEW [{f.rule}] {f.subject} :: {f.key}\n"
              f"      {f.message}")
    for e in stale:
        print(f"  stale suppression: [{e['rule']}] {e['subject']} :: "
              f"{e['key']} (fixed? prune it from the baseline)")
    if args.update_baseline:
        save_baseline(report.errors(), args.baseline)
        print(f"baseline rewritten: {args.baseline} "
              f"({len(report.errors())} suppressions)")
        return 0
    if args.fail_on_new and new:
        print(f"FAIL: {len(new)} new finding(s) not in baseline")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
