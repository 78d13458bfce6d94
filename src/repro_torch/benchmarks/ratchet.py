"""Per-PR bound-ratio ratchet (counterpart of the JAX harness's
``benchmarks/ratchet.py``): fails when the eq. (3) verification grid's
worst bound ratios regress by more than ``RATCHET_FACTOR`` against a
baseline record.

``bench_error --grid`` records one ``bench = "error_grid_summary"`` row a
(impl, dtype) with the worst ``err / bound`` over the spectra x k grid.
This module compares a baseline record of such rows with a fresh one:

    PYTHONPATH=src python -m repro_torch.benchmarks.ratchet \\
        --baseline BASE.json --fresh FRESH.json

(both written by ``python -m repro_torch.benchmarks.bench_error --grid
--json PATH``).  A fresh worst ratio above ``factor * max(baseline,
floor)`` is a regression; a cell of the baseline missing from the fresh
grid is flagged too (a silent loss of coverage would read as a pass).
New cells ratchet from their first recorded run.  ``floor`` keeps ratios
at roundoff level from tripping on roundoff-scale wiggle.
"""
from __future__ import annotations

import json
import sys

from .common import cli_parser

__all__ = ["RATCHET_FACTOR", "RATCHET_FLOOR", "summary_ratios",
           "check_ratchet", "main"]

RATCHET_FACTOR = 2.0
# Ratios below this measure roundoff, not pivot quality: a 2x swing at
# 1e-5 is noise; at 1e-2 it is a real quality loss.
RATCHET_FLOOR = 1e-4


def summary_ratios(rows: list[dict]) -> dict[tuple[str, str], float]:
    """(impl, dtype) -> worst_ratio from error_grid_summary rows; a later
    duplicate (a re-recorded trajectory) wins."""
    out = {}
    for r in rows:
        if r.get("bench") == "error_grid_summary":
            out[(r["impl"], r["dtype"])] = float(r["worst_ratio"])
    return out


def check_ratchet(baseline_rows: list[dict], fresh_rows: list[dict], *,
                  factor: float = RATCHET_FACTOR,
                  floor: float = RATCHET_FLOOR) -> list[str]:
    """Regression messages (empty = the ratchet holds)."""
    base = summary_ratios(baseline_rows)
    fresh = summary_ratios(fresh_rows)
    problems = []
    if not fresh:
        return ["fresh record has no error_grid_summary rows — did the "
                "grid run?"]
    if not base:
        # An empty baseline would make every later run pass vacuously.
        return ["baseline record has no error_grid_summary rows — was the "
                "committed baseline regenerated without --grid?"]
    for key in sorted(base):
        impl, dtype = key
        if key not in fresh:
            problems.append(f"{impl}/{dtype}: present in baseline but "
                            f"missing from the fresh grid (coverage loss)")
            continue
        limit = factor * max(base[key], floor)
        if fresh[key] > limit:
            problems.append(
                f"{impl}/{dtype}: worst bound ratio {fresh[key]:.3e} > "
                f"{factor:g}x baseline {base[key]:.3e} (limit {limit:.3e})")
    return problems


def main(argv=None) -> int:
    # (the common flags: --device and --full change nothing here, the
    # records are read from disk)
    ap = cli_parser("The eq. (3) grid's bound-ratio ratchet")
    ap.add_argument("--baseline", required=True,
                    help="a record carrying the baseline's "
                         "error_grid_summary rows")
    ap.add_argument("--fresh", required=True,
                    help="a freshly generated grid record "
                         "(bench_error --grid --json PATH)")
    ap.add_argument("--factor", type=float, default=RATCHET_FACTOR)
    ap.add_argument("--floor", type=float, default=RATCHET_FLOOR)
    args = ap.parse_args(argv)
    with open(args.baseline) as f:
        baseline = json.load(f)
    with open(args.fresh) as f:
        fresh = json.load(f)
    problems = check_ratchet(baseline, fresh, factor=args.factor,
                             floor=args.floor)
    if problems:
        print("bound-ratio ratchet FAILED:")
        for p in problems:
            print(f"  {p}")
        return 1
    n = len(summary_ratios(fresh))
    print(f"bound-ratio ratchet ok: {n} (impl, dtype) cells within "
          f"{args.factor:g}x of baseline")
    return 0


if __name__ == "__main__":
    sys.exit(main())
