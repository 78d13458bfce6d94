"""Paper Figures 1-2 on the port: the parallel speed-up of
``rid_distributed`` (counterpart of the JAX harness's
``benchmarks/bench_scaling.py``).

One host has one card here, so the curve is a MODEL, as the reference's
is: ``scaling_worker`` counts one rank's work at N = 4..128 ranks on
torch's fake backend (flops, bytes accessed, collective bytes, the live
peak), and each width's time is the roofline of the H100's published
constants (``scaling_worker.H100``),

    t(N) = max(flops / peak, bytes / HBM, coll_NVLink / 450 GB/s
                                          + coll_network / 50 GB/s),

a collective counted on the network when its group spans hosts of 8
cards.  Speedup(N) = t(4) / t(N) * 4 (the paper's baseline is 4 procs);
with ``--weak`` (``n`` grows with N, constant columns a rank) it is
t(4) / t(N) * N.  No multi-card run stands behind these numbers.

``--qr-impl`` picks the distributed pivoted-QR engine ('cgs2' | 'blocked'
gather the sketch and factor it on every rank, 'panel_parallel' factors
the shards in place).  ``--paper`` (or ``--full``) takes the paper's rows,
counted only: nothing is allocated.  ``--exec`` also runs each row for
real (``wall_s``): gloo ranks on ``--device cpu``, one rank a card over
NCCL on ``--device cuda`` (so ``--procs 1`` on a one-card host; 1 is
allowed only with ``--exec``).  ``--json PATH`` appends the rows to a
JSON list (never ``BENCH_scaling.json``, the JAX harness's record).

  python -m repro_torch.benchmarks.bench_scaling --device cpu
  python -m repro_torch.benchmarks.bench_scaling --paper --rows 0,6 \\
      --device cpu
"""
from __future__ import annotations

import sys

from ..configs.paper_rid import PAPER_GRID, SMALL_GRID
from .common import cli_parser, finish
from .scaling_worker import H100, QR_IMPLS, model_time, sweep

__all__ = ["scaling_rows", "main"]


def scaling_rows(case, ns: dict, recs: dict, procs: list, *, weak: bool,
                 qr_impl: str) -> list[dict]:
    """The reference's rows (its keys) from one grid case's records by
    proc count, plus the counts and the constants each row's model used."""
    mode = "weak" if weak else "strong"
    t4 = model_time(recs[procs[0]])
    rows = []
    for p in procs:
        rec = recs[p]
        t = model_time(rec)
        speedup = t4 / t * (p if weak else procs[0])
        rows.append({"k": case.k, "m": case.m, "n": ns[p], "procs": p,
                     "qr_impl": qr_impl, "mode": mode,
                     "flops_per_dev": rec["flops"],
                     "coll_bytes_per_dev": rec["collective_bytes"],
                     "bytes_per_dev": rec["bytes_per_device"],
                     "wall_s": rec["wall_s"],
                     "model_time_s": t,
                     "speedup_vs4": speedup,
                     "efficiency": speedup / p,
                     "hbm_bytes_per_dev": rec["bytes"],
                     "interhost_bytes_per_dev": rec["interhost_bytes"],
                     "host_reads": sum(rec["host_reads"].values()),
                     "kernels_at_bound": "+".join(rec["kernel_calls"]),
                     "constants": H100["name"],
                     "peak_flops": H100["peak_flops"],
                     "hbm_bytes_s": H100["hbm_bytes_s"],
                     "nvlink_bytes_s": H100["nvlink_bytes_s"],
                     "net_bytes_s": H100["net_bytes_s"]})
    return rows


def main(argv=None) -> list[dict]:
    ap = cli_parser("Figures 1-2 on the port: modeled parallel scaling of "
                    "rid_distributed")
    ap.add_argument("--procs", default="4,8,16,32,64,128")
    ap.add_argument("--rows", default="1,6",
                    help="grid row indices (default: a tall m-heavy row "
                         "and a wide n-heavy row, the paper's two scaling "
                         "regimes)")
    ap.add_argument("--paper", action="store_true",
                    help="the paper's full-size rows (counted on fake "
                         "tensors: nothing is allocated); --full too")
    ap.add_argument("--qr-impl", default="blocked", choices=QR_IMPLS)
    ap.add_argument("--weak", action="store_true",
                    help="grow n with the rank count (constant columns "
                         "a rank)")
    ap.add_argument("--exec", dest="do_exec", action="store_true",
                    help="also run each row for real and record wall_s "
                         "(not with --paper)")
    args = ap.parse_args(argv)
    procs = [int(p) for p in args.procs.split(",")]
    least = 1 if args.do_exec else 2
    if any(p < least for p in procs):
        ap.error(f"--procs must be >= {least}"
                 + ("" if args.do_exec else " (1 only with --exec)"))
    paper = args.paper or args.full
    grid = PAPER_GRID if paper else SMALL_GRID
    do_exec = args.do_exec and not paper
    rows = []
    for case in [grid[int(i)] for i in args.rows.split(",")]:
        ns = {p: case.n * p // procs[0] if args.weak else case.n
              for p in procs}
        recs = dict(zip(procs, sweep(
            case.k, case.m, [ns[p] for p in procs], procs, args.qr_impl,
            exec_on=args.device if do_exec else None)))
        rows += scaling_rows(case, ns, recs, procs, weak=args.weak,
                             qr_impl=args.qr_impl)
    mode = "weak" if args.weak else "strong"
    finish(rows, f"Figures 1-2 on the port: modeled parallel scaling of "
                 f"rid_distributed (H100 roofline: {H100['source']}; "
                 f"qr_impl={args.qr_impl}, {mode} scaling)", args.json)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
