"""Paper Table 1 on the port: the whole randomized ID, phase by phase.

Phases timed apart on the same complex Gaussian low-rank ``A = B P``: the
sketch (``sketch_kind``), the paper's iterated classical Gram-Schmidt QR
(``cgs2_pivoted_qr``), the factorization of R (``interp_from_qr``), and
the total, the sketch plus ``rid_from_sketch`` (the default blocked QR on
the ``panel_step`` kernel, the solve and the gather).

    python -m repro_torch.benchmarks.bench_total [--full] [--device cuda|cpu]
        [--sketch srft|srht|gaussian]
"""
from __future__ import annotations

import torch

from ..configs import PAPER_GRID, SMALL_GRID
from ..core import cgs2_pivoted_qr, rid_from_sketch, sketch
from ..core.rng import check_device
from ..core.tsolve import interp_from_qr
from .common import cli_parser, finish, randn, time_fn

__all__ = ["lowrank_complex", "run", "main"]


def lowrank_complex(gen: torch.Generator, m: int, n: int, k: int,
                    dtype: torch.dtype, device) -> torch.Tensor:
    """``B @ P`` with ``B`` (m, k) and ``P`` (k, n) complex Gaussian: the
    paper's test matrices, rank ``k``."""
    return randn(gen, (m, k), dtype, device) @ randn(gen, (k, n), dtype,
                                                     device)


def run(grid, sketch_kind: str, dtype: torch.dtype,
        device="cuda") -> list[dict]:
    """One row per case of ``grid``: median seconds of each phase."""
    dev = check_device(device)
    rows = []
    for case in grid:
        gen = torch.Generator(device=dev).manual_seed(case.k)
        A = lowrank_complex(gen, case.m, case.n, case.k, dtype, dev)
        seed, l, k = case.k + 7, case.l, case.k

        Y = sketch(seed, A, l, kind=sketch_kind).Y
        t_sketch = time_fn(lambda: sketch(seed, A, l, kind=sketch_kind))
        qres = cgs2_pivoted_qr(Y, k)
        t_qr = time_fn(lambda: cgs2_pivoted_qr(Y, k))
        t_solve = time_fn(lambda: interp_from_qr(qres.R, qres.piv))
        t_total = t_sketch + time_fn(lambda: rid_from_sketch(A, Y, k))
        rows.append({"k": k, "m": case.m, "n": case.n,
                     "dtype": str(dtype).replace("torch.", ""),
                     "sketch": sketch_kind, "device": str(dev),
                     "sketch_s": t_sketch, "gs_qr_s": t_qr,
                     "rfac_s": t_solve, "total_s": t_total})
        del A, Y, qres
    return rows


def main(argv=None) -> None:
    ap = cli_parser("Paper Table 1 on the port: total RID runtime")
    ap.add_argument("--sketch", default="srft",
                    choices=["srft", "srht", "gaussian"])
    args = ap.parse_args(argv)
    grid = PAPER_GRID if args.full else SMALL_GRID
    dtype = torch.complex128 if args.full else torch.complex64
    finish(run(grid, args.sketch, dtype, args.device),
           f"Table 1 analogue: total RID runtime (sketch={args.sketch}, "
           f"{str(dtype).replace('torch.', '')}, {args.device})", args.json)


if __name__ == "__main__":
    main()
