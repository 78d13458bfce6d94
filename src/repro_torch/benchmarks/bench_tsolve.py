"""Paper Table 4 on the port: the factorization of R, a triangular solve
independent per column (dominated by n).

Columns: the row-recurrence back substitution
(``core.tsolve.solve_upper_triangular``), the library solve
(``solve_upper_triangular_lib``) and the ``tsolve`` kernel, on the JAX
harness's system ``R1 = triu(randn) + 3 I``, ``R2 = randn``.  That ``R1``'s
condition grows exponentially with ``k``, so the kernel's result is held
to its normwise backward error, ``||R1 T - R2|| / (||R1|| ||T|| +
||R2||)`` (Frobenius), reported as ``cuda_backward_err``.

    python -m repro_torch.benchmarks.bench_tsolve [--full] [--device cuda|cpu]
"""
from __future__ import annotations

import torch

from ..configs import PAPER_GRID, SMALL_GRID
from ..core.rng import check_device
from ..core.tsolve import solve_upper_triangular, solve_upper_triangular_lib
from ..kernels.tsolve import tsolve
from .common import cli_parser, finish, randn, time_fn

__all__ = ["run", "main", "bench_system", "backward_error"]


def bench_system(gen: torch.Generator, k: int, n: int, dtype: torch.dtype,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """The harness's ``R1 = triu(randn(k, k)) + 3 I`` and ``R2 = randn(k,
    n)``."""
    eye = torch.eye(k, dtype=dtype, device=device)
    r1 = torch.triu(randn(gen, (k, k), dtype, device)) + 3 * eye
    return r1, randn(gen, (k, n), dtype, device)


def backward_error(r1: torch.Tensor, r2: torch.Tensor,
                   t: torch.Tensor) -> float:
    """``||triu(r1) t - r2|| / (||triu(r1)|| ||t|| + ||r2||)``, Frobenius,
    evaluated in double precision (the single-precision norms of the
    harness's fast-growing ``t`` overflow)."""
    wide = torch.complex128 if t.is_complex() else torch.float64
    u, r2, t = torch.triu(r1).to(wide), r2.to(wide), t.to(wide)
    num = torch.linalg.norm(u @ t - r2)
    den = torch.linalg.norm(u) * torch.linalg.norm(t) + torch.linalg.norm(r2)
    return float(num / den)


def run(grid, dtype: torch.dtype, device="cuda") -> list[dict]:
    """One row per case of ``grid``: median seconds of each solve of
    ``R1 T = R2`` with ``R1`` (k, k), ``R2`` (k, n), and the kernel's
    backward error."""
    dev = check_device(device)
    rows = []
    for case in grid:
        gen = torch.Generator(device=dev).manual_seed(case.k)
        R1, R2 = bench_system(gen, case.k, case.n, dtype, dev)
        t_ref = time_fn(lambda: solve_upper_triangular(R1, R2))
        t_lib = time_fn(lambda: solve_upper_triangular_lib(R1, R2))
        t_k = time_fn(lambda: tsolve(R1, R2))
        rows.append({"k": case.k, "n": case.n,
                     "dtype": str(dtype).replace("torch.", ""),
                     "device": str(dev), "rowrec_s": t_ref, "lib_s": t_lib,
                     "cuda_s": t_k,
                     "cuda_backward_err": backward_error(R1, R2,
                                                         tsolve(R1, R2))})
    return rows


def main(argv=None) -> None:
    args = cli_parser("Paper Table 4 on the port: factorization of R"
                      ).parse_args(argv)
    grid = PAPER_GRID if args.full else SMALL_GRID
    dtype = torch.float64 if args.full else torch.float32
    finish(run(grid, dtype, args.device),
           f"Table 4 analogue: factorization of R ({args.device})",
           args.json)


if __name__ == "__main__":
    main()
