"""Paper Table 2 on the port: the randomization phase by backend.

Columns: the paper-faithful complex SRFT (``torch.fft``), the real SRHT
with the plain transform, the gaussian sketch (the ``sketch_accum``
kernel, block-seeded operator drawn in the call), and the two
sketch kernels of this table on given operators: ``srht`` through the
``fwht`` kernel and ``sketch_matmul``.  On the CPU every column runs the
plain versions.

    python -m repro_torch.benchmarks.bench_sketch [--full] [--device cuda|cpu]
"""
from __future__ import annotations

import torch

from ..configs import PAPER_GRID, SMALL_GRID
from ..core import gaussian_sketch, next_pow2, srft_sketch, srht_sketch
from ..core.rng import check_device
from ..kernels.sketch_matmul import sketch_matmul
from ..kernels.srht import srht
from .common import cli_parser, finish, randn, time_fn

__all__ = ["run", "main"]


def run(grid, dtype: torch.dtype, device="cuda") -> list[dict]:
    """One row per case of ``grid``: median seconds of each backend on a
    Gaussian ``A`` (m, n) of the real ``dtype``, sketched to ``l = 2k``
    rows."""
    dev = check_device(device)
    rows = []
    for case in grid:
        gen = torch.Generator(device=dev).manual_seed(case.k)
        A = randn(gen, (case.m, case.n), dtype, dev)
        l, seed = case.l, case.k
        t_srft = time_fn(lambda: srft_sketch(seed, A, l))
        t_srht = time_fn(lambda: srht_sketch(seed, A, l))
        t_gauss = time_fn(lambda: gaussian_sketch(seed, A, l))

        signs = (torch.randint(0, 2, (case.m,), generator=gen, device=dev)
                 * 2 - 1).to(dtype)
        rowsel = torch.randint(0, next_pow2(case.m), (l,), generator=gen,
                               device=dev)
        t_srht_k = time_fn(lambda: srht(signs, A, rowsel))
        omega = randn(gen, (l, case.m), dtype, dev)
        t_mm_k = time_fn(lambda: sketch_matmul(omega, A))
        rows.append({"k": case.k, "m": case.m, "n": case.n,
                     "dtype": str(dtype).replace("torch.", ""),
                     "device": str(dev),
                     "srft_s": t_srft, "srht_s": t_srht,
                     "gaussian_s": t_gauss, "srht_cuda_s": t_srht_k,
                     "gauss_cuda_s": t_mm_k})
        del A, omega
    return rows


def main(argv=None) -> None:
    args = cli_parser("Paper Table 2 on the port: sketch by backend"
                      ).parse_args(argv)
    grid = PAPER_GRID if args.full else SMALL_GRID
    dtype = torch.float64 if args.full else torch.float32
    finish(run(grid, dtype, args.device),
           f"Table 2 analogue: sketch phase by backend ({args.device})",
           args.json)


if __name__ == "__main__":
    main()
