"""Quickstart on the port: the paper's randomized interpolative
decomposition, on an H100 (or the CPU with ``--device cpu``).

  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]

Every number is drawn from ``torch.Generator`` seeds, so a run repeats
itself bit for bit on the same device.
"""
import argparse
import sys

import torch

from repro_torch.core import (error_bound, expected_sigma_kp1, rid, rsvd,
                              spectral_norm_dense)
from repro_torch.core.rng import check_device

ROWS, COLS, RANK = 2048, 1024, 64


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = check_device(args.device)
    m, n, k = ROWS, COLS, RANK

    # A = B P with complex Gaussian factors, the paper's benchmark
    # matrices: "almost no exploitable structure, other than their rank".
    g = torch.Generator(device=dev).manual_seed(0)

    def gauss(shape):
        return torch.randn(shape, generator=g, dtype=torch.float64,
                           device=dev)
    B0 = torch.complex(gauss((m, k)), gauss((m, k)))
    P0 = torch.complex(gauss((k, n)), gauss((k, n)))
    A = B0 @ P0
    print(f"A: {m}x{n} complex128 of exact rank {k} "
          f"({A.nbytes / 1e6:.0f} MB dense) on {dev}")

    # The paper's pipeline: sketch (Y = S F D A) -> pivoted QR -> R1 T = R2
    # (the real SRHT gets a real rank-k matrix of its own: Re(B P) alone
    # has rank up to 2k).
    A_real = B0.real @ P0.real
    out = {"device": str(dev), "sketches": {}}
    for kind in ("srft", "srht", "gaussian"):
        M = A if kind != "srht" else A_real
        dec = rid(2, M, k, sketch_kind=kind)
        err = float(spectral_norm_dense(M - dec.reconstruct()))
        stored = dec.B.nbytes + dec.P.nbytes
        out["sketches"][kind] = err
        print(f"  rid[{kind:8s}]  ||A - BP||_2 = {err:.2e}   storage "
              f"{stored:,} B ({stored / M.nbytes:.1%} of dense)")

    # Paper eq. (3): the probabilistic error bound.
    bound = error_bound(m, n, k) * expected_sigma_kp1(m, n)
    dec = rid(2, A, k)
    err = float(spectral_norm_dense(A - dec.reconstruct()))
    out.update(eq3_bound=bound, eq3_err=err, satisfied=err <= bound)
    print(f"eq.(3) bound: {bound:.2e}  measured: {err:.2e}  "
          f"satisfied: {err <= bound}")

    # The ID as the basis of a fast SVD (the paper's ref. [3]).
    sv = rsvd(2, A, k)
    svd_err = float(spectral_norm_dense(A - sv.reconstruct()))
    out["rsvd_err"] = svd_err
    print(f"rsvd: ||A - U S Vh||_2 = {svd_err:.2e}; top-3 singular values "
          f"{[f'{float(s):.1f}' for s in sv.S[:3]]}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
