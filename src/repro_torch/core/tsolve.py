"""The interpolation solve (paper eq. 10): ``R1 T = R2`` with ``R1`` upper
triangular (counterpart of ``repro.core.tsolve``).

The solve is independent per column of ``R2``.  ``interp_from_qr`` runs
``torch.linalg.solve_triangular`` (the counterpart of
``solve_upper_triangular_xla``); ``solve_upper_triangular`` is the
row-recurrence oracle.
"""
from __future__ import annotations

import torch

from .types import real_dtype_of

__all__ = ["solve_upper_triangular", "solve_upper_triangular_lib",
           "interp_from_qr"]


def solve_upper_triangular(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Back substitution: ``T`` with ``triu(R1) @ T = R2``, one row at a
    time from the bottom, all columns at once.  A zero diagonal entry is
    replaced by the dtype's ``tiny``, as in the reference."""
    k = R1.shape[0]
    R1u = torch.triu(R1)
    tiny = torch.finfo(real_dtype_of(R1.dtype)).tiny
    T = torch.zeros_like(R2)
    for i in reversed(range(k)):
        row = R1u[i]
        acc = row @ T                       # T[i] is still 0
        diag = row[i]
        safe = torch.where(diag.abs() > 0, diag,
                           torch.full_like(diag, tiny))
        T[i] = (R2[i] - acc) / safe
    return T


def solve_upper_triangular_lib(R1: torch.Tensor,
                               R2: torch.Tensor) -> torch.Tensor:
    """The library's triangular solve, the production path."""
    return torch.linalg.solve_triangular(torch.triu(R1), R2, upper=True)


def interp_from_qr(R: torch.Tensor, piv: torch.Tensor, *,
                   use_lib: bool = True) -> torch.Tensor:
    """The interpolation matrix ``P`` (paper eq. 11) from ``R = Q^H Y``:
    ``P = R1^{-1} R`` with ``R1 = R[:, piv]``, then an exact ``I_k``
    written into the pivot columns."""
    k = R.shape[0]
    R1 = R.index_select(1, piv)
    solve = solve_upper_triangular_lib if use_lib else solve_upper_triangular
    P = solve(R1, R)
    P[:, piv] = torch.eye(k, dtype=P.dtype, device=P.device)
    return P
