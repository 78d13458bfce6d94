"""Randomized SVD built on the interpolative decomposition (counterpart of
``repro.core.rsvd``).

Given ``A ~= B P`` with ``B = A[:, J]`` (m x k) and ``P`` (k x n):
  1. thin-QR the tall panel:   B = Q_b R_b      (CholeskyQR2)
  2. small dense SVD:          R_b P = U' S Vh
  3. lift:                     U = Q_b U'
"""
from __future__ import annotations

from typing import Optional

import torch

from .qr import cholesky_qr2
from .rid import rid
from .types import IDResult, SVDResult

__all__ = ["rsvd", "rsvd_from_id"]


def rsvd_from_id(dec: IDResult) -> SVDResult:
    Qb, Rb = cholesky_qr2(dec.B.to(dec.P.dtype))
    U_small, S, Vh = torch.linalg.svd(Rb @ dec.P, full_matrices=False)
    return SVDResult(U=Qb @ U_small, S=S, Vh=Vh)


def rsvd(gen_or_seed, A: torch.Tensor, k: int, *, l: Optional[int] = None,
         sketch_kind: str = "gaussian", qr_impl: str = "blocked",
         qr_panel=32, qr_norm_recompute="auto", **operator) -> SVDResult:
    """Rank-``k`` randomized SVD of ``A`` via the ID; the keywords are
    ``rid``'s."""
    return rsvd_from_id(rid(gen_or_seed, A, k, l=l, sketch_kind=sketch_kind,
                            qr_impl=qr_impl, qr_panel=qr_panel,
                            qr_norm_recompute=qr_norm_recompute, **operator))
