"""Result containers for the randomized decomposition core (counterpart of
``repro.core.types``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["SketchResult", "QRResult", "IDResult", "SVDResult",
           "real_dtype_of"]


class SketchResult(NamedTuple):
    """The compressed matrix ``Y = Phi @ A`` plus the operator kind."""

    Y: torch.Tensor       # (l, n) sketch
    kind: str = "gaussian"


class QRResult(NamedTuple):
    """Pivoted thin-QR of the sketch: ``Y[:, piv] ~= Q @ triu(R[:, piv])``."""

    Q: torch.Tensor       # (l, k) orthonormal columns
    R: torch.Tensor       # (k, n) = Q^H Y (columns in ORIGINAL order)
    piv: torch.Tensor     # (k,) int64 pivot column indices, selection order


class IDResult(NamedTuple):
    """Interpolative decomposition ``A ~= B @ P`` (paper eq. (1)):
    ``B = A[:, J]`` and ``P[:, J] == I_k``."""

    B: torch.Tensor       # (m, k) selected columns of A
    P: torch.Tensor       # (k, n) interpolation matrix, P[:, J] == I_k
    J: torch.Tensor       # (k,) pivot indices into columns of A
    Q: torch.Tensor       # (l, k) sketch-space basis
    R: torch.Tensor       # (k, n) sketch-space coefficients

    def reconstruct(self) -> torch.Tensor:
        return self.B @ self.P


class SVDResult(NamedTuple):
    """Rank-k randomized SVD ``A ~= U @ diag(S) @ Vh`` built on the ID."""

    U: torch.Tensor       # (m, k)
    S: torch.Tensor       # (k,) non-negative, descending
    Vh: torch.Tensor      # (k, n)

    def reconstruct(self) -> torch.Tensor:
        return (self.U * self.S[None, :].to(self.U.dtype)) @ self.Vh


def real_dtype_of(dtype: torch.dtype) -> torch.dtype:
    """The real dtype backing ``dtype`` (itself if already real)."""
    return dtype.to_real() if dtype.is_complex else dtype
