"""Known-spectrum test matrices for the eq. (3) verification grid
(counterpart of the matrix half of ``repro.data.synthetic``).

``spectrum_sigmas`` / ``spectrum_matrix`` build matrices ``A = U S V^H``
with an exactly known singular spectrum, so eq. (3), which bounds
``||A - BP||_2`` by a multiple of ``sigma_{k+1}``, can be checked against
the true ``sigma_{k+1}`` instead of the paper's noise-floor estimate.
Three shapes cover the failure modes of the blocked and distributed QRCP
engines:

  fast_decay -- geometric decay down to ``floor``: the residual-norm
                downdate drift case in f32;
  cliff      -- flat at 1.0 through index k-1, then a hard drop: the pivot
                quality case (missing one leading column costs 1/gap);
  noisy_tail -- polynomial decay into a flat noise plateau: the near-tie
                case.

``spectrum_sigmas`` is the reference's numpy code as it is, so the two
packages give the same singular values bit for bit.  ``spectrum_matrix``
draws its orthonormal factors from a ``torch.Generator`` (Philox), so its
bits differ from the reference's (threefry); its singular values do not.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.rng import as_generator, check_device

__all__ = ["SPECTRA", "DTYPE_FLOORS", "spectrum_sigmas", "spectrum_matrix"]

SPECTRA = ("fast_decay", "cliff", "noisy_tail")

# Smallest spectrum floor per dtype that keeps sigma_{k+1} well above the
# working precision's cancellation level (the reference's values).
DTYPE_FLOORS = {"float32": 1e-5, "complex64": 1e-5,
                "float64": 1e-12, "complex128": 1e-12}


def spectrum_sigmas(spectrum: str, r: int, k: int, *,
                    floor: float = 1e-6) -> np.ndarray:
    """The ``r`` singular values of a synthetic ``spectrum`` (see module
    docstring), scaled so ``sigma_0 = 1``; ``floor`` sets the smallest
    value (pick it well above the working dtype's cancellation level:
    ~1e-5 for f32, ~1e-12 for f64)."""
    if spectrum not in SPECTRA:
        raise ValueError(f"unknown spectrum {spectrum!r}; expected one of "
                         f"{SPECTRA}")
    if not (0 < k < r):
        raise ValueError(f"need 0 < k < r, got k={k}, r={r}")
    i = np.arange(r, dtype=np.float64)
    if spectrum == "fast_decay":
        return floor ** (i / (r - 1))
    if spectrum == "cliff":
        # sqrt(floor) keeps the post-cliff block itself well-conditioned
        # relative to the dtype while the k|k+1 gap stays hard.
        return np.where(i < k, 1.0, np.sqrt(floor))
    # noisy_tail: polynomial decay into a flat plateau at sqrt(floor)
    return np.maximum((i + 1.0) ** -1.5, np.sqrt(floor))


def _orthonormal(g: torch.Generator, rows: int, r: int, cplx: bool,
                 device) -> torch.Tensor:
    """Q of the QR of a seeded (rows, r) Gaussian, f64 or c128."""
    x = torch.randn((rows, r), generator=g, dtype=torch.float64,
                    device=device)
    if cplx:
        x = torch.complex(x, torch.randn((rows, r), generator=g,
                                         dtype=torch.float64, device=device))
    return torch.linalg.qr(x).Q


def spectrum_matrix(gen_or_seed, m: int, n: int, spectrum: str, k: int, *,
                    r: Optional[int] = None,
                    dtype: torch.dtype = torch.float64, floor: float = 1e-6,
                    device="cuda") -> tuple[torch.Tensor, np.ndarray]:
    """``(A, sigmas)``: an ``m x n`` matrix of rank ``r`` (default
    ``min(2 * k + 16, m, n)``) on ``device`` with exactly the singular
    values ``spectrum_sigmas(spectrum, r, k, floor=floor)`` (up to the
    rounding of two orthonormal factors, formed in f64 / c128), in
    ``dtype`` (real or complex).  The true ``sigma_{k+1}`` is
    ``sigmas[k]``, the eq. (3) reference.  ``gen_or_seed`` is an int seed
    or a ``torch.Generator`` on ``device``."""
    dev = check_device(device)
    r = min(2 * k + 16, m, n) if r is None else r
    sig = spectrum_sigmas(spectrum, r, k, floor=floor)
    g = as_generator(gen_or_seed, dev)
    U = _orthonormal(g, m, r, dtype.is_complex, dev)
    V = _orthonormal(g, n, r, dtype.is_complex, dev)
    s = torch.as_tensor(sig, dtype=torch.float64, device=dev)
    A = (U * s[None, :].to(U.dtype)) @ V.mH
    return A.to(dtype), sig
