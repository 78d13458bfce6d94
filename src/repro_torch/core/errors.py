"""Error measurement and the paper's probabilistic bound (eq. 3)
(counterpart of ``repro.core.errors``).

``spectral_error`` estimates ``||A - B P||_2`` by power iteration on the
implicit operator ``E^H E`` with ``E = A - B P``, never forming ``E``.
``error_bound`` is the right-hand side of

    ||A - BP||_2 / sigma_{k+1}  <=  50 sqrt(mn) (1/eps)^(1/k)      (3)

and ``expected_sigma_kp1`` the paper's noise floor
``sigma_{k+1} ~ sqrt(2 min(m, n)) * delta`` for a product of Gaussian
factors computed at precision ``delta``.
"""
from __future__ import annotations

import math

import torch

from .rng import as_generator
from .types import real_dtype_of

__all__ = ["spectral_error", "spectral_norm_dense", "error_bound",
           "expected_sigma_kp1"]


def spectral_error(gen_or_seed, A: torch.Tensor, B: torch.Tensor,
                   P: torch.Tensor, iters: int = 50) -> torch.Tensor:
    """Power-iteration estimate of ``||A - B @ P||_2`` (a 0-d tensor on
    ``A``'s device)."""
    n = A.shape[1]
    dtype = P.dtype if P.dtype.is_complex else A.dtype
    A_, B_, P_ = A.to(dtype), B.to(dtype), P.to(dtype)
    rdtype = real_dtype_of(dtype)
    tiny = torch.finfo(rdtype).tiny

    def e_mv(x):            # E x
        return A_ @ x - B_ @ (P_ @ x)

    def eh_mv(y):           # E^H y
        return A_.mH @ y - P_.mH @ (B_.mH @ y)

    g = as_generator(gen_or_seed, A.device)
    v = torch.randn(n, generator=g, dtype=rdtype, device=A.device).to(dtype)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = eh_mv(e_mv(v))
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=tiny)
    return torch.linalg.vector_norm(e_mv(v))


def spectral_norm_dense(E: torch.Tensor) -> torch.Tensor:
    """Exact ``||E||_2`` via dense SVD, for small test matrices only."""
    return torch.linalg.svdvals(E)[0]


def error_bound(m: int, n: int, k: int, eps: float = 1e-20) -> float:
    """Right-hand side of paper eq. (3), times sigma_{k+1}=1."""
    return 50.0 * math.sqrt(m * n) * (1.0 / eps) ** (1.0 / k)


def expected_sigma_kp1(m: int, n: int, delta: float = 1e-16) -> float:
    """Paper section 3.3 noise-floor estimate for A = B P in finite precision."""
    return math.sqrt(2 * min(m, n)) * delta
