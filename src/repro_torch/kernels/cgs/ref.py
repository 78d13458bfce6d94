"""Plain PyTorch versions of the classical Gram-Schmidt block deflation
(counterpart of ``repro.kernels.cgs.ref``): ``W = Q^H Z`` and
``Z - Q W``, accumulated in ``accum_dtype_for`` of ``Z``'s dtype.

The reference writes ``q.T`` for real types and its wrappers send complex
types to ``q.conj().T``; ``q.mH`` is both.
"""
from __future__ import annotations

import torch

from ..sketch_accum import accum_dtype_for

__all__ = ["project_out_ref", "panel_deflate_ref"]


def _deflate(q: torch.Tensor, z: torch.Tensor):
    """``(Z - Q W, W)`` in the accumulator dtype, ``W = Q^H Z``."""
    acc = accum_dtype_for(z.dtype)
    za = z.to(acc)
    w = q.to(acc).mH @ za
    return za - q.to(acc) @ w.to(q.dtype).to(acc), w


def project_out_ref(q: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Project the columns of ``z`` (l x n) off the orthonormal basis ``q``
    (l x k): ``z - q (q^H z)``."""
    return _deflate(q, z)[0].to(z.dtype)


def panel_deflate_ref(q: torch.Tensor, z: torch.Tensor):
    """Panel trailing update of the split blocked QR: ``(z - q w, w)`` with
    ``w = q^H z`` for the orthonormal panel ``q`` (l x b)."""
    o, w = _deflate(q, z)
    return o.to(z.dtype), w.to(z.dtype)
