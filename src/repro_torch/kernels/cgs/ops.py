"""Public wrappers of the classical Gram-Schmidt block deflation
(counterpart of ``repro.kernels.cgs.ops``): ``project_out`` against a
basis of any width, ``panel_deflate`` against one panel of the split
blocked QR (``benchmarks/bench_qr.split_blocked_qr``).

Dispatch: CPU tensors take the plain versions (``ref.py``); CUDA tensors
launch the Hopper kernels (``kernel.py``) for every real and complex
dtype, or raise.
"""
from __future__ import annotations

import torch

from ..common import refuse_dtensor
from .kernel import panel_deflate_kernel, project_out_kernel
from .ref import panel_deflate_ref, project_out_ref

__all__ = ["project_out", "panel_deflate"]


def _common(q: torch.Tensor, z: torch.Tensor):
    """``q`` and ``z`` checked for rows and device, in their promoted
    dtype."""
    if q.shape[0] != z.shape[0]:
        raise ValueError(f"q rows ({q.shape[0]}) must match z rows "
                         f"({z.shape[0]})")
    if q.device != z.device:
        raise ValueError(f"q and z must share one device, got {q.device} "
                         f"and {z.device}")
    dt = torch.promote_types(q.dtype, z.dtype)
    return q.to(dt), z.to(dt)


def project_out(q: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``z - q (q^H z)`` with ``q`` (l x k) orthonormal and ``z``
    (l x n)."""
    refuse_dtensor("project_out", q, z)
    q, z = _common(q, z)
    if z.device.type == "cpu":
        return project_out_ref(q, z)
    return project_out_kernel(q.contiguous(), z.contiguous())


def panel_deflate(q: torch.Tensor, z: torch.Tensor):
    """Panel trailing update ``(z - q (q^H z), q^H z)`` with ``q`` (l x b)
    one orthonormal panel of the blocked pivoted QR and ``z`` (l x n) the
    trailing residual; on the card ``b <= MAX_PANEL`` (64)."""
    refuse_dtensor("panel_deflate", q, z)
    q, z = _common(q, z)
    if z.device.type == "cpu":
        return panel_deflate_ref(q, z)
    return panel_deflate_kernel(q.contiguous(), z.contiguous())
