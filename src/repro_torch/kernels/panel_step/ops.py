"""Public wrapper of the fused panel step (counterpart of
``repro.kernels.panel_step.ops.panel_step``).

Dispatch: CPU tensors take the plain version (``ref.py``); CUDA tensors
launch the Hopper kernels (``kernel.py``) for every real and complex
dtype, or raise.
"""
from __future__ import annotations

import torch

from .kernel import panel_step_kernel
from .ref import panel_step_ref

__all__ = ["panel_step"]


def panel_step(c: torch.Tensor, z: torch.Tensor, *, emit_w: bool = True):
    """Fused panel step: factor the candidate panel ``c`` (l x b) with
    CholeskyQR2 and sweep the residual ``z`` (l x n), returning
    ``(Q_p, Z - Q_p W, W, colnorms^2(Z - Q_p W))``.  With
    ``emit_w=False`` the ``W`` slot is ``None`` (the kernel skips its
    store; ``blocked_pivoted_qr`` recomputes ``R = Q^H Y`` at the end)."""
    l, b = c.shape
    l2, n = z.shape
    if l != l2:
        raise ValueError(f"c rows ({l}) must match z rows ({l2})")
    if c.device != z.device:
        raise ValueError(f"c and z must share one device, got {c.device} "
                         f"and {z.device}")
    dt = torch.promote_types(c.dtype, z.dtype)
    c, z = c.to(dt), z.to(dt)
    if c.device.type == "cpu":
        qp, o, w, r2 = panel_step_ref(c, z)
        return qp, o, (w if emit_w else None), r2
    return panel_step_kernel(c.contiguous(), z.contiguous(), emit_w=emit_w)
