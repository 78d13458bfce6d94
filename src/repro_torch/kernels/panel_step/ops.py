"""Public wrappers of the panel kernels (counterpart of
``repro.kernels.panel_step.ops``): ``panel_step`` for the blocked QR, and
its split siblings ``panel_coeff`` / ``panel_apply`` for the distributed
engine (``core/qr_dist.py``).

Dispatch: CPU tensors take the plain versions (``ref.py``); CUDA tensors
launch the Hopper kernels (``kernel.py``) for every real and complex
dtype, or raise.
"""
from __future__ import annotations

import torch

from ..common import refuse_dtensor
from .kernel import panel_apply_kernel, panel_coeff_kernel, panel_step_kernel
from .ref import (panel_apply_norms_ref, panel_apply_ref, panel_coeff_ref,
                  panel_step_ref)

__all__ = ["panel_step", "panel_coeff", "panel_apply"]


def _common(*tensors: torch.Tensor) -> list[torch.Tensor]:
    """The tensors on one device, in their promoted dtype."""
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"tensors must share one device, got "
                         f"{[str(t.device) for t in tensors]}")
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in tensors]


def _check_rows(name: str, panel: torch.Tensor, z: torch.Tensor) -> None:
    if panel.shape[0] != z.shape[0]:
        raise ValueError(f"{name} rows ({panel.shape[0]}) must match z rows "
                         f"({z.shape[0]})")


def panel_step(c: torch.Tensor, z: torch.Tensor, *, emit_w: bool = True):
    """Fused panel step: factor the candidate panel ``c`` (l x b) with
    CholeskyQR2 and sweep the residual ``z`` (l x n), returning
    ``(Q_p, Z - Q_p W, W, colnorms^2(Z - Q_p W))``.  With
    ``emit_w=False`` the ``W`` slot is ``None`` (the kernel skips its
    store; ``blocked_pivoted_qr`` recomputes ``R = Q^H Y`` at the end)."""
    refuse_dtensor("panel_step", c, z)
    _check_rows("c", c, z)
    c, z = _common(c, z)
    if c.device.type == "cpu":
        qp, o, w, r2 = panel_step_ref(c, z)
        return qp, o, (w if emit_w else None), r2
    return panel_step_kernel(c.contiguous(), z.contiguous(), emit_w=emit_w)


def panel_coeff(c: torch.Tensor, z: torch.Tensor, res2: torch.Tensor):
    """Factor and coefficient half (distributed stage A): ``(Q_p, W,
    max(res2 - colnorms^2(W), 0))`` for the candidate panel ``c`` (l x b),
    the residual ``z`` (l x n) and its real norms ``res2`` (n,).  The
    downdated norms make the next panel's pivot collective independent of
    the deflation (stage B), so it can run while ``panel_apply`` does."""
    refuse_dtensor("panel_coeff", c, z, res2)
    _check_rows("c", c, z)
    if tuple(res2.shape) != (z.shape[1],):
        raise ValueError(f"res2 shape {tuple(res2.shape)} must be "
                         f"({z.shape[1]},)")
    c, z = _common(c, z)
    rdtype = c.real.dtype if c.is_complex() else c.dtype
    if res2.device != c.device:
        raise ValueError(f"res2 on {res2.device}, c and z on {c.device}")
    res2 = res2.to(rdtype)
    if c.device.type == "cpu":
        return panel_coeff_ref(c, z, res2)
    return panel_coeff_kernel(c.contiguous(), z.contiguous(),
                              res2.contiguous())


def panel_apply(qp: torch.Tensor, w: torch.Tensor, z: torch.Tensor, *,
                emit_norms: bool = False):
    """Deflation half (distributed stage B): ``z - qp @ w`` with ``w`` from
    ``panel_coeff``.  ``emit_norms=True`` returns ``(O, colnorms^2(O))``
    from the same pass: the exact pivot norms of the deflated slab, which a
    norm-recompute panel puts in place of the drifting downdate."""
    refuse_dtensor("panel_apply", qp, w, z)
    _check_rows("qp", qp, z)
    if tuple(w.shape) != (qp.shape[1], z.shape[1]):
        raise ValueError(f"w shape {tuple(w.shape)} must be "
                         f"{(qp.shape[1], z.shape[1])}")
    qp, w, z = _common(qp, w, z)
    if z.device.type == "cpu":
        if emit_norms:
            return panel_apply_norms_ref(qp, w, z)
        return panel_apply_ref(qp, w, z)
    return panel_apply_kernel(qp.contiguous(), w.contiguous(),
                              z.contiguous(), emit_norms=emit_norms)
