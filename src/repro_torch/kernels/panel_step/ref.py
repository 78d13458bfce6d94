"""Plain PyTorch versions of the panel kernels (real and complex): the
fused panel step and its two halves for the distributed engine,
``panel_coeff`` (factor, W, downdated norms) and ``panel_apply`` (the
deflation, with or without its column norms).

It follows the TPU kernel (``repro/kernels/panel_step/kernel.py``), not
the JAX ``ref.py``: CholeskyQR2 with the Yamamoto correction (round 2
factors the computed ``Q1``), where each Cholesky is the right-looking
loop of ``_chol_masked`` (``L[:, j] = G[:, j] / sqrt(diag)``) and each
right solve the forward substitution of ``_solve_right_lt``.

Degenerate pivots.  ``_chol_masked`` clamps a pivot at the dtype's
``tiny``; that keeps the square root real but not the panel finite (a
duplicate-column f32 panel gives ``-inf`` there), and a pivot that is
rounding noise just above ``tiny`` yields an orthonormal junk column that
no check can see.  Here a pivot is *dead* when its Schur-complement
diagonal is at most ``max(tiny, b * eps * G0[j, j])``, ``G0`` the Gram
matrix before elimination: below that the value is rounding noise of the
``b`` elimination steps.  A dead column of ``L`` is zero, eliminates
nothing, and its column of the solve's result is zero.  A degenerate panel
therefore yields a finite ``Q_p`` with a zero column, which fails the
callers' ``||Q_p^H Q_p - I||`` check, never a NaN; the CUDA kernel applies
the same rule, so the two agree on such panels too.
"""
from __future__ import annotations

import torch

__all__ = ["chol_clamped", "solve_right_lh", "factor_cholqr2",
           "colnorms2", "panel_step_ref", "panel_coeff_ref",
           "panel_apply_ref", "panel_apply_norms_ref"]


def chol_clamped(G: torch.Tensor) -> torch.Tensor:
    """Lower ``L`` with ``G ~= L L^H`` by ``b`` right-looking rank-1 steps;
    dead pivots (module docstring) give a zero column."""
    b = G.shape[0]
    rdtype = G.real.dtype if G.is_complex() else G.dtype
    fi = torch.finfo(rdtype)
    floor = torch.clamp(G.diagonal().real * (b * fi.eps), min=fi.tiny)
    A = G.clone()
    for j in range(b):
        diag = A[j, j].real
        live = diag > floor[j]
        s = torch.sqrt(torch.where(live, diag, torch.ones_like(diag)))
        lj = torch.where(live, A[:, j] / s, torch.zeros_like(A[:, j]))
        lj[j] = torch.where(live, diag / s, torch.zeros_like(diag))
        lj[:j] = 0
        A[:, j + 1:] -= lj[:, None] * lj[j + 1:].conj()[None, :]
        A[:, j] = lj
    return torch.tril(A)


def solve_right_lh(C: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """``X = C L^{-H}`` for lower-triangular ``L``: forward substitution
    over columns, ``X[:, j] = (C[:, j] - X[:, :j] L[j, :j]^H) / L[j, j]``;
    a dead column (``L[j, j] == 0``) gives ``X[:, j] = 0``."""
    X = torch.zeros_like(C)
    for j in range(C.shape[1]):
        d = L[j, j].real
        live = d > 0
        s = X[:, :j] @ L[j, :j].conj()
        X[:, j] = torch.where(live, (C[:, j] - s)
                              / torch.where(live, d, torch.ones_like(d)),
                              torch.zeros_like(s))
    return X


def factor_cholqr2(c: torch.Tensor) -> torch.Tensor:
    """``Q_p = C (L2 L1)^{-H}``: two Gram -> Cholesky -> solve rounds."""
    L1 = chol_clamped(c.mH @ c)
    Q1 = solve_right_lh(c, L1)
    L2 = chol_clamped(Q1.mH @ Q1)
    return solve_right_lh(Q1, L2)


def colnorms2(x: torch.Tensor) -> torch.Tensor:
    """Squared column norms, real."""
    return (x.real.square() + x.imag.square() if x.is_complex()
            else x.square()).sum(0)


def panel_step_ref(c: torch.Tensor, z: torch.Tensor):
    """``(Q_p, Z - Q_p W, W, colnorms^2(Z - Q_p W))`` with
    ``Q_p = cholqr2(c)`` and ``W = Q_p^H z``; the norms are real."""
    qp = factor_cholqr2(c)
    w = qp.mH @ z
    o = z - qp @ w
    return qp, o, w, colnorms2(o)


def panel_coeff_ref(c: torch.Tensor, z: torch.Tensor, res2: torch.Tensor):
    """``(Q_p, W, max(res2 - colnorms^2(W), 0))``: the factor and
    coefficient half of the panel (stage A of the distributed panel), with
    the residual norms downdated instead of recomputed (exact for an
    orthonormal panel, by Pythagoras); ``res2`` is real."""
    qp = factor_cholqr2(c)
    w = qp.mH @ z
    return qp, w, torch.clamp(res2 - colnorms2(w), min=0)


def panel_apply_ref(qp: torch.Tensor, w: torch.Tensor,
                    z: torch.Tensor) -> torch.Tensor:
    """``Z - Q_p W`` with ``W`` given (stage B)."""
    return z - qp @ w


def panel_apply_norms_ref(qp: torch.Tensor, w: torch.Tensor,
                          z: torch.Tensor):
    """``(Z - Q_p W, colnorms^2(Z - Q_p W))``: stage B on a norm-recompute
    panel, the deflated slab and its exact column norms."""
    o = z - qp @ w
    return o, colnorms2(o)
