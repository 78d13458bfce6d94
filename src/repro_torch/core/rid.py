"""Randomized interpolative decomposition, the paper's core algorithm
(counterpart of ``repro.core.rid``).

Pipeline (paper section 2):
  1. sketch      Y = Phi A          (l x n)
  2. pivoted QR  Y Pi ~= Q [R1 R2]
  3. interp      R1 T = R2, P = [I T] Pi^-1
  4. subset      B = A[:, J]

``rid`` computes on ``A``'s device.  The same ``gen_or_seed`` on the same
device reproduces the same decomposition bit for bit: the gaussian sketch
reduces in fixed blocks (``kernels/sketch_accum``) and steps 2-3 run
through the one function ``_qr_interp``, which a streamed sketch will
share.
"""
from __future__ import annotations

from typing import Optional

import torch

from .qr import pivoted_qr
from .sketch import sketch
from .tsolve import interp_from_qr
from .types import IDResult
from .validate import check_l_ge_k

__all__ = ["rid", "rid_from_sketch"]


def _qr_interp(Y: torch.Tensor, k: int, qr_impl: str, qr_panel,
               qr_norm_recompute):
    """Steps 2-3: pivoted QR of the sketch and the interpolation solve."""
    qr = pivoted_qr(Y, k, impl=qr_impl, panel=qr_panel,
                    norm_recompute=qr_norm_recompute)
    P = interp_from_qr(qr.R, qr.piv)
    return P, qr.piv, qr.Q, qr.R


def _cast_interp(P: torch.Tensor, a_dtype: torch.dtype) -> torch.Tensor:
    """``P`` is in the sketch dtype (complex for SRFT); for a real ``A`` its
    imaginary part is roundoff, since A's row space is real, so keep the
    real part in ``A``'s dtype."""
    if P.is_complex() and not a_dtype.is_complex:
        return P.real.to(a_dtype)
    return P


def rid_from_sketch(A: torch.Tensor, Y: torch.Tensor, k: int, *,
                    qr_impl: str = "blocked", qr_panel=32,
                    qr_norm_recompute="auto") -> IDResult:
    """Steps 2-4 given an existing sketch ``Y`` (l x n)."""
    P, piv, Q, R = _qr_interp(Y, k, qr_impl, qr_panel, qr_norm_recompute)
    B = A.index_select(1, piv.to(A.device))
    return IDResult(B=B, P=_cast_interp(P, A.dtype), J=piv, Q=Q, R=R)


def rid(gen_or_seed, A: torch.Tensor, k: int, *, l: Optional[int] = None,
        sketch_kind: str = "srft", qr_impl: str = "blocked", qr_panel=32,
        qr_norm_recompute="auto", **operator) -> IDResult:
    """Rank-``k`` randomized ID of ``A``: ``A ~= B @ P``.

    Args:
      gen_or_seed: an int seed or a ``torch.Generator`` on ``A``'s device,
        driving the sketch's random operator.
      A: (m, n) matrix, real or complex.
      k: target rank.
      l: sketch rows; defaults to the paper's ``l = 2k``.
      sketch_kind: 'srft' (paper-faithful) | 'srht' | 'gaussian'.
      qr_impl: 'blocked' (panel engine, default) | 'cgs2' (the oracle).
      qr_panel: panel width of the blocked engine, an int or 'auto'.
      qr_norm_recompute: validated for the blocked engine ('auto', or an
        int >= 0); its fused panels recompute norms exactly anyway.
      operator: the sketch's random operator injected instead of drawn
        (``omega=`` for gaussian, ``phases=``/``rows=`` for srft,
        ``signs=``/``rows=`` for srht).
    """
    l = 2 * k if l is None else l
    check_l_ge_k(l, k)
    Y = sketch(gen_or_seed, A, l, kind=sketch_kind, **operator).Y
    return rid_from_sketch(A, Y, k, qr_impl=qr_impl, qr_panel=qr_panel,
                           qr_norm_recompute=qr_norm_recompute)


# ----------------------------------------------------- analysis registry
# The rid entry point as the dataflow pass runs it (repro_torch.analysis), at the
# reference's registration shapes: one eager call on the given device.
# The blocked engine reads one scalar a panel (``qr._panel_ok``) by
# design.

def _analysis_build_rid(device):
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    A = torch.randn((256, 400), generator=gen, device=device)

    def fn(A):
        return rid(0, A, 21, sketch_kind="gaussian")
    return fn, (A,)


def _register_analysis_entries():
    from ..analysis.registry import register
    # k = 21 at the default panel width is one panel.
    register("rid", _analysis_build_rid, max_host_syncs=1)


_register_analysis_entries()
