"""QR factorizations of the sketch (paper eq. 8-9); counterpart of
``repro.core.qr``.

* ``cgs2_pivoted_qr``    -- the paper's iterated classical Gram-Schmidt
  with greedy column pivoting, the parity oracle.
* ``householder_qr`` / ``cholesky_qr2`` -- tall-panel factorizations.
* ``blocked_pivoted_qr`` -- the production engine: pivots are chosen a
  panel at a time by residual norm (``torch.topk``), each panel is
  orthonormalized, and the residual is deflated with one GEMM pair per
  panel.  ``panel_impl="fused"`` (the default) runs each panel through the
  port's ``panel_step`` kernel; 'auto' | 'chol' | 'house' are the split
  parity oracles.
* ``pivoted_qr``         -- the ``impl`` dispatcher, with ``resolve_panel``
  and ``resolve_norm_recompute``.

Where the reference branches on device with ``lax.cond`` (the degenerate
panel check), the port branches on the host: one synchronization per
panel.  ``torch.topk`` may break ties in another order than
``lax.top_k``, so pivot sets are compared on well-separated spectra.

Observability (``repro_torch.obs``), the reference's spans in the one
eager loop: ``pivoted_qr`` opens ``qr.pivoted`` around the engine, or,
for the fused engine under ``tracing(deep=True)``, ``qr.blocked_deep``;
the fused loop opens one ``qr.panel`` span a panel (``engine``,
``panel``, ``off``, ``width``; the ``qr.panels`` counter) and
``qr.final_r``.  A span waits for the device at its close only under deep
tracing, so normal tracing adds no host synchronization, and with no
tracer each costs a ``None`` check.
"""
from __future__ import annotations

import torch

from ..kernels.panel_step import panel_step
from ..obs import trace as obs_trace
from .types import QRResult, real_dtype_of
from .validate import check_panel, check_rank_bounds

__all__ = ["cgs2_pivoted_qr", "blocked_pivoted_qr", "pivoted_qr",
           "householder_qr", "cholesky_qr2", "resolve_panel",
           "resolve_norm_recompute"]


def _tiny(dtype: torch.dtype) -> float:
    return torch.finfo(real_dtype_of(dtype)).tiny


def _colnorms2(Z: torch.Tensor, rdtype: torch.dtype) -> torch.Tensor:
    return (Z.abs() ** 2).sum(0).to(rdtype)


def _masked_res2(Z: torch.Tensor, picked: torch.Tensor,
                 rdtype: torch.dtype) -> torch.Tensor:
    """Residual column norms^2 with picked columns at the -1 sentinel."""
    res2 = _colnorms2(Z, rdtype)
    return torch.where(picked, torch.full_like(res2, -1.0), res2)


def _downdate_res2(res2: torch.Tensor, w: torch.Tensor,
                   p: torch.Tensor) -> torch.Tensor:
    """Downdate norms^2 after pivot ``p`` with coefficients ``w = Z^H q``.
    Picked columns keep their negative sentinel (clamping them to 0 would
    let them be picked again once every live residual is noise)."""
    res2 = torch.where(res2 < 0, res2,
                       torch.clamp(res2 - w.abs() ** 2, min=0))
    return res2.index_fill(0, p.reshape(1), -1.0)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v), min=_tiny(v.dtype))


def cgs2_pivoted_qr(Y: torch.Tensor, k: int) -> QRResult:
    """Greedy-pivoted CGS2 thin QR of the wide sketch ``Y`` (l x n): ``k``
    columns by largest residual norm, each orthonormalized twice against
    the running basis, the residual deflated rank-1 per column.  ``R = Q^H
    Y`` is recomputed at the end."""
    l, n = Y.shape
    check_rank_bounds(k, l, n)
    dtype = Y.dtype
    rdtype = real_dtype_of(dtype)
    Q = torch.zeros((l, k), dtype=dtype, device=Y.device)
    piv = torch.zeros((k,), dtype=torch.int64, device=Y.device)
    Z = Y
    res2 = _colnorms2(Y, rdtype)
    for j in range(k):
        p = torch.argmax(res2)
        v = _normalize(Z.index_select(1, p.reshape(1))[:, 0])
        v = _normalize(v - Q @ (Q.mH @ v))      # columns >= j of Q are zero
        Q[:, j] = v
        piv[j] = p
        w = Z.mH @ v                            # (n,) coefficients Z^H q
        Z = Z - v[:, None] * w.conj()[None, :]
        res2 = _downdate_res2(res2, w, p)
    return QRResult(Q=Q, R=Q.mH @ Y, piv=piv)


def householder_qr(Y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Householder thin QR of a tall panel (l x k, l >= k): ``(Q, R)`` with
    ``Q`` l x k orthonormal and ``R`` k x k upper triangular."""
    l, k = Y.shape
    dtype = Y.dtype
    tiny = _tiny(dtype)
    idx = torch.arange(l, device=Y.device)
    A = Y.clone()
    V = torch.zeros((l, k), dtype=dtype, device=Y.device)
    for j in range(k):
        col = A[:, j]
        tail = torch.where(idx >= j, col, torch.zeros_like(col))
        sigma = torch.linalg.vector_norm(tail).to(dtype)
        ajj = col[j]
        absa = ajj.abs()
        phase = torch.where(absa > 0, ajj / torch.clamp(absa, min=tiny),
                            torch.ones_like(ajj))
        v = tail.clone()
        v[j] = v[j] + phase * sigma
        v = _normalize(v)
        A = A - 2.0 * torch.outer(v, v.conj() @ A)
        V[:, j] = v
    R = torch.triu(A[:k, :])
    Q = torch.eye(l, k, dtype=dtype, device=Y.device)
    for j in reversed(range(k)):
        v = V[:, j]
        Q = Q - 2.0 * torch.outer(v, v.conj() @ Q)
    return Q, R


def cholesky_qr2(Y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """CholeskyQR2 of a tall panel (l x k): two rounds of
    ``Q <- Q chol(Q^H Q)^{-H}``.  A Gram that is not positive definite
    gives a junk factor (no exception), which callers detect."""
    def one_round(Q):
        C = torch.linalg.cholesky_ex(Q.mH @ Q).L      # G = C C^H
        Qn = torch.linalg.solve_triangular(C, Q.mH, upper=False).mH
        return Qn, C
    Q1, C1 = one_round(Y)
    Q2, C2 = one_round(Q1)
    return Q2, C2.mH @ C1.mH


# --------------------------------------------------------------------------
# Blocked-panel pivoted QR
# --------------------------------------------------------------------------

def _panel_ok(Qp: torch.Tensor) -> bool:
    """Host-side check that a panel factor is finite and orthonormal to
    ``sqrt(eps)`` (the reference's ``lax.cond`` predicate)."""
    b = Qp.shape[1]
    eye = torch.eye(b, dtype=Qp.dtype, device=Qp.device)
    err = torch.max(torch.abs(Qp.mH @ Qp - eye))
    eps = torch.finfo(real_dtype_of(Qp.dtype)).eps
    return bool(torch.isfinite(Qp).all() & (err < eps ** 0.5))


def _panel_select_cgs2(Z: torch.Tensor, Q_prev: torch.Tensor,
                       picked: torch.Tensor, b: int):
    """Adaptive per-column pivot selection for one panel, the fallback when
    the top-``b`` candidates are (near-)collinear: ``b`` greedy steps with
    the norms downdated instead of ``Z`` rewritten, each pivot projected
    three times against the prior basis and the panel so far."""
    l = Z.shape[0]
    dtype = Z.dtype
    res2 = _masked_res2(Z, picked, real_dtype_of(dtype))
    Qp = torch.zeros((l, b), dtype=dtype, device=Z.device)
    idx = torch.zeros((b,), dtype=torch.int64, device=Z.device)
    for j in range(b):
        p = torch.argmax(res2)
        v = _normalize(Z.index_select(1, p.reshape(1))[:, 0])
        # Three passes: a noise-floor column can be a bitwise copy of an
        # earlier junk pick, so pass 1 may collapse it into the span.
        for _ in range(3):
            v = v - Q_prev @ (Q_prev.mH @ v)
            v = v - Qp @ (Qp.mH @ v)            # columns >= j still zero
            v = _normalize(v)
        Qp[:, j] = v
        idx[j] = p
        res2 = _downdate_res2(res2, Z.mH @ v, p)
    return Qp, idx


def _panel_orthonormalize(Z, idx, Q_prev, picked, panel_impl: str):
    """Orthonormal basis of ``Z[:, idx]`` against ``Q_prev`` for the split
    engines; 'auto' falls back to the adaptive selection on a degenerate
    CholeskyQR2 factor."""
    C = Z.index_select(1, idx)
    if Q_prev.shape[1]:
        C = C - Q_prev @ (Q_prev.mH @ C)
    if panel_impl == "house":
        return householder_qr(C)[0], idx
    Qp, _ = cholesky_qr2(C)
    if panel_impl == "chol" or _panel_ok(Qp):
        return Qp, idx
    return _panel_select_cgs2(Z, Q_prev, picked, C.shape[1])


def _fused_panel_update(Z, res2, picked, Q, piv, off: int, b: int):
    """One panel of the fused engine: select the top-``b`` residual norms,
    re-project against the prior basis, run ``panel_step`` (factor,
    deflation and the next panel's norms in one kernel call), and fall
    back to the adaptive selection on a degenerate panel."""
    rdtype = real_dtype_of(Z.dtype)
    idx = torch.topk(res2, b).indices
    C = Z.index_select(1, idx)
    if off:                                      # block re-projection
        C = C - Q[:, :off] @ (Q[:, :off].mH @ C)
    Qp, O, _, r2 = panel_step(C, Z, emit_w=False)
    if not _panel_ok(Qp):
        Qp, idx = _panel_select_cgs2(Z, Q[:, :off], picked, b)
        O = Z - Qp @ (Qp.mH @ Z)
        r2 = _colnorms2(O, rdtype)
    picked = picked.index_fill(0, idx, True)
    res2 = torch.where(picked, torch.full_like(res2, -1.0), r2.to(rdtype))
    Q[:, off:off + b] = Qp
    piv[off:off + b] = idx
    return O, res2, picked, Q, piv


def blocked_pivoted_qr(Y: torch.Tensor, k: int, *, panel: int = 32,
                       panel_impl: str = "fused",
                       norm_recompute="auto") -> QRResult:
    """Blocked-panel greedy-pivoted thin QR of the wide sketch ``Y``
    (l x n): per panel of ``b = panel`` pivots, rank the unpicked columns by
    residual norm, orthonormalize the top ``b`` against the prior basis and
    themselves, and deflate the residual with one GEMM pair.

    ``panel_impl="fused"`` runs each panel through ``panel_step``; its
    residual norms come exact from the freshly deflated slab, so
    ``norm_recompute`` (validated, for one API shape with the distributed
    engine) changes nothing here.  Returns ``QRResult(Q, R, piv)`` with
    ``R = Q^H Y``."""
    l, n = Y.shape
    check_rank_bounds(k, l, n)
    check_panel(panel)
    if panel_impl not in ("fused", "auto", "chol", "house"):
        raise ValueError(f"unknown panel_impl {panel_impl!r}")
    resolve_norm_recompute(norm_recompute)
    dtype = Y.dtype
    rdtype = real_dtype_of(dtype)
    Q = torch.zeros((l, k), dtype=dtype, device=Y.device)
    piv = torch.zeros((k,), dtype=torch.int64, device=Y.device)
    picked = torch.zeros((n,), dtype=torch.bool, device=Y.device)
    Z = Y
    off = 0
    if panel_impl == "fused":
        deep = obs_trace.deep_tracing()
        panels_ctr = obs_trace.counter("qr.panels")
        res2 = _masked_res2(Z, picked, rdtype)   # the only full norm pass
        pi = 0
        while off < k:
            b = min(panel, k - off)
            # panel= is the ordinal (the timeline's stragglers attribute
            # by it), off and width locate it in the factorization.
            with obs_trace.span("qr.panel", engine="blocked-fused",
                                panel=pi, off=off, width=b) as sp:
                Z, res2, picked, Q, piv = _fused_panel_update(
                    Z, res2, picked, Q, piv, off, b)
                if deep:
                    sp.block_on((Z, res2, Q))
            panels_ctr.add(1)
            off += b
            pi += 1
        with obs_trace.span("qr.final_r") as sp:
            R = Q.mH @ Y
            if deep:
                sp.block_on(R)
        return QRResult(Q=Q, R=R, piv=piv)
    while off < k:
        b = min(panel, k - off)
        res2 = _masked_res2(Z, picked, rdtype)
        idx = torch.topk(res2, b).indices
        Qp, idx = _panel_orthonormalize(Z, idx, Q[:, :off], picked,
                                        panel_impl)
        Z = Z - Qp @ (Qp.mH @ Z)                 # the one GEMM-pair deflation
        Q[:, off:off + b] = Qp
        piv[off:off + b] = idx
        picked = picked.index_fill(0, idx, True)
        off += b
    return QRResult(Q=Q, R=Q.mH @ Y, piv=piv)


# --------------------------------------------------------------------------
# Fitted panel-width model + norm-recompute cadence (copied from the
# reference: the same constants give the same resolved values)
# --------------------------------------------------------------------------

# Widest power-of-two panel with panel * k <= _WIDTH_TAU * l is taken as
# safe for eq.(3) pivot quality; 16 at the paper's l = 2k.
_WIDTH_TAU = 12.0
_PANEL_WIDTHS = (64, 32, 16, 8)
# 'auto' recompute cadence of the distributed engine: every 8 panels.
_NORM_RECOMPUTE_AUTO = 8


def resolve_panel(panel, k: int, l: int) -> int:
    """Resolve ``panel="auto"`` through the fitted width model; integers
    pass through, any other string is rejected."""
    if isinstance(panel, str):
        if panel == "auto":
            for w in _PANEL_WIDTHS:
                if w * k <= _WIDTH_TAU * l:
                    return w
            return _PANEL_WIDTHS[-1]
        raise ValueError(f"unknown panel {panel!r}; expected an int or 'auto'")
    return panel


def resolve_norm_recompute(norm_recompute) -> int:
    """Resolve the ``norm_recompute`` cadence to an int (``0`` never, ``1``
    every panel, ``"auto"`` every 8); other values are rejected with the
    value received."""
    if norm_recompute is None:
        return 0
    if isinstance(norm_recompute, str):
        if norm_recompute == "auto":
            return _NORM_RECOMPUTE_AUTO
        raise ValueError(f"unknown norm_recompute {norm_recompute!r}; "
                         f"expected an int >= 0 or 'auto'")
    if not isinstance(norm_recompute, int) or norm_recompute < 0:
        raise ValueError(f"need norm_recompute >= 0 (or 'auto'), "
                         f"got {norm_recompute!r}")
    return norm_recompute


def pivoted_qr(Y: torch.Tensor, k: int, *, impl: str = "blocked",
               panel=32, panel_impl: str = "fused",
               norm_recompute="auto") -> QRResult:
    """Dispatch the pivoted QR of the sketch: ``impl="cgs2"`` (the per-column
    oracle) or ``impl="blocked"`` (the panel engine; ``panel`` an int or
    ``"auto"``, ``panel_impl`` and ``norm_recompute`` as in
    ``blocked_pivoted_qr``).  Opens the ``qr.pivoted`` span (``qr.blocked_
    deep`` for the fused engine under deep tracing; module docstring)."""
    if impl not in ("cgs2", "blocked"):
        raise ValueError(
            f"unknown qr impl {impl!r}; expected 'cgs2' or 'blocked'")
    deep = obs_trace.deep_tracing()
    if impl == "cgs2":
        with obs_trace.span("qr.pivoted", impl="cgs2", k=k) as sp:
            out = cgs2_pivoted_qr(Y, k)
            if deep:
                sp.block_on(out)
        return out
    p = resolve_panel(panel, k, Y.shape[0])
    if deep and panel_impl == "fused":
        l, n = Y.shape
        cm = obs_trace.span("qr.blocked_deep", l=l, n=n, k=k, panel=p)
    else:
        cm = obs_trace.span("qr.pivoted", impl="blocked", k=k, panel=p,
                            panel_impl=panel_impl)
    with cm as sp:
        out = blocked_pivoted_qr(Y, k, panel=p, panel_impl=panel_impl,
                                 norm_recompute=norm_recompute)
        if deep:
            sp.block_on(out)
    return out


# ----------------------------------------------------- analysis registry
# The blocked pivoted QR as the dataflow pass runs it (repro_torch.analysis), at the
# reference's registration shapes: one eager call on the given device.
# Panel 7 gives three panels; the engine reads one scalar a panel
# (``_panel_ok``) by design.

def _analysis_build_blocked(device):
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    Y = torch.randn((48, 400), generator=gen, device=device)

    def fn(Y):
        return pivoted_qr(Y, 21, impl="blocked", panel=7)
    return fn, (Y,)


def _register_analysis_entries():
    from ..analysis.registry import register
    register("pivoted_qr.blocked", _analysis_build_blocked, max_host_syncs=3)


_register_analysis_entries()
