"""Panel-parallel distributed pivoted QR of a column-sharded sketch
(counterpart of ``repro.core.qr_dist``), SPMD over the ranks of a
``torch.distributed`` process group.

Every rank calls these functions with its own column block ``Y_loc``
(l x n_loc; rank r owns the global columns ``[r n_loc, (r + 1) n_loc)``)
and factors it in place; no rank ever holds the l x n sketch:

  * pivots come from replicated residual norms: each rank scatters its
    masked local norms into its slot of a length-n zero vector and one
    ``all_reduce(SUM)`` assembles them (``_scatter_res2_psum``);
  * the owners contribute the candidate columns, zeros elsewhere, and one
    l x b ``all_reduce`` replicates the panel (``gather_columns_psum``;
    each global column lives on one rank, so the sum is an exact gather);
  * ``panel_impl="fused"`` (the default) runs stage A through the
    ``panel_coeff`` kernel (factor of the replicated panel, ``W = Q_p^H
    Z_loc`` and the downdated norms) and stage B through ``panel_apply``
    (``Z_loc -= Q_p W``).  The norm collective of panel p+1 is issued
    asynchronously from stage A's downdated norms BEFORE stage B runs, and
    waited on just before the next ``topk``: it overlaps the deflation.
    Every ``norm_recompute`` panels (``"auto"`` = 8) stage B emits the
    deflated shard's exact norms instead (``panel_apply(...,
    emit_norms=True)``) and the collective is issued after it, which
    bounds the downdate's drift;
  * ``panel_impl="gram"`` is the serialized oracle: ``panel_gram``, the
    b x b Cholesky solves, the deflation, and norms recomputed from the
    deflated shard before every panel.

From the reference's ``shard_map`` to ranks: ``mesh`` + ``axis`` become
the required keyword ``group``, ``lax.axis_index`` is
``dist.get_rank(group)``, ``psum`` is ``all_reduce(SUM)``.  The
reference's on-device ``lax.cond`` fallback for a degenerate panel is the
host check ``_panel_ok`` followed by Householder.  Every rank takes the
same branch, because the check reads only ``Q_p``, which a deterministic
kernel computes from the replicated panel; ``Q`` and ``piv`` come out
bitwise identical on every rank.

The backend must match the tensors: CUDA tensors need an NCCL group, CPU
tensors a gloo group.  A gloo group given CUDA tensors raises, because
gloo would stage them through host memory.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels.panel_gram import panel_gram
from ..kernels.panel_step import panel_apply, panel_coeff
from .qr import (_colnorms2, _masked_res2, _panel_ok, householder_qr,
                 resolve_norm_recompute)
from .tsolve import solve_upper_triangular_lib
from .types import QRResult, real_dtype_of
from .validate import check_divides, check_panel, check_rank_bounds

__all__ = ["panel_parallel_pivoted_qr", "panel_parallel_qr_local",
           "panel_parallel_rid_interp_local", "gather_columns_psum",
           "identity_at_owned_pivots", "check_group"]

# Name of the sharded axis in validation messages.
AXIS = "ranks"


def check_group(group, t: torch.Tensor) -> None:
    """Require a process group whose backend moves ``t``'s device: NCCL
    for CUDA tensors, gloo for CPU tensors."""
    if not isinstance(group, dist.ProcessGroup):
        raise TypeError(f"group must be a torch.distributed.ProcessGroup, "
                        f"got {type(group).__name__}")
    backend = str(dist.get_backend(group))
    need = "nccl" if t.device.type == "cuda" else "gloo"
    if need not in backend:
        raise ValueError(f"tensors on {t.device} need a {need} process "
                         f"group, got backend {backend!r}")


def _psum(t: torch.Tensor, group, *, async_op: bool = False):
    """In-place ``all_reduce(SUM)`` of ``t`` over ``group``; the work
    handle when ``async_op``."""
    check_group(group, t)
    return dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group,
                           async_op=async_op)


def global_columns(X_loc: torch.Tensor, group, *, ctx: str = "") -> int:
    """Column count ``n`` of a column-sharded array: one ``all_gather`` of
    the ranks' ``n_loc``.  Raises unless ``n`` divides the group evenly and
    every rank holds ``n / ndev`` columns."""
    check_group(group, X_loc)
    ndev = dist.get_world_size(group)
    mine = torch.tensor([X_loc.shape[1]], dtype=torch.int64,
                        device=X_loc.device)
    sizes = [torch.empty_like(mine) for _ in range(ndev)]
    dist.all_gather(sizes, mine, group=group)
    sizes = [int(s) for s in sizes]
    n = sum(sizes)
    check_divides(n, ndev, AXIS, ctx=ctx)
    if len(set(sizes)) != 1:
        raise ValueError(f"{ctx}column shards must be equal, got "
                         f"n_loc={sizes}")
    return n


def gather_columns_psum(Z_loc: torch.Tensor, idx: torch.Tensor, group
                        ) -> torch.Tensor:
    """Gather GLOBAL columns ``idx`` from a column-sharded array: every
    rank contributes the columns it owns (zeros elsewhere) and one
    ``all_reduce`` replicates the l x b panel, an exact gather."""
    n_loc = Z_loc.shape[1]
    loc = idx - dist.get_rank(group) * n_loc
    owned = (loc >= 0) & (loc < n_loc)
    cols = Z_loc.index_select(1, loc.clamp(0, n_loc - 1))
    contrib = torch.where(owned[None, :], cols,
                          torch.zeros((), dtype=Z_loc.dtype,
                                      device=Z_loc.device))
    _psum(contrib, group)
    return contrib


def _scatter_res2_psum(res2_loc: torch.Tensor, n: int, group, *,
                       async_op: bool = False):
    """The replicated length-``n`` pivot norms from each rank's length-
    ``n_loc`` masked local norms: scattered into the rank's slot of a zero
    vector, one ``all_reduce``.  Returns ``(res2, work)``; with
    ``async_op`` the sum is complete only after ``work.wait()``, else
    ``work`` is ``None``."""
    n_loc = res2_loc.shape[0]
    off = dist.get_rank(group) * n_loc
    contrib = torch.zeros((n,), dtype=res2_loc.dtype, device=res2_loc.device)
    contrib[off:off + n_loc] = res2_loc
    return contrib, _psum(contrib, group, async_op=async_op)


def _masked_local_res2(Z_loc: torch.Tensor, picked: torch.Tensor
                       ) -> torch.Tensor:
    """Local residual norms^2 with picked columns at the -1 sentinel."""
    return _masked_res2(Z_loc, picked, real_dtype_of(Z_loc.dtype))


def _global_res2(Z_loc: torch.Tensor, picked: torch.Tensor, n: int, group
                 ) -> torch.Tensor:
    """Replicated length-``n`` residual norms^2, recomputed from the
    deflated shard (the 'gram' oracle path)."""
    return _scatter_res2_psum(_masked_local_res2(Z_loc, picked), n, group)[0]


def _cholesky_or_nan(G: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of ``G``, all NaN where it does not exist (the
    reference's ``jnp.linalg.cholesky``), so a degenerate panel fails the
    caller's check instead of yielding a partial factor."""
    L, info = torch.linalg.cholesky_ex(G)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def _panel_qp_w(C: torch.Tensor, Z_loc: torch.Tensor):
    """CholeskyQR2 of the replicated candidate panel ``C`` (l x b) through
    the ``panel_gram`` pass, returning ``(Q_p, W = Q_p^H Z_loc)``.  Round 1
    factors the kernel's Gram (``Q1 = C L1^{-H}``) and maps its coefficient
    block with the same solve; round 2 re-orthonormalizes the computed
    ``Q1`` (Yamamoto's correction).  ``Z_loc`` is read once, in the
    kernel."""
    G, V = panel_gram(C, Z_loc)
    L1 = _cholesky_or_nan(G)
    Q1 = torch.linalg.solve_triangular(L1, C.mH, upper=False).mH
    L2 = _cholesky_or_nan(Q1.mH @ Q1)
    Qp = torch.linalg.solve_triangular(L2, Q1.mH, upper=False).mH
    W = torch.linalg.solve_triangular(
        L2, torch.linalg.solve_triangular(L1, V, upper=False), upper=False)
    return Qp, W


def _mark_owned(picked: torch.Tensor, idx: torch.Tensor,
                off: int) -> torch.Tensor:
    """``picked`` with the global pivots ``idx`` this rank owns set."""
    n_loc = picked.shape[0]
    loc = idx - off
    owned = (loc >= 0) & (loc < n_loc)
    hit = torch.zeros((n_loc + 1,), dtype=torch.bool, device=picked.device)
    hit[torch.where(owned, loc, n_loc)] = True   # others: the spare slot
    return picked | hit[:n_loc]


def _check_panel_impl(panel_impl: str, ctx: str) -> None:
    if panel_impl not in ("fused", "gram"):
        raise ValueError(f"{ctx}unknown panel_impl {panel_impl!r}; "
                         f"expected 'fused' or 'gram'")


def panel_parallel_qr_local(Y_loc: torch.Tensor, k: int, *, group,
                            panel: int = 32, panel_impl: str = "fused",
                            norm_recompute="auto"):
    """Per-rank body of the panel-parallel pivoted QR: ``Y_loc`` is this
    rank's l x n_loc column block of the sketch (module docstring).

    Returns ``(Q, piv, R_loc)``: ``Q`` (l x k) and the global pivots
    ``piv`` (k,) are bitwise identical on every rank; ``R_loc = Q^H Y_loc``
    (k x n_loc) stays sharded."""
    ctx = "panel_parallel_qr_local: "
    check_group(group, Y_loc)
    ndev = dist.get_world_size(group)
    l, n_loc = Y_loc.shape
    check_rank_bounds(k, l, n_loc * ndev, ctx=ctx)
    check_panel(panel, ctx=ctx)
    _check_panel_impl(panel_impl, ctx)
    recompute_every = resolve_norm_recompute(norm_recompute)
    n = n_loc * ndev
    dtype, dev = Y_loc.dtype, Y_loc.device
    rdtype = real_dtype_of(dtype)
    off = dist.get_rank(group) * n_loc

    Q = torch.zeros((l, k), dtype=dtype, device=dev)
    piv = torch.zeros((k,), dtype=torch.int64, device=dev)
    picked = torch.zeros((n_loc,), dtype=torch.bool, device=dev)
    Z = Y_loc
    pos = 0
    if panel_impl == "fused":
        # Prologue: panel 0's norms from the undeflated shard.
        res2_loc = _masked_local_res2(Z, picked)
        res2_g, work = _scatter_res2_psum(res2_loc, n, group, async_op=True)
        p_i = 0                                  # panel counter (cadence)
        while pos < k:
            b = min(panel, k - pos)
            # 1. pivots from the collective issued last panel.
            work.wait()
            idx = torch.topk(res2_g, b).indices
            # 2. candidate gather, then re-projection off the prior basis.
            C = gather_columns_psum(Z, idx, group)
            if pos:
                C = C - Q[:, :pos] @ (Q[:, :pos].mH @ C)
            # 3. stage A: factor of the replicated panel, W, downdated norms.
            Qp, W, r2d = panel_coeff(C, Z, res2_loc)
            if not _panel_ok(Qp):
                Qp = householder_qr(C)[0]
                W = Qp.mH @ Z
                r2d = torch.clamp(res2_loc - _colnorms2(W, rdtype), min=0)
            # 4. bookkeeping for the pivots every rank agreed on.
            picked = _mark_owned(picked, idx, off)
            p_i += 1
            more = pos + b < k
            sentinel = torch.full_like(r2d, -1.0)
            if more and recompute_every and p_i % recompute_every == 0:
                # Recompute panel: stage B emits the deflated shard's exact
                # norms, and the collective is issued from those.
                Z, r2x = panel_apply(Qp, W, Z, emit_norms=True)
                res2_loc = torch.where(picked, sentinel, r2x)
                res2_g, work = _scatter_res2_psum(res2_loc, n, group,
                                                  async_op=True)
            else:
                # Issue panel p+1's collective from the downdated norms
                # BEFORE stage B: it does not depend on the deflation.
                res2_loc = torch.where(picked, sentinel, r2d)
                if more:
                    res2_g, work = _scatter_res2_psum(res2_loc, n, group,
                                                      async_op=True)
                # 5. stage B: deflate this rank's shard.
                Z = panel_apply(Qp, W, Z)
            Q[:, pos:pos + b] = Qp
            piv[pos:pos + b] = idx
            pos += b
        return Q, piv, Q.mH @ Y_loc
    while pos < k:
        b = min(panel, k - pos)
        res2 = _global_res2(Z, picked, n, group)
        idx = torch.topk(res2, b).indices
        C = gather_columns_psum(Z, idx, group)
        if pos:
            C = C - Q[:, :pos] @ (Q[:, :pos].mH @ C)
        Qp, W = _panel_qp_w(C, Z)
        if not _panel_ok(Qp):
            Qp = householder_qr(C)[0]
            W = Qp.mH @ Z
        Z = Z - Qp @ W
        picked = _mark_owned(picked, idx, off)
        Q[:, pos:pos + b] = Qp
        piv[pos:pos + b] = idx
        pos += b
    return Q, piv, Q.mH @ Y_loc


def identity_at_owned_pivots(P_loc: torch.Tensor, piv: torch.Tensor,
                             group) -> torch.Tensor:
    """Exact identity in the pivot columns this rank owns: the
    interpolation matrix is the identity there by construction, so write it
    exactly instead of through the solve's roundoff."""
    n_loc = P_loc.shape[1]
    cols = dist.get_rank(group) * n_loc + torch.arange(n_loc,
                                                       device=P_loc.device)
    match = cols[None, :] == piv[:, None]                    # (k, n_loc)
    return torch.where(match.any(0)[None, :], match.to(P_loc.dtype), P_loc)


def panel_parallel_rid_interp_local(Y_loc: torch.Tensor, k: int, *, group,
                                    panel: int = 32,
                                    panel_impl: str = "fused",
                                    norm_recompute="auto"):
    """Per-rank QRCP and interpolation: ``panel_parallel_qr_local``, then
    ``R1 = R[:, piv]`` by a k x k gather, and each rank solves
    ``R1 P_loc = R_loc`` for its own column block with no communication
    (the paper's "column-wise in parallel"); owned pivot columns are
    written as exact identity.  Returns ``(P_loc, piv, Q, R_loc)``."""
    Q, piv, R_loc = panel_parallel_qr_local(
        Y_loc, k, group=group, panel=panel, panel_impl=panel_impl,
        norm_recompute=norm_recompute)
    R1 = gather_columns_psum(R_loc, piv, group)
    P_loc = solve_upper_triangular_lib(R1, R_loc)
    P_loc = identity_at_owned_pivots(P_loc, piv, group)
    return P_loc, piv, Q, R_loc


def panel_parallel_pivoted_qr(Y_loc: torch.Tensor, k: int, *, group,
                              panel: int = 32, panel_impl: str = "fused",
                              norm_recompute="auto") -> QRResult:
    """Entry point of the panel-parallel pivoted QR: every rank of
    ``group`` passes its equal column block ``Y_loc`` of the wide sketch
    (l x n).  ``panel_impl`` picks the per-panel engine ('fused', the
    overlapped kernel path, or 'gram', the serialized oracle) and
    ``norm_recompute`` the fused path's exact-norm cadence.  Returns
    ``QRResult(Q, R, piv)`` with ``Q``/``piv`` replicated and ``R`` this
    rank's column block."""
    ctx = "panel_parallel_pivoted_qr: "
    l = Y_loc.shape[0]
    n = global_columns(Y_loc, group, ctx=ctx)
    check_rank_bounds(k, l, n, ctx=ctx)
    check_panel(panel, ctx=ctx)
    _check_panel_impl(panel_impl, ctx)
    resolve_norm_recompute(norm_recompute)
    Q, piv, R_loc = panel_parallel_qr_local(
        Y_loc, k, group=group, panel=panel, panel_impl=panel_impl,
        norm_recompute=norm_recompute)
    return QRResult(Q=Q, R=R_loc, piv=piv)


# ----------------------------------------------------- analysis registry
# The per-rank panel-parallel QR as the dataflow pass runs it (repro_torch.analysis), at the
# reference's registration shapes: one eager call on the given device.
# On the default process group; panel=7 gives three panels, and 400
# columns divide any world up to 8 ranks.  The fused path must keep each
# panel's norm all_reduce in flight across the previous panel's
# ``panel_apply``; the gram path is the serialized oracle and the
# in-registry positive control (``expect_overlap=False``).  Both read one
# scalar a panel (``_panel_ok``) by design.

def _analysis_build(panel_impl: str):
    def build(device):
        group = dist.group.WORLD
        l, n, k, b = 48, 400, 21, 7
        ndev = dist.get_world_size(group)
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        Y = torch.randn((l, n), generator=gen, device=device)
        r = dist.get_rank(group)
        Y_loc = Y[:, r * (n // ndev):(r + 1) * (n // ndev)].contiguous()

        def fn(Y_loc):
            return panel_parallel_qr_local(Y_loc, k, group=group, panel=b,
                                           panel_impl=panel_impl)
        return fn, (Y_loc,)
    return build


def _register_analysis_entries():
    from ..analysis.registry import OverlapSpec, register
    l, n = 48, 400
    register("panel_parallel_qr_local.fused", _analysis_build("fused"),
             overlap=OverlapSpec(norm_shape=(n,), deflate="panel_apply"),
             max_collective_elems=l * n - 1,
             max_host_syncs=3, tags=("distributed",))
    register("panel_parallel_qr_local.gram", _analysis_build("gram"),
             overlap=OverlapSpec(norm_shape=(n,), deflate="sub",
                                 deflate_shape=(l, -1),
                                 expect_overlap=False),
             max_collective_elems=l * n - 1,
             max_host_syncs=3,
             tags=("control", "distributed"))


_register_analysis_entries()
