"""Distributed randomized ID over ``torch.distributed`` (counterpart of
``repro.core.distributed``): the paper's parallelization (section 3.2),
``A`` sharded BY COLUMNS over the ranks of a process group ("each
processor owns columns").

SPMD: every rank calls ``rid_distributed`` with its own column block
``A_loc`` (m x n/ndev; rank r owns the global columns
``[r n_loc, (r + 1) n_loc)``, as ``shard_columns`` cuts them) and the same
seed.  Phase costs by ``qr_impl``:

  sketch        : no communication.  Every backend acts on the row index
                  only and every rank draws the same operator from the
                  seed, so each rank's ``Y_loc`` is its columns of the full
                  sketch.
  pivoted QR    :
    'cgs2' /    one all_gather of the l x n_loc sketches, then the
    'blocked'   replicated factorization on every rank: O(l n) memory and
                redundant flops per rank.
    'panel_     no replication (``core.qr_dist``): each rank factors its
    parallel'   own shard in place; per panel of b pivots one l x b
                all_reduce gathering the candidates and one length-n
                all_reduce of the downdated norms, issued before the
                shard's deflation and overlapping it.
  interp solve  : no communication: each rank solves ``R1 T = R2`` for its
                  own column block.

``B = A[:, J]`` is the one cross-shard motion proportional to m: the
owners contribute their columns of the m x k panel, zeros elsewhere, and
one all_reduce replicates it.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .qr import pivoted_qr, resolve_norm_recompute, resolve_panel
from .qr_dist import (AXIS, check_group, gather_columns_psum, global_columns,
                      identity_at_owned_pivots,
                      panel_parallel_rid_interp_local)
from .rid import _cast_interp
from .sketch import sketch
from .tsolve import solve_upper_triangular_lib
from .types import IDResult
from .validate import (check_divides, check_l_ge_k, check_panel,
                       check_rank_bounds)

__all__ = ["rid_distributed", "shard_columns"]

QR_IMPLS = ("cgs2", "blocked", "panel_parallel")


def shard_columns(A: torch.Tensor, group) -> torch.Tensor:
    """This rank's column block of ``A`` (the whole matrix, the same on
    every rank): a contiguous copy of columns ``[r n/ndev, (r+1) n/ndev)``.
    Raises unless ``n`` divides the group evenly."""
    check_group(group, A)
    ndev = dist.get_world_size(group)
    n = A.shape[1]
    check_divides(n, ndev, AXIS)
    n_loc = n // ndev
    r = dist.get_rank(group)
    return A[:, r * n_loc:(r + 1) * n_loc].contiguous()


def _all_gather_columns(Y_loc: torch.Tensor, group) -> torch.Tensor:
    """The l x n sketch on every rank from the ranks' column blocks."""
    check_group(group, Y_loc)
    Y_loc = Y_loc.contiguous()
    parts = [torch.empty_like(Y_loc)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, Y_loc, group=group)
    return torch.cat(parts, dim=1)


def rid_distributed(gen_or_seed, A_loc: torch.Tensor, k: int, *, group,
                    l: Optional[int] = None, sketch_kind: str = "gaussian",
                    qr_impl: str = "blocked", qr_panel=32,
                    qr_norm_recompute="auto") -> IDResult:
    """Rank-``k`` randomized ID of a column-sharded ``A``; every rank of
    ``group`` calls it with its block ``A_loc`` and the same
    ``gen_or_seed`` (an int, or generators in the same state).

    Returns an ``IDResult`` whose ``P`` is this rank's column block
    ``P_loc`` (k x n_loc), ``B`` the replicated m x k pivot columns, and
    ``J``/``Q`` replicated.  ``R`` is this rank's column block on
    'panel_parallel' and replicated on 'cgs2'/'blocked'.  ``qr_impl``:

      'cgs2' / 'blocked'  -- gather the sketch and factor it on every rank
                             (bitwise identical, from identical inputs);
      'panel_parallel'    -- factor the column shards in place
                             (``core.qr_dist``), no l x n sketch per rank.

    ``qr_panel`` is the panel width for 'blocked' and 'panel_parallel' (an
    int, or 'auto'); ``qr_norm_recompute`` the fused panel loop's
    exact-norm cadence ('auto' = every 8 panels)."""
    l = 2 * k if l is None else l
    check_l_ge_k(l, k)
    if qr_impl not in QR_IMPLS:
        raise ValueError(f"unknown qr impl {qr_impl!r}; expected one of "
                         f"{QR_IMPLS}")
    qr_panel = resolve_panel(qr_panel, k, l)
    check_panel(qr_panel, name="qr_panel")
    resolve_norm_recompute(qr_norm_recompute)
    n = global_columns(A_loc, group)
    check_rank_bounds(k, l, n)

    Y_loc = sketch(gen_or_seed, A_loc, l, kind=sketch_kind).Y
    if qr_impl == "panel_parallel":
        P_loc, piv, Q, R = panel_parallel_rid_interp_local(
            Y_loc, k, group=group, panel=qr_panel,
            norm_recompute=qr_norm_recompute)
    else:
        qr = pivoted_qr(_all_gather_columns(Y_loc, group), k, impl=qr_impl,
                        panel=qr_panel, norm_recompute=qr_norm_recompute)
        piv, Q, R = qr.piv, qr.Q, qr.R
        P_loc = solve_upper_triangular_lib(R.index_select(1, piv),
                                           Q.mH @ Y_loc)
        P_loc = identity_at_owned_pivots(P_loc, piv, group)
    B = gather_columns_psum(A_loc, piv, group)
    return IDResult(B=B, P=_cast_interp(P_loc, A_loc.dtype), J=piv, Q=Q,
                    R=R)


# ----------------------------------------------------- analysis registry
# The distributed ID as the dataflow pass runs it (repro_torch.analysis), at the
# reference's registration shapes: one eager call on the given device.
# On the default process group.  The panel-parallel path must never
# materialize an l x n collective (budget l n - 1 at l = 24); the
# gathering 'blocked' path does so by design (budget l n).  Host reads by
# design: one scalar a panel (two panels) and ``global_columns``'s shard
# sizes, one a rank (one rank in the CLI's group).

def _analysis_build_rid_distributed(qr_impl: str):
    def build(device):
        group = dist.group.WORLD
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        A = torch.randn((64, 400), generator=gen, device=device)

        def fn(A):
            return rid_distributed(0, shard_columns(A, group), 12,
                                   group=group, qr_impl=qr_impl, qr_panel=7)
        return fn, (A,)
    return build


def _register_analysis_entries():
    from ..analysis.registry import register
    l, n = 24, 400
    register("rid_distributed.panel_parallel",
             _analysis_build_rid_distributed("panel_parallel"),
             max_collective_elems=l * n - 1,
             max_host_syncs=3, tags=("distributed",))
    register("rid_distributed.blocked",
             _analysis_build_rid_distributed("blocked"),
             max_collective_elems=l * n, max_host_syncs=3,
             tags=("distributed",))


_register_analysis_entries()
