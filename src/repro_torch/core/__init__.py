"""Core randomized low-rank decomposition library of the port.

  rid, rid_from_sketch       -- randomized interpolative decomposition A ~= B P
  rsvd, rsvd_from_id         -- randomized SVD built on the ID
  sketch / srft / srht / gaussian -- the randomization operators (paper eq. 4)
  cgs2_pivoted_qr            -- the paper's iterated classical Gram-Schmidt QR
  blocked_pivoted_qr         -- blocked-panel pivoted QR (panel_impl="fused"
                                runs each panel through the panel_step kernel)
  pivoted_qr, resolve_panel, resolve_norm_recompute
  householder_qr, cholesky_qr2
  panel_parallel_pivoted_qr  -- distributed pivoted QR of a column-sharded
                                sketch over torch.distributed (qr_dist)
  rid_distributed, shard_columns -- the column-parallel ID (paper section 3)
  solve_upper_triangular, interp_from_qr -- the interpolation solve
  spectral_error, error_bound, expected_sigma_kp1 -- paper eq. (3) tools
"""
from .errors import (error_bound, expected_sigma_kp1, spectral_error,
                     spectral_norm_dense)
from .distributed import rid_distributed, shard_columns
from .qr import (blocked_pivoted_qr, cgs2_pivoted_qr, cholesky_qr2,
                 householder_qr, pivoted_qr, resolve_norm_recompute,
                 resolve_panel)
from .qr_dist import (gather_columns_psum, identity_at_owned_pivots,
                      panel_parallel_pivoted_qr, panel_parallel_qr_local,
                      panel_parallel_rid_interp_local)
from .rid import rid, rid_from_sketch
from .rsvd import rsvd, rsvd_from_id
from .sketch import (finalize_gaussian_sketch, fwht, gaussian_omega_cols,
                     gaussian_sketch, next_pow2, sketch, srft_sketch,
                     srht_sketch)
from .tsolve import (interp_from_qr, solve_upper_triangular,
                     solve_upper_triangular_lib)
from .types import IDResult, QRResult, SketchResult, SVDResult

__all__ = [
    "rid", "rid_from_sketch", "rsvd", "rsvd_from_id",
    "sketch", "srft_sketch", "srht_sketch", "gaussian_sketch",
    "gaussian_omega_cols", "finalize_gaussian_sketch", "fwht", "next_pow2",
    "cgs2_pivoted_qr", "blocked_pivoted_qr", "pivoted_qr", "resolve_panel",
    "resolve_norm_recompute", "householder_qr", "cholesky_qr2",
    "panel_parallel_pivoted_qr", "panel_parallel_qr_local",
    "panel_parallel_rid_interp_local", "gather_columns_psum",
    "identity_at_owned_pivots", "rid_distributed", "shard_columns",
    "solve_upper_triangular", "solve_upper_triangular_lib", "interp_from_qr",
    "spectral_error", "spectral_norm_dense", "error_bound",
    "expected_sigma_kp1",
    "IDResult", "QRResult", "SketchResult", "SVDResult",
]
