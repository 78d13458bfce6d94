"""Paper Table 3 on the port: the Gram-Schmidt phase (dominated by k, the
paper's non-scaling bottleneck).

Columns, on a Gaussian sketch-shaped ``Y`` (l x n): the paper's CGS2
(``cgs2_pivoted_qr``), the blocked-panel pivoted QR on the ``panel_step``
kernel at each panel width of ``--panels`` with its best speedup over
CGS2, Householder and CholeskyQR2 on the (l x k) panel ``Y[:, :k]``, and
the two CGS kernels: ``project_out`` against an orthonormal (l x k) basis
(``cuda_deflate_s``) and ``panel_deflate`` against its first
``min(32, k)`` columns (``cuda_panel_deflate_s``).  Then the acceptance
rows at ``l=256, n=4096, k=128`` in f32 (blocked against CGS2), and the
fused ``panel_step`` loop against the split ``panel_gram`` +
``panel_deflate`` loop it replaces (``fused_vs_split_sweep``).  The JAX
harness printed CPU targets beside the ratios (2x, 1.5x); they do not
carry over to the card, and nothing here is gated on them.  On the CPU
every column runs the plain versions.

    python -m repro_torch.benchmarks.bench_qr [--full] [--device cuda|cpu]
        [--panels 16 32 64] [--json PATH]
"""
from __future__ import annotations

import torch

from ..configs import PAPER_GRID, SMALL_GRID
from ..core import (blocked_pivoted_qr, cgs2_pivoted_qr, cholesky_qr2,
                    householder_qr)
from ..core.qr import _masked_res2
from ..core.rng import check_device
from ..core.types import real_dtype_of
from ..kernels.cgs import panel_deflate, project_out
from ..kernels.panel_gram import panel_gram
from .common import (append_json_rows, cli_parser, emit, finish, randn,
                     time_fn)

__all__ = ["PANEL_SWEEP", "split_blocked_qr", "fused_flops",
           "fused_vs_split_sweep", "acceptance", "run", "main"]

PANEL_SWEEP = (16, 32, 64)
# The acceptance shape of the blocked engine and of the fused panel step.
ACCEPT_L, ACCEPT_N, ACCEPT_K = 256, 4096, 128


def _dname(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def split_blocked_qr(Y: torch.Tensor, k: int, panel: int):
    """The split panel loop that the fused ``panel_step`` replaces: per
    panel, a full residual-norm pass, the ``panel_gram`` kernel and two
    Cholesky rounds with triangular solves for the panel factor, and the
    ``panel_deflate`` kernel for the trailing update (which derives the
    coefficient block again): three reads of the residual per panel where
    the fused path makes one.  Returns ``(Q, Q^H Y, piv)``."""
    l, n = Y.shape
    rdtype = real_dtype_of(Y.dtype)
    Q = torch.zeros((l, k), dtype=Y.dtype, device=Y.device)
    piv = torch.zeros((k,), dtype=torch.int64, device=Y.device)
    picked = torch.zeros((n,), dtype=torch.bool, device=Y.device)
    Z = Y
    off = 0
    while off < k:
        b = min(panel, k - off)
        idx = torch.topk(_masked_res2(Z, picked, rdtype), b).indices
        C = Z.index_select(1, idx)
        if off:
            C = C - Q[:, :off] @ (Q[:, :off].mH @ C)
        G, _ = panel_gram(C, Z)
        L1 = torch.linalg.cholesky(G)
        Q1 = torch.linalg.solve_triangular(L1, C.mH, upper=False).mH
        L2 = torch.linalg.cholesky(Q1.mH @ Q1)
        Qp = torch.linalg.solve_triangular(L2, Q1.mH, upper=False).mH
        Z, _ = panel_deflate(Qp, Z)
        Q[:, off:off + b] = Qp
        piv[off:off + b] = idx
        picked = picked.index_fill(0, idx, True)
        off += b
    return Q, Q.mH @ Y, piv


def fused_flops(l: int, n: int, k: int, panel: int) -> float:
    """Operations of one fused ``blocked_pivoted_qr(Y, k, panel=panel)``
    from the shapes (XLA's cost analysis, which the reference reports, has
    no counterpart here).  Per panel of width ``b`` at offset ``off``: the
    re-projection ``C - Q (Q^H C)``, ``4 l off b``; CholeskyQR2, two rounds
    of a Gram ``2 l b^2``, a Cholesky ``b^3 / 3`` and a solve ``l b^2``;
    the sweep ``W = Q_p^H Z`` and ``Z - Q_p W``, ``4 l b n``, and the
    column norms ``2 l n``.  Then the norms of ``Y``, ``2 l n``, and
    ``R = Q^H Y``, ``2 l k n``.  Real operations on a real ``Y``."""
    total = 2.0 * l * n + 2.0 * l * k * n
    off = 0
    while off < k:
        b = min(panel, k - off)
        total += (4.0 * l * off * b + 2 * (3.0 * l * b * b + b ** 3 / 3)
                  + 4.0 * l * b * n + 2.0 * l * n)
        off += b
    return total


def fused_vs_split_sweep(panels, *, l: int = ACCEPT_L, n: int = ACCEPT_N,
                         k: int = ACCEPT_K, device="cuda",
                         json_path=None) -> list[dict]:
    """The whole panel loop at ``l=256, n=4096, k=128`` in f32 through the
    fused ``panel_step`` kernel and through the split ``panel_gram`` +
    ``panel_deflate`` path (``split_blocked_qr``), one row per panel
    width, with ``flops`` of the fused path from ``fused_flops``."""
    dev = check_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    Y = randn(gen, (l, n), torch.float32, dev)
    rows = []
    for b in panels:
        t_fused = time_fn(lambda: blocked_pivoted_qr(Y, k, panel=b,
                                                     panel_impl="fused"))
        t_split = time_fn(lambda: split_blocked_qr(Y, k, b))
        rows.append({"bench": "fused_panel_step", "l": l, "n": n, "k": k,
                     "panel": b, "device": str(dev), "split_s": t_split,
                     "fused_s": t_fused, "speedup": t_split / t_fused,
                     "flops": fused_flops(l, n, k, b)})
    emit(rows, header=f"Fused panel-step kernel vs split panel_gram + "
                      f"panel_deflate path, l={l} n={n} k={k} f32 "
                      f"({device})")
    if json_path:
        append_json_rows(json_path, rows)
    return rows


def acceptance(panels, *, device="cuda") -> list[dict]:
    """The blocked engine against the per-column CGS2 loop at ``l=256,
    n=4096, k=128`` in f32, one row per panel width."""
    dev = check_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    l, n, k = ACCEPT_L, ACCEPT_N, ACCEPT_K
    Y = randn(gen, (l, n), torch.float32, dev)
    t_cgs2 = time_fn(lambda: cgs2_pivoted_qr(Y, k))
    rows = []
    for b in panels:
        t_blk = time_fn(lambda: blocked_pivoted_qr(Y, k, panel=b))
        rows.append({"k": k, "l": l, "n": n, "panel": b, "device": str(dev),
                     "cgs2_s": t_cgs2, "blocked_s": t_blk,
                     "speedup": t_cgs2 / t_blk})
    return rows


def run(grid, dtype: torch.dtype, device="cuda",
        panels=PANEL_SWEEP) -> list[dict]:
    """One Table 3 row per case of ``grid``: median seconds of each QR
    engine on a Gaussian ``Y`` (l x n) of the real ``dtype``, and of the
    two CGS kernels."""
    dev = check_device(device)
    rows = []
    for case in grid:
        gen = torch.Generator(device=dev).manual_seed(case.k)
        l, n, k = case.l, case.n, case.k
        Y = randn(gen, (l, n), dtype, dev)
        t_cgs2 = time_fn(lambda: cgs2_pivoted_qr(Y, k))
        row = {"k": k, "l": l, "n": n, "dtype": _dname(dtype),
               "device": str(dev), "cgs2_pivoted_s": t_cgs2}
        best = None
        for b in panels:
            t_blk = time_fn(lambda: blocked_pivoted_qr(Y, k, panel=b))
            row[f"blocked_b{b}_s"] = t_blk
            best = t_blk if best is None else min(best, t_blk)
        row["blocked_speedup"] = t_cgs2 / best
        panel = Y[:, :k].contiguous()
        t_house = time_fn(lambda: householder_qr(panel))
        t_chol = time_fn(lambda: cholesky_qr2(panel))
        Q = torch.linalg.qr(randn(gen, (l, k), dtype, dev)).Q.contiguous()
        Qp = Q[:, :min(32, k)].contiguous()
        t_proj = time_fn(lambda: project_out(Q, Y))
        t_pdef = time_fn(lambda: panel_deflate(Qp, Y))
        row.update({"householder_panel_s": t_house,
                    "choleskyqr2_panel_s": t_chol,
                    "cuda_deflate_s": t_proj,
                    "cuda_panel_deflate_s": t_pdef})
        rows.append(row)
        del Y, Q, Qp, panel
    return rows


def main(argv=None) -> None:
    ap = cli_parser("Paper Table 3 on the port: the QR phase")
    ap.add_argument("--panels", type=int, nargs="*",
                    default=list(PANEL_SWEEP),
                    help="panel widths of the blocked engine sweep")
    args = ap.parse_args(argv)
    panels = args.panels or list(PANEL_SWEEP)   # bare --panels: the default
    grid = PAPER_GRID if args.full else SMALL_GRID
    dtype = torch.float64 if args.full else torch.float32
    finish(run(grid, dtype, args.device, panels),
           f"Table 3 analogue: QR phase ({_dname(dtype)}, {args.device})",
           args.json)
    finish(acceptance(panels, device=args.device),
           f"Acceptance: blocked vs cgs2, l={ACCEPT_L} n={ACCEPT_N} "
           f"k={ACCEPT_K} f32 ({args.device})", args.json)
    fused_vs_split_sweep(panels, l=ACCEPT_L, n=ACCEPT_N, k=ACCEPT_K,
                         device=args.device, json_path=args.json)


if __name__ == "__main__":
    main()
