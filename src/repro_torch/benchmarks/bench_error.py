"""Paper Table 5 on the port: ``||A - BP||_2`` across the grid and the
eq. (3) bound.

Default mode: one row per grid case, on the paper's complex Gaussian
low-rank ``A = B P`` in complex128 (``bench_total.lowrank_complex``),
decomposed by ``rid`` with ``--sketch`` and ``--qr-impl`` (default the
paper's CGS2: this is a paper-parity check) and measured by
``spectral_error`` (40 power iterations) against
``error_bound * expected_sigma_kp1``, the paper's noise-floor estimate.
Rows of the paper's grid carry the paper's measured error beside them
(``paper_table5``).  ``SMALL_GRID`` by default, ``--full`` the paper's
grid.

``--grid`` runs the known-spectrum verification grid instead: matrices
with exact singular values (``data.spectrum_matrix``) over spectra
{fast_decay, cliff, noisy_tail} x dtypes {f32, f64, c64} x QR engines
{cgs2, blocked, panel_parallel} x k, each row's error held to eq. (3)
with the true ``sigma_{k+1}``; then the panel-width calibration sweep
(bound ratio against the blocked engine's panel width on the cliff
spectrum, from which ``core.qr.resolve_panel``'s width model was fitted)
and the worst ratio per engine and dtype.  ``panel_parallel`` runs on a
``torch.distributed`` group: ``grid_sweep`` takes one as ``group=``, and
the CLI creates a one-rank group (gloo for ``--device cpu``, NCCL for
cuda) and destroys it afterwards.

Gates, as in the reference: every Table 5 row, every grid row and every
summary row must be within the bound; the width-sweep rows are data (they
probe past the safe widths on purpose) and are not gated.  Rows are
printed and recorded (``--json PATH``) before the gate.

    python -m repro_torch.benchmarks.bench_error [--full] [--device cuda|cpu]
        [--sketch srft|srht|gaussian] [--qr-impl cgs2|blocked]
        [--qr-panel auto|N] [--grid] [--json PATH]
"""
from __future__ import annotations

import contextlib
import datetime
import tempfile

import torch
import torch.distributed as dist

from ..configs import PAPER_GRID, PAPER_TABLE5_ERRORS, SMALL_GRID
from ..core import (error_bound, expected_sigma_kp1, rid, rid_distributed,
                    shard_columns, spectral_error, spectral_norm_dense)
from ..core.distributed import QR_IMPLS as GRID_IMPLS
from ..core.distributed import _all_gather_columns
from ..core.rng import check_device
from ..data import DTYPE_FLOORS, SPECTRA, spectrum_matrix
from .bench_total import lowrank_complex
from .common import append_json_rows, cli_parser, emit, finish

__all__ = ["GRID_DTYPES", "GRID_SHAPES", "GRID_IMPLS", "WIDTH_SWEEP",
           "run", "grid_sweep", "one_rank_group", "main"]

GRID_DTYPES = {name: (getattr(torch, name), DTYPE_FLOORS[name])
               for name in ("float32", "float64", "complex64")}
GRID_SHAPES = {10: (128, 120), 40: (256, 240), 96: (512, 480),
               100: (512, 480)}
WIDTH_SWEEP = (8, 16, 32, 64)


def run(grid, *, sketch_kind: str = "srft", qr_impl: str = "cgs2",
        qr_panel="auto", device="cuda") -> list[dict]:
    """One Table 5 row per case of ``grid``: the spectral error of the
    rank-k ``rid`` of a complex128 ``A = B P`` against the eq. (3) bound
    on the paper's noise floor.  Not gated here (``main`` gates)."""
    dev = check_device(device)
    rows = []
    for case in grid:
        seed = case.k + 13
        gen = torch.Generator(device=dev).manual_seed(seed)
        A = lowrank_complex(gen, case.m, case.n, case.k, torch.complex128,
                            dev)
        dec = rid(seed + 3, A, case.k, sketch_kind=sketch_kind,
                  qr_impl=qr_impl, qr_panel=qr_panel)
        err = float(spectral_error(seed + 4, A, dec.B, dec.P, iters=40))
        floor = expected_sigma_kp1(case.m, case.n)
        bound = error_bound(case.m, case.n, case.k) * floor
        row = {"k": case.k, "m": case.m, "n": case.n, "device": str(dev),
               "err_2norm": err, "sigma_floor": floor, "eq3_bound": bound,
               "within_bound": err <= bound}
        if case in PAPER_GRID:
            row["paper_table5"] = PAPER_TABLE5_ERRORS[PAPER_GRID.index(case)]
        rows.append(row)
        del A, dec
    return rows


def _grid_err(seed: int, A: torch.Tensor, k: int, impl: str, *, group,
              qr_panel="auto") -> float:
    """``||A - BP||_2`` in complex128 (dense SVD) of the rank-k gaussian
    ``rid`` through ``impl``; ``panel_parallel`` runs on ``group`` with
    this rank's column block and gathers ``P``."""
    if impl == "panel_parallel":
        dec = rid_distributed(seed, shard_columns(A, group), k, group=group,
                              sketch_kind="gaussian",
                              qr_impl="panel_parallel", qr_panel=qr_panel)
        P = _all_gather_columns(dec.P, group)
    else:
        dec = rid(seed, A, k, sketch_kind="gaussian", qr_impl=impl,
                  qr_panel=qr_panel)
        P = dec.P
    c = torch.complex128
    return float(spectral_norm_dense(A.to(c) - dec.B.to(c) @ P.to(c)))


def grid_sweep(*, group, full: bool = False, json_path=None,
               device="cuda") -> list[dict]:
    """The eq. (3) verification grid, the width-calibration sweep and the
    worst ratio per engine and dtype; every rank of ``group`` calls it.
    Prints and records the rows, then gates the grid and summary rows."""
    dev = check_device(device)
    ks = (10, 40, 100) if full else (10, 40)
    rows = []
    for k in ks:
        m, n = GRID_SHAPES[k]
        for spectrum in SPECTRA:
            for dname, (dtype, floor) in GRID_DTYPES.items():
                A, sig = spectrum_matrix(k, m, n, spectrum, k, dtype=dtype,
                                         floor=floor, device=dev)
                bound = error_bound(m, n, k) * float(sig[k])
                for impl in GRID_IMPLS:
                    err = _grid_err(k + 1, A, k, impl, group=group)
                    rows.append({"bench": "error_grid", "spectrum": spectrum,
                                 "dtype": dname, "impl": impl, "k": k,
                                 "m": m, "n": n, "err_2norm": err,
                                 "sigma_kp1": float(sig[k]),
                                 "eq3_bound": bound, "ratio": err / bound,
                                 "within_bound": err <= bound})
    emit(rows, header="eq.(3) verification grid: known-spectrum matrices, "
                      "bound ratio vs the TRUE sigma_k+1")

    # Width calibration: bound ratio against the blocked engine's panel
    # width on the cliff spectrum (resolve_panel's fit).
    wrows = []
    for k in ((40, 96, 100) if full else (40, 96)):
        m, n = GRID_SHAPES[k]
        A, sig = spectrum_matrix(3, m, n, "cliff", k, dtype=torch.float64,
                                 floor=1e-10, device=dev)
        bound = error_bound(m, n, k) * float(sig[k])
        for panel in WIDTH_SWEEP:
            err = _grid_err(5, A, k, "blocked", group=group, qr_panel=panel)
            wrows.append({"bench": "error_grid_width", "k": k, "l": 2 * k,
                          "m": m, "n": n, "panel": panel,
                          "wk_over_l": panel * k / (2 * k),
                          "ratio": err / bound,
                          "within_bound": err <= bound})
    emit(wrows, header="Width calibration: bound ratio vs panel width "
                       "(cliff spectrum, l = 2k) -- resolve_panel's fit")

    summary = []
    for impl in GRID_IMPLS:
        for dname in GRID_DTYPES:
            worst = max(r["ratio"] for r in rows
                        if r["impl"] == impl and r["dtype"] == dname)
            summary.append({"bench": "error_grid_summary", "impl": impl,
                            "dtype": dname, "worst_ratio": worst,
                            "within_bound": worst <= 1.0})
    emit(summary, header="error-grid summary: worst eq.(3) bound ratio "
                         "per impl/dtype")
    # Record before gating: the rows of a violated bound say which point.
    if json_path:
        append_json_rows(json_path, rows + wrows + summary)
    assert all(r["within_bound"] for r in rows + summary), \
        "eq.(3) bound violated on the verification grid!"
    return rows + wrows + summary


@contextlib.contextmanager
def one_rank_group(device):
    """A one-rank ``torch.distributed`` group on a file store in a
    temporary directory (gloo for the CPU, NCCL for a card), destroyed on
    exit."""
    dev = check_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                                rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=300))
        try:
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()


def main(argv=None) -> None:
    ap = cli_parser("Paper Table 5 on the port: ||A - BP||_2 and the "
                    "eq. (3) bound")
    ap.add_argument("--sketch", default="srft",
                    choices=["srft", "srht", "gaussian"])
    ap.add_argument("--qr-impl", default="cgs2", choices=["cgs2", "blocked"],
                    help="pivoted-QR engine (default: the paper's CGS2)")
    ap.add_argument("--qr-panel", default="auto",
                    help="blocked-engine panel width: an int, or 'auto' for "
                         "core.qr.resolve_panel's width model")
    ap.add_argument("--grid", action="store_true",
                    help="run the known-spectrum eq. (3) verification grid "
                         "and the panel-width calibration sweep instead of "
                         "the Table 5 rows")
    args = ap.parse_args(argv)
    if args.grid:
        with one_rank_group(args.device) as group:
            grid_sweep(group=group, full=args.full, json_path=args.json,
                       device=args.device)
        return
    qr_panel = args.qr_panel if args.qr_panel == "auto" else int(args.qr_panel)
    rows = run(PAPER_GRID if args.full else SMALL_GRID,
               sketch_kind=args.sketch, qr_impl=args.qr_impl,
               qr_panel=qr_panel, device=args.device)
    finish(rows, f"Table 5 analogue: ||A-BP||_2 in complex128 "
                 f"(sketch={args.sketch}, qr={args.qr_impl}, {args.device}); "
                 f"eq.(3) bound check", args.json)
    assert all(r["within_bound"] for r in rows), "eq.(3) bound violated!"


if __name__ == "__main__":
    main()
