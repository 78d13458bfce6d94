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
        [--qr-panel auto|N] [--grid] [--attribute-main N] [--json PATH]

``--attribute-main N`` draws the main row's matrix (f64, k=400, m=2^16,
n=2^14) for seeds 0..N-1 and runs each one's gaussian sketch through the
CGS2 oracle and the blocked engine at panels 8, 16 and 32: which engine an
eq. (3) reading above 1 follows (data, not gated).  ``--witness`` runs
the exact-rank draws of ``WITNESS_CASES``, made on the CPU and moved to
``--device``, through the same engines, with the exact 2-norm of the
error: the rows the tests hold to the reference's engines on the same
sketch (data, not gated).
"""
from __future__ import annotations

import contextlib
import datetime
import hashlib
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ..configs import PAPER_GRID, PAPER_TABLE5_ERRORS, SMALL_GRID
from ..core import (error_bound, expected_sigma_kp1, rid, rid_distributed,
                    rid_from_sketch, shard_columns, sketch, spectral_error,
                    spectral_norm_dense)
from ..core.distributed import QR_IMPLS as GRID_IMPLS
from ..core.distributed import _all_gather_columns
from ..core.rng import check_device
from ..data import DTYPE_FLOORS, SPECTRA, spectrum_matrix
from .bench_total import lowrank_complex
from .common import append_json_rows, cli_parser, emit, finish

__all__ = ["GRID_DTYPES", "GRID_SHAPES", "GRID_IMPLS", "WIDTH_SWEEP",
           "ATTRIBUTION_ENGINES", "WITNESS_CASES", "run", "grid_sweep",
           "main_row_attribution", "witness_inputs", "eq3_witness",
           "j_digest", "two_norm", "one_rank_group", "main"]

GRID_DTYPES = {name: (getattr(torch, name), DTYPE_FLOORS[name])
               for name in ("float32", "float64", "complex64")}
GRID_SHAPES = {10: (128, 120), 40: (256, 240), 96: (512, 480),
               100: (512, 480)}
WIDTH_SWEEP = (8, 16, 32, 64)
# The engines main_row_attribution runs on one sketch: (impl, panel).
ATTRIBUTION_ENGINES = (("cgs2", None), ("blocked", 8), ("blocked", 16),
                       ("blocked", 32))
# Exact-rank draws (m, n, k, seed) on which the blocked engine reads above
# the eq. (3) bound on the CPU at panel 32, 32, 16 and 8 in turn; one
# shape, small enough for an exact 2-norm.
WITNESS_CASES = tuple((512, 480, 96, seed) for seed in (0, 4, 16, 18))


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


def main_row_attribution(seeds, *, case=PAPER_GRID[2],
                         device="cuda") -> list[dict]:
    """The main row (``case``, f64; by default k=400, m=2^16, n=2^14) drawn
    by seed as the smoke draws it, ``A = randn(m, k) @ randn(k, n)`` from a
    generator seeded with the seed, its gaussian sketch, and that one
    sketch through each of ``ATTRIBUTION_ENGINES``: the eq. (3) ratio of
    each (``spectral_error``'s 50 power iterations against ``error_bound *
    expected_sigma_kp1``, as the smoke's main phase measures it).  Data:
    not gated."""
    dev = check_device(device)
    m, n, k = case.m, case.n, case.k
    bound = error_bound(m, n, k) * expected_sigma_kp1(m, n)
    rows = []
    for seed in seeds:
        gen = torch.Generator(device=dev).manual_seed(seed)
        A = torch.randn((m, k), generator=gen, dtype=torch.float64,
                        device=dev) @ torch.randn(
            (k, n), generator=gen, dtype=torch.float64, device=dev)
        Y = sketch(seed, A, 2 * k, kind="gaussian").Y
        for impl, panel in ATTRIBUTION_ENGINES:
            dec = rid_from_sketch(A, Y, k, qr_impl=impl,
                                  qr_panel=panel or 32)
            err = float(spectral_error(seed + 1, A, dec.B, dec.P))
            rows.append({"bench": "eq3_attribution", "seed": seed, "m": m,
                         "n": n, "k": k, "impl": impl, "panel": panel,
                         "device": str(dev), "err_2norm": err,
                         "eq3_bound": bound, "ratio": err / bound})
            del dec
        del A, Y
    return rows


def witness_inputs(m: int, n: int, k: int, seed: int) -> tuple:
    """``A = randn(m, k) @ randn(k, n)`` (f64, from a CPU generator seeded
    with ``seed``) and its gaussian sketch (``l = 2k``), both made on the
    CPU so that every device is given the same bits."""
    gen = torch.Generator().manual_seed(seed)
    A = torch.randn((m, k), generator=gen, dtype=torch.float64) @ torch.randn(
        (k, n), generator=gen, dtype=torch.float64)
    return A, sketch(seed, A, 2 * k, kind="gaussian").Y


def eq3_witness(cases=WITNESS_CASES, *, device="cuda") -> list[dict]:
    """Each case's ``witness_inputs``, moved to ``device``, through each of
    ``ATTRIBUTION_ENGINES``: the exact 2-norm of ``A - BP`` (``two_norm``,
    in f64 on the CPU) over ``error_bound * expected_sigma_kp1``, and a digest of the
    pivots ``J``.  Data: not gated."""
    dev = check_device(device)
    rows = []
    for m, n, k, seed in cases:
        A, Y = witness_inputs(m, n, k, seed)
        bound = error_bound(m, n, k) * expected_sigma_kp1(m, n)
        Ad, Yd = A.to(dev), Y.to(dev)
        for impl, panel in ATTRIBUTION_ENGINES:
            dec = rid_from_sketch(Ad, Yd, k, qr_impl=impl,
                                  qr_panel=panel or 32)
            J, P = dec.J.cpu(), dec.P.cpu()
            err = two_norm(A - A[:, J] @ P)
            rows.append({"bench": "eq3_witness", "seed": seed, "m": m,
                         "n": n, "k": k, "impl": impl, "panel": panel,
                         "device": str(dev), "err_2norm": err,
                         "eq3_bound": bound, "ratio": err / bound,
                         "j_sha256": j_digest(J)})
        del Ad, Yd
    return rows


def j_digest(J) -> str:
    """SHA-256 of the pivots ``J`` (CPU) as little-endian int64."""
    return hashlib.sha256(np.asarray(J, dtype="<i8").tobytes()).hexdigest()


def two_norm(E: torch.Tensor) -> float:
    """The exact 2-norm of ``E``: the root of the largest eigenvalue of
    its Gram on the shorter side."""
    G = E.mT @ E if E.shape[0] >= E.shape[1] else E @ E.mT
    return float(torch.linalg.eigvalsh(G)[-1].clamp(min=0).sqrt())


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
    ap.add_argument("--attribute-main", type=int, default=0, metavar="N",
                    help="draw the main row's matrix for seeds 0..N-1 and "
                         "run each sketch through CGS2 and the blocked "
                         "engine at panels 8, 16 and 32 (eq. (3) ratios; "
                         "not gated) instead of the Table 5 rows")
    ap.add_argument("--witness", action="store_true",
                    help="run WITNESS_CASES (made on the CPU) through CGS2 "
                         "and the blocked engine at panels 8, 16 and 32 "
                         "(exact eq. (3) ratios; not gated) instead of the "
                         "Table 5 rows")
    args = ap.parse_args(argv)
    if args.witness:
        finish(eq3_witness(device=args.device),
               f"eq. (3) on the witness draws by engine ({args.device})",
               args.json)
        return
    if args.attribute_main:
        finish(main_row_attribution(range(args.attribute_main),
                                    device=args.device),
               f"eq. (3) on the main row by engine ({args.device})",
               args.json)
        return
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
