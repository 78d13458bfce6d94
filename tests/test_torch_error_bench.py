"""The port's Table 5 slice against the JAX reference, on the CPU: the
known-spectrum matrices (``repro_torch.data``) and the ``bench_error``
module (Table 5 rows and the ``--grid`` verification grid).

The two frameworks draw different numbers (threefry against Philox), so
``spectrum_matrix`` is held by its singular values and ``spectrum_sigmas``
bit for bit; the error path is held by feeding both packages the same
matrix (numpy) and checking that both are within eq. (3).  The JAX
harness ``benchmarks/bench_error.py`` is not imported: it turns on
``jax_enable_x64`` at import, which would leak into this process; its
pieces are taken from ``repro.data.synthetic`` and ``repro.core``.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.benchmarks import bench_error  # noqa: E402
from repro_torch.configs import SMALL_GRID  # noqa: E402
from repro_torch.core import (error_bound, expected_sigma_kp1,  # noqa: E402
                              rid, spectral_norm_dense)
from repro_torch.data import (DTYPE_FLOORS, SPECTRA,  # noqa: E402
                              spectrum_matrix, spectrum_sigmas)
from torch_ranks import pin_threads  # noqa: E402

pin_threads()

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


@pytest.fixture(autouse=True, scope="module")
def _x64_scope():
    """f64 for this module only, restored afterwards."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


# ------------------------------------------------------ known spectra

@pytest.mark.parametrize("spectrum", SPECTRA)
@pytest.mark.parametrize("r,k,floor", [(36, 10, 1e-5), (96, 40, 1e-12)])
def test_spectrum_sigmas_bit_equal_to_jax(spectrum, r, k, floor):
    from repro.data.synthetic import spectrum_sigmas as jax_sigmas
    np.testing.assert_array_equal(spectrum_sigmas(spectrum, r, k, floor=floor),
                                  jax_sigmas(spectrum, r, k, floor=floor))


def test_spectrum_constants_and_validation_match_jax():
    from repro.data import synthetic as ref
    assert SPECTRA == ref.SPECTRA and DTYPE_FLOORS == ref.DTYPE_FLOORS
    with pytest.raises(ValueError, match="unknown spectrum 'flat'"):
        spectrum_sigmas("flat", 10, 3)
    with pytest.raises(ValueError, match="need 0 < k < r, got k=10, r=10"):
        spectrum_sigmas("cliff", 10, 10)


@pytest.mark.parametrize("spectrum", SPECTRA)
@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64",
                                   "complex128"])
def test_spectrum_matrix_has_the_stated_singular_values(spectrum, dtype):
    """``svdvals`` of the port's matrix equals the reference's sigmas
    within 1e-12 relative (double) / 1e-5 (single); rank r, zeros after."""
    from repro.data.synthetic import spectrum_matrix as jax_matrix
    tdt = getattr(torch, dtype)
    floor = DTYPE_FLOORS[dtype]
    m, n, k = 128, 120, 10
    A, sig = spectrum_matrix(7, m, n, spectrum, k, dtype=tdt, floor=floor,
                             device="cpu")
    _, jsig = jax_matrix(jax.random.key(7), m, n, spectrum, k,
                         dtype=getattr(jnp, dtype), floor=floor)
    np.testing.assert_array_equal(sig, jsig)
    assert A.dtype == tdt and tuple(A.shape) == (m, n)
    sv = torch.linalg.svdvals(A.to(torch.complex128)).numpy()
    r = len(sig)
    rel = 1e-5 if dtype in ("float32", "complex64") else 1e-12
    np.testing.assert_allclose(sv[:r], sig, rtol=0, atol=rel * sig[0])
    assert sv[r:].max() <= rel * sig[0]


def test_spectrum_matrix_is_seeded_and_refuses_a_missing_card():
    a1, _ = spectrum_matrix(3, 40, 30, "cliff", 5, device="cpu")
    a2, _ = spectrum_matrix(torch.Generator().manual_seed(3), 40, 30,
                            "cliff", 5, device="cpu")
    assert torch.equal(a1, a2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            spectrum_matrix(3, 40, 30, "cliff", 5)


# --------------------------------------------------- Table 5 and the grid

def test_table5_row_within_the_bound():
    rows = bench_error.run(SMALL_GRID[:1], device="cpu")
    assert len(rows) == 1
    row = rows[0]
    assert row["within_bound"] and 0 < row["err_2norm"] <= row["eq3_bound"]
    assert "paper_table5" not in row


def test_table5_same_matrix_both_packages_within_the_bound():
    """The paper's complex Gaussian A = B P (numpy) through the port's
    ``rid`` and the reference's, both with the CGS2 QR and the SRFT: both
    errors within eq. (3) on the paper's noise floor."""
    import repro.core as jcore
    case = SMALL_GRID[0]
    rng = np.random.default_rng(44)

    def cg(shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)

    A = cg((case.m, case.k)) @ cg((case.k, case.n))
    bound = error_bound(case.m, case.n, case.k) * \
        expected_sigma_kp1(case.m, case.n)
    dec = rid(1, interop.to_torch(A, device="cpu"), case.k, qr_impl="cgs2")
    err = float(spectral_norm_dense(interop.to_torch(A, device="cpu")
                                    - dec.B @ dec.P))

    @jax.jit
    def jax_error(key, A):
        jdec = jcore.rid(key, A, case.k, qr_impl="cgs2")
        return jcore.spectral_norm_dense(A - jdec.B @ jdec.P)
    jerr = float(jax_error(jax.random.key(1), jnp.asarray(A)))
    assert err <= bound and jerr <= bound, (err, jerr, bound)


@pytest.mark.parametrize("impl", ["cgs2", "blocked"])
@pytest.mark.parametrize("spectrum", SPECTRA)
def test_grid_point_same_matrix_both_packages_within_the_bound(spectrum,
                                                               impl):
    """One grid point (k=10, f64): the reference's known-spectrum matrix
    through the port's gaussian ``rid`` and the reference's, with
    ``qr_panel='auto'``; both within eq. (3) on the true sigma_{k+1}."""
    import repro.core as jcore
    from repro.data.synthetic import spectrum_matrix as jax_matrix
    k, (m, n) = 10, bench_error.GRID_SHAPES[10]
    A, sig = jax_matrix(jax.random.key(k), m, n, spectrum, k,
                        dtype=jnp.float64, floor=DTYPE_FLOORS["float64"])
    bound = error_bound(m, n, k) * float(sig[k])
    At = interop.to_torch(np.asarray(A), device="cpu")
    dec = rid(k + 1, At, k, sketch_kind="gaussian", qr_impl=impl,
              qr_panel="auto")
    err = float(spectral_norm_dense(At - dec.B @ dec.P))
    jdec = jcore.rid(jax.random.key(k + 1), A, k, sketch_kind="gaussian",
                     qr_impl=impl, qr_panel="auto")
    jerr = float(jcore.spectral_norm_dense(A - jdec.B @ jdec.P))
    assert err <= bound and jerr <= bound, (err, jerr, bound)


def test_grid_cli_in_a_subprocess(tmp_path):
    """``--grid`` through the CLI on the CPU: it joins its own one-rank
    gloo group (this process joins none), prints and records every row,
    and exits 0 only if every gated row is within the bound.  One CPU
    thread, as the rank subprocesses of test_torch_qr_dist.py: beside
    the suite's other workers, a thread per core makes the grid's small
    products crawl."""
    path = tmp_path / "grid.json"
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""), TMPDIR=str(tmp_path),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.bench_error",
         "--device", "cpu", "--grid", "--json", str(path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "# eq.(3) verification grid" in out.stdout
    assert "# Width calibration" in out.stdout
    rows = json.loads(path.read_text())
    grid = [r for r in rows if r["bench"] == "error_grid"]
    width = [r for r in rows if r["bench"] == "error_grid_width"]
    summary = [r for r in rows if r["bench"] == "error_grid_summary"]
    impls = bench_error.GRID_IMPLS
    assert len(grid) == 2 * len(SPECTRA) * len(bench_error.GRID_DTYPES) \
        * len(impls)
    assert len(width) == 2 * len(bench_error.WIDTH_SWEEP)
    assert len(summary) == len(impls) * len(bench_error.GRID_DTYPES)
    assert all(r["within_bound"] and r["ratio"] <= 1 for r in grid)
    assert all(r["within_bound"] for r in summary)
    assert {r["impl"] for r in grid} == set(impls)


def test_bench_error_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        bench_error.run(SMALL_GRID[:1])
    with pytest.raises(RuntimeError, match="is_available"):
        bench_error.main(["--grid"])


def test_main_row_attribution_runs_each_engine_on_one_sketch():
    """A small row on the CPU: per seed one row per engine (CGS2, blocked
    at panels 8, 16, 32), each with the same bound; exact-rank inputs sit
    far below it."""
    from repro_torch.configs.paper_rid import RIDCase
    case = RIDCase(k=12, m=256, n=200)
    rows = bench_error.main_row_attribution((0, 1), case=case, device="cpu")
    assert [(r["seed"], r["impl"], r["panel"]) for r in rows] == [
        (s, impl, p) for s in (0, 1)
        for impl, p in bench_error.ATTRIBUTION_ENGINES]
    assert len({r["eq3_bound"] for r in rows}) == 1
    assert all(math.isfinite(r["ratio"]) and r["ratio"] < 1 for r in rows)
