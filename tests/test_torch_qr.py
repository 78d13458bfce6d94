"""Parity of the port's pivoted QR, interpolation solve and their
validation (``repro_torch.core.qr`` / ``tsolve`` / ``validate``) with the
JAX reference, on the CPU, on well-separated spectra."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import (blocked_pivoted_qr, cgs2_pivoted_qr,  # noqa: E402
                              cholesky_qr2, householder_qr, interp_from_qr,
                              pivoted_qr, resolve_norm_recompute,
                              resolve_panel, solve_upper_triangular)
from torch_ranks import pin_threads  # noqa: E402

pin_threads()


def _t(x):
    """numpy -> torch on the CPU, dtype kept."""
    return interop.to_torch(x, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _x64_scope():
    """f64 for this module only, restored afterwards."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def _sketch_like(rng, l, n, dtype):
    """A generic (l, n) matrix whose column norms are spread log-uniformly
    over two decades: greedy pivot choices are separated by far more than
    the two libraries' rounding."""
    g = rng.standard_normal((l, n))
    if np.dtype(dtype).kind == "c":
        g = g + 1j * rng.standard_normal((l, n))
    return (g * np.logspace(0, 2, n)[rng.permutation(n)]).astype(dtype)


TOL = {"float64": 1e-9, "complex128": 1e-9}


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
@pytest.mark.parametrize("engine", ["cgs2", "fused", "auto"])
def test_pivoted_qr_matches_jax(engine, dtype):
    """Same pivots (as sets, and in order), and Q, R to tolerance, for the
    per-column oracle and the blocked engine (fused on the port's
    panel_step; 'auto' the split CholeskyQR2 oracle), with a remainder
    panel (k=20, panel=8)."""
    import repro.core as jcore
    rng = np.random.default_rng(10)
    l, n, k = 40, 300, 20
    Y = _sketch_like(rng, l, n, dtype)
    Yt = _t(Y)
    if engine == "cgs2":
        got = cgs2_pivoted_qr(Yt, k)
        want = jcore.cgs2_pivoted_qr(jnp.asarray(Y), k)
    else:
        got = blocked_pivoted_qr(Yt, k, panel=8, panel_impl=engine)
        want = jcore.blocked_pivoted_qr(jnp.asarray(Y), k, panel=8,
                                        panel_impl=engine)
    gp, wp = interop.to_numpy(got.piv), np.asarray(want.piv)
    assert set(gp.tolist()) == set(wp.tolist())
    np.testing.assert_array_equal(gp, wp)
    scale = np.abs(Y).max()
    np.testing.assert_allclose(interop.to_numpy(got.Q), np.asarray(want.Q),
                               atol=TOL[dtype], rtol=0)
    np.testing.assert_allclose(interop.to_numpy(got.R), np.asarray(want.R),
                               atol=TOL[dtype] * scale, rtol=0)


def test_pivoted_qr_float32_blocked_matches_jax():
    """f32 through the fused engine: same pivot set, factors to f32
    rounding scaled by the sketch size."""
    import repro.core as jcore
    rng = np.random.default_rng(11)
    Y = _sketch_like(rng, 32, 200, "float32")
    got = blocked_pivoted_qr(_t(Y), 16, panel=8)
    want = jcore.blocked_pivoted_qr(jnp.asarray(Y), 16, panel=8)
    assert set(interop.to_numpy(got.piv).tolist()) == \
        set(np.asarray(want.piv).tolist())
    np.testing.assert_allclose(interop.to_numpy(got.Q), np.asarray(want.Q),
                               atol=1e-4, rtol=0)


def test_interp_from_qr_matches_jax():
    """Same (R, piv) in, same P out (library solve and the row-recurrence
    oracle), with exact identity columns at the pivots."""
    from repro.core.tsolve import interp_from_qr as jax_interp
    rng = np.random.default_rng(12)
    Y = _sketch_like(rng, 30, 120, "float64")
    qr = cgs2_pivoted_qr(_t(Y), 12)
    R, piv = interop.to_numpy(qr.R), interop.to_numpy(qr.piv)
    want = np.asarray(jax_interp(jnp.asarray(R), jnp.asarray(piv)))
    for use_lib in (True, False):
        P = interp_from_qr(qr.R, qr.piv, use_lib=use_lib)
        np.testing.assert_allclose(interop.to_numpy(P), want, atol=1e-10,
                                   rtol=0)
        assert torch.equal(P[:, qr.piv], torch.eye(12, dtype=P.dtype))


def test_triangular_solve_matches_jax_oracle():
    from repro.core.tsolve import solve_upper_triangular as jax_solve
    rng = np.random.default_rng(13)
    R1 = np.triu(rng.standard_normal((24, 24))) + 4 * np.eye(24)
    R2 = rng.standard_normal((24, 50))
    got = solve_upper_triangular(_t(R1), _t(R2))
    np.testing.assert_allclose(interop.to_numpy(got),
                               np.asarray(jax_solve(jnp.asarray(R1),
                                                    jnp.asarray(R2))),
                               atol=1e-12, rtol=0)


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_panel_factorizations_match_jax(dtype):
    import repro.core as jcore
    rng = np.random.default_rng(14)
    C = _sketch_like(rng, 48, 10, dtype)
    for port_fn, jax_fn in ((householder_qr, jcore.householder_qr),
                            (cholesky_qr2, jcore.cholesky_qr2)):
        Q, R = port_fn(_t(C))
        Qj, Rj = jax_fn(jnp.asarray(C))
        np.testing.assert_allclose(interop.to_numpy(Q), np.asarray(Qj),
                                   atol=1e-10, rtol=0)
        np.testing.assert_allclose(interop.to_numpy(R), np.asarray(Rj),
                                   atol=1e-10 * np.abs(C).max(), rtol=0)


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_fused_duplicate_columns_fall_back(dtype):
    """Duplicate-column sketch (rank 10, every column repeated): the fused
    panel's factor fails the check, the per-column fallback re-selects,
    pivots stay unique and the residual stays within 10x of cgs2's."""
    rng = np.random.default_rng(15)
    base = _sketch_like(rng, 64, 10, dtype)
    Y = np.concatenate([base] * 30, axis=1)
    Yt = _t(Y)
    fus = blocked_pivoted_qr(Yt, 16, panel=8)
    orc = cgs2_pivoted_qr(Yt, 16)
    assert len(set(interop.to_numpy(fus.piv).tolist())) == 16
    err = lambda qr: float(torch.linalg.norm(Yt - qr.Q @ qr.R))  # noqa: E731
    assert err(fus) <= 10 * err(orc) + 1e-10 * np.linalg.norm(Y)


def test_resolve_panel_and_norm_recompute_match_jax():
    from repro.core import qr as jqr
    for k, l in ((100, 200), (16, 400), (400, 800), (10, 10), (5, 1000)):
        assert resolve_panel("auto", k, l) == jqr.resolve_panel("auto", k, l)
    assert resolve_panel(24, 10, 20) == 24
    for v in ("auto", None, 0, 1, 5):
        assert resolve_norm_recompute(v) == jqr.resolve_norm_recompute(v)


@pytest.mark.parametrize("call,match", [
    (lambda: resolve_panel("wide", 4, 8), "unknown panel 'wide'"),
    (lambda: resolve_norm_recompute("often"), "unknown norm_recompute "
                                              "'often'"),
    (lambda: resolve_norm_recompute(-2), r"need norm_recompute >= 0 "
                                         r"\(or 'auto'\), got -2"),
    (lambda: cgs2_pivoted_qr(torch.ones(4, 6), 5),
     r"need 0 < k <= min\(l, n\); got k=5, l=4, n=6"),
    (lambda: blocked_pivoted_qr(torch.ones(4, 6), 2, panel=0),
     "need panel >= 1, got panel=0"),
    (lambda: blocked_pivoted_qr(torch.ones(4, 6), 2, panel_impl="magic"),
     "unknown panel_impl 'magic'"),
    (lambda: pivoted_qr(torch.ones(4, 6), 2, impl="lu"),
     "unknown qr impl 'lu'"),
])
def test_validation_names_argument_and_value(call, match):
    with pytest.raises(ValueError, match=match):
        call()
