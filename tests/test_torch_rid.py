"""The slice as a whole: the port's ``rid`` against ``repro.core.rid`` on
the same ``A`` with the reference's own random operator injected, the
paper's eq. (3) on exact-rank inputs, the sketch backends, and import
hygiene of the port."""
import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.core import (error_bound, expected_sigma_kp1,  # noqa: E402
                              fwht, gaussian_omega_cols, rid, rsvd, sketch,
                              spectral_error, spectral_norm_dense)
from torch_ranks import pin_threads  # noqa: E402

pin_threads()

REPO = Path(__file__).resolve().parents[1]


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


def _lowrank(rng, m, n, k, dtype):
    cx = np.dtype(dtype).kind == "c"

    def g(shape):
        x = rng.standard_normal(shape)
        return x + 1j * rng.standard_normal(shape) if cx else x
    return (g((m, k)) @ g((k, n))).astype(dtype)


def _jax_srft_operator(key, m, l, dtype):
    """The phases and rows ``repro.core.sketch.srft_sketch`` draws from
    ``key`` (its lines drawing ``phi`` and ``rows``), rebuilt here."""
    cdtype = (jnp.complex128 if dtype in ("float64", "complex128")
              else jnp.complex64)
    rdtype = jnp.finfo(cdtype).dtype
    kphase, krows = jax.random.split(key)
    phi = jax.random.uniform(kphase, (m,), dtype=rdtype)
    d = jnp.exp((2j * jnp.pi) * phi).astype(cdtype)
    rows = jax.random.randint(krows, (l,), 0, m, dtype=jnp.int32)
    return np.asarray(d), np.asarray(rows)


def _compare(got, want, A, k):
    """J equal as sets, P[:, J] == I, B exact given J, P to tolerance."""
    gJ, wJ = interop.to_numpy(got.J), np.asarray(want.J)
    assert set(gJ.tolist()) == set(wJ.tolist())
    assert len(set(gJ.tolist())) == k
    P = interop.to_numpy(got.P)
    np.testing.assert_array_equal(P[:, gJ], np.eye(k, dtype=P.dtype))
    np.testing.assert_array_equal(interop.to_numpy(got.B), A[:, gJ])
    go, wo = np.argsort(gJ), np.argsort(wJ)
    Pw = np.asarray(want.P)
    np.testing.assert_allclose(P[go], Pw[wo], atol=1e-8 * np.abs(Pw).max(),
                               rtol=0)


@pytest.mark.parametrize("qr_impl", ["blocked", "cgs2"])
def test_rid_gaussian_matches_jax(qr_impl):
    """Gaussian sketch with JAX's own Omega injected: the port's sketch runs
    its sketch_accum, the reference its Pallas kernel (interpret mode)."""
    from repro.core import rid as jax_rid
    from repro.core.sketch import gaussian_omega_cols as jax_omega
    rng = np.random.default_rng(20)
    m, n, k = 300, 200, 20
    A = _lowrank(rng, m, n, k, "float64")
    key = jax.random.key(5)
    omega = np.asarray(jax_omega(key, 0, m, 2 * k, jnp.float64))
    want = jax_rid(key, jnp.asarray(A), k, sketch_kind="gaussian",
                   qr_impl=qr_impl, qr_panel=8)
    got = rid(0, _t(A), k, sketch_kind="gaussian",
              qr_impl=qr_impl, qr_panel=8, omega=_t(omega))
    _compare(got, want, A, k)


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_rid_srft_matches_jax(dtype):
    """The default srft sketch with JAX's phases and rows injected."""
    from repro.core import rid as jax_rid
    rng = np.random.default_rng(21)
    m, n, k = 256, 160, 16
    A = _lowrank(rng, m, n, k, dtype)
    key = jax.random.key(6)
    phases, rows = _jax_srft_operator(key, m, 2 * k, dtype)
    want = jax_rid(key, jnp.asarray(A), k, qr_panel=8)
    got = rid(0, _t(A), k, qr_panel=8,
              phases=_t(phases), rows=_t(rows))
    _compare(got, want, A, k)


@pytest.mark.parametrize("qr_impl", ["blocked", "cgs2"])
@pytest.mark.parametrize("dtype", ["float64", "complex128"])
@pytest.mark.parametrize("sketch_kind", ["srft", "gaussian"])
def test_rid_eq3_bound_exact_rank(sketch_kind, dtype, qr_impl):
    """Paper eq. (3): ||A - BP||_2 <= error_bound * expected_sigma_kp1 on
    an exact-rank A = B0 P0, with the port's own random operators."""
    rng = np.random.default_rng(22)
    m, n, k = 512, 384, 24
    A = _t(_lowrank(rng, m, n, k, dtype))
    dec = rid(3, A, k, sketch_kind=sketch_kind, qr_impl=qr_impl, qr_panel=8)
    err = float(spectral_error(4, A, dec.B, dec.P))
    assert err <= error_bound(m, n, k) * expected_sigma_kp1(m, n)
    assert torch.equal(dec.P[:, dec.J],
                       torch.eye(k, dtype=dec.P.dtype))


def test_rid_is_reproducible_per_seed():
    rng = np.random.default_rng(23)
    A = _t(_lowrank(rng, 256, 128, 12, "float64"))
    d1 = rid(7, A, 12, sketch_kind="gaussian")
    d2 = rid(torch.Generator().manual_seed(99), A, 12,
             sketch_kind="gaussian")
    d3 = rid(7, A, 12, sketch_kind="gaussian")
    assert torch.equal(d1.P, d3.P) and torch.equal(d1.J, d3.J)
    assert d2.P.shape == d1.P.shape


def test_gaussian_operator_is_seeded_per_block():
    """Block b of Omega depends on (seed, b) alone: any block-aligned
    column range equals the same slice of the whole operator."""
    whole = gaussian_omega_cols(11, 0, 700, 8, torch.float64, device="cpu")
    part = gaussian_omega_cols(11, 256, 600, 8, torch.float64, device="cpu")
    assert torch.equal(part, whole[:, 256:600])
    cx = gaussian_omega_cols(11, 0, 300, 8, torch.complex64, device="cpu")
    assert cx.dtype == torch.complex64 and cx.shape == (8, 300)
    with pytest.raises(ValueError, match="got r0=100"):
        gaussian_omega_cols(11, 100, 300, 8, torch.float64, device="cpu")


def test_operator_helpers_refuse_a_missing_card():
    """Functions that create tensors default to the card and raise without
    one rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        gaussian_omega_cols(0, 0, 128, 4, torch.float64)
    with pytest.raises(RuntimeError, match="is_available"):
        interop.to_torch(np.ones(3))


def test_srht_and_fwht_match_jax():
    from repro.core.sketch import fwht as jax_fwht
    rng = np.random.default_rng(24)
    x = rng.standard_normal((64, 5))
    np.testing.assert_allclose(interop.to_numpy(fwht(_t(x))),
                               np.asarray(jax_fwht(jnp.asarray(x))),
                               atol=1e-13, rtol=0)
    A = _lowrank(rng, 100, 60, 6, "float64")
    signs = np.where(rng.standard_normal(100) > 0, 1.0, -1.0)
    rows = rng.integers(0, 128, 12)
    Y = sketch(0, _t(A), 12, kind="srht",
               signs=_t(signs), rows=_t(rows)).Y
    H = np.asarray(jax_fwht(jnp.asarray(
        np.pad(signs[:, None] * A, ((0, 28), (0, 0))))))
    np.testing.assert_allclose(interop.to_numpy(Y),
                               H[rows] * math.sqrt(128 / 12), atol=1e-12,
                               rtol=0)
    with pytest.raises(ValueError, match="unknown sketch kind 'dct'"):
        sketch(0, _t(A), 12, kind="dct")


def test_rsvd_and_error_tools():
    from repro.core.errors import error_bound as jax_bound
    from repro.core.errors import expected_sigma_kp1 as jax_sigma
    rng = np.random.default_rng(25)
    A = _t(_lowrank(rng, 200, 150, 10, "float64"))
    svd = rsvd(1, A, 10)
    resid = spectral_norm_dense(A - svd.reconstruct())
    assert float(resid) < 1e-9 * float(spectral_norm_dense(A))
    est = spectral_error(2, A, torch.zeros(200, 1, dtype=A.dtype),
                         torch.zeros(1, 150, dtype=A.dtype), iters=200)
    np.testing.assert_allclose(float(est), float(spectral_norm_dense(A)),
                               rtol=1e-6)
    assert error_bound(2 ** 16, 2 ** 14, 400) == jax_bound(2 ** 16, 2 ** 14,
                                                           400)
    assert expected_sigma_kp1(512, 300) == jax_sigma(512, 300)
    with pytest.raises(ValueError, match="need l >= k, got l=4 < k=6"):
        rid(0, A, 6, l=4)


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_repro():
    """Every file of the port and chip_smoke.py: no import of jax (or
    jaxlib) and none of the reference package."""
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"
