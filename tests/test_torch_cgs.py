"""The port's Table 3 slice against the JAX reference, on the CPU: the CGS
kernels ``project_out`` and ``panel_deflate``, the split panel loop
``split_blocked_qr``, and the ``bench_qr`` module.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode (its complex types go to
its jnp oracle), as tests/test_kernels.py runs them.  Inputs are made with
a seeded numpy generator and cross as numpy arrays.
"""
import json
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.benchmarks import bench_qr  # noqa: E402
from repro_torch.configs import PAPER_GRID, SMALL_GRID  # noqa: E402
from repro_torch.kernels import panel_deflate, project_out  # noqa: E402
from repro_torch.kernels.common import (SMEM_BUDGET_BYTES,  # noqa: E402
                                        cdiv, dtype_code, product_tile,
                                        type_name)

DTYPES = ["float32", "float64", "complex64", "complex128"]


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


def _rand(rng, shape, dtype):
    dt = np.dtype(dtype)
    if dt.kind == "c":
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(dt)
    return rng.standard_normal(shape).astype(dt)


def _orthonormal(rng, l, k, dtype):
    return np.linalg.qr(_rand(rng, (l, k), dtype))[0].astype(dtype)


def _tol(dtype) -> float:
    return 1e-5 if dtype in ("float32", "complex64") else 1e-12


def _assert_close(got, want, rtol):
    """Agreement relative to the largest entry of ``want``."""
    want = np.asarray(want)
    np.testing.assert_allclose(interop.to_numpy(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


# ------------------------------------------------------------ the kernels

@pytest.mark.parametrize("l,k,n", [(33, 1, 129), (70, 17, 200),
                                   (200, 150, 130)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_project_out_matches_jax(l, k, n, dtype):
    """Ragged shapes (n not a multiple of the reference's 128-column slab,
    l not a multiple of 32), k from 1 to 150: 1e-5 (single) / 1e-12
    (double) of the largest entry."""
    from repro.kernels import project_out as jax_project_out
    rng = np.random.default_rng(40)
    q, z = _orthonormal(rng, l, k, dtype), _rand(rng, (l, n), dtype)
    want = jax_project_out(jnp.asarray(q), jnp.asarray(z))
    got = project_out(_t(q), _t(z))
    assert got.dtype == _t(z).dtype and tuple(got.shape) == (l, n)
    _assert_close(got, want, _tol(dtype))


@pytest.mark.parametrize("b", [1, 16, 32, 64])
@pytest.mark.parametrize("dtype", DTYPES)
def test_panel_deflate_matches_jax(b, dtype):
    """Both outputs, ``Z - Q_p W`` and ``W = Q_p^H Z``, at l=100, n=300."""
    from repro.kernels import panel_deflate as jax_panel_deflate
    rng = np.random.default_rng(41)
    q, z = _orthonormal(rng, 100, b, dtype), _rand(rng, (100, 300), dtype)
    want_o, want_w = jax_panel_deflate(jnp.asarray(q), jnp.asarray(z))
    got_o, got_w = panel_deflate(_t(q), _t(z))
    assert tuple(got_w.shape) == (b, 300) and got_w.dtype == _t(z).dtype
    _assert_close(got_o, want_o, _tol(dtype))
    _assert_close(got_w, want_w, _tol(dtype))


def test_cgs_ops_promote_and_validate():
    q = torch.linalg.qr(torch.randn(20, 4, dtype=torch.float64)).Q
    z = torch.randn(20, 7, dtype=torch.float32)
    assert project_out(q, z).dtype == torch.float64
    o, w = panel_deflate(q, z)
    assert o.dtype == w.dtype == torch.float64
    assert float((q.mH @ o).abs().max()) < 1e-12
    with pytest.raises(ValueError, match=r"q rows \(19\) must match z rows "
                                         r"\(20\)"):
        project_out(q[:19], z)
    with pytest.raises(ValueError, match="must share one device"):
        panel_deflate(q, z.to("meta"))


def test_cpu_tensors_take_the_plain_versions():
    from repro_torch.kernels.cgs.kernel import DEFLATE_LAUNCHES, LAUNCHES
    before = (LAUNCHES.count, DEFLATE_LAUNCHES.count)
    project_out(torch.eye(5, 2), torch.ones(5, 3))
    panel_deflate(torch.eye(5, 2), torch.ones(5, 3))
    assert (LAUNCHES.count, DEFLATE_LAUNCHES.count) == before


@pytest.mark.parametrize("call", ["project_out", "panel_deflate"])
def test_cgs_ops_raise_off_the_cpu_without_a_card(call):
    """A tensor that is not on the CPU goes to the kernel, never to the
    plain version: without a card (meta tensors here) the kernel wrapper
    raises, and the raw wrappers refuse CPU tensors."""
    from repro_torch.kernels.cgs.kernel import (panel_deflate_kernel,
                                                project_out_kernel)
    op, raw = {"project_out": (project_out, project_out_kernel),
               "panel_deflate": (panel_deflate, panel_deflate_kernel)}[call]
    with pytest.raises(ValueError, match="CUDA"):
        op(torch.ones(8, 2, device="meta"), torch.ones(8, 3, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        raw(torch.ones(8, 2), torch.ones(8, 3))


# The paper's Table 3 rows (l = 2k, k, n), the smallest and ragged bases,
# and the tile edges, for the launch geometry of project_out.
PROJECT_SHAPES = ([(2 * c.k, c.k, c.n) for c in PAPER_GRID]
                  + [(8, 1, 5), (3, 1, 1), (100, 60, 130), (127, 100, 129),
                     (129, 128, 131), (2000, 1000, 700)])
TORCH_DTYPES = [torch.float32, torch.float64, torch.complex64,
                torch.complex128]


@pytest.mark.parametrize("dtype", TORCH_DTYPES)
@pytest.mark.parametrize("l,k,n", PROJECT_SHAPES)
def test_project_out_launches_tile_both_products(dtype, l, k, n):
    """Two launches of one C call, in order: W = Q^H Z over (k, n) output
    tiles, then O = Z - Q W over (l, n); each with the row blocks the
    fastest grid index, every tile holding an output element, within the
    grid limits and one block's shared memory."""
    from repro_torch.kernels.cgs.kernel import (PROJECT_STAGES,
                                                project_out_launch)
    lw, lo = project_out_launch(dtype, l, k, n)
    bm, bn = product_tile(dtype)
    for ln, rows, part in ((lw, k, 0), (lo, l, 1)):
        gx, gy, gz = ln.grid
        assert (gx, gy, gz) == (cdiv(rows, bm), cdiv(n, bn), 1)
        assert (gx - 1) * bm < rows <= gx * bm
        assert (gy - 1) * bn < n <= gy * bn
        assert gx <= 2 ** 31 - 1 and gy <= 65535
        assert ln.smem <= SMEM_BUDGET_BYTES and ln.threads_per_block <= 1024
        assert (ln.part, ln.parts, ln.entry) == (part, 2, "repro_project_out")
        assert ln.args == (dtype_code(dtype), None, None, None, None, l, k, n,
                           None)
    if dtype == torch.float64:
        assert (bm, bn) == (128, 128)
        assert (lw.kernel, lo.kernel) == ("project_w_dmma_kernel<true>",
                                          "project_o_dmma_kernel<true>")
        assert lw.smem == lo.smem == PROJECT_STAGES * 32768
    else:
        assert (lw.kernel, lo.kernel) == (
            f"project_w_kernel<{type_name(dtype)}>",
            f"project_o_kernel<{type_name(dtype)}>")
        assert lw.smem == lo.smem == 0


def test_project_out_launches_skip_an_empty_product():
    """An empty basis (k = 0) launches only O = Z; no rows (l = 0) only
    W = 0; the geometry says so, as the C side launches."""
    from repro_torch.kernels.cgs.kernel import project_out_launch
    f64 = torch.float64
    (lo,) = project_out_launch(f64, 300, 0, 129)
    assert lo.kernel.startswith("project_o") and (lo.part, lo.parts) == (0, 1)
    (lw,) = project_out_launch(f64, 0, 7, 129)
    assert lw.kernel.startswith("project_w") and lw.grid == (1, 2, 1)
    assert project_out_launch(torch.float32, 0, 0, 5) == ()


# Shapes for panel_deflate's geometry: Table 3's rows and the split
# sweep's, the widest and the narrowest panels, ragged l and n, and l past
# the resident slab.
DEFLATE_SHAPES = [(800, 32, 2 ** 14), (800, 64, 2 ** 14), (256, 16, 4096),
                  (256, 64, 4096), (77, 3, 301), (1, 1, 1), (800, 1, 130),
                  (1600, 16, 1000), (4000, 32, 257), (10000, 64, 33)]


def _deflate_expected(dtype, l, b, nc, resident):
    """Shared bytes of csrc/panel_deflate.cu, written out: the slab (l
    rounded up to 32 rows), W (b rounded up to 16 rows), the ring of
    32-row stages of the panel (and of the slab when not resident): 2
    stages beside W, or 3 with W in their place for f64."""
    item = torch.empty((), dtype=dtype).element_size()
    bp = (b + 15) // 16 * 16
    slab = (l + 31) // 32 * 32 * nc if resident else 0
    if dtype == torch.float64:
        ring = 3 * 32 * (bp + (0 if resident else nc))
        return item * (slab + max(ring, bp * nc))
    ring = 2 * 32 * (bp + (0 if resident else nc))
    return item * (slab + ring + bp * nc)


@pytest.mark.parametrize("dtype", TORCH_DTYPES)
@pytest.mark.parametrize("l,b,n", DEFLATE_SHAPES)
def test_panel_deflate_launch_keeps_the_slab_resident_where_it_fits(
        dtype, l, b, n):
    """One CTA of 256 threads per column slab (32 columns, 16 for c128):
    the slab resident in shared memory when it fits one block's 232448 B,
    else 16 columns resident, else the re-reading geometry; every launch
    within the budget; the 16-byte-copy flag from the rows' byte widths."""
    from repro_torch.kernels.cgs.kernel import (DEFLATE_THREADS,
                                                deflate_geometry,
                                                panel_deflate_launch)
    ln = panel_deflate_launch(dtype, l, b, n)
    nc, resident = deflate_geometry(dtype, l, b)
    pref = 16 if dtype == torch.complex128 else 32
    fits = [c for c in (pref, 16)
            if _deflate_expected(dtype, l, b, c, True) <= SMEM_BUDGET_BYTES]
    assert (nc, resident) == ((fits[0], True) if fits else (pref, False))
    assert ln.grid == (cdiv(n, nc), 1, 1)
    assert ln.threads == (DEFLATE_THREADS, 1, 1)
    assert ln.smem == _deflate_expected(dtype, l, b, nc, resident)
    assert ln.smem <= SMEM_BUDGET_BYTES
    item = torch.empty((), dtype=dtype).element_size()
    vec = (b * item) % 16 == 0 and (n * item) % 16 == 0
    assert ln.kernel == (f"panel_deflate_kernel<{type_name(dtype)},{nc},"
                         f"{str(resident).lower()},{str(vec).lower()}>")
    assert (ln.entry, ln.args) == ("repro_panel_deflate",
                                   (dtype_code(dtype), None, None, None,
                                    None, l, b, n, None))


def test_panel_deflate_launch_at_the_main_row_and_past_the_slab():
    """f64 at Table 3's row keeps a 32-column slab resident (204800 B of
    slab, W in the ring's place: 229376 B); b = 64, or l = 1200, takes 16
    columns resident; l = 4000 re-reads; c128 has 16 columns only, resident
    at l = 256 and re-reading at 800."""
    from repro_torch.kernels.cgs.kernel import (deflate_geometry,
                                                panel_deflate_launch)
    f64, c128 = torch.float64, torch.complex128
    main = panel_deflate_launch(f64, 800, 32, 2 ** 14)
    assert (main.kernel, main.grid, main.smem) == (
        "panel_deflate_kernel<float64,32,true,true>", (512, 1, 1), 229376)
    assert deflate_geometry(f64, 800, 64) == (16, True)
    narrow = panel_deflate_launch(f64, 1200, 32, 2 ** 14)
    assert (narrow.kernel, narrow.grid) == (
        "panel_deflate_kernel<float64,16,true,true>", (1024, 1, 1))
    assert deflate_geometry(f64, 4000, 32) == (32, False)
    assert deflate_geometry(c128, 256, 32) == (16, True)
    assert deflate_geometry(c128, 800, 32) == (16, False)


# ------------------------------------------------------- split panel loop

def _sketch_like(rng, l, n):
    """Column norms spread log-uniformly over two decades: greedy pivot
    choices are separated by far more than the two libraries' rounding."""
    return rng.standard_normal((l, n)) * np.logspace(0, 2, n)[rng.permutation(n)]


@pytest.mark.parametrize("k,panel", [(20, 8), (24, 24)])
def test_split_blocked_qr_matches_jax(k, panel):
    """The split panel_gram + Cholesky + panel_deflate loop against the
    reference's (real f64, with a remainder panel at k=20, panel=8):
    equal pivots in order, Q and R within 1e-9 of their largest entry."""
    from benchmarks.bench_qr import split_blocked_qr as jax_split
    Y = _sketch_like(np.random.default_rng(42), 48, 300)
    jq, jr, jp = jax_split(jnp.asarray(Y), k, panel)
    q, r, p = bench_qr.split_blocked_qr(_t(Y), k, panel)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    _assert_close(q, jq, 1e-9)
    _assert_close(r, jr, 1e-9)
    eye = np.eye(k)
    np.testing.assert_allclose((q.mH @ q).numpy(), eye, atol=1e-12)


def test_split_blocked_qr_matches_the_fused_engine():
    """The split loop and the fused ``blocked_pivoted_qr`` pick the same
    pivots and agree in Q on a complex sketch (the split loop takes .mH
    everywhere)."""
    from repro_torch.core import blocked_pivoted_qr
    rng = np.random.default_rng(43)
    Y = _t((_sketch_like(rng, 40, 200)
            + 1j * _sketch_like(rng, 40, 200)).astype(np.complex128))
    q, r, p = bench_qr.split_blocked_qr(Y, 16, 8)
    fused = blocked_pivoted_qr(Y, 16, panel=8)
    assert torch.equal(p, fused.piv)
    _assert_close(q, interop.to_numpy(fused.Q), 1e-9)
    _assert_close(r, interop.to_numpy(fused.R), 1e-9)


def test_fused_flops_counts_each_panel():
    l, n, k = 256, 4096, 128
    one = bench_qr.fused_flops(l, n, k, 128)
    want = (2 * l * n + 2 * l * k * n + 2 * (3 * l * k * k + k ** 3 / 3)
            + 4 * l * k * n + 2 * l * n)
    assert one == pytest.approx(want)
    # Two panels add the re-projection of the second against the first.
    two = bench_qr.fused_flops(l, n, k, 64)
    b = 64
    assert two == pytest.approx(
        2 * l * n + 2 * l * k * n + 4 * l * b * b
        + 2 * (2 * (3 * l * b * b + b ** 3 / 3) + 4 * l * b * n + 2 * l * n))


# ------------------------------------------------------------ bench module

def test_bench_qr_runs_one_row_on_the_cpu():
    rows = bench_qr.run(SMALL_GRID[:1], torch.float32, device="cpu")
    assert len(rows) == 1 and rows[0]["device"] == "cpu"
    row = rows[0]
    cols = ["cgs2_pivoted_s", "blocked_b16_s", "blocked_b32_s",
            "blocked_b64_s", "householder_panel_s", "choleskyqr2_panel_s",
            "cuda_deflate_s", "cuda_panel_deflate_s"]
    assert [c for c in row if c.endswith("_s")] == cols
    assert all(math.isfinite(row[c]) and row[c] > 0 for c in cols), row
    best = min(row[f"blocked_b{b}_s"] for b in bench_qr.PANEL_SWEEP)
    assert row["blocked_speedup"] == pytest.approx(row["cgs2_pivoted_s"]
                                                   / best)


def test_bench_qr_refuses_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="is_available"):
        bench_qr.run(SMALL_GRID[:1], torch.float32)


def test_bench_qr_cli_prints_and_records_rows(tmp_path, capsys):
    path = tmp_path / "rows.json"
    bench_qr.main(["--device", "cpu", "--panels", "32", "--json", str(path)])
    out = capsys.readouterr().out
    assert out.startswith("# Table 3 analogue")
    assert ("k,l,n,dtype,device,cgs2_pivoted_s,blocked_b32_s,"
            "blocked_speedup,householder_panel_s,choleskyqr2_panel_s,"
            "cuda_deflate_s,cuda_panel_deflate_s") in out
    assert "# Acceptance: blocked vs cgs2, l=256 n=4096 k=128 f32" in out
    assert "fused_panel_step,256,4096,128,32,cpu," in out
    rows = json.loads(path.read_text())
    assert len(rows) == len(SMALL_GRID) + 2
    assert [r["k"] for r in rows[:len(SMALL_GRID)]] == \
        [c.k for c in SMALL_GRID]
    assert rows[-2]["panel"] == 32 and "cgs2_s" in rows[-2]
    assert rows[-1]["bench"] == "fused_panel_step"
    assert rows[-1]["flops"] == bench_qr.fused_flops(256, 4096, 128, 32)
