"""The port's phase-benchmark slice against the JAX reference, on the CPU:
the kernels of paper Tables 2 and 4 (``sketch_matmul``, ``fwht``/``srht``,
``tsolve``), the port's copy of the paper grid, and the three bench
modules.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
side runs its Pallas kernels in interpret mode (its complex paths go to
jnp/XLA), as tests/test_kernels.py runs them.  Inputs are made with a
seeded numpy generator and cross as numpy arrays.
"""
import json
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch.benchmarks import (bench_sketch, bench_total,  # noqa: E402
                                    bench_tsolve)
from repro_torch.benchmarks.bench_tsolve import (backward_error,  # noqa: E402
                                                 bench_system)
from repro_torch.configs import SMALL_GRID  # noqa: E402
from repro_torch.kernels.sketch_matmul import sketch_matmul  # noqa: E402
from repro_torch.kernels.srht import fwht, fwht_factors, srht  # noqa: E402
from repro_torch.kernels.tsolve import tsolve  # noqa: E402

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


def _single(dtype) -> bool:
    return dtype in ("float32", "complex64")


def _assert_close(got, want, rtol):
    """Agreement relative to the largest entry of ``want``."""
    want = np.asarray(want)
    np.testing.assert_allclose(interop.to_numpy(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_paper_grid_is_the_reference_grid():
    from repro.configs import paper_rid as ref
    from repro_torch.configs import paper_rid as port
    for name in ("PAPER_GRID", "SMALL_GRID", "PAPER_PROCS",
                 "PAPER_TABLE5_ERRORS"):
        assert tuple(map(tuple, np.atleast_2d(getattr(port, name)))) == \
            tuple(map(tuple, np.atleast_2d(getattr(ref, name)))), name
    row = port.PAPER_GRID[2]
    assert (row.k, row.m, row.n, row.l) == (400, 2 ** 16, 2 ** 14, 800)
    assert str(row) == str(ref.PAPER_GRID[2])
    assert row.bytes_c128 == ref.PAPER_GRID[2].bytes_c128


# ----------------------------------------------------------- sketch_matmul

@pytest.mark.parametrize("l,m,n", [(8, 64, 32), (17, 1000, 150),
                                   (100, 777, 129)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sketch_matmul_matches_jax(l, m, n, dtype):
    """Ragged shapes; the reference pads to its tiles and runs complex as
    four real GEMMs, the port runs one complex product, so they agree to
    1e-5 (single) / 1e-12 (double) of the largest entry, not in bits."""
    from repro.kernels import sketch_matmul as jax_sketch_matmul
    rng = np.random.default_rng(30)
    om, a = _rand(rng, (l, m), dtype), _rand(rng, (m, n), dtype)
    want = jax_sketch_matmul(jnp.asarray(om), jnp.asarray(a))
    got = sketch_matmul(_t(om), _t(a))
    assert got.dtype == _t(a).dtype and tuple(got.shape) == (l, n)
    _assert_close(got, want, 1e-5 if _single(dtype) else 1e-12)


# ------------------------------------------------------------- fwht / srht

@pytest.mark.parametrize("m,n", [(2, 5), (64, 5), (1024, 40), (8192, 3),
                                 (16384, 4)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_fwht_bit_equal_to_jax(m, n, dtype):
    """The stages in increasing-h order and one final scale: bit-equal to
    the reference's kernel, its four-step split at m = 16384 included."""
    from repro.kernels import fwht_pallas
    x = _rand(np.random.default_rng(31), (m, n), dtype)
    want = np.asarray(fwht_pallas(jnp.asarray(x)))
    np.testing.assert_array_equal(interop.to_numpy(fwht(_t(x))), want)


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_fwht_complex_matches_jax(dtype):
    """The reference's Pallas transform takes real dtypes only; complex is
    held against its jnp oracle."""
    from repro.kernels.srht.ref import fwht_ref as jax_fwht_ref
    x = _rand(np.random.default_rng(32), (1024, 6), dtype)
    _assert_close(fwht(_t(x)), jax_fwht_ref(jnp.asarray(x)),
                  1e-6 if _single(dtype) else 1e-14)


def test_fwht_factors_and_validation():
    assert fwht_factors(1) == [0] and fwht_factors(256) == [8]
    assert fwht_factors(2 ** 13) == [7, 6]
    assert fwht_factors(2 ** 16) == [8, 8]
    assert fwht_factors(2 ** 18) == [6, 6, 6]
    for m in (1, 2 ** 9, 2 ** 17, 2 ** 24):
        assert sum(fwht_factors(m)) == m.bit_length() - 1
        assert max(fwht_factors(m)) <= 8
    with pytest.raises(ValueError, match="power of two, got 100"):
        fwht(torch.ones(100, 3))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_srht_matches_jax(dtype):
    """Injected signs and rows at a non-power-of-two m (zero pad to 1024)."""
    from repro.kernels import srht_pallas
    rng = np.random.default_rng(33)
    m, n, l = 700, 24, 32
    a = _rand(rng, (m, n), dtype)
    signs = np.where(rng.standard_normal(m) > 0, 1.0, -1.0).astype(dtype)
    rows = rng.integers(0, 1024, l).astype(np.int32)
    want = np.asarray(srht_pallas(jnp.asarray(signs), jnp.asarray(a),
                                  jnp.asarray(rows)))
    got = interop.to_numpy(srht(_t(signs), _t(a), _t(rows)))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match=r"signs shape \(699,\) must be "
                                         r"\(700,\)"):
        srht(_t(signs[:-1]), _t(a), _t(rows))


# ------------------------------------------------------------------ tsolve

@pytest.mark.parametrize("k,n", [(77, 33), (150, 200)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tsolve_matches_jax(k, n, dtype):
    """A well-conditioned R1 (the R of a QR) with junk below the diagonal,
    k not a multiple of the reference's 128-row blocks: 1e-12 (double) /
    1e-5 (single) of the largest entry of T."""
    from repro.kernels import tsolve as jax_tsolve
    rng = np.random.default_rng(34)
    r = np.linalg.qr(_rand(rng, (k + 20, k), dtype))[1]
    r1 = (r + np.tril(_rand(rng, (k, k), dtype), -1)).astype(dtype)
    r2 = _rand(rng, (k, n), dtype)
    want = jax_tsolve(jnp.asarray(r1), jnp.asarray(r2))
    got = tsolve(_t(r1), _t(r2))
    assert got.dtype == _t(r2).dtype
    _assert_close(got, want, 1e-5 if _single(dtype) else 1e-12)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tsolve_backward_error_on_bench_system(dtype):
    """The bench's R1 = triu(randn) + 3 I is exponentially ill-conditioned,
    so elementwise agreement means little: the port's solve and the
    reference's kernel are each held to a normwise backward error of
    4 k eps on the same system."""
    from repro.kernels import tsolve as jax_tsolve
    k, n = 200, 64
    r1, r2 = bench_system(torch.Generator().manual_seed(35), k, n,
                          getattr(torch, dtype), "cpu")
    bar = 4 * k * np.finfo(dtype).eps
    assert backward_error(r1, r2, tsolve(r1, r2)) <= bar
    jt = np.asarray(jax_tsolve(jnp.asarray(r1.numpy()),
                               jnp.asarray(r2.numpy())))
    assert backward_error(r1, r2, _t(jt)) <= bar


# ---------------------------------------------------- dispatch, no fallback

def test_cpu_tensors_take_the_plain_versions():
    from repro_torch.kernels.sketch_matmul.kernel import LAUNCHES as LM
    from repro_torch.kernels.srht.kernel import LAUNCHES as LF
    from repro_torch.kernels.tsolve.kernel import LAUNCHES as LT
    before = (LM.count, LF.count, LT.count)
    sketch_matmul(torch.ones(4, 9), torch.ones(9, 3))
    srht(torch.ones(9), torch.ones(9, 3), torch.zeros(2, dtype=torch.int64))
    tsolve(torch.eye(3), torch.ones(3, 2))
    assert (LM.count, LF.count, LT.count) == before


@pytest.mark.parametrize("call", ["sketch_matmul", "fwht", "tsolve"])
def test_new_ops_raise_off_the_cpu_without_a_card(call):
    """A tensor that is not on the CPU goes to the kernel, never to the
    plain version: without a card (meta tensors here) the kernel wrapper
    raises, and the raw wrappers refuse CPU tensors."""
    from repro_torch.kernels.sketch_matmul.kernel import sketch_matmul_kernel
    from repro_torch.kernels.srht.kernel import fwht_pass_kernel
    from repro_torch.kernels.tsolve.kernel import tsolve_kernel
    op, raw = {
        "sketch_matmul": (lambda d: sketch_matmul(torch.ones(4, 8, device=d),
                                                  torch.ones(8, 3, device=d)),
                          lambda: sketch_matmul_kernel(torch.ones(4, 8),
                                                       torch.ones(8, 3))),
        "fwht": (lambda d: fwht(torch.ones(8, 3, device=d)),
                 lambda: fwht_pass_kernel(torch.ones(8, 3), torch.ones(8, 3),
                                          3, 1, 1.0)),
        "tsolve": (lambda d: tsolve(torch.eye(3, device=d),
                                    torch.ones(3, 2, device=d)),
                   lambda: tsolve_kernel(torch.eye(3), torch.ones(3, 2))),
    }[call]
    with pytest.raises(ValueError, match="CUDA"):
        op("meta")
    with pytest.raises(ValueError, match="CUDA"):
        raw()


def test_bench_modules_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for run in (lambda: bench_sketch.run(SMALL_GRID[:1], torch.float32),
                lambda: bench_tsolve.run(SMALL_GRID[:1], torch.float32),
                lambda: bench_total.run(SMALL_GRID[:1], "srft",
                                        torch.complex64)):
        with pytest.raises(RuntimeError, match="is_available"):
            run()


# ------------------------------------------------------------ bench modules

@pytest.mark.parametrize("bench", ["sketch", "tsolve", "total"])
def test_bench_module_runs_one_row_on_the_cpu(bench):
    run = {"sketch": lambda: bench_sketch.run(SMALL_GRID[:1], torch.float32,
                                              device="cpu"),
           "tsolve": lambda: bench_tsolve.run(SMALL_GRID[:1], torch.float32,
                                              device="cpu"),
           "total": lambda: bench_total.run(SMALL_GRID[:1], "srft",
                                            torch.complex64, device="cpu")}
    rows = run[bench]()
    assert len(rows) == 1 and rows[0]["device"] == "cpu"
    times = {key: v for key, v in rows[0].items() if key.endswith("_s")}
    assert len(times) >= 3
    assert all(math.isfinite(v) and v > 0 for v in times.values()), times
    if bench == "tsolve":
        k = SMALL_GRID[0].k
        assert rows[0]["cuda_backward_err"] <= 4 * k * np.finfo("float32").eps


def test_bench_cli_prints_and_records_rows(tmp_path, capsys):
    path = tmp_path / "rows.json"
    bench_tsolve.main(["--device", "cpu", "--json", str(path)])
    bench_tsolve.main(["--device", "cpu", "--json", str(path)])
    out = capsys.readouterr().out
    assert out.startswith("# Table 4 analogue")
    assert "k,n,dtype,device,rowrec_s,lib_s,cuda_s,cuda_backward_err" in out
    rows = json.loads(path.read_text())
    assert len(rows) == 2 * len(SMALL_GRID)
    assert [r["k"] for r in rows[:len(SMALL_GRID)]] == \
        [c.k for c in SMALL_GRID]


# ------------------------------------------------- the DMMA tile's bench

@pytest.mark.parametrize("parts", [("probe",), ("kernels", "shapes"),
                                   ("gram",), ("deflate",), ("split",),
                                   ("flash",)])
def test_bench_dmma_refuses_a_missing_card(parts):
    from repro_torch.benchmarks import bench_dmma
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        bench_dmma.run("cpu", parts)


def test_bench_dmma_cli_refuses_an_unknown_part():
    from repro_torch.benchmarks import bench_dmma
    with pytest.raises(SystemExit):
        bench_dmma.main(["--parts", "variants"])


def test_bench_dmma_parity_holds_gram_rows_to_an_earlier_run():
    """Each gram row is bit-equal only where the earlier run has a row at
    the same (dtype, l, b, n) with both digests; other rows are ignored."""
    from repro_torch.benchmarks.bench_dmma import parity
    row = {"what": "gram", "kernel": "panel_gram", "dtype": "float64",
           "l": 800, "b": 32, "n": 16384, "g_sha256": "g", "v_sha256": "v"}
    other = {"what": "kernel", "kernel": "sketch_matmul"}
    assert [r["bit_equal"] for r in parity([row, other], [other, row])] == [True]
    assert not parity([row], [dict(row, v_sha256="w")])[0]["bit_equal"]
    assert not parity([row], [dict(row, b=16)])[0]["bit_equal"]
    assert parity([other], [row]) == []


def test_bench_dmma_parity_holds_sweep_rows_and_skips_deflate_rows():
    """``sweep`` rows (panel_step, panel_coeff, panel_apply) are held to
    the earlier run's digest list; ``deflate`` rows (a kernel this slice
    redesigned) are not held at all."""
    from repro_torch.benchmarks.bench_dmma import parity
    sweep = {"what": "sweep", "kernel": "panel_coeff", "dtype": "complex64",
             "l": 800, "b": 32, "n": 16384, "outputs_sha256": ["w", "r2"]}
    deflate = {"what": "deflate", "kernel": "panel_deflate",
               "dtype": "float64", "l": 800, "b": 32, "n": 16384,
               "o_sha256": "o", "w_sha256": "w"}
    assert [r["bit_equal"] for r in parity([sweep, deflate],
                                           [sweep])] == [True]
    other = dict(sweep, outputs_sha256=["w", "r3"])
    assert not parity([sweep], [other])[0]["bit_equal"]
    assert not parity([sweep], [dict(sweep, kernel="panel_step")])[0][
        "bit_equal"]


def test_bench_dmma_deflate_and_flash_work_counts():
    """panel_deflate: 2 l b n multiply-adds (8 real flops each in complex),
    Q_p and Z read and O and W written once; flash: 4 hd flops a live pair,
    the live pairs those the causal mask and the window keep (counted here
    against the dense mask), q, k, v read and o written once."""
    from repro_torch.benchmarks.bench_dmma import (deflate_work, flash_work,
                                                   live_pairs)
    flops, nbytes = deflate_work(torch.float64, 800, 32, 2 ** 14)
    assert flops == 4.0 * 800 * 32 * 2 ** 14 == 1677721600.0
    assert nbytes == 8 * (800 * 32 + 2 * 800 * 2 ** 14 + 32 * 2 ** 14)
    assert deflate_work(torch.complex64, 10, 3, 7) == (
        8.0 * 2 * 10 * 3 * 7, 8 * (10 * 3 + 2 * 10 * 7 + 3 * 7))
    for s, t, causal, window in ((50, 50, True, None), (40, 70, True, None),
                                 (60, 60, True, 9), (30, 20, False, None),
                                 (70, 40, True, 16)):
        i, j = np.arange(s)[:, None], np.arange(t)[None, :]
        ok = np.ones((s, t), bool)
        if causal:
            ok &= j <= i
        if window:
            ok &= j > i - window
        assert live_pairs(s, t, causal, window) == int(ok.sum())
    pairs, flops, nbytes = flash_work(32, 4000, 4000, 64, True, None,
                                      torch.float32, torch.bfloat16)
    assert pairs == 32 * 4000 * 4001 // 2 == 256064000
    assert flops == 4.0 * 64 * pairs
    assert nbytes == 32 * 64 * (2 * 4000 * 4 + 2 * 4000 * 2)


def test_bench_dmma_device_summary_sums_a_trace_by_kernel():
    """The split part's trace: rows of one kernel (its template arguments
    kept, its argument list and namespace dropped) add up in ms and
    launches; busy is the sum of the device rows, idle the rest of the
    wall time; kernels come by device time."""
    from repro_torch.benchmarks.bench_dmma import device_summary
    rows = [("void (anonymous namespace)::panel_deflate_kernel<float, 32, "
             "true, true>(float const*, float const*, float*, float*, long, "
             "int, long)", 300.0, 4),
            ("void panel_gram_kernel<float, true, 1>(float const*, long)",
             500.0, 4),
            ("void (anonymous namespace)::panel_deflate_kernel<float, 32, "
             "true, true>(float const*, float const*, float*, float*, long, "
             "int, long)", 250.0, 2)]
    got = device_summary(rows, 0.002)
    assert got["busy_ms"] == pytest.approx(1.05)
    assert got["idle_share"] == pytest.approx(0.475)
    assert got["kernels"] == [
        {"name": "panel_deflate_kernel<float, 32, true, true>",
         "ms": pytest.approx(0.55), "launches": 6},
        {"name": "panel_gram_kernel<float, true, 1>", "ms": 0.5,
         "launches": 4}]
