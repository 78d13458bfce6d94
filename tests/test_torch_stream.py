"""The streamed ID of the port (``repro_torch.stream``): bit for bit against
the port's in-memory gaussian ``rid``, against the reference's
``rid_streamed`` with its operator injected, under faults, killed and
resumed, and its three benchmarks on patched small grids.  CPU only."""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import rid, spectral_norm_dense  # noqa: E402
from repro_torch.data import spectrum_id_error  # noqa: E402
from repro_torch.obs import FakeClock, ProgressReporter, tracing  # noqa: E402
from repro_torch.runtime import (ChunkReadFailed, FaultPlan,  # noqa: E402
                                 FlakySource, RetryPolicy, SourceDied)
from repro_torch.stream import (ArraySource, SpectrumSource,  # noqa: E402
                                rid_streamed)
from repro_torch.benchmarks.bench_chaos import (  # noqa: E402
    fields_equal, killed_twice_then_resumed)
from torch_ranks import pin_threads  # noqa: E402

pin_threads()


@pytest.fixture(autouse=True, scope="module")
def _x64_scope():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


def _matrix(dtype, m=1024, n=160, k=16, seed=5, noise=1e-3):
    """A numerically rank-``k`` matrix plus a little noise, as a tensor."""
    g = torch.Generator().manual_seed(seed)
    rdt = torch.float64

    def draw(shape):
        x = torch.randn(shape, generator=g, dtype=rdt)
        if dtype.is_complex:
            x = torch.complex(x, torch.randn(shape, generator=g, dtype=rdt))
        return x
    return draw((m, k)) @ draw((k, n)) + noise * draw((m, n))


@pytest.mark.parametrize("chunk_rows", [128, 256, 384, 1024])
@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_streamed_equals_in_memory_rid_bit_for_bit(dtype, chunk_rows):
    """All five fields of the in-memory gaussian rid, for chunkings of one
    block, two, three (an uneven last chunk: 1024 % 384) and all of m."""
    A = _matrix(dtype)
    want = rid(7, A, 16, sketch_kind="gaussian")
    got = rid_streamed(7, ArraySource(A, chunk_rows), 16, device="cpu")
    assert fields_equal(got, want)
    assert got.B.device.type == "cpu" and got.B.shape == (1024, 16)


def test_streamed_serial_cgs2_and_generator_seed():
    A = _matrix(torch.float64)
    src = ArraySource(A, 256)
    want = rid(3, A, 16, sketch_kind="gaussian", qr_impl="cgs2")
    got = rid_streamed(3, src, 16, qr_impl="cgs2", overlap=False,
                       device="cpu")
    assert fields_equal(got, want)
    g1, g2 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    assert fields_equal(rid_streamed(g1, src, 16, device="cpu"),
                        rid(g2, A, 16, sketch_kind="gaussian"))


def test_spectrum_source_streams_like_its_materialised_matrix():
    src = SpectrumSource(2, 1024, 128, "fast_decay", 10, chunk_rows=256,
                         floor=1e-12, device="cpu")
    got = rid_streamed(4, src, 10, device="cpu")
    assert fields_equal(got, rid(4, src.materialize(), 10,
                                 sketch_kind="gaussian"))


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_closed_form_error_equals_the_dense_norm(dtype):
    """||A - B P||_2 from the source's factors (no row of A formed) equals
    the dense norm of the materialised residual."""
    src = SpectrumSource(3, 1536, 192, "noisy_tail", 12, chunk_rows=512,
                         dtype=dtype, floor=1e-12, device="cpu")
    dec = rid_streamed(1, src, 12, device="cpu")
    A = src.materialize()
    dense = float(spectral_norm_dense(A - dec.B @ dec.P))
    assert spectrum_id_error(src.factors, dec.J, dec.P) == \
        pytest.approx(dense, rel=1e-9)


def test_validation():
    A = _matrix(torch.float64, m=512)
    with pytest.raises(ValueError, match="multiple of ACCUM_BLOCK"):
        rid_streamed(0, ArraySource(A, 200), 16, device="cpu")
    with pytest.raises(ValueError, match="cannot stream"):
        rid_streamed(0, ArraySource(A, 256), 16, sketch_kind="srft",
                     device="cpu")
    with pytest.raises(ValueError, match="panel_parallel"):
        rid_streamed(0, ArraySource(A, 256), 16, qr_impl="panel_parallel",
                     device="cpu")
    with pytest.raises(ValueError, match="checkpoint_every"):
        rid_streamed(0, ArraySource(A, 256), 16, checkpoint_every=0,
                     device="cpu")
    with pytest.raises(ValueError, match="ChunkSource"):
        rid_streamed(0, A, 16, device="cpu")
    with pytest.raises(ValueError, match="omega"):
        rid_streamed(0, ArraySource(A, 256), 16, device="cpu",
                     omega=torch.zeros(3, 3))

    class Liar(ArraySource):
        def chunk(self, c):
            return super().chunk(c)[:-1]
    with pytest.raises(ValueError, match=r"source.chunk\(0\) returned shape"):
        rid_streamed(0, Liar(A, 256), 16, device="cpu")
    # one chunk covering m needs no block multiple
    assert rid_streamed(0, ArraySource(A, 600), 16, device="cpu").J.numel() \
        == 16


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        rid_streamed(0, ArraySource(_matrix(torch.float64, m=256), 128), 8)


def test_slice_matches_the_reference_rid_streamed():
    """The port's rid_streamed with the reference's Omega injected, and the
    reference's rid_streamed, on the same ArraySource data: on an exact
    rank-k matrix of well-separated, well-conditioned singular values
    (1 down to 0.1), the same pivots in the same order, so B bit for bit,
    and P to 1e-10 of its largest entry (the two sum in different
    orders)."""
    from repro.core.sketch import gaussian_omega_cols as jax_omega
    from repro.stream import ArraySource as RefArraySource
    from repro.stream import rid_streamed as ref_rid_streamed
    m, n, k = 1024, 128, 12
    g = torch.Generator().manual_seed(11)
    U = torch.linalg.qr(torch.randn(m, k, generator=g,
                                    dtype=torch.float64)).Q
    V = torch.linalg.qr(torch.randn(n, k, generator=g,
                                    dtype=torch.float64)).Q
    A = (U * torch.logspace(0, -1, k, dtype=torch.float64)) @ V.T
    A_np = A.numpy()
    key = jax.random.key(4)
    omega = np.asarray(jax_omega(key, 0, m, 2 * k, jnp.float64))
    want = ref_rid_streamed(key, RefArraySource(A_np, 256), k, qr_panel=8)
    got = rid_streamed(0, ArraySource(A, 256), k, qr_panel=8, device="cpu",
                       omega=torch.from_numpy(omega.copy()))
    wJ, gJ = np.asarray(want.J), got.J.numpy()
    assert gJ.tolist() == wJ.tolist()
    np.testing.assert_allclose(got.P.numpy(), np.asarray(want.P), rtol=0,
                               atol=1e-10 * np.abs(np.asarray(want.P)).max())
    np.testing.assert_array_equal(got.B.numpy(), np.asarray(want.B))


def test_kill_in_both_passes_then_resume_is_bit_equal():
    A = _matrix(torch.float64)
    clean = rid_streamed(1, ArraySource(A, 128), 16, device="cpu")
    killed1, killed2, out = killed_twice_then_resumed(A, 128, 16, "cpu")
    assert killed1 and killed2
    assert fields_equal(out, clean)


def test_retries_are_bit_equal_and_failures_are_named(tmp_path):
    A = _matrix(torch.complex128, m=768)
    clean = rid_streamed(1, ArraySource(A, 128), 16, device="cpu")
    flaky = FlakySource(ArraySource(A, 128), FaultPlan(seed=3,
                                                       transient_p=0.3))
    clock = FakeClock()
    pol = RetryPolicy(max_attempts=12, seed=3, clock=clock)
    with tracing() as tr:
        out = rid_streamed(1, flaky, 16, retry=pol, device="cpu")
    assert fields_equal(out, clean)
    assert flaky.injected["transient"] > 0
    assert tr.metrics.counter("stream.retry").value == \
        flaky.injected["transient"]
    never = FlakySource(ArraySource(A, 128), FaultPlan(transient={2: 99}))
    with pytest.raises(ChunkReadFailed, match=r"source.chunk\(2\)"):
        rid_streamed(1, never, 16, retry=RetryPolicy(
            max_attempts=3, clock=FakeClock()), device="cpu")
    dead = FlakySource(ArraySource(A, 128), FaultPlan(die_at=4))
    with pytest.raises(SourceDied):
        rid_streamed(1, dead, 16, retry=pol, device="cpu",
                     resume_dir=str(tmp_path))


def test_foreign_checkpoint_is_refused(tmp_path):
    A = _matrix(torch.float64, m=512)
    rid_streamed(1, ArraySource(A, 128), 16, device="cpu",
                 resume_dir=str(tmp_path))
    with pytest.raises(ValueError, match="different job") as ei:
        rid_streamed(2, ArraySource(A, 128), 16, device="cpu",
                     resume_dir=str(tmp_path))
    assert "!=" in str(ei.value)
    with pytest.raises(ValueError, match="different job"):
        rid_streamed(1, ArraySource(A, 256), 16, device="cpu",
                     resume_dir=str(tmp_path))


def test_progress_counts_both_passes_and_the_trace_records_the_job():
    A = _matrix(torch.float64, m=640)
    seen = []
    rep = ProgressReporter(callbacks=[seen.append], clock=FakeClock(tick=1))
    with tracing() as tr:
        rid_streamed(1, ArraySource(A, 128), 16, device="cpu", progress=rep)
    assert rep.total == 10 and rep.done == 10 and rep.state == "done"
    assert [s["phase"] for s in seen if s["done"] in (0, 5)][:1] == ["pass1"]
    assert {"pass1", "qr_interp", "pass2"} <= {s["phase"] for s in seen}
    names = [s.name for s in tr.spans]
    assert names.count("stream.accumulate") == 5
    assert names.count("stream.gather") == 5
    assert tr.metrics.counter("stream.chunks").value == 5
    assert tr.metrics.counter("stream.h2d_bytes").value == 0   # on the CPU
    root = next(s for s in tr.spans if s.name == "rid_streamed")
    assert len(root.attrs["job"]) == 12
    cert = [e for s in tr.spans for e in s.events if e[0] == "eq3.certificate"]
    assert cert and cert[0][2]["k"] == 16


# ------------------------------------------------------------ benchmarks

def test_bench_stream_on_a_patched_small_grid(monkeypatch, tmp_path):
    from repro_torch.benchmarks import bench_stream
    monkeypatch.setattr(bench_stream, "SWEEP_MS", (1024, 2048))
    monkeypatch.setattr(bench_stream, "N", 96)
    monkeypatch.setattr(bench_stream, "K", 8)
    monkeypatch.setattr(bench_stream, "CHUNK_ROWS", 256)
    out = tmp_path / "rows.json"
    bench_stream.main(["--device", "cpu", "--json", str(out)])
    rows = __import__("json").loads(out.read_text())
    scaling = [r for r in rows if r["bench"] == "stream_scaling"]
    assert [r["m"] for r in scaling] == [1024, 2048]
    assert all(r["peak_device_bytes"] is None and r["wall_pipelined_s"] > 0
               for r in scaling)
    phases = [r for r in rows if r["bench"] == "stream_phases"]
    assert [r["phase"] for r in phases] == ["h2d", "accumulate", "qr_interp",
                                            "gather"]


def test_bench_chaos_on_a_small_matrix(monkeypatch, tmp_path):
    from repro_torch.benchmarks import bench_chaos
    monkeypatch.setenv("REPRO_CHAOS_SEED", "5")
    monkeypatch.setenv("REPRO_CHAOS_P", "0.2")
    row = bench_chaos.chaos_run(m=1024, n=64, k=8, chunk_rows=128,
                                device="cpu",
                                report_path=str(tmp_path / "r.json"))
    assert row["retry_parity_bit_exact"] and row["resume_parity_bit_exact"]
    assert row["kill_pass1_fired"] and row["kill_pass2_fired"]
    assert row["injected"]["transient"] > 0 and row["seed"] == 5
    assert (tmp_path / "r.json").exists()


def test_bench_overlap_on_a_patched_small_matrix(monkeypatch, tmp_path):
    from repro_torch.benchmarks import bench_overlap
    monkeypatch.setattr(bench_overlap, "M", 1024)
    monkeypatch.setattr(bench_overlap, "N", 64)
    monkeypatch.setattr(bench_overlap, "K", 8)
    monkeypatch.setattr(bench_overlap, "CHUNK_ROWS", 128)
    rows = bench_overlap.overlap_gate(device="cpu",
                                      out_dir=str(tmp_path / "o"))
    row = rows[0]
    assert 0.0 <= row["hidden_fraction"] <= 1.0
    assert row["exposed_serial_s"] > 0 and row["wall_pipelined_s"] > 0
    for name in ("trace_pipelined.jsonl", "trace_serialized.jsonl",
                 "overlap_report.json", "progress.json"):
        assert (tmp_path / "o" / name).exists()
