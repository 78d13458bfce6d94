"""The streamed ID's supporting modules in the port: the known-spectrum
row generator against the reference's, the checkpoint store, the fault
harness and retry policy, progress, the residency sampler, the chunk
sources and the prefetcher.  CPU only, small sizes."""
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.checkpoint import (CheckpointManager, latest_step,  # noqa: E402
                                    restore_pytree, save_pytree)
from repro_torch.core.rng import block_seed  # noqa: E402
from repro_torch.data import (PrefetchIterator, SpectrumFactors,  # noqa: E402
                              row_diagonal, spectrum_factors, spectrum_rows)
from repro_torch.obs import (FakeClock, MeteredSource,  # noqa: E402
                             ProgressReporter, live_device_bytes, tracing)
from repro_torch.runtime import (ChunkReadFailed, FaultPlan,  # noqa: E402
                                 FlakySource, ProcessKilled, ReadTimeout,
                                 RetryPolicy, SourceDied, TransientReadError)
from repro_torch.runtime.faults import _uniform  # noqa: E402
from repro_torch.stream import (ArraySource, FileSource,  # noqa: E402
                                SpectrumSource, chunk_bounds, num_chunks)
from torch_ranks import pin_threads  # noqa: E402

pin_threads()


@pytest.fixture(autouse=True, scope="module")
def _x64_scope():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", prev)


# ------------------------------------------------------------ synthetic

def _reference_diag(rf, r0, r1):
    """The reference's row diagonal of ``spectrum_rows`` (its lines drawing
    ``d``), rebuilt here."""
    i = jnp.arange(r0, r1)
    keys = jax.vmap(lambda ii: jax.random.fold_in(rf.sign_key, ii))(i)
    if jnp.issubdtype(rf.dtype, jnp.complexfloating):
        phase = jax.vmap(lambda kk: jax.random.uniform(kk, ()))(keys)
        return np.array(jnp.exp((2j * jnp.pi) * phase.astype(jnp.float64)))
    return np.array(jax.vmap(
        lambda kk: jax.random.rademacher(kk, (), jnp.float64))(keys))


@pytest.mark.parametrize("dtype,tdtype", [("float64", torch.float64),
                                          ("complex128", torch.complex128)])
@pytest.mark.parametrize("spectrum", ["fast_decay", "cliff"])
def test_spectrum_rows_match_the_reference(dtype, tdtype, spectrum):
    """Given the reference's frequencies, V, sigmas and row diagonal, the
    port's closed-form rows are the reference's to 1e-12 of the largest
    entry, over a row range far from 0 (the exact modular reduction)."""
    from repro.data.synthetic import spectrum_factors as ref_factors
    from repro.data.synthetic import spectrum_rows as ref_rows
    m, n, k = 2048, 96, 12
    rf = ref_factors(jax.random.key(3), m, n, spectrum, k, dtype=dtype)
    pf = SpectrumFactors(freqs=np.asarray(rf.freqs),
                         V=torch.from_numpy(np.array(rf.V)),
                         sig=np.asarray(rf.sig), seed=0, m=m, dtype=tdtype)
    for r0, r1 in ((0, 300), (1700, 2048)):
        want = np.asarray(ref_rows(rf, r0, r1))
        got = spectrum_rows(pf, r0, r1, diag=torch.from_numpy(
            _reference_diag(rf, r0, r1))).numpy()
        assert got.dtype == want.dtype
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("dtype", [torch.float64, torch.complex128])
def test_spectrum_source_sigmas_exact_and_chunking_free(dtype):
    """The materialised matrix has exactly the source's singular values
    (to 1e-10), and every multi-row chunking concatenates to its bits."""
    src = SpectrumSource(5, 2048, 256, "noisy_tail", 16, chunk_rows=384,
                         dtype=dtype, floor=1e-12, device="cpu")
    A = src.materialize()
    assert A.shape == (2048, 256) and A.dtype == dtype
    s = torch.linalg.svdvals(A).numpy()
    r = len(src.sigmas)
    assert np.abs(s[:r] - src.sigmas).max() <= 1e-10
    assert s[r:].max() <= 1e-10
    for c in (100, 128, 1000):
        parts = torch.cat([spectrum_rows(src.factors, r0, min(r0 + c, 2048))
                           for r0 in range(0, 2048, c)])
        assert torch.equal(parts, A)


def test_row_diagonal_is_the_splitmix_hash_of_the_row():
    """Each entry depends on (seed, global row) alone: the block_seed
    hash's top bit (real) or top 53 bits (complex); unit modulus."""
    seed = 2 ** 63 + 12345
    d = row_diagonal(seed, 10, 200, torch.float64, "cpu")
    want = [1.0 - 2.0 * (block_seed(seed, i) >> 63) for i in range(10, 200)]
    assert d.tolist() == want
    z = row_diagonal(seed, 10, 200, torch.complex128, "cpu")
    u = [(block_seed(seed, i) >> 11) * 2.0 ** -53 for i in range(10, 200)]
    np.testing.assert_allclose(np.angle(z.numpy()) % (2 * np.pi),
                               (2 * np.pi * np.asarray(u)) % (2 * np.pi),
                               atol=1e-12)
    np.testing.assert_allclose(np.abs(z.numpy()), 1.0, atol=1e-15)
    assert torch.equal(row_diagonal(seed, 50, 60, torch.float64, "cpu"),
                       d[40:50])


def test_spectrum_factors_frequencies_and_validation():
    f = spectrum_factors(1, 300, 40, "cliff", 5, device="cpu")
    assert len(set(f.freqs.tolist())) == len(f.freqs) == 26
    assert f.freqs.min() >= 1 and f.freqs.max() < 300
    assert f.freqs.dtype == np.int64
    g = spectrum_factors(1, 300, 40, "cliff", 5, device="cpu")
    assert np.array_equal(f.freqs, g.freqs) and torch.equal(f.V, g.V)
    with pytest.raises(ValueError, match="r <= min"):
        spectrum_factors(1, 30, 40, "cliff", 5, r=35, device="cpu")


# ----------------------------------------------------------- checkpoints

def test_checkpoint_round_trip_with_reference_names(tmp_path):
    tree = {"acc": torch.randn(4, 3, dtype=torch.float64),
            "z": torch.randn(2, dtype=torch.complex128),
            "fp": np.arange(32, dtype=np.uint8),
            "phase": np.int64(2), "nest": [torch.arange(3), (np.ones(2),)]}
    save_pytree(str(tmp_path), 7, tree)
    manifest = json.loads((tmp_path / "step_000007" / "manifest.json")
                          .read_text())["leaves"]
    assert {"['acc']", "['z']", "['fp']", "['phase']", "['nest'][0]",
            "['nest'][1][0]"} == set(manifest)
    assert all("crc32" in e for e in manifest.values())
    back = restore_pytree(str(tmp_path), 7, tree, device="cpu")
    assert torch.equal(back["acc"], tree["acc"])
    assert torch.equal(back["z"], tree["z"])
    assert torch.equal(back["nest"][0], tree["nest"][0])
    host = restore_pytree(str(tmp_path), 7, tree, host=True)
    assert isinstance(host["acc"], np.ndarray)
    assert host["phase"] == 2 and host["fp"].dtype == np.uint8


def test_checkpoint_crc_mismatch_is_caught(tmp_path):
    tree = {"acc": torch.ones(64, dtype=torch.float64)}
    path = save_pytree(str(tmp_path), 1, tree)
    leaf = os.path.join(path, "leaf_00000.npy")
    raw = bytearray(open(leaf, "rb").read())
    raw[-1] ^= 0xFF
    open(leaf, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="corrupt"):
        restore_pytree(str(tmp_path), 1, tree, device="cpu")


def test_leftover_tmp_is_ignored_and_replaced(tmp_path):
    tree = {"a": torch.zeros(3)}
    save_pytree(str(tmp_path), 2, tree)
    os.makedirs(tmp_path / ".tmp-step_000009")
    (tmp_path / ".tmp-step_000009" / "junk").write_text("torn")
    assert latest_step(str(tmp_path)) == 2
    save_pytree(str(tmp_path), 9, {"a": torch.ones(3)})
    assert latest_step(str(tmp_path)) == 9
    assert not (tmp_path / ".tmp-step_000009").exists()
    assert latest_step(str(tmp_path / "absent")) is None


def test_checkpoint_restore_defaults_to_the_card(tmp_path):
    """Like every entry point of the port, a restore that names no device
    goes to the card, and raises without one; ``host=True`` needs none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    tree = {"acc": torch.ones(3, dtype=torch.float64)}
    save_pytree(str(tmp_path), 4, tree)
    with pytest.raises(RuntimeError, match="is_available"):
        restore_pytree(str(tmp_path), 4, tree)
    with pytest.raises(RuntimeError, match="is_available"):
        CheckpointManager(str(tmp_path)).restore_latest(tree)
    assert restore_pytree(str(tmp_path), 4, tree, host=True)["acc"].tolist() \
        == [1.0, 1.0, 1.0]


def test_checkpoint_manager_retention_and_errors(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(4):
        mgr.save(s, {"x": torch.full((2,), float(s))})
    step, tree = mgr.restore_latest({"x": torch.zeros(2)}, device="cpu")
    assert step == 3 and tree["x"].tolist() == [3.0, 3.0]
    assert sorted(os.listdir(tmp_path)) == ["step_000002", "step_000003"]
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    bad = CheckpointManager(str(blocker))
    bad.save(0, {"x": torch.zeros(1)})
    with pytest.raises(OSError):
        bad.wait()


# ------------------------------------------------------- faults, retry

def test_uniform_rule_is_deterministic_and_in_range():
    draws = [_uniform(3, c, a) for c in range(50) for a in range(4)]
    assert draws == [_uniform(3, c, a) for c in range(50) for a in range(4)]
    assert all(0.0 <= u < 1.0 for u in draws)
    assert draws != [_uniform(4, c, a) for c in range(50) for a in range(4)]
    assert 0.3 < np.mean(draws) < 0.7


def test_fault_plan_rate_and_overrides():
    plan = FaultPlan(seed=1, transient_p=0.2, transient={5: 2})
    hits = [plan.transient_hits(c, 0) for c in range(2000)]
    assert 0.15 < np.mean(hits) < 0.25
    assert plan.transient_hits(5, 0) and plan.transient_hits(5, 1)
    with pytest.raises(ValueError, match="transient_p"):
        FaultPlan(transient_p=1.0)
    os.environ["REPRO_CHAOS_SEED"] = "9"
    try:
        env = FaultPlan.from_env()
    finally:
        del os.environ["REPRO_CHAOS_SEED"]
    assert env.seed == 9 and env.transient_p == 0.2


def test_flaky_source_realizes_the_plan():
    A = torch.arange(40.0).reshape(10, 4)
    clock = FakeClock()
    src = FlakySource(ArraySource(A, 2),
                      FaultPlan(transient={1: 1}, stall_s={2: 3.0},
                                die_at=4, kill_at=(0,)), clock=clock)
    assert src.shape == (10, 4) and src.fingerprint() is None
    with pytest.raises(ProcessKilled):
        src.chunk(0)
    assert torch.equal(src.chunk(0), A[:2])            # kills once
    with pytest.raises(TransientReadError):
        src.chunk(1)
    assert torch.equal(src.chunk(1), A[2:4])
    src.chunk(2)
    assert clock.sleeps == [3.0]
    with pytest.raises(SourceDied):
        src.chunk(4)
    assert src.injected == {"transient": 1, "stall": 1, "dead": 1, "kill": 1}
    assert not issubclass(ProcessKilled, Exception)


def test_retry_policy_backoff_timeout_and_exhaustion():
    clock = FakeClock()
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise TransientReadError("x")
        return "ok"
    pol = RetryPolicy(max_attempts=4, base_delay_s=0.1, jitter=0.0,
                      clock=clock)
    retries = []
    assert pol.call(flaky, on_retry=lambda a, e: retries.append(a)) == "ok"
    assert clock.sleeps == [0.1, 0.2] and retries == [1, 2]
    with tracing() as tr:
        with pytest.raises(ChunkReadFailed) as ei:
            RetryPolicy(max_attempts=2, base_delay_s=0.0, clock=clock).call(
                lambda: (_ for _ in ()).throw(TransientReadError("y")))
    assert ei.value.attempts == 2
    assert tr.metrics.counter("stream.chunk_failures").value == 1
    assert tr.metrics.counter("stream.retry").value == 1
    slow = FakeClock(tick=1.0)
    pol = RetryPolicy(max_attempts=2, base_delay_s=0.0, timeout_s=0.5,
                      clock=slow)
    with pytest.raises(ChunkReadFailed) as ei:
        pol.call(lambda: "late")
    assert isinstance(ei.value.__cause__, ReadTimeout)
    j1 = RetryPolicy(seed=4, clock=clock)
    j2 = RetryPolicy(seed=4, clock=clock)
    assert [j1.backoff_s(a) for a in range(3)] == \
        [j2.backoff_s(a) for a in range(3)]


# ------------------------------------------- progress, residency, misc

def test_progress_reporter_eta_and_atomic_file(tmp_path):
    clock = FakeClock()
    path = tmp_path / "status.json"
    seen = []
    rep = ProgressReporter(str(path), clock=clock, callbacks=[seen.append],
                           job="j")
    rep.update(total=10, done=0, phase="pass1")
    for d in range(1, 5):
        clock.advance(2.0)
        rep.update(done=d)
    assert rep.eta_s() == pytest.approx(12.0)
    rep.on_retry(1, RuntimeError())
    rep.checkpoint_saved(4)
    rep.finish("done")
    status = json.loads(path.read_text())
    assert status["done"] == 4 and status["state"] == "done"
    assert status["retries"] == 1 and status["checkpoint_step"] == 4
    assert not (tmp_path / ".tmp-status.json").exists()
    assert seen[-1]["state"] == "done"


def test_live_device_bytes_is_zero_on_a_host_without_a_card():
    """``torch.cuda.memory_allocated``, summed over the cards: 0 here, where
    there is no card (CPU tensors are not device residency)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    big = torch.zeros(1 << 20)
    assert live_device_bytes() == 0
    src = SpectrumSource(1, 256, 32, "cliff", 4, chunk_rows=128,
                         device="cpu")
    metered = MeteredSource(src)
    assert metered.fingerprint() == src.fingerprint()
    assert metered.sigmas is src.sigmas
    assert torch.equal(metered.chunk(1), src.chunk(1))
    assert metered.peak_bytes == 0
    del big


def test_array_source_views_and_bounds():
    A = np.arange(60.0).reshape(20, 3)
    src = ArraySource(A, 8)
    assert num_chunks(src) == 3 and chunk_bounds(src, 2) == (16, 20)
    assert src.dtype == torch.float64
    ch = src.chunk(1)
    assert np.shares_memory(ch.numpy(), A) and ch.shape == (8, 3)
    for c in (-1, 3):
        with pytest.raises(ValueError, match=f"c={c}"):
            src.chunk(c)
    with pytest.raises(ValueError, match="2-D"):
        ArraySource(np.zeros(3), 1)
    with pytest.raises(ValueError, match="chunk_rows"):
        ArraySource(A, 0)


def test_file_source_read_ahead_restart_and_failures(tmp_path):
    A = np.random.default_rng(0).standard_normal((50, 6))
    path = tmp_path / "a.npy"
    np.save(path, A)
    with FileSource(path, 8, readahead=2) as src:
        assert src.shape == (50, 6) and src.dtype == torch.float64
        got = torch.cat([src.chunk(c) for c in range(num_chunks(src))])
        assert np.array_equal(got.numpy(), A)
        assert np.array_equal(src.chunk(3).numpy(), A[24:32])   # restart
        assert np.array_equal(src.chunk(1).numpy(), A[8:16])
        with pytest.raises(ValueError, match="c=7"):
            src.chunk(7)
        fp = src.fingerprint()
        assert fp[0] == os.path.abspath(path)
    with pytest.raises(ValueError, match="closed"):
        src.chunk(0)
    sync = FileSource(path, 8, readahead=0)
    np.save(path, np.zeros((51, 6)))
    with pytest.raises(SourceDied, match="changed mid-job"):
        sync.chunk(0)
    with pytest.raises(FileNotFoundError):
        FileSource(tmp_path / "none.npy", 8)
    np.save(tmp_path / "v.npy", np.zeros(5))
    with pytest.raises(ValueError, match="2-D"):
        FileSource(tmp_path / "v.npy", 8)


def test_prefetch_iterator_yields_in_order_and_closes():
    it = PrefetchIterator(iter(range(100)), depth=2)
    assert [next(it) for _ in range(5)] == [0, 1, 2, 3, 4]
    it.close()
    with pytest.raises(StopIteration):
        next(it)

    def bad():
        yield 1
        raise KeyError("boom")
    with PrefetchIterator(bad()) as it2:
        assert next(it2) == 1
        with pytest.raises(KeyError):
            next(it2)
