"""The paper's Figures 1-2 on the port (``repro_torch.benchmarks.
scaling_worker`` / ``bench_scaling``) against the JAX harness's.

Two subprocesses run at once: the port's program (``torch_ranks.
start_ranks``; it joins torch's fake backend, the test process joins none)
counts ``rid_distributed`` at SMALL_GRID row 1 (k=16, m=2^11, n=2^9) for
the three engines at N = 4 and 8, the weak-scaling points of
``panel_parallel``, and the paper's row 6 (k=400, m=2^14, n=2^18, 64 GB in
c128) at N = 4 and 128 on fake tensors; the reference's program runs the
JAX harness's own worker (``benchmarks/scaling_worker.py``, which lowers
the ID on fake host devices and reads XLA's cost analysis and HLO) on the
same rows at N = 4 and 8, and ``panel_parallel`` at N = 2.

Held: the collective bytes a rank equal the reference's, apart from one
named collective, ``global_columns``' all-gather of the ranks' int64 shard
widths (8 N bytes); the flops equal a count by hand of the ID's matrix
products and its kernels' bounds (XLA's ``flops`` and ``bytes accessed``
are not this measure: XLA counts a ``while`` loop's body once, and the
reference's sketch runs as such a loop, so its count falls below the
sketch product alone, which the test shows; it also counts the Gaussian
draw's arithmetic and every elementwise op); the meter counts the bytes
an op moves and nothing for views, allocations and metadata queries; the
host reads answered are exactly N shard widths plus one a panel where
``_panel_ok`` runs, and any other read raises; ``model_time``,
``speedup_vs4`` and ``efficiency`` are the reference's formulas on the
same records (its constants set to the H100's, where no collective spans
hosts); ``--weak`` grows n; the paper row's counts stand for a 4.95 GB
block while the process stays far below it; the CLI's ``--exec`` runs rows
on 1 and 2 gloo ranks (here, while the subprocesses count).
"""
import json
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from benchmarks import bench_scaling as jbs  # noqa: E402
from repro_torch.benchmarks import bench_scaling, scaling_worker  # noqa: E402
from repro_torch.configs import SMALL_GRID  # noqa: E402
from torch_ranks import failures, pin_threads, start_ranks  # noqa: E402

pin_threads()

ROW = SMALL_GRID[1]
IMPLS = ("cgs2", "blocked", "panel_parallel")
ROOT = Path(__file__).resolve().parents[1]

_PROGRAM = r"""
import json
import torch
from repro_torch.benchmarks.scaling_worker import measure
import repro_torch.core.distributed as core_dist
out = {"small": [measure(16, 2048, 512, p, impl)
                 for impl in ("cgs2", "blocked", "panel_parallel")
                 for p in (4, 8)],
       "weak": [measure(16, 2048, 512 * p // 4, p, "panel_parallel")
                for p in (4, 8)],
       "paper": [measure(400, 2 ** 14, 2 ** 18, p, "panel_parallel")
                 for p in (4, 128)],
       # this process's peak resident set (VmHWM: the memory map's own
       # high-water mark; ru_maxrss would carry the parent's across exec)
       "maxrss_bytes": 1024 * int(next(
           line.split()[1] for line in open("/proc/self/status")
           if line.startswith("VmHWM:")))}
# a data-dependent read the worker does not know raises
orig = core_dist.global_columns
def reads_more(X, group, **kw):
    float(X.sum())
    return orig(X, group, **kw)
core_dist.global_columns = reads_more
try:
    measure(16, 2048, 512, 4, "blocked")
    out["unknown_read"] = None
except RuntimeError as e:
    out["unknown_read"] = str(e)
print(json.dumps(out))
"""

# The JAX harness's worker, as its bench_scaling runs it (one process a
# row there; here one process on 8 fake host devices runs its ``main``
# for each row, a mesh of the first N devices).
_REFERENCE = r"""
import contextlib, io, json, sys
sys.path.insert(0, sys.argv[3])
from benchmarks import scaling_worker
out = []
for impl, p in [(i, p) for i in ("cgs2", "blocked", "panel_parallel")
                for p in (4, 8)] + [("panel_parallel", 2)]:
    sys.argv = ["scaling_worker", "16", "2048", "512", str(p), impl, "0"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        scaling_worker.main()
    out.append(json.loads(buf.getvalue().strip().splitlines()[-1]))
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def recs():
    """The port's records, with ``exec``: the CLI's ``--exec`` rows at
    1 and 2 gloo ranks, run here while the programs run, and ``ref``: the
    reference worker's records by (engine, N)."""
    wait = start_ranks(_PROGRAM, 1, timeout=300, OMP_NUM_THREADS="1")
    wait_ref = start_ranks(
        _REFERENCE, 1, str(ROOT), timeout=300, JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=8")
    rows = bench_scaling.main(["--exec", "--procs", "1,2", "--rows", "1",
                               "--qr-impl", "panel_parallel",
                               "--device", "cpu"])
    res, ref = wait(), wait_ref()
    assert not failures(res), failures(res)
    assert not failures(ref), failures(ref)
    ref_recs = json.loads(ref[0][1].strip().splitlines()[-1])
    return dict(json.loads(res[0][1].strip().splitlines()[-1]), exec=rows,
                ref={(r["qr_impl"], r["nproc"]): r for r in ref_recs})


def _small(recs, impl, p):
    (rec,) = [r for r in recs["small"]
              if r["qr_impl"] == impl and r["nproc"] == p]
    return rec


@pytest.mark.parametrize("impl", IMPLS)
def test_collective_bytes_are_the_references(recs, impl):
    for p in (4, 8):
        rec, ref = _small(recs, impl, p), recs["ref"][impl, p]
        width_gather = 8 * p      # global_columns: the int64 shard widths
        assert rec["collective_bytes"] - width_gather == \
            ref["collective_bytes"], (rec["collective_by_kind"], ref)
        kinds = rec["collective_by_kind"]
        l, n, m, k = 2 * ROW.k, ROW.n, ROW.m, ROW.k
        if impl == "panel_parallel":
            assert kinds == {"all-gather": width_gather,
                             "all-reduce": ref["collective_bytes"]}
        else:
            # the sketch gathered, B's columns summed into place
            assert kinds == {"all-gather": l * n * 4 + width_gather,
                             "all-reduce": m * k * 4}
        assert rec["interhost_bytes"] == 0


def _hand_flops(impl: str, p: int) -> float:
    """The ID's flops by hand: its matrix products (2 per multiply-add),
    the triangular solve (k^2 a column) and its kernels at their bounds'
    operations (PERF.md section 6), at SMALL_GRID row 1 on N = p ranks."""
    k, m, n = ROW.k, ROW.m, ROW.n
    l, b, nl = 2 * k, k, n // p          # k = 16: one panel of 16
    factor = 2 * (3 * l * b * b + b ** 3 / 3)
    f = (2 * l * m * nl                  # sketch_accum: Omega A_loc
         + 2 * k * l * nl                # Q^H Y_loc
         + k * k * nl)                   # the interpolation solve
    if impl == "cgs2":                   # the replicated l x n sketch
        f += k * (2 * l * k + 2 * l * k  # Q^H v, Q (Q^H v)
                  + 2 * l * n)           # Z^H v
        f += 2 * k * l * n               # R = Q^H Y
    elif impl == "blocked":
        f += factor + 4 * l * b * n + 2 * l * n   # panel_step
        f += 2 * b * l * b                        # _panel_ok: Qp^H Qp
        f += 2 * k * l * n                        # R = Q^H Y
    else:                                # each rank's l x n/N block
        f += factor + 2 * l * b * nl + 2 * b * nl   # panel_coeff
        f += 2 * l * b * nl                         # panel_apply
        f += 2 * b * l * b                          # _panel_ok
    return f


@pytest.mark.parametrize("impl", IMPLS)
def test_flops_are_the_hand_count(recs, impl):
    for p in (4, 8):
        rec = _small(recs, impl, p)
        # each kernel call's count is truncated to an integer
        assert rec["flops"] == pytest.approx(_hand_flops(impl, p), abs=2)
        # XLA's count of the reference is not this measure: it falls
        # below the sketch product alone (a while loop counted once)
        sketch = 2 * (2 * ROW.k) * ROW.m * (ROW.n // p)
        assert recs["ref"][impl, p]["flops"] < sketch <= rec["flops"]


def test_meter_counts_what_ops_move():
    """Bytes: an op's operands and results; nothing for an allocation, a
    metadata query or a view.  Flops: the matrix products, ``mv`` by the
    worker's formula."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.dryrun import _Meter
    with FakeTensorMode(), _Meter(
            8, flop_formulas=scaling_worker._flop_formulas()) as meter:
        x = torch.empty((64, 32))
        torch.ops.prim.device.default(x)
        y = x.t()
        assert (meter.bytes, meter.flops) == (0, 0)
        y + 1.0                                      # 8 KB in, 8 KB out
        assert meter.bytes == 2 * 8192
        x @ torch.ones((32, 8))                      # ones writes 1 KB
        assert meter.bytes == 2 * 8192 + 1024 + (8192 + 1024 + 2048)
        assert meter.flops == 2 * 64 * 32 * 8
        torch.mv(x, torch.ones(32))
        assert meter.flops == 2 * 64 * 32 * 8 + 2 * 64 * 32


@pytest.mark.parametrize("p", [4, 8])
def test_host_reads_are_answered_exactly(recs, p):
    for impl in IMPLS:
        rec = _small(recs, impl, p)
        panels = 0 if impl == "cgs2" else 1         # k=16: one panel
        assert rec["host_reads"] == {"shard_widths": p,
                                     "panel_ok": panels}, impl
    assert "data-dependent host read" in recs["unknown_read"]


def test_model_and_speedup_are_the_references_formulas(recs, monkeypatch):
    c = scaling_worker.H100
    monkeypatch.setattr(jbs, "PEAK", c["peak_flops"])
    monkeypatch.setattr(jbs, "HBM", c["hbm_bytes_s"])
    monkeypatch.setattr(jbs, "LINK", c["nvlink_bytes_s"])
    for impl in IMPLS:
        by_p = {p: _small(recs, impl, p) for p in (4, 8)}
        for rec in by_p.values():
            assert scaling_worker.model_time(rec) == jbs.model_time(rec)
        monkeypatch.setattr(jbs, "worker",
                            lambda k, m, n, p, *a, **kw: by_p[p])
        want = jbs.main(["--procs", "4,8", "--rows", "1",
                         "--qr-impl", impl])
        got = bench_scaling.scaling_rows(ROW, {4: ROW.n, 8: ROW.n}, by_p,
                                         [4, 8], weak=False, qr_impl=impl)
        for w, g in zip(want, got, strict=True):
            assert {key: g[key] for key in w} == w
    # across hosts of 8 the network carries the collective
    rec = recs["paper"][1]
    assert rec["nproc"] == 128 and rec["interhost_bytes"] == \
        rec["collective_bytes"] > 0
    assert scaling_worker.model_time(rec) == max(
        rec["flops"] / c["peak_flops"], rec["bytes"] / c["hbm_bytes_s"],
        rec["collective_bytes"] / c["net_bytes_s"])


def test_weak_scaling_grows_n(recs):
    by_p = {r["nproc"]: r for r in recs["weak"]}
    ns = {p: ROW.n * p // 4 for p in (4, 8)}
    rows = bench_scaling.scaling_rows(ROW, ns, by_p, [4, 8], weak=True,
                                      qr_impl="panel_parallel")
    assert [r["n"] for r in rows] == [ROW.n, 2 * ROW.n]
    assert all(r["mode"] == "weak" for r in rows)
    assert rows[0]["speedup_vs4"] == 4 and rows[0]["efficiency"] == 1
    t4, t8 = (r["model_time_s"] for r in rows)
    assert rows[1]["speedup_vs4"] == pytest.approx(t4 / t8 * 8)
    # panel_parallel keeps no l x n sketch: the block, and so the peak a
    # rank, stay flat as n grows with the ranks
    assert rows[1]["bytes_per_dev"] == rows[0]["bytes_per_dev"]


def test_paper_row_is_counted_without_allocating(recs):
    r4, r128 = recs["paper"]
    assert (r4["k"], r4["m"], r4["n"]) == (400, 2 ** 14, 2 ** 18)
    assert r4["out_shapes"] == [[2 ** 14, 400], [400, 2 ** 18 // 4]]
    assert r128["out_shapes"][1] == [400, 2 ** 18 // 128]
    block = 2 ** 14 * 2 ** 18 // 4 * 4                 # A's f32 block at N=4
    assert r4["bytes_per_device"] > block
    assert recs["maxrss_bytes"] < block / 3
    assert r128["host_reads"]["shard_widths"] == 128
    assert r4["flops"] / r128["flops"] > 16


def test_exec_runs_on_two_gloo_ranks(recs):
    one, two = recs["exec"]
    assert (one["procs"], two["procs"]) == (1, 2)
    assert one["wall_s"] > 0 and two["wall_s"] > 0
    assert two["coll_bytes_per_dev"] == \
        recs["ref"]["panel_parallel", 2]["collective_bytes"] + 8 * 2
    assert one["speedup_vs4"] == 1 and two["efficiency"] == pytest.approx(
        one["model_time_s"] / two["model_time_s"] / 2)
