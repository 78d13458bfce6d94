"""The sharded streamed ID of the port, ``rid_streamed(..., group=)``, on
the CPU over gloo.

* Worlds 1, 2 and 4: bit-equal in ``P_loc``, ``J``, ``Q``, ``R_loc`` and
  ``B`` to the port's in-memory sharded path, ``rid_distributed(...,
  sketch_kind="gaussian", qr_impl="panel_parallel")``, on the same matrix;
  the root span's ``ndev``, one ``qr.panel_schedule`` event a panel, and
  progress driven by rank 0 alone.
* A rank killed in pass 1 (``runtime.faults``), the other rank failing at
  the next checkpoint's all_reduce, one write lost, then every rank
  resumed: bit-equal to an uninterrupted run.
* A resume on another world size, and ``n`` that does not divide the
  world, are refused; the validation messages without a group.
* Against the reference's sharded ``rid_streamed`` on a 2-device mesh (a
  subprocess, as ``tests/test_stream_sharded.py`` runs it), with its
  operator injected: the same pivots, ``P`` within 1e-10 of its largest
  entry (f64).
* The panel schedule events against the reference's for the same shapes.

Ranks run as subprocesses (``tests/torch_ranks.py``), each with its own
timeout, one thread and a ``file://`` store; this process never joins a
process group.  Each world's processes are started once (module fixtures)
and every test reads their output.
"""
import json
import shutil
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro_torch.stream import ArraySource, rid_streamed  # noqa: E402
from torch_ranks import failures, pin_threads, run_ranks  # noqa: E402

pin_threads()

RANK_TIMEOUT = 120          # seconds per rank process
M, N, K, PANEL, CHUNK = 1000, 400, 21, 7, 384     # 3 chunks, the last short
KILL_CHUNK, KILL_AT = 128, 3                      # 8 chunks; rank 1 dies
# The reference comparison: an exact rank-12 matrix whose singular values
# run from 1 down to 0.1 (well separated), as test_torch_stream.py's.
JM, JN, JK, JCHUNK = 1024, 128, 12, 256
# (k, panel, panel_impl, norm_recompute) of the schedule comparison: a
# recompute every other panel, and the oracle (the default cadence is the
# parity run's).
SCHEDULES = [(40, 8, "fused", 2), (21, 7, "gram", "auto")]

RANK_PROGRAM = r"""
import datetime, json, os, sys
from pathlib import Path
import numpy as np
import torch
import torch.distributed as dist

rank, world, work, mode = (int(sys.argv[1]), int(sys.argv[2]),
                           Path(sys.argv[3]), sys.argv[4])
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=(work / f"store-{mode}").as_uri(),
                        rank=rank, world_size=world,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.core import (panel_parallel_pivoted_qr, rid_distributed,
                              shard_columns)
from repro_torch.obs import ProgressReporter, tracing
from repro_torch.runtime import FaultPlan, FlakySource, ProcessKilled
from repro_torch.stream import ArraySource, rid_streamed

g = dist.group.WORLD
data = work.parent
spec = json.loads((data / "spec.json").read_text())
K, PANEL, CHUNK = spec["k"], spec["panel"], spec["chunk"]
A = torch.from_numpy(np.load(data / "A.npy"))
out = {}

def fields(dec):
    return {f: getattr(dec, f).numpy() for f in "PJQRB"}

def run(source, **kw):
    return rid_streamed(3, source, K, group=g, device="cpu", qr_panel=PANEL,
                        **kw)

if mode == "parity":
    rep = ProgressReporter(clock=lambda: 0.0)
    with tracing() as tr:
        got = run(ArraySource(A, CHUNK), progress=rep)
    want = rid_distributed(3, shard_columns(A, g), K, group=g,
                           sketch_kind="gaussian", qr_impl="panel_parallel",
                           qr_panel=PANEL)
    out["equal"] = {f: bool(torch.equal(getattr(got, f), getattr(want, f)))
                    for f in "PJQRB"}
    root = next(s for s in tr.spans if s.name == "rid_streamed")
    out["ndev"] = root.attrs["ndev"]
    out["schedule"] = [a for sp in tr.spans for name, _, a in sp.events
                       if name == "qr.panel_schedule"]
    out["progress"] = rep.status()
    np.savez(work / f"parity{rank}.npz", **fields(got))
    if world == 1:
        Y = torch.from_numpy(np.load(data / "Y.npy"))
        out["engine"] = []
        for k, b, impl, rec in spec["schedules"]:
            with tracing() as tr:
                panel_parallel_pivoted_qr(Y, k, group=g, panel=b,
                                          panel_impl=impl, norm_recompute=rec)
            out["engine"].append({
                "events": [a for sp in tr.spans for name, _, a in sp.events
                           if name == "qr.panel_schedule"],
                "recompute_panels": tr.metrics.counter(
                    "qr.recompute_panels").value})
    if world == 2:
        AJ = torch.from_numpy(np.load(data / "AJ.npy"))
        omega = torch.from_numpy(np.load(data / "omegaJ.npy"))
        dec = rid_streamed(0, ArraySource(AJ, spec["jchunk"]), spec["jk"],
                           group=g, device="cpu", omega=omega)
        np.savez(work / f"jax{rank}.npz", **fields(dec))
    if world == 4:
        ckpt = str(work / "ckpt")
        run(ArraySource(A, CHUNK), resume_dir=ckpt)
        sub = dist.new_group([0, 1])
        if rank < 2:
            try:
                rid_streamed(3, ArraySource(A, CHUNK), K, group=sub,
                             device="cpu", qr_panel=PANEL, resume_dir=ckpt)
            except ValueError as e:
                out["other_world"] = str(e)
        try:
            run(ArraySource(torch.zeros(512, 402, dtype=torch.float64), 256))
        except ValueError as e:
            out["divides"] = str(e)
elif mode == "kill":
    src = ArraySource(A, spec["kill_chunk"])
    if rank == 1:
        src = FlakySource(src, FaultPlan(kill_at=(spec["kill_at"],)))
    try:
        run(src, resume_dir=str(data / "ckpt"))
        out["finished"] = True
    except ProcessKilled:
        print(json.dumps({"killed": True}), flush=True)
        os._exit(0)                      # the process dies with its rank
    except RuntimeError as e:            # the survivor's next all_reduce
        out["survivor_error"] = type(e).__name__
elif mode == "resume":
    clean = run(ArraySource(A, spec["kill_chunk"]))
    with tracing() as tr:
        got = run(ArraySource(A, spec["kill_chunk"]),
                  resume_dir=str(data / "ckpt"))
    out["equal"] = {f: bool(torch.equal(getattr(got, f), getattr(clean, f)))
                    for f in "PJQRB"}
    out["resumed_from"] = [a["chunks_done"] for sp in tr.spans
                           for name, _, a in sp.events
                           if name == "stream.resume"]
print(json.dumps(out), flush=True)
if mode == "kill":
    # The survivor leaves without tearing its gloo group down: with the
    # peer dead, gloo's teardown can abort the process after the result
    # is out ("terminate called without an active exception").
    os._exit(0)
"""


def _launch(work, world, mode):
    work.mkdir(exist_ok=True)
    res = run_ranks(RANK_PROGRAM, world, str(work), mode,
                    timeout=RANK_TIMEOUT, OMP_NUM_THREADS="1")
    return res


def _outputs(res):
    assert not failures(res), failures(res)
    return [json.loads(out.strip().splitlines()[-1]) for _, out, _ in res]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded")
    rng = np.random.default_rng(0)
    A = (rng.standard_normal((M, 64)) @ rng.standard_normal((64, N))
         + 1e-3 * rng.standard_normal((M, N)))
    np.save(d / "A.npy", A)
    U = np.linalg.qr(rng.standard_normal((JM, JK)))[0]
    V = np.linalg.qr(rng.standard_normal((JN, JK)))[0]
    np.save(d / "AJ.npy", (U * np.logspace(0, -1, JK)) @ V.T)
    np.save(d / "Y.npy", rng.standard_normal((96, 160)))
    (d / "spec.json").write_text(json.dumps(
        {"k": K, "panel": PANEL, "chunk": CHUNK, "kill_chunk": KILL_CHUNK,
         "kill_at": KILL_AT, "jk": JK, "jchunk": JCHUNK,
         "schedules": SCHEDULES}))
    return d


def _reference(data):
    """The reference's sharded rid_streamed on a 2-device CPU mesh, and its
    unscaled operator (written for the port's world-2 run)."""
    from conftest import run_with_devices
    r = run_with_devices(f"""
import jax, jax.numpy as jnp, numpy as np
from repro.compat import AxisType, make_mesh
from repro.core.sketch import gaussian_omega_cols
from repro.stream import ArraySource, rid_streamed
mesh = make_mesh((2,), ("data",), axis_types=(AxisType.Auto,))
A = np.load("{data / 'AJ.npy'}")
key = jax.random.key(4)
np.save("{data / 'omegaJ.npy'}", np.asarray(
    gaussian_omega_cols(key, 0, {JM}, {2 * JK}, jnp.float64)))
dec = rid_streamed(key, ArraySource(A, {JCHUNK}), {JK}, mesh=mesh)
np.savez("{data / 'ref.npz'}", J=np.asarray(dec.J), P=np.asarray(dec.P),
         B=np.asarray(dec.B))
print("OK")
""", n_devices=2, timeout=RANK_TIMEOUT, x64=True)
    assert r.returncode == 0, r.stderr[-3000:]
    return np.load(data / "ref.npz")


@pytest.fixture(scope="module")
def runs(data):
    """The reference's run and the parity program at worlds 1, 2 and 4, at
    once (world 2 after the reference, whose operator it reads):
    ``(reference, {world: (rank outputs, work dir)})``."""
    def world_run(world):
        work = data / f"w{world}"
        return world, (_outputs(_launch(work, world, "parity")), work)

    def reference_then_world2():
        return _reference(data), world_run(2)
    with ThreadPoolExecutor(3) as pool:
        ref_job = pool.submit(reference_then_world2)
        others = [pool.submit(world_run, w) for w in (1, 4)]
        reference, two = ref_job.result()
        parity = dict([two] + [job.result() for job in others])
    return reference, parity


@pytest.fixture(scope="module")
def reference(runs):
    return runs[0]


@pytest.fixture(scope="module")
def parity(runs):
    """world -> (rank outputs, work dir) of the parity program."""
    return runs[1]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sharded_stream_bit_equal_to_rid_distributed(parity, world):
    outs, work = parity[world]
    for rank, out in enumerate(outs):
        assert out["equal"] == {f: True for f in "PJQRB"}, (rank, out)
        assert out["ndev"] == world
    # P and R are column blocks, J, Q and B replicated.
    parts = [np.load(work / f"parity{r}.npz") for r in range(world)]
    assert np.concatenate([p["P"] for p in parts], 1).shape == (K, N)
    for p in parts[1:]:
        for f in "JQB":
            np.testing.assert_array_equal(p[f], parts[0][f])


def test_sharded_stream_schedule_and_progress(parity):
    """One schedule event a panel (k=21 at panel 7), every panel's psum
    overlapped at the default cadence; rank 0 alone reports 2 C units."""
    for world, (outs, _) in parity.items():
        for rank, out in enumerate(outs):
            assert [e["panel"] for e in out["schedule"]] == [0, 1, 2]
            assert {e["psum"] for e in out["schedule"]} == {"overlapped"}
            if rank == 0:
                assert out["progress"]["state"] == "done"
                assert out["progress"]["total"] == 2 * 3
            else:
                assert out["progress"]["total"] in (0, None)


def test_sharded_stream_against_the_reference(parity, reference):
    """The reference's sharded stream on two devices and the port's on two
    ranks, the operator injected: the same pivots in the same order, B bit
    for bit, and P to 1e-10 of its largest entry (the two QR engines sum in
    different orders)."""
    _, work = parity[2]
    parts = [np.load(work / f"jax{r}.npz") for r in range(2)]
    P = np.concatenate([p["P"] for p in parts], 1)
    assert parts[0]["J"].tolist() == reference["J"].tolist()
    np.testing.assert_allclose(P, reference["P"], rtol=0,
                               atol=1e-10 * np.abs(reference["P"]).max())
    np.testing.assert_array_equal(parts[0]["B"], reference["B"])


def test_panel_schedule_events_match_the_reference(parity, data):
    """The port's ``qr.panel_schedule`` events and ``qr.recompute_panels``
    counter against the reference's ``panel_parallel_pivoted_qr`` traced on
    a one-device mesh, for the same shapes and cadences."""
    from repro.compat import AxisType, make_mesh
    from repro.core.qr_dist import panel_parallel_pivoted_qr as ref_pp
    from repro.obs import tracing as ref_tracing
    mesh = make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))
    Y = jax.numpy.asarray(np.load(data / "Y.npy"), dtype=jax.numpy.float32)
    (out,), _ = parity[1]
    for (k, b, impl, rec), got in zip(SCHEDULES, out["engine"]):
        with ref_tracing() as tr:
            ref_pp(Y, k, mesh=mesh, panel=b, panel_impl=impl,
                   norm_recompute=rec)
        want = [a for sp in tr.spans for name, _, a in sp.events
                if name == "qr.panel_schedule"]
        assert got["events"] == want, (k, b, impl, rec)
        assert got["recompute_panels"] == \
            tr.metrics.counter("qr.recompute_panels").value


def test_resume_on_another_world_size_and_divisibility_are_refused(parity):
    outs, _ = parity[4]
    for out in outs[:2]:
        assert "different job" in out["other_world"]
        assert "-of-4" in out["other_world"]
    for out in outs:
        assert "must divide" in out["divides"]


def test_rank_killed_in_pass1_then_all_resumed_is_bit_equal(data):
    """Rank 1 dies reading chunk 3 (steps 1 and 2 saved); rank 0 fails at
    the all_reduce before step 3.  Rank 0's step 2 is then deleted (the
    write a kill can lose), so the ranks' latest steps differ: the resumed
    ranks agree on step 1, roll rank 1 back, and replay bit for bit."""
    work = data / "kill"
    res = _launch(work, 2, "kill")
    assert [rc for rc, _, _ in res] == [0, 0], failures(res)
    killed = json.loads(res[1][1].strip().splitlines()[-1])
    survivor = json.loads(res[0][1].strip().splitlines()[-1])
    assert killed == {"killed": True}
    assert "survivor_error" in survivor, survivor
    ckpt = data / "ckpt"
    steps = {r: sorted(p.name for p in (ckpt / f"rank{r}-of-2").iterdir())
             for r in range(2)}
    assert steps == {0: ["step_000001", "step_000002"],
                     1: ["step_000001", "step_000002"]}
    shutil.rmtree(ckpt / "rank0-of-2" / "step_000002")
    outs = _outputs(_launch(data / "resume", 2, "resume"))
    for out in outs:
        assert out["equal"] == {f: True for f in "PJQRB"}, out
        assert out["resumed_from"] == [1]


def test_validation_without_a_group():
    src = ArraySource(torch.zeros(256, 64, dtype=torch.float64), 128)
    with pytest.raises(ValueError, match=r"qr_impl='panel_parallel' factors "
                                         r"column shards in place and needs "
                                         r"group=\.\.\.; got group=None"):
        rid_streamed(0, src, 8, qr_impl="panel_parallel", device="cpu")
    with pytest.raises(ValueError, match=r"need qr_impl='panel_parallel' "
                                         r"\(or 'auto'\), got "
                                         r"qr_impl='blocked'"):
        rid_streamed(0, src, 8, qr_impl="blocked", group=object(),
                     device="cpu")
    with pytest.raises(TypeError, match="ProcessGroup"):
        rid_streamed(0, src, 8, group=object(), device="cpu")
