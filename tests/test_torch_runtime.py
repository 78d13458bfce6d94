"""The port's coordinator, elastic planning and straggler monitor
(``repro_torch.runtime``) against the reference's (``repro.runtime``): each
scenario of ``tests/test_runtime.py`` is driven through both packages on
their ``FakeClock`` s, and every decision is recorded; the two records must
be equal, and hold the reference tests' values.  CPU only."""
import pytest

pytest.importorskip("jax")

import repro.obs as ref_obs  # noqa: E402
import repro.runtime as ref_runtime  # noqa: E402
import repro_torch.obs as port_obs  # noqa: E402
import repro_torch.runtime as port_runtime  # noqa: E402

PACKAGES = {"reference": (ref_runtime, ref_obs),
            "port": (port_runtime, port_obs)}


def _both(scenario):
    got = {name: scenario(*mods) for name, mods in PACKAGES.items()}
    assert got["port"] == got["reference"]
    return got["port"]


def _check(c, rt):
    """``c.check()`` as a record: None, or the failure's hosts and count."""
    try:
        c.check()
        return None
    except rt.HostFailure as e:
        return (e.dead_hosts, e.alive)


def test_coordinator_detects_silence_and_rejoin():
    def scenario(rt, obs):
        clk = obs.FakeClock()
        c = rt.Coordinator(4, timeout_s=10.0, clock=clk)
        out = []
        clk.t = 5.0
        for h in range(4):
            c.heartbeat(h)
        out.append(_check(c, rt))
        clk.t = 14.0
        for h in (0, 1, 2):
            c.heartbeat(h)
        out.append(_check(c, rt))        # host 3 at 9 s of silence
        clk.t = 16.0
        out.append(_check(c, rt))
        c2 = rt.Coordinator(2, timeout_s=1.0, clock=clk)
        c2.mark_dead(1)
        out.append(_check(c2, rt))
        c2.rejoin(1)
        c2.heartbeat(1)
        out.append(_check(c2, rt))
        return out
    assert _both(scenario) == [None, None, ([3], 3), ([1], 1), None]


def test_plan_elastic_mesh():
    def scenario(rt, _):
        out = [rt.plan_elastic_mesh(c) for c in (512, 256, 200, 16, 1024)]
        out.append(rt.plan_elastic_mesh(64, model_axis=8, chips_per_pod=32))
        with pytest.raises(ValueError, match="cannot keep model=16"):
            rt.plan_elastic_mesh(8)
        return out
    got = _both(scenario)
    assert got[:3] == [((2, 16, 16), ("pod", "data", "model")),
                       ((16, 16), ("data", "model")),
                       ((8, 16), ("data", "model"))]


def test_failure_to_replan_chain():
    """A pod's hosts go silent, the failure names them, the survivors are
    re-planned (model axis kept), dead hosts cannot heartbeat before they
    rejoin, and after the rejoin the full fleet is planned again."""
    def scenario(rt, obs):
        clk = obs.FakeClock()
        chips = 4
        c = rt.Coordinator(128, timeout_s=30.0, clock=clk)
        clk.t = 10.0
        for h in range(128):
            c.heartbeat(h)
        out = [rt.plan_elastic_mesh(len(c.alive_hosts) * chips)]
        clk.t = 50.0
        for h in range(64):
            c.heartbeat(h)
        fail = _check(c, rt)
        out += [fail, rt.plan_elastic_mesh(fail[1] * chips)]
        with pytest.raises(RuntimeError, match="declared dead"):
            c.heartbeat(64)
        for h in range(64, 128):
            c.rejoin(h)
        for h in range(128):
            c.heartbeat(h)
        out += [_check(c, rt), rt.plan_elastic_mesh(len(c.alive_hosts)
                                                    * chips)]
        return out
    got = _both(scenario)
    assert got[1] == (list(range(64, 128)), 64)
    assert got[2] == ((16, 16), ("data", "model")) and got[3] is None


def test_straggler_tiers_median_and_recovery_streak():
    def scenario(rt, _):
        out = []
        m = rt.StragglerMonitor(4, threshold=1.5, rank_tiers=(32, 16, 8),
                                recovery_steps=3)
        for h in range(4):
            for _ in range(5):
                m.record(h, 1.0 if h != 2 else 2.5)
        out.append((m.stragglers(), m.compression_rank, m.adapt(),
                    m.compression_rank))
        for _ in range(30):
            m.record(2, 1.0)
        out.append([m.adapt() for _ in range(3)] + [m.compression_rank])
        even = rt.StragglerMonitor(4, threshold=1.3, rank_tiers=(32, 16))
        for h, v in enumerate((1.0, 1.0, 2.0, 2.0)):
            even.record(h, v)
        out.append((even.fleet_median, even.stragglers()))
        s = rt.StragglerMonitor(2, threshold=1.5, rank_tiers=(32, 16),
                                recovery_steps=2)
        s.record(0, 1.0)
        s.record(1, 5.0)
        seq = [s.adapt()]
        for _ in range(30):
            s.record(1, 1.0)
        seq.append(s.adapt())
        s.record(1, 50.0)
        seq.append(s.adapt())
        for _ in range(40):
            s.record(1, 1.0)
        seq += [s.adapt(), s.adapt(), s.compression_rank]
        out.append(seq)
        with pytest.raises(ValueError, match="recovery_steps"):
            rt.StragglerMonitor(2, recovery_steps=0)
        return out
    got = _both(scenario)
    assert got[0] == ([2], 32, True, 16)
    assert got[1] == [False, False, True, 32]
    assert got[2] == (1.5, [2, 3])
    assert got[3] == [True, False, False, False, True, 32]


def test_straggler_step_timer_hysteresis_and_histogram():
    """Driven only through ``step()`` on a FakeClock: a slow host drops the
    tier, recovery needs uninterrupted clear checks, a relapse restarts
    the wait; under a tracer every step lands in ``runtime.step_seconds``."""
    def scenario(rt, obs):
        clk = obs.FakeClock()
        m = rt.StragglerMonitor(2, threshold=1.5, rank_tiers=(32, 16),
                                recovery_steps=2, clock=clk)

        def run(host, seconds):
            with m.step(host):
                clk.advance(seconds)
        out = []
        with obs.tracing(clock=clk) as tr:
            for _ in range(5):
                run(0, 1.0)
                run(1, 4.0)
            out.append((m.stragglers(), m.adapt(), m.compression_rank))
            for _ in range(20):
                run(0, 1.0)
                run(1, 1.0)
            out.append((m.stragglers(), m.adapt()))
            run(1, 60.0)
            out.append((m.adapt(), m.compression_rank))
            for _ in range(40):
                run(0, 1.0)
                run(1, 1.0)
            out.append((m.adapt(), m.adapt(), m.compression_rank))
        h = tr.metrics.histogram("runtime.step_seconds")
        out.append((h.count, h.sum, m.fleet_median))
        return out
    got = _both(scenario)
    assert got[:4] == [([1], True, 16), ([], False), (False, 16),
                       (False, True, 32)]
    assert got[4][0] == 131
