"""Trace analytics and live telemetry of the port (``repro_torch.obs.
timeline``, ``obs.telemetry``) against the reference's (``repro.obs``),
and the QR engines' spans.

* The reference's synthetic traces (``tests/test_obs_analytics.py``),
  built in each package on a ``FakeClock``: the same overlap report,
  critical path, ``psum_overlap``, throughput and stragglers, exactly.
* ``Timeline.from_jsonl`` of both packages on a JSONL trace written by the
  port's exporter (a real ``rid_streamed``) and on one written by the
  reference's: the same phases, critical path, stragglers, throughput.
* ``prometheus_text`` byte-equal from the same instrument operations in
  both registries; the server's routes, concurrent scrapes, the exporter.
* The blocked engine's ``qr.panel`` spans against the reference's
  deep-tracing driver; a watched ``rid_streamed`` keeps its bits and its
  scraped counters equal the tracer's.
* ``bench_trace`` (both traces written and validated) and ``bench_stream``'s
  sharded sweep at small shapes on two gloo ranks, and its CLI on one.
CPU only.
"""
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.obs as ref_obs  # noqa: E402
import repro_torch.obs as port_obs  # noqa: E402
from repro.obs import trace as ref_trace  # noqa: E402
from repro_torch.core import pivoted_qr  # noqa: E402
from repro_torch.obs import (FakeClock, ProgressReporter,  # noqa: E402
                             TelemetryServer, Timeline, Tracer, tracing)
from repro_torch.obs import trace as port_trace  # noqa: E402
from repro_torch.obs.export import exporter_names, get_exporter  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.obs.telemetry import PrometheusExporter  # noqa: E402
from repro_torch.stream import ArraySource, rid_streamed  # noqa: E402
from torch_ranks import failures, pin_threads, run_ranks  # noqa: E402

pin_threads()

PACKAGES = {"reference": (ref_obs, ref_trace),
            "port": (port_obs, port_trace)}


def _both(build):
    """``build(obs, trace)`` in the reference and in the port."""
    return {name: build(*mods) for name, mods in PACKAGES.items()}


def _stream_trace(obs, acc_dur, *, h2d_dur=1.0, chunks=2, job="job0"):
    """The reference's synthetic pass-1 trace: a chunk is one h2d span of
    ``h2d_dur`` and one accumulate span of ``acc_dur``."""
    clk = obs.FakeClock(100.0)
    tr = obs.Tracer(clock=clk)
    with tr.bind(job=job):
        with tr.span("rid_streamed"):
            with tr.span("stream.pass1"):
                for c in range(chunks):
                    with tr.span("stream.h2d", chunk=c):
                        clk.advance(h2d_dur)
                    with tr.span("stream.accumulate", chunk=c, rows=64):
                        clk.advance(acc_dur)
    tr.finish()
    return tr


def _phase_table(tl):
    return {name: (st.count, st.total, st.self_total, st.max_dur,
                   st.max_index) for name, st in tl.phases().items()}


def _summary(tl):
    return {"phases": _phase_table(tl), "critical": tl.critical_path(),
            "stragglers": tl.stragglers(), "throughput": tl.throughput(),
            "psum": tl.psum_overlap(), "wall": tl.wall()}


# ----------------------------------------------------------------- timeline

def test_overlap_report_matches_the_reference():
    """2 chunks, h2d 1 s each; accumulate blocks 1 s serialized and
    dispatches in 0.25 s pipelined: hidden = 1.5 / 2 = 0.75 exactly; a
    pipelined trace cheaper than possible clamps to 1; empty traces 0."""
    def build(obs, _):
        ser = obs.Timeline.from_tracer(_stream_trace(obs, 1.0))
        pip = obs.Timeline.from_tracer(_stream_trace(obs, 0.25))
        free = obs.Timeline.from_tracer(_stream_trace(obs, 0.0, h2d_dur=0.0))
        empty = obs.Timeline([])
        return (obs.overlap_report(pip, ser), obs.overlap_report(ser, ser),
                obs.overlap_report(free, ser)["hidden_fraction"],
                obs.overlap_report(empty, empty)["hidden_fraction"])
    got = _both(build)
    assert got["port"] == got["reference"]
    rep, self_rep, clamped, empty = got["port"]
    assert rep["hidden_fraction"] == 0.75
    assert rep["exposed_serial_s"] == 4.0 and rep["exposed_pipelined_s"] == 2.5
    assert rep["speedup"] == 4.0 / 2.5
    assert (self_rep["hidden_fraction"], clamped, empty) == (0.0, 1.0, 0.0)


def test_critical_path_psum_overlap_throughput_and_stragglers():
    def build(obs, _):
        clk = obs.FakeClock(0.0)
        tr = obs.Tracer(clock=clk)
        tr.counter("stream.h2d_bytes").add(4000)
        with tr.span("rid_streamed"):
            clk.advance(1.0)                       # root self time
            for c, dur in enumerate((1.0, 1.0, 6.0, 1.0)):
                with tr.span("stream.h2d", chunk=c):
                    clk.advance(dur)
                with tr.span("stream.accumulate", chunk=c, rows=25):
                    clk.advance(1.0)
            with tr.span("qr.panel_parallel"):
                for i, kind in enumerate(("overlapped", "overlapped",
                                          "serialized", "overlapped")):
                    tr.event("qr.panel_schedule", panel=i, psum=kind)
                clk.advance(2.0)
        tr.finish()
        return _summary(obs.Timeline.from_tracer(tr))
    got = _both(build)
    assert got["port"] == got["reference"]
    s = got["port"]
    assert s["wall"] == 16.0 == sum(v for _, v in s["critical"])
    assert s["critical"][0] == ("stream.h2d", 9.0)
    assert s["psum"] == 0.75
    assert s["throughput"]["rows"] == 100 and s["throughput"]["bytes"] == 4000
    worst = s["stragglers"][0]
    assert worst["phase"] == "stream.h2d" and worst["chunk"] == 2
    assert worst["ratio"] == 6.0 / 2.25


def _port_jsonl(path):
    """A JSONL trace of a real streamed ID by the port's exporter."""
    A = torch.from_numpy(np.random.default_rng(1).standard_normal((512, 64)))
    with tracing(jsonl=path):
        rid_streamed(0, ArraySource(A, 128), 8, device="cpu")


def _reference_jsonl(path):
    """A JSONL trace by the reference's exporter: nested spans with a job,
    events and metrics on its FakeClock."""
    clk = ref_obs.FakeClock(50.0)
    with ref_obs.tracing(jsonl=path, clock=clk):
        with ref_trace.attributes(job="deadbeef"):
            with ref_trace.span("rid_streamed"):
                for c in range(3):
                    with ref_trace.span("stream.h2d", chunk=c):
                        clk.advance(1.0 + c)
                    with ref_trace.span("stream.accumulate", chunk=c,
                                        rows=16):
                        clk.advance(0.5)
                ref_trace.event("eq3.certificate", bound=1.5)
        ref_trace.counter("stream.h2d_bytes").add(3072)


@pytest.mark.parametrize("writer", [_port_jsonl, _reference_jsonl],
                         ids=["port-exporter", "reference-exporter"])
def test_from_jsonl_agrees_with_the_reference(tmp_path, writer):
    path = tmp_path / "t.jsonl"
    writer(path)
    port = port_obs.Timeline.from_jsonl(path)
    ref = ref_obs.Timeline.from_jsonl(path)
    assert _summary(port) == _summary(ref)
    assert port.report() == ref.report()
    assert port.phases()["stream.h2d"].count >= 3


def test_timeline_from_tracer_equals_its_jsonl(tmp_path):
    out = tmp_path / "t.jsonl"
    clk = FakeClock(50.0)
    with tracing(jsonl=out, clock=clk) as tr:
        with port_trace.attributes(job="deadbeef"):
            with port_trace.span("rid_streamed"):
                with port_trace.span("stream.h2d", chunk=0):
                    clk.advance(2.0)
                port_trace.event("eq3.certificate", bound=1.5)
        port_trace.counter("stream.chunks").add(1)
    live, disk = Timeline.from_tracer(tr), Timeline.from_jsonl(out)
    assert [(s.name, s.ts, s.dur, s.depth, s.index, s.attrs)
            for s in live.spans] == \
        [(s.name, s.ts, s.dur, s.depth, s.index, s.attrs) for s in disk.spans]
    assert live.report() == disk.report()


# ---------------------------------------------------------------- telemetry

def _instruments(obs_metrics_registry, clock):
    reg = obs_metrics_registry(clock=clock)
    reg.counter("stream.chunks").add(7)
    reg.counter("stream.h2d_bytes").add(1.5e9)
    reg.gauge("device.live_bytes").set(12345.0)
    h = reg.histogram("runtime.step_seconds")
    for v in (0.1, 0.3, 2.5e-7):
        h.observe(v)
    reg.histogram("serve.empty")                  # min/max render NaN
    return reg


@pytest.mark.parametrize("namespace", ["repro", "job"])
def test_prometheus_text_is_byte_equal_to_the_reference(namespace):
    from repro.obs.metrics import MetricsRegistry as RefRegistry
    from repro.obs.telemetry import prometheus_text as ref_text
    from repro_torch.obs import prometheus_text
    port = prometheus_text(_instruments(MetricsRegistry, FakeClock(0.0)),
                           namespace=namespace)
    ref = ref_text(_instruments(RefRegistry, ref_obs.FakeClock(0.0)),
                   namespace=namespace)
    assert port == ref
    lines = port.splitlines()
    assert f"{namespace}_stream_chunks_total 7.0" in lines
    assert f"{namespace}_runtime_step_seconds_count 3.0" in lines
    for line in lines:
        if not line.startswith("#"):
            name, value = line.split(" ")
            assert "." not in name
            float(value)
    with pytest.raises(ValueError, match="summary"):
        prometheus_text([{"type": "summary", "name": "x"}])


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def test_telemetry_server_routes_and_live_scrape():
    clk = FakeClock(0.0)
    reg = MetricsRegistry(clock=clk)
    reg.counter("stream.chunks").add(3)
    rep = ProgressReporter(clock=clk, job="abc")
    rep.update(done=2, total=8, phase="pass1")
    with TelemetryServer(registry=reg, progress=rep, clock=clk) as srv:
        assert srv.port != 0 and srv.url.startswith("http://127.0.0.1:")
        code, body = _get(srv.url + "/metrics")
        assert code == 200 and "repro_stream_chunks_total 3.0" in body
        assert "repro_progress_done 2.0" in body
        clk.advance(4.0)
        reg.counter("stream.chunks").add(1)
        _, body = _get(srv.url + "/metrics")
        assert "repro_stream_chunks_total 4.0" in body
        assert "repro_uptime_seconds 4.0" in body
        code, body = _get(srv.url + "/healthz")
        assert code == 200 and json.loads(body)["status"] == "ok"
        code, body = _get(srv.url + "/progress")
        st = json.loads(body)
        assert code == 200 and st["done"] == 2 and st["job"] == "abc"
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.url + "/nope")
        assert e.value.code == 404
        assert "/metrics" in e.value.read().decode()
    with pytest.raises(OSError):
        urllib.request.urlopen(srv.url + "/healthz", timeout=0.5)
    with TelemetryServer(registry=reg) as bare:
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(bare.url + "/progress")          # no reporter attached
        assert e.value.code == 404


def test_telemetry_server_concurrent_scrapes():
    reg = MetricsRegistry(clock=FakeClock(0.0))
    reg.counter("stream.chunks").add(1)
    errors = []
    with TelemetryServer(registry=reg) as srv:
        def scrape():
            try:
                for _ in range(5):
                    code, body = _get(srv.url + "/metrics")
                    assert code == 200
                    assert "repro_stream_chunks_total" in body
            except Exception as e:                 # surfaced after join
                errors.append(e)
        threads = [threading.Thread(target=scrape) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    assert errors == []


def test_prometheus_exporter_registered_and_writes(tmp_path):
    assert "prometheus" in exporter_names()
    out = tmp_path / "metrics.prom"
    ex = get_exporter("prometheus", out)
    assert isinstance(ex, PrometheusExporter)
    with tracing(Tracer(clock=FakeClock(0.0), exporters=[ex])) as tr:
        tr.counter("stream.chunks").add(5)
    assert "repro_stream_chunks_total 5.0" in out.read_text()


def test_watched_rid_streamed_keeps_its_bits_and_scrapes_its_counters():
    """Progress, a tracer and live scrapes change nothing of the result;
    the final scrape's counters equal the tracer's, and /progress reads
    both passes done."""
    A = torch.from_numpy(np.random.default_rng(2).standard_normal((512, 64)))
    src = ArraySource(A, 128)
    plain = rid_streamed(1, src, 8, device="cpu")
    rep = ProgressReporter()
    with tracing() as tr:
        with TelemetryServer(registry=tr.metrics, progress=rep) as srv:
            watched = rid_streamed(1, src, 8, device="cpu", progress=rep)
            _, body = _get(srv.url + "/metrics")
            _, prog = _get(srv.url + "/progress")
            code, health = _get(srv.url + "/healthz")
    for f in "BPJQR":
        assert torch.equal(getattr(plain, f), getattr(watched, f)), f
    chunks = tr.metrics.counter("stream.chunks").value
    assert f"repro_stream_chunks_total {float(chunks)!r}" in body
    h2d = tr.metrics.counter("stream.h2d_bytes").value
    assert f"repro_stream_h2d_bytes_total {float(h2d)!r}" in body
    st = json.loads(prog)
    assert st["done"] == st["total"] == 2 * 4 and st["state"] == "done"
    assert code == 200 and json.loads(health)["status"] == "ok"


# ------------------------------------------------------------- engine spans

def test_blocked_engine_panel_spans_match_the_reference_deep_driver():
    """Deep tracing: the port's one loop opens the reference's
    ``qr.blocked_deep`` > ``qr.panel`` x 2 > ``qr.final_r`` spans with the
    same attributes and ``qr.panels`` count; normal tracing keeps the
    ``qr.panel`` spans under ``qr.pivoted``."""
    from repro.core.qr import pivoted_qr as ref_pivoted_qr
    Y = np.random.default_rng(0).standard_normal((48, 400)).astype(np.float32)

    def qr_spans(tr):
        return [(s.name, s.depth,
                 {k: v for k, v in s.attrs.items() if k != "panel_impl"})
                for s in sorted(tr.spans, key=lambda s: s.index)
                if s.name.startswith("qr.")]
    with ref_obs.tracing(deep=True) as ref:
        ref_pivoted_qr(jnp.asarray(Y), 14, panel=7)
    with tracing(deep=True) as port:
        pivoted_qr(torch.from_numpy(Y), 14, panel=7)
    assert qr_spans(port) == qr_spans(ref)
    assert [s[0] for s in qr_spans(port)] == \
        ["qr.blocked_deep"] + ["qr.panel"] * 2 + ["qr.final_r"]
    assert port.metrics.counter("qr.panels").value == \
        ref.metrics.counter("qr.panels").value == 2
    with tracing() as normal:
        pivoted_qr(torch.from_numpy(Y), 14, panel=7)
    names = [s[0] for s in qr_spans(normal)]
    assert names == ["qr.pivoted"] + ["qr.panel"] * 2 + ["qr.final_r"]
    assert qr_spans(normal)[0][2]["impl"] == "blocked"


# --------------------------------------------------------------- benchmarks

def test_bench_trace_writes_two_valid_traces(tmp_path):
    from repro_torch.benchmarks import bench_trace
    written = bench_trace.main(["--out", str(tmp_path), "--device", "cpu"])
    assert [p.rsplit("/", 1)[1] for p, _ in written] == \
        ["stream_trace.json", "serve_trace.json"]
    ev = json.loads((tmp_path / "stream_trace.json").read_text())
    names = [e["name"] for e in ev["traceEvents"] if e["ph"] == "X"]
    assert names.count("stream.h2d") == names.count("stream.accumulate") == 8
    assert "eq3.certificate" in [e["name"] for e in ev["traceEvents"]
                                 if e["ph"] == "i"]
    (tmp_path / "bad.json").write_text(json.dumps(
        {"traceEvents": [{"ph": "X"}, {"ph": "B"}]}))
    with pytest.raises(AssertionError, match="bad ph"):
        bench_trace.validate(tmp_path / "bad.json")


SWEEP_PROGRAM = r"""
import datetime, json, sys
from pathlib import Path
import torch
import torch.distributed as dist
from repro_torch.benchmarks import bench_stream

rank, world, work = int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])
torch.set_num_threads(1)
bench_stream.SHARDED_M, bench_stream.N0 = 1024, 64      # small shapes
if world == 1:                     # the CLI: its own one-rank group
    bench_stream.main(["--sharded", "--device", "cpu",
                       "--json", str(work / "cli.json")])
else:
    dist.init_process_group("gloo", init_method=(work / "store").as_uri(),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    rows = bench_stream.stream_sharded_sweep(dist.group.WORLD, device="cpu")
    dist.destroy_process_group()
    print(json.dumps(rows))
"""


def test_bench_stream_sharded_sweep_on_small_shapes(tmp_path):
    res = run_ranks(SWEEP_PROGRAM, 2, str(tmp_path), timeout=120,
                    OMP_NUM_THREADS="1")
    assert not failures(res), failures(res)
    rows = json.loads(res[0][1].strip().splitlines()[-1])
    assert json.loads(res[1][1].strip().splitlines()[-1]) == []
    assert [(r["ndev"], r["n"], r["m"]) for r in rows] == \
        [(1, 64, 1024), (2, 128, 1024)]
    for r in rows:
        assert r["on_disk_bytes"] > r["m"] * r["n"] * 4
        assert r["acc_shard_bytes"] == 2 * 48 * 64 * 4
        assert r["wall_s"] > 0 and r["peak_device_bytes"] is None
    res = run_ranks(SWEEP_PROGRAM, 1, str(tmp_path), timeout=120,
                    OMP_NUM_THREADS="1")
    assert not failures(res), failures(res)
    cli = json.loads((tmp_path / "cli.json").read_text())
    assert [(r["bench"], r["ndev"]) for r in cli] == [("stream_sharded", 1)]
