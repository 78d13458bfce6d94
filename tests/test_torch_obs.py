"""The port's observability layer (``repro_torch.obs``) against
``repro.obs``, on the CPU: the same instrumentation under the two tracers,
driven by fake clocks, must give the same spans, events, metrics and the
same exported JSONL and Chrome trace; and the serving engines of the two
packages must open the same spans, counters and gauges for the same
requests."""
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import configs as jcfgs  # noqa: E402
from repro import models as jmodels  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch import models as tmodels  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.obs import trace as ttrace  # noqa: E402


def _workload(obs, trace, block_value):
    """One instrumented run: nested spans, a bound attribute, events inside
    and outside spans, every metric kind, an error span and a leaked one."""
    trace.event("boot", phase="init")               # root-level event
    with trace.span("job", n=3) as root:
        with trace.attributes(job_id="j1"):
            for i in range(3):
                with trace.span("step", i=i) as sp:
                    sp.block_on(block_value)
                    trace.counter("steps").add(1)
                    trace.histogram("step.size").observe(10.0 * (i + 1))
                    trace.gauge("queue").set(3 - i)
                    if i == 1:
                        trace.event("checkpoint", step=i)
        try:
            with trace.span("bad"):
                raise RuntimeError("boom")
        except RuntimeError:
            pass
        tracer = trace.current_tracer()
        tracer.start("leaked", why="never closed")
        with trace.span("after"):
            pass
        root.set(done=True)


def _run(obs, trace, block_value, tmp, tag):
    jsonl, chrome = tmp / f"{tag}.jsonl", tmp / f"{tag}.json"
    tracer = obs.Tracer(clock=obs.FakeClock(tick=0.5), exporters=[
        obs.JsonlExporter(jsonl), obs.ChromeTraceExporter(chrome)])
    with trace.tracing(tracer):
        _workload(obs, trace, block_value)
    lines = [json.loads(s) for s in jsonl.read_text().splitlines()]
    return tracer, lines, json.loads(chrome.read_text())


def test_trace_exports_equal_the_reference(tmp_path):
    jtr, jlines, jchrome = _run(jobs, jtrace, jax.numpy.ones(3), tmp_path, "j")
    ttr, tlines, tchrome = _run(tobs, ttrace, torch.ones(3), tmp_path, "t")
    assert tlines == jlines
    assert tchrome == jchrome
    assert [(s.name, s.depth, s.attrs) for s in ttr.spans] == \
        [(s.name, s.depth, s.attrs) for s in jtr.spans]
    names = {s.name for s in ttr.spans}
    assert {"boot", "job", "step", "bad", "leaked", "after"} <= names
    bad = [s for s in ttr.spans if s.name == "bad"][0]
    assert bad.attrs["error"] == "RuntimeError: boom"
    step = [s for s in ttr.spans if s.name == "step"][0]
    assert step.attrs["job_id"] == "j1" and step.depth == 1


def test_no_tracer_is_a_no_op():
    assert ttrace.current_tracer() is None and not ttrace.deep_tracing()
    with ttrace.span("x", a=1) as sp:
        assert sp.block_on(torch.ones(1)) is sp
    ttrace.counter("c").add(5)
    ttrace.gauge("g").set(1.0)
    ttrace.histogram("h").observe(2.0)
    ttrace.event("e")


def test_metrics_registry_rules():
    reg = tobs.MetricsRegistry(clock=tobs.FakeClock())
    assert reg.counter("a") is reg.counter("a")
    with pytest.raises(ValueError, match="already registered as Counter"):
        reg.gauge("a")
    with pytest.raises(ValueError, match="negative increment"):
        reg.counter("a").add(-1)
    h = reg.histogram("h")
    for v in (1.0, 3.0):
        h.observe(v)
    assert h.snapshot() == {"type": "histogram", "name": "h", "count": 2,
                            "sum": 4.0, "min": 1.0, "max": 3.0, "mean": 2.0}


def test_exporter_registry():
    assert tobs.exporter_names() == ["chrome", "jsonl", "prometheus"]
    with pytest.raises(ValueError, match="duplicate exporter name 'jsonl'"):
        tobs.register_exporter("jsonl")(object)
    with pytest.raises(ValueError, match="unknown exporter 'otlp'"):
        tobs.get_exporter("otlp")


def test_fake_clock_and_sleep():
    clk = tobs.FakeClock(start=2.0, tick=1.0)
    assert clk() == 2.0 and clk() == 3.0
    clk.sleep(0.5)
    assert clk.sleeps == [0.5] and clk.t == 4.5
    with pytest.raises(ValueError, match="dt=-1"):
        clk.advance(-1)


def test_block_on_takes_nested_tensors():
    """``block_on`` accepts what the reference's pytrees hold here: nested
    lists, tuples and dicts of tensors (CPU tensors need no wait)."""
    tracer = tobs.Tracer(clock=tobs.FakeClock(tick=1.0))
    with ttrace.tracing(tracer):
        with ttrace.span("s") as sp:
            sp.block_on({"a": [torch.ones(2), (torch.zeros(1),)], "b": 3})
    assert [s.name for s in tracer.spans] == ["s"]
    assert tracer.spans[0].dur == 1.0


@pytest.fixture(scope="module")
def engines():
    arch = "granite_3_2b"
    jc = jcfgs.get_smoke_config(arch).replace(dtype="float32")
    tc = tcfgs.get_smoke_config(arch).replace(dtype="float32")
    jp = jmodels.init_params(jax.random.key(0), jc)
    model = tmodels.params_from_jax(jax.tree.map(np.asarray, jp), tc,
                                    device="cpu")
    return (jc, jp, jserving, jobs, jtrace), (tc, model, tserving, tobs,
                                              ttrace)


def _traced_serve(side):
    """A chunked and a one-shot request, one shed and one poisoned, under
    a fake-clock tracer."""
    cfg, params, serving, obs, trace = side
    eng = serving.ServeEngine(cfg, params, max_batch=2, max_len=64,
                              prefill_chunk_tokens=8, max_queue=3)
    reqs = [serving.GenerationRequest(request_id=0,
                                      prompt=np.arange(20, dtype=np.int32),
                                      max_new_tokens=3),
            serving.GenerationRequest(request_id=1,
                                      prompt=np.arange(4, dtype=np.int32),
                                      max_new_tokens=2),
            serving.GenerationRequest(request_id=2,
                                      prompt=np.array([-1], dtype=np.int32)),
            serving.GenerationRequest(request_id=3,
                                      prompt=np.arange(4, dtype=np.int32))]
    for r in reqs:
        eng.submit(r)
    tracer = obs.Tracer(clock=obs.FakeClock(tick=1.0))
    with trace.tracing(tracer):
        eng.run()
    spans = [(s.name, s.depth, s.attrs,
              [(n, a) for n, _, a in s.events]) for s in tracer.spans]
    return spans, tracer.metrics.snapshot(), [r.status for r in reqs]


def test_engine_spans_equal_the_reference(engines):
    jside, tside = engines
    jspans, jmetrics, jstatus = _traced_serve(jside)
    tspans, tmetrics, tstatus = _traced_serve(tside)
    assert tstatus == jstatus == ["done", "done", "failed", "evicted"]
    assert tmetrics == jmetrics
    assert tspans == jspans
    assert {"serve.run", "serve.admit", "serve.prefill", "serve.prefill_chunk",
            "serve.decode"} <= {s[0] for s in tspans}
