"""CPU tests of the benchmark's files: BENCHMARK.json against its contract,
loading every configuration, traffic mix and metric by name (a new one
added as files too), the counting functions, and the trace reduction."""
from __future__ import annotations

import json
import re
import shutil

import pytest

from perfbench import trace as trace_mod
from perfbench.harness import Run
from perfbench.workload import (HERE, ROOT, load_benchmark, load_cell,
                                load_entry, load_json, load_limits,
                                load_metric, metrics_for)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = load_benchmark()


def test_benchmark_json_keeps_to_its_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len({x["name"] for x in BENCH["end_to_end"] + BENCH["per_layer"]}) \
        == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
    for w in BENCH["workloads"]:
        got = {m["name"] for m in metrics_for(BENCH, w["name"], False)}
        assert "setup_s" in got and len(got) >= 2
        assert metrics_for(BENCH, w["name"], True)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_its_configuration_traffic_and_metrics(cell):
    c = load_cell(BENCH, cell)
    entry = next(x for x in BENCH["configs"] if x["name"] == c.entry["config"])
    assert c.config["name"] == entry["name"]
    assert c.config["source"] == entry["source"]
    assert c.config["reduced"] == entry["reduced"] == []
    assert c.traffic["name"] == c.entry["traffic"]
    entry = load_entry(c.traffic["entry"])
    assert callable(entry.System) and entry.STAGE_RANGES
    assert load_limits(c.config["dtype"])["limits"]
    for trace in (False, True):
        for m in metrics_for(BENCH, cell, trace):
            assert callable(load_metric(m["name"]).read)


def test_a_new_configuration_traffic_and_metric_are_files_and_entries(
        tmp_path):
    """A later PR adds a cell by files and entries alone: copy the tree,
    add a configuration, a mix with an entry point of its own and a
    metric, and load them by name."""
    base = tmp_path / "perfbench"
    shutil.copytree(HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    cfg = dict(load_json(HERE / "configs" / "rid-row0-c128.json"),
               name="rid-row1-c128", k=400)
    (base / "configs" / "rid-row1-c128.json").write_text(json.dumps(cfg))
    mix = dict(load_json(HERE / "traffic" / "srft.json"), name="srft-auto",
               qr_panel="auto", entry="rid_streamed")
    (base / "traffic" / "srft-auto.json").write_text(json.dumps(mix))
    (base / "entries" / "rid_streamed.py").write_text(
        "ID_RANGE = 'bench.id'\nSTAGE_RANGES = ('bench.pass1',)\n"
        "class System:\n    pass\n")
    (base / "metrics" / "ids_done.v2.py").write_text(
        "def read(run):\n    return run.attempted - run.failed\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "rid-row1-c128", "source": "x",
                             "file": "perfbench/configs/rid-row1-c128.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "row1-srft-auto",
                               "config": "rid-row1-c128",
                               "traffic": "srft-auto", "chips": 4,
                               "why": "x"})
    bench["per_layer"].append({"name": "ids_done.v2", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "id_s",
                               "workloads": ["row1-srft-auto"]})
    cell = load_cell(bench, "row1-srft-auto", base=base)
    assert cell.config["k"] == 400 and cell.traffic["qr_panel"] == "auto"
    assert cell.chips == 4
    entry = load_entry(cell.traffic["entry"], base=base)
    assert entry.STAGE_RANGES == ("bench.pass1",)
    names = [m["name"] for m in metrics_for(bench, "row1-srft-auto", True)]
    assert names == ["ids_done.v2"]
    run = Run(config=cell.config, traffic=cell.traffic, attempted=7, failed=2)
    assert load_metric("ids_done.v2", base=base).read(run) == 5


def _sketch_count():
    return load_metric("sketch_roofline")


def test_counting_functions_against_hand_worked_numbers():
    mod = _sketch_count()
    peaks = load_json(HERE / "peaks.json")
    row0 = load_json(HERE / "configs" / "rid-row0-c128.json")
    row2 = load_json(HERE / "configs" / "rid-row2-c128.json")
    gauss = load_json(HERE / "traffic" / "gaussian.json")
    srft = load_json(HERE / "traffic" / "srft.json")
    # 8 l m n = 8 * 800 * 2^16 * 2^14
    assert mod.ops(row2, gauss) == 6_871_947_673_600
    assert mod.least_seconds(row2, gauss, peaks) == pytest.approx(0.10257,
                                                                  rel=1e-4)
    # (m n + l n) * 16 = (2^28 + 200 * 2^14) * 16
    assert mod.bytes_moved(row0, srft) == 4_347_396_096
    assert mod.least_seconds(row0, srft, peaks) == pytest.approx(1.2977e-3,
                                                                 rel=1e-4)
    # 5 m log2 m n at row 2 is under the bytes bound of 17.4 GB
    assert mod.ops(row2, srft) == 5 * 2**16 * 16 * 2**14
    assert mod.least_seconds(row2, srft, peaks) == pytest.approx(
        (2**30 + 800 * 2**14) * 16 / 3.35e12)
    assert mod.ops(row0, dict(srft, sketch_kind="srht")) is None


def _trace_run(summary):
    row0 = load_json(HERE / "configs" / "rid-row0-c128.json")
    return Run(config=row0, traffic=load_json(HERE / "traffic" / "srft.json"),
               trace=summary, peaks=load_json(HERE / "peaks.json"))


class _Ev:
    """A stand-in for a Kineto event."""

    def __init__(self, name, dev, t0, dur, corr=0, ann=False, tid=1):
        self._v = (name, dev, t0, dur, corr, ann, tid)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[1] else "DeviceType.CPU"

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


def _events():
    """Two IDs of 1000 ns each: a sketch kernel and a copy launched in
    ``bench.sketch``, two QR kernels in ``bench.qr_interp`` (one overlapping
    the other), and an idle gap while the host sits in ``aten::item``."""
    ev = []
    for base in (0, 1000):
        ev += [_Ev("bench.id", False, base, 1000, ann=True),
               _Ev("bench.sketch", False, base, 300, ann=True),
               _Ev("bench.qr_interp", False, base + 300, 500, ann=True),
               _Ev("cudaLaunchKernel", False, base + 10, 5, corr=base + 1),
               _Ev("cudaMemcpyAsync", False, base + 20, 5, corr=base + 2),
               _Ev("cudaLaunchKernel", False, base + 310, 5, corr=base + 3),
               _Ev("cudaLaunchKernel", False, base + 320, 5, corr=base + 4),
               _Ev("aten::item", False, base + 600, 300),
               _Ev("sketch_accum_kernel", True, base + 50, 200,
                   corr=base + 1),
               _Ev("Memcpy HtoD", True, base + 250, 50, corr=base + 2),
               _Ev("panel_step", True, base + 400, 100, corr=base + 3),
               _Ev("panel_apply", True, base + 450, 100, corr=base + 4)]
    ev.append(_Ev("warmup_kernel", True, 5000, 100, corr=99))
    return ev


def test_trace_reduction_assigns_ops_to_the_launching_range():
    s = trace_mod.summarize(_events(), "bench.id",
                            ("bench.sketch", "bench.qr_interp"))
    assert s.ids == 2 and s.window_s == pytest.approx(2000e-9)
    assert s.ranges["bench.sketch"] == {"device_s": pytest.approx(500e-9),
                                        "launches": 2}
    assert s.ranges["bench.qr_interp"] == {"device_s": pytest.approx(400e-9),
                                           "launches": 4}
    # busy = union: [50, 300) + [400, 550) per ID
    assert s.busy_s == pytest.approx(800e-9)
    gaps = dict(s.idle_gaps)
    assert gaps["aten::item"] == pytest.approx(950e-9)   # [550, 1050) + [1550, 2000)
    assert s.device_ops[0][0] == "sketch_accum_kernel"
    run = _trace_run(s)
    assert load_metric("device_idle").read(run) == pytest.approx(60.0)
    assert load_metric("sketch_ms").read(run) == pytest.approx(250e-6)
    assert load_metric("qr_interp_ms").read(run) == pytest.approx(200e-6)
    assert load_metric("qr_interp_launches").read(run) == 2
    share = load_metric("sketch_roofline").read(run)
    assert share == pytest.approx(100 * 1.2977e-3 / 250e-9, rel=1e-4)


def test_readers_read_nothing_without_a_device_trace():
    s = trace_mod.summarize([e for e in _events() if not e._v[1]],
                            "bench.id", ("bench.sketch", "bench.qr_interp"))
    run = _trace_run(s)
    for m in BENCH["per_layer"]:
        assert load_metric(m["name"]).read(run) is None
    assert load_metric("sketch_roofline").read(_trace_run(None)) is None


def test_end_to_end_readers():
    run = _trace_run(None)
    run.window_s, run.attempted, run.setup_s = 10.0, 40, 12.5
    run.walls = [0.25] * 38 + [0.5, 1.0]
    run.peak_bytes = 20_000_000_000
    assert load_metric("id_s").read(run) == 0.25
    assert load_metric("id_p95_s").read(run) == pytest.approx(0.2625)
    assert load_metric("peak_gb").read(run) == 20.0
    assert load_metric("setup_s").read(run) == 12.5
    run.walls = run.walls[:10]
    assert load_metric("id_p95_s").read(run) is None


def test_no_file_of_the_benchmark_lies_outside_its_folder():
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).resolve().is_relative_to(HERE)
    assert not (ROOT / "perfbench_torch").exists()
