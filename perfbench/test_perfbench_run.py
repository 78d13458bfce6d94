"""CPU tests of the command: the shape of its last line, its refusals, and
that neither the harness nor its reference loads JAX or the JAX package
(and the reference nothing of the program)."""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from perfbench import harness, run as run_mod
from perfbench.workload import HERE, ROOT, load_benchmark, load_cell, load_json

TINY = dict(load_json(HERE / "configs" / "rid-row0-c128.json"),
            m=256, n=192, k=20)


def test_last_line_has_the_required_keys_and_check_last():
    bench = load_benchmark()
    cell = load_cell(bench, "row0-srft")
    run = harness.run_cell(TINY, cell.traffic, seed=3, seconds=0.3,
                           trace=False, device="cpu",
                           t_start=time.perf_counter())
    run.peak_bytes = 5_000_000_000      # the card's reading, stood in
    device = {"platform": "gpu", "kind": "x", "count": 1,
              "memory_peak_bytes": run.peak_bytes}
    line = json.loads(json.dumps(run_mod.result_line(run, bench, cell,
                                                     False, device)))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "check"]
    assert line["correct"] is True and line["failed"] == 0
    # id_p95_s reads nothing under 20 IDs
    assert {"id_s", "peak_gb", "setup_s"} <= set(line["metrics"]) <= {
        "id_s", "id_p95_s", "peak_gb", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in line["check"].values():
        assert set(c) == {"value", "limit"}
    traced = run_mod.result_line(run, bench, cell, True, device)
    assert set(traced["metrics"]) == set()     # no device trace on the CPU


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["repro_torch.core", "jaxtyping", "reproducer", "jax.numpy",
             "repro", "flax.linen", "jaxlib", "torch"]
    assert run_mod.forbidden_modules(names) == ["flax.linen", "jax.numpy",
                                                "jaxlib", "repro"]


_PROBE = r"""
import sys, time, json
sys.path[:0] = [{root!r}, {src!r}]
import torch
from perfbench import reference
from perfbench.workload import make_matrix
cfg = dict(m=128, n=96, k=8, dtype="complex128")
A = make_matrix(1, cfg, "cpu")
reference.decompose("srft", 2, A, 8, 16, 32)
after_reference = sorted({{n.split(".")[0] for n in sys.modules}})
from perfbench import harness
from perfbench.workload import HERE, load_json
tr = load_json(HERE / "traffic" / "gaussian.json")
run = harness.run_cell(dict(load_json(HERE / "configs" / "rid-row0-c128.json"),
                            m=128, n=96, k=8), tr, seed=1, seconds=0.1,
                       trace=True, device="cpu", t_start=time.perf_counter())
print(json.dumps({{"reference": after_reference, "correct": run.correct,
                  "run": sorted({{n.split(".")[0] for n in sys.modules}})}}))
"""


def test_neither_the_run_nor_the_reference_loads_jax():
    code = _PROBE.format(root=str(ROOT), src=str(ROOT / "src"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["correct"] is True
    forbidden = {"jax", "jaxlib", "flax", "repro"}
    assert not forbidden & set(got["run"])
    assert "repro_torch" in got["run"]
    assert not (forbidden | {"repro_torch"}) & set(got["reference"])


def test_the_command_refuses_without_a_card_and_prints_no_result():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                          "row0-srft", "--seed", str(2**31 + 3), "--seconds",
                          "1", "--trace", "0"], capture_output=True,
                         text=True, timeout=240, cwd=ROOT, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
