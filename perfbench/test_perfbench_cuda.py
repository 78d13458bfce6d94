"""A tiny cell on the card: the kernels built, the timed path traced, and
its answers held to the reference.  Skips without a CUDA device.

    PYTHONPATH=src python -m pytest -m cuda perfbench/test_perfbench_cuda.py
"""
from __future__ import annotations

import time

import pytest
import torch

from perfbench import harness
from perfbench.workload import HERE, load_json


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["gaussian", "srft"])
def test_cuda_tiny_cell_is_correct_and_traced(card, kind):
    cfg = dict(load_json(HERE / "configs" / "rid-row0-c128.json"),
               m=2048, n=1024, k=40)
    tr = load_json(HERE / "traffic" / f"{kind}.json")
    run = harness.run_cell(cfg, tr, seed=2**31 + 19, seconds=1.0, trace=True,
                           device=card, t_start=time.perf_counter())
    assert run.correct, run.check
    assert run.peak_bytes > 0
    t = run.trace
    assert t.ids == tr["trace_ids"] and 0 < t.busy_s <= t.window_s
    assert t.ranges["bench.sketch"]["device_s"] > 0
    assert t.ranges["bench.qr_interp"]["launches"] > 0
