"""The port's dry-run (``repro_torch.launch.dryrun``) on torch's fake
backend, on the CPU.

Two subprocesses at once (``torch_ranks.start_ranks``; each joins the fake
group, the test process joins none; the training cells in one, the rest
and the CLI in the other) run SMOKE granite-3-2b cells on a (2, 2, 2)
("pod", "data", "model") mesh of the 512-rank fake world: a training cell
(8 x 64), a decode cell and a prefill cell over ``BLOCKWISE_THRESHOLD``
(2 x 4096, the flash op), and the training cell again on a (1, 1) mesh,
and in f32 with one token a row; then, in the second process, the CLI runs
whisper-tiny's decode_32k cell at full width in a 512-rank fake group of
its own and writes its record (under the gitignored
``experiments/dryrun_torch/``).
Held: every cell's ``status`` is ``"ok"`` with the record's keys; the
parameter bytes a device equal the sum of the local shards worked out
from the REFERENCE's ``param_specs`` on the same stand-in mesh; a (1, 1)
mesh moves no collective bytes where (2, 2, 2) moves some; the long
prefill's peak is below the bytes of its S x S scores (the flash op's
fake kernel gives its output alone); the one-token cell's peak is the
live set counted by hand (4 P and three temporaries of the largest leaf).
"""
import json
import math
import os

import pytest

jax = pytest.importorskip("jax")

from repro import configs as jcfgs  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.models import transformer as jtransformer  # noqa: E402
from torch_ranks import failures, pin_threads, start_ranks  # noqa: E402

pin_threads()

_PROGRAM = r"""
import contextlib, io, json, runpy, sys, traceback
import torch
import torch.distributed as dist
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.launch.shapes import ShapeCase
OUT = {}
part = sys.argv[3]

# 1. the dry-run's cells (part "a": the training cells; "b": decode and
# prefill, then the CLI)
dryrun.join_fake_group()
cfg = get_smoke_config("granite_3_2b")
mesh = make_elastic_mesh((2, 2, 2), ("pod", "data", "model"),
                         device_type="cpu")
one = make_elastic_mesh((1, 1), ("data", "model"), device_type="cpu")
cells = {}
for name, case, m in (("token_1x1", ShapeCase("train", 1, 8, "train"), one),
                      ("train", ShapeCase("train", 64, 8, "train"), mesh),
                      ("decode", ShapeCase("decode", 64, 8, "decode"), mesh),
                      ("prefill", ShapeCase("prefill", 4096, 2, "prefill"),
                       mesh),
                      ("train_1x1", ShapeCase("train", 64, 8, "train"), one)):
    if (part == "a") != (case.kind == "train"):
        continue
    c = cfg.replace(dtype="float32") if name == "token_1x1" else cfg
    cells[name] = dryrun.run_cell("granite_3_2b", "train_4k", name, cfg=c,
                                  case=case, mesh=m, save=False)
OUT["cells"] = cells
dist.destroy_process_group()
if part == "a":
    print(json.dumps(OUT))
    sys.exit(0)

# 2. the dry-run CLI: its own 512-rank fake group, one cell, its record
sys.argv = ["dryrun", "--cell", "whisper-tiny:decode_32k:pod", "--jsonl"]
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    try:
        runpy.run_module("repro_torch.launch.dryrun", run_name="__main__")
        code = 0
    except SystemExit as e:
        code = e.code
OUT["cli"] = {"exit": code, "lines": buf.getvalue().splitlines()}
print(json.dumps(OUT))
"""

KEYS = ("status", "flops", "peak_bytes_per_device", "param_bytes_per_device",
        "grad_bytes_per_device", "opt_bytes_per_device", "collective_bytes",
        "collective_total", "interpod_bytes", "propagations_excluded",
        "hbm_bytes_per_device", "seconds", "backend")


@pytest.fixture(scope="module")
def results():
    """The program's two parts at once, one process each: ``cells``
    (records by name) and ``cli`` (the CLI's exit code and output lines)."""
    waits = [start_ranks(_PROGRAM, 1, part, timeout=600, OMP_NUM_THREADS="1")
             for part in "ab"]
    a, b = (w() for w in waits)
    assert not failures(a + b), failures(a + b)
    out_a, out_b = (json.loads(r[0][1].strip().splitlines()[-1])
                    for r in (a, b))
    return {"cells": {**out_a["cells"], **out_b["cells"]},
            "cli": out_b["cli"]}


@pytest.fixture(scope="module")
def cells(results):
    return results["cells"]


@pytest.mark.parametrize("name", ["train", "decode", "prefill", "train_1x1",
                                  "token_1x1"])
def test_cells_run_ok_with_the_records_keys(cells, name):
    rec = cells[name]
    assert rec["status"] == "ok", rec.get("traceback")
    assert all(k in rec for k in KEYS)
    assert rec["backend"] == "fake"
    assert rec["flops"] > 0 and rec["peak_bytes_per_device"] > 0
    assert rec["propagations_excluded"] > 0


def test_peak_is_the_hand_counted_live_set(cells):
    """SMOKE granite in f32 on (1, 1), one token a row: the activations
    are a few KB, so the peak is ``adamw_update`` on the largest leaf (the
    embedding or the head, V x d): the parameters, their gradients and
    the two moments (4 P), and three temporaries of that leaf's size at
    once (``m / bc1``, ``sqrt(v / bc2) + eps`` and ``upd``; later
    ``upd``, ``lr * upd`` and the new value), plus scalars (under 1 KB).
    A meter that counted DTensor's global-shape propagation runs, or
    storages twice, would read more."""
    jc = jcfgs.get_smoke_config("granite_3_2b")
    rec = cells["token_1x1"]
    P = rec["param_bytes_per_device"]
    assert P == _reference_param_bytes((1, 1), ("data", "model"))
    leaf = 4 * jc.vocab_size * jc.d_model
    assert rec["grad_bytes_per_device"] == P
    assert rec["opt_bytes_per_device"] == 2 * P
    live = 4 * P + 3 * leaf
    assert live <= rec["peak_bytes_per_device"] <= live + 1024, (
        rec["peak_bytes_per_device"], live)


def _reference_param_bytes(shape, axes) -> int:
    """Sum over the reference's leaves of the local shard's bytes under
    its own param_specs on a stand-in mesh."""
    import types
    mesh = types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=axes)
    jc = jcfgs.get_smoke_config("granite_3_2b")
    pshape = jtransformer.params_shape(jc)
    specs = jsharding.param_specs(jc, pshape, mesh)
    total = 0
    for leaf, spec in zip(jax.tree.leaves(pshape), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))):
        n = 1
        for i, dim in enumerate(leaf.shape):
            ax = spec[i] if i < len(spec) else None
            group = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
            n *= dim // math.prod(mesh.shape[a] for a in group)
        total += n * leaf.dtype.itemsize
    return total


def test_param_bytes_are_the_reference_shards(cells):
    want = _reference_param_bytes((2, 2, 2), ("pod", "data", "model"))
    assert cells["train"]["param_bytes_per_device"] == want
    assert cells["decode"]["param_bytes_per_device"] == want
    assert cells["train"]["grad_bytes_per_device"] == want
    assert cells["train"]["opt_bytes_per_device"] == 2 * want
    one = _reference_param_bytes((1, 1), ("data", "model"))
    assert cells["train_1x1"]["param_bytes_per_device"] == one


def test_one_device_mesh_moves_no_collective_bytes(cells):
    assert cells["train_1x1"]["collective_total"] == 0
    assert cells["train"]["collective_total"] > 0
    assert cells["train"]["interpod_bytes"] >= 0


def test_long_prefill_counts_no_scores(cells):
    cfg = jcfgs.get_smoke_config("granite_3_2b")
    B, S = 2, 4096
    scores = B * cfg.n_heads * S * S * 4
    rec = cells["prefill"]
    assert rec["peak_bytes_per_device"] < scores / 8
    assert rec["flops"] > 4 * B * cfg.n_heads * cfg.hd * S * S / 2 / 8


def test_cli_writes_its_record(results):
    from repro_torch.launch.dryrun import ARTIFACT_DIR
    cli = results["cli"]
    assert cli["exit"] == 0, cli["lines"][-5:]
    rec = json.loads(cli["lines"][-1])
    assert rec["status"] == "ok" and rec["mesh_shape"] == [16, 16]
    with open(os.path.join(ARTIFACT_DIR,
                           "whisper_tiny_decode_32k_pod.json")) as f:
        saved = json.load(f)
    assert saved["peak_bytes_per_device"] == rec["peak_bytes_per_device"]
