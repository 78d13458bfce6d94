"""Everything the harness finds by name, and the one traffic generator.

``BENCHMARK.json`` at the root of the checkout lists the cells and metrics.
A cell names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``), which names the entry point it drives
(``entries/<name>.py``); a metric is read by ``metrics/<name>.py``; the
correctness limits of a dtype are in ``limits/<dtype>.json``.  Adding any of
them is adding a file and an entry: nothing here names one.

The generator makes the cell's matrix on the device from ``--seed``: the
paper's ``A = B0 P0`` with Gaussian factors (complex: real and imaginary
parts each standard normal), drawn in four large calls from one
``torch.Generator`` on the device and multiplied once.  ID ``i`` of a run
takes the sketch seed ``id_seed(seed, i)``.  ``make_factors`` gives the
factors themselves, drawn again, for the check.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

import torch

from .reference import splitmix64

__all__ = ["HERE", "ROOT", "Cell", "load_benchmark", "load_cell",
           "load_json", "load_entry", "load_metric", "load_limits",
           "metrics_for", "make_factors", "make_matrix", "id_seed",
           "WARMUP_BASE", "dtype_of"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

_MASK64 = (1 << 64) - 1
# Warm-up IDs draw their seeds from indices far past any window's.
WARMUP_BASE = 1 << 40


class Cell:
    """One entry of ``workloads`` with its configuration and traffic."""

    def __init__(self, entry: dict, config: dict, traffic: dict):
        self.name = entry["name"]
        self.chips = int(entry["chips"])
        self.entry = entry
        self.config = config
        self.traffic = traffic


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def _entry(items: list, name: str, what: str) -> dict:
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json; have "
                   f"{sorted(i['name'] for i in items)}")


def load_cell(bench: dict, name: str, base: Path = HERE) -> Cell:
    """The cell ``name`` with its configuration file and traffic file."""
    entry = _entry(bench["workloads"], name, "workload")
    cfg_entry = _entry(bench["configs"], entry["config"], "configuration")
    config = load_json(Path(base).parent / cfg_entry["file"])
    traffic = load_json(Path(base) / "traffic" / f"{entry['traffic']}.json")
    return Cell(entry, config, traffic)


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: the end-to-end ones untraced,
    the per-layer ones traced, each where its ``workloads`` (if any) name
    the cell."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def _load_file(path: Path, what: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + "".join(c if c.isalnum() else "_"
                               for c in f"{path.parent.name}_{path.stem}"),
        path)
    if spec is None or spec.loader is None or not path.is_file():
        raise FileNotFoundError(f"no {what} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str, base: Path = HERE) -> ModuleType:
    """The reader ``metrics/<name>.py``, loaded from its path (a name may
    hold dots)."""
    return _load_file(Path(base) / "metrics" / f"{name}.py",
                      f"reader for metric {name!r}")


def load_entry(name: str, base: Path = HERE) -> ModuleType:
    """The entry point ``entries/<name>.py``: its ``System``, ``ID_RANGE``
    and ``STAGE_RANGES``."""
    return _load_file(Path(base) / "entries" / f"{name}.py",
                      f"entry {name!r}")


def load_limits(dtype: str, base: Path = HERE) -> dict:
    return load_json(Path(base) / "limits" / f"{dtype}.json")


def dtype_of(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def id_seed(seed: int, i: int) -> int:
    """The sketch seed of ID ``i``: ``splitmix64(seed, i)`` kept to 62
    bits."""
    return splitmix64(seed, i) >> 2


def make_factors(seed: int, config: dict, device):
    """``B0`` (m x k) and ``P0`` (k x n) in the configuration's dtype."""
    dtype = dtype_of(config["dtype"])
    m, n, k = config["m"], config["n"], config["k"]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & _MASK64)

    def randn(shape):
        if dtype.is_complex:
            rdt = dtype.to_real()
            re = torch.randn(shape, generator=g, dtype=rdt, device=device)
            im = torch.randn(shape, generator=g, dtype=rdt, device=device)
            return torch.complex(re, im)
        return torch.randn(shape, generator=g, dtype=dtype, device=device)

    return randn((m, k)), randn((k, n))


def make_matrix(seed: int, config: dict, device) -> torch.Tensor:
    """``A = B0 P0`` (m x n, rank k) in the configuration's dtype."""
    B0, P0 = make_factors(seed, config, device)
    return B0 @ P0
