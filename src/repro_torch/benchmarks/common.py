"""Shared benchmark utilities (counterpart of the JAX harness's
``benchmarks/common.py``): timing around synchronized calls, CSV emission
and the JSON record."""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable

import torch

__all__ = ["WARMUP", "ITERS", "time_fn", "emit", "append_json_rows",
           "cli_parser", "finish", "randn", "RECORD", "REFERENCE_RECORD",
           "check_record"]

# The port's bench record (``benchmarks.run``'s default, gitignored), and
# the JAX harness's, which the port never writes or deletes.
RECORD = "BENCH_torch.json"
REFERENCE_RECORD = "BENCH_scaling.json"

# Calls of ``fn`` per ``time_fn``: warm-up calls, then timed calls.
WARMUP, ITERS = 2, 5


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn: Callable, warmup: int = WARMUP, iters: int = ITERS) -> float:
    """Median host seconds of ``fn()`` over ``iters`` calls after
    ``warmup`` calls, with the device synchronized before and after each
    (PyTorch returns before the card finishes)."""
    for _ in range(warmup):
        fn()
    _sync()
    ts = []
    for _ in range(iters):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def check_record(path: str) -> str:
    """``path``, unless it names the JAX harness's record."""
    if os.path.basename(os.path.normpath(path)) == REFERENCE_RECORD:
        raise ValueError(f"{path}: {REFERENCE_RECORD} is the JAX harness's "
                         f"record; the port writes its own ({RECORD})")
    return path


def append_json_rows(path: str, rows: list[dict]) -> None:
    """Append ``rows`` to the JSON list at ``path`` (created if absent;
    never the JAX harness's record)."""
    check_record(path)
    existing = []
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
    with open(path, "w") as f:
        json.dump(existing + rows, f, indent=1)


def emit(rows: list[dict], header: str = "") -> None:
    """Print rows as aligned CSV (the bench harness contract)."""
    if not rows:
        return
    cols = list(rows[0].keys())
    if header:
        print(f"# {header}")
    print(",".join(cols))
    for r in rows:
        print(",".join(_fmt(r[c]) for c in cols))


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def cli_parser(description: str) -> argparse.ArgumentParser:
    """The bench CLIs' common arguments: ``--full`` (the paper's grid in
    double precision), ``--device`` (default ``cuda``) and ``--json PATH``
    (append the rows to a JSON list there)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--full", action="store_true",
                    help="the paper's grid (PAPER_GRID) in f64/c128; "
                         "default SMALL_GRID in f32/c64")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", default=None,
                    help="append the rows to the JSON list at this path")
    return ap


def finish(rows: list[dict], header: str, json_path: str | None) -> None:
    """Print the rows and append them to ``json_path`` if given."""
    emit(rows, header=header)
    if json_path:
        append_json_rows(json_path, rows)


def randn(gen: torch.Generator, shape, dtype: torch.dtype,
          device) -> torch.Tensor:
    """Standard normal entries from ``gen`` (real and imaginary parts each
    standard normal for a complex dtype)."""
    if dtype.is_complex:
        rdt = dtype.to_real()
        re = torch.randn(shape, generator=gen, dtype=rdt, device=device)
        im = torch.randn(shape, generator=gen, dtype=rdt, device=device)
        return torch.complex(re, im)
    return torch.randn(shape, generator=gen, dtype=dtype, device=device)
