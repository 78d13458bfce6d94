"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``.  The last line
of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, with ``--trace 1`` a ``breakdown``,
and last ``check``: each number compared with its limit.  The same numbers
end standard error.  ``--control 1`` puts the plain reference, computed in
the next lower precision, in the program's place for the checked IDs (no
window; its result must come out not correct).

The run exits with a code other than 0, and prints no result, where there
is no CUDA device or fewer than the cell asks for, where the program is not
in the checkout, and where a JAX module is loaded once the window closes.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Forbidden top-level module names in the process that prints the result:
# JAX, its libraries, and the JAX package this port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({name for name in names
                   if name.split(".", 1)[0] in FORBIDDEN})


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None


def result_line(run, bench, cell, trace: bool, device: dict) -> dict:
    from perfbench.workload import load_metric, metrics_for
    metrics = {}
    for entry in metrics_for(bench, cell.name, trace):
        value = load_metric(entry["name"]).read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    line = {"correct": run.correct, "attempted": run.attempted,
            "failed": run.failed, "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        line["breakdown"] = {"device_ops": run.trace.device_ops,
                             "idle_gaps": run.trace.idle_gaps}
    line["check"] = run.check
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from perfbench.harness import run_cell
    from perfbench.workload import load_benchmark, load_cell

    bench = load_benchmark()
    cell = load_cell(bench, args.workload)
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"perfbench: the cell needs {cell.chips} devices, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("perfbench: the program (src/repro_torch) is not in the "
              "checkout", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    run = run_cell(cell.config, cell.traffic, seed=args.seed,
                   seconds=args.seconds, trace=bool(args.trace), device=dev,
                   t_start=T_START, control=bool(args.control),
                   chips=cell.chips)
    found = forbidden_modules()
    if found:
        print(f"perfbench: JAX modules loaded in the measuring process: "
              f"{found}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell.chips, "memory_peak_bytes": run.peak_bytes,
              "power_limit": power_limit()}
    if args.trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
    line = result_line(run, bench, cell, bool(args.trace), device)
    if args.control:
        from perfbench.workload import load_limits
        line = {"control": load_limits(cell.config["dtype"])["control_dtype"],
                **line}
    for err in run.errors:
        print(f"failed {err}", file=sys.stderr)
    if run.trace is not None:
        t = run.trace
        print(f"trace ids {t.ids} window_s {t.window_s!r} busy_s "
              f"{t.busy_s!r} ranges {t.ranges}", file=sys.stderr)
    for name, c in run.check.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {run.correct}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
