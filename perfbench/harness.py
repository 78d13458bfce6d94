"""One run of one cell: set-up, the measured window, the check, the result.

``run_cell`` does everything but the look for a chip, so that the CPU
tests drive it at a tiny size.  The traffic file names the entry
(``entries/<entry>.py``), whose ``System`` makes the cell's input from the
seed and runs one request a call.  The loop is closed with one caller:
request ``i + 1`` is issued once request ``i`` has returned and the device
has finished it.  Its seed is ``id_seed(seed, i)``.

After the window, a sample of the window's answers drawn from the seed
(reservoir sampling, ``CHECK_IDS`` of them) goes to the entry's check,
number by number, each against its limit (``limits/<dtype>.json``).  The
program's other state is freed first, and the peak memory read before, so
the reference neither sets nor hides it.
"""
from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

import torch

from .trace import Summary, summarize
from .workload import (HERE, WARMUP_BASE, id_seed, load_entry, load_json,
                       load_limits)

__all__ = ["Run", "run_cell", "WARMUP_IDS", "CHECK_IDS"]

# Requests run before the window (the first one sizes the answer slots),
# and answers of the window held to the reference after it.
WARMUP_IDS = 2
CHECK_IDS = 3


@dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``)."""

    config: dict
    traffic: dict
    setup_s: float = 0.0
    window_s: float = 0.0
    walls: list = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    peak_bytes: int = 0
    trace: Summary | None = None
    peaks: dict = field(default_factory=dict)
    check: dict = field(default_factory=dict)
    correct: bool = False
    errors: list = field(default_factory=list)   # the first failures' text


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _copy_into(slot, out):
    """Copy one answer into its slot, holding no reference to it."""
    for dst, src in zip(slot, out):
        dst.copy_(src)


def _peak_bytes(device, chips: int) -> int:
    """The allocator's peak on the fullest of the cell's cards."""
    if device.type != "cuda":
        return 0
    return max(torch.cuda.max_memory_allocated(d) for d in range(chips))


def run_cell(config: dict, traffic: dict, *, seed: int, seconds: float,
             trace: bool, device, t_start: float, control: bool = False,
             chips: int = 1, system_cls=None) -> Run:
    """Set up, measure for ``seconds``, check.  ``system_cls`` stands in
    for the entry's ``System`` (the tests break the timed path so)."""
    if traffic["loop"] != "closed" or traffic["callers"] != 1:
        raise ValueError("the generator drives a closed loop with one "
                         f"caller, not {traffic['loop']!r} with "
                         f"{traffic['callers']}")
    device = torch.device(device)
    entry = load_entry(traffic["entry"])
    if system_cls is None:
        system_cls = entry.System
    run = Run(config=config, traffic=traffic,
              peaks=load_json(HERE / "peaks.json"))
    limits = load_limits(config["dtype"])
    system = system_cls(config, traffic, seed, device)
    call = system.call_staged if trace else system.call
    # The checked answers are copied into slots made before the program's
    # own buffers: answers held in the program's freed segments would split
    # them, and the next request would not fit where it did.
    first = call(id_seed(seed, WARMUP_BASE))
    like = [(t.shape, t.dtype) for t in first]
    make = type(first)
    del first
    if device.type == "cuda":
        torch.cuda.empty_cache()
    slots = [make(*[torch.empty(sh, dtype=dt, device=device)
                    for sh, dt in like]) for _ in range(CHECK_IDS)]
    for j in range(1, WARMUP_IDS):
        call(id_seed(seed, WARMUP_BASE + j))
    _sync(device)
    run.setup_s = time.perf_counter() - t_start
    if control:
        sample = [(id_seed(seed, i), None) for i in range(CHECK_IDS)]
        run.check, run.correct = system.check(sample, limits, control=True)
        return run

    rng = random.Random(seed ^ 0xC0FFEE)
    keep = {}       # slot number -> (index, seed)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        n_traced = traffic["trace_ids"]
    if device.type == "cuda":
        for d in range(chips):
            torch.cuda.reset_peak_memory_stats(d)
    t0 = time.perf_counter()
    t_end = t0
    i = 0
    if prof is not None:
        prof.__enter__()
    try:
        while True:
            s = id_seed(seed, i)
            t1 = time.perf_counter()
            try:
                out = call(s)
            except RuntimeError as exc:
                run.failed += 1
                if len(run.errors) < 3:
                    run.errors.append(f"ID {i}: {exc!r}"[:2000])
                out = None
            t_end = time.perf_counter()
            run.attempted += 1
            run.walls.append(t_end - t1)
            if out is not None:
                j = len(keep) if len(keep) < CHECK_IDS else rng.randrange(
                    i + 1)
                if j < CHECK_IDS:
                    _copy_into(slots[j], out)
                    keep[j] = (i, s)
            out = None
            i += 1
            if prof is not None and i == n_traced:
                prof.__exit__(None, None, None)
                run.trace = summarize(
                    prof.profiler.kineto_results.events(), entry.ID_RANGE,
                    entry.STAGE_RANGES)
                prof = None
                t_end = time.perf_counter()
            if t_end - t0 >= seconds and prof is None:
                break
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    run.window_s = t_end - t0
    run.peak_bytes = _peak_bytes(device, chips)
    del call
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sample = [(s, slots[j]) for j, (i, s) in sorted(
        keep.items(), key=lambda kv: kv[1])]
    run.check, ok = system.check(sample, limits)
    run.correct = ok and run.failed == 0
    return run
