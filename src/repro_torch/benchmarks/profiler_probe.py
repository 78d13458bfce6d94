"""Does a short ``torch.profiler`` session lose device events once the
process has traced a training step?  (The question behind the warmup cycle
of ``chip_smoke.py``'s ``readings``.)

Counts the device events of sessions of 30 ``tsolve`` calls (one kernel a
call; k = 400, n = 2^14, f64): a plain session and one with a warmup cycle
(``schedule(wait=0, warmup=1, active=1)``, ten calls in the warmup), first
on a fresh process, then after a plain session of 12,000 small kernels
launched from the main thread, then after a profiled granite-3-2b training
step at full width (``--layers`` deep, 2 x 4096 tokens).  Prints one JSON
line a session.  Needs a card:

    PYTHONPATH=src python -m repro_torch.benchmarks.profiler_probe
"""
from __future__ import annotations

import argparse
import json
import os

import torch

CALLS = 30


def _count(prof) -> int:
    """Kernels recorded on the device (a cycle's ProfilerStep range also
    shows as a device span, and is left out)."""
    from torch.autograd import DeviceType
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("ProfilerStep"))


def _plain(fn, calls: int = CALLS) -> int:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return _count(prof)


def _warm(fn, calls: int = CALLS) -> int:
    from torch.profiler import ProfilerActivity, profile, schedule
    got = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: got.append(_count(p))) as prof:
        for n in (10, calls):
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return got[0]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=40)
    args = ap.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from ..configs import get_config
    from ..data import SyntheticConfig, batch_for_step
    from ..kernels.tsolve import tsolve
    from ..launch.steps import TrainConfig, make_train_step
    from ..launch.train import train_loop
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    k, n, f64 = 400, 1 << 14, torch.float64
    R1 = torch.triu(torch.randn((k, k), generator=gen, device=dev,
                                dtype=f64)) + 40 * torch.eye(k, device=dev,
                                                             dtype=f64)
    R = torch.randn((k, n), generator=gen, device=dev, dtype=f64)

    def fn():
        tsolve(R1, R)

    fn()
    rows = []

    def sessions(after: str, **extra):
        for mode, run in (("plain", _plain), ("warmup", _warm)):
            rows.append(dict(after=after, mode=mode, calls=CALLS,
                             device_events=run(fn), **extra))
            print(json.dumps(rows[-1]), flush=True)

    sessions("nothing")
    x = torch.zeros(1024, device=dev)
    sessions("main_thread_trace",
             traced_events=_plain(lambda: x.add_(1.0), 12000))
    cfg = get_config("granite-3-2b").replace(n_layers=args.layers)
    tcfg = TrainConfig(peak_lr=3e-4, warmup_steps=1, total_steps=2)
    state = train_loop(cfg, tcfg, global_batch=2, seq_len=4096, steps=1,
                       log=lambda *a: None, device=dev)["state"]
    step = make_train_step(cfg, tcfg)
    batch = batch_for_step(SyntheticConfig(vocab_size=cfg.vocab_size,
                                           seq_len=4096, global_batch=2,
                                           seed=0), 1, device=dev)
    holder = [state]

    def train_step():
        holder[0], _ = step(holder[0], batch)

    traced = _plain(train_step, 1)
    del holder, state, batch
    torch.cuda.empty_cache()
    sessions("train_step_trace", traced_events=traced, layers=args.layers)
    sessions("train_step_trace_again")
    return rows


if __name__ == "__main__":
    main()
