"""Rank processes for the examples that run over ``torch.distributed``:
gloo ranks on the CPU, or one rank a card over NCCL (the JAX examples
force host devices instead).

``launch(script, args, body)``: with ``args.rank`` unset, start
``args.ranks`` copies of ``script`` (the same argv plus ``--rank r``),
wait for them, print rank 0's output, and exit with the first failure's
code; with one rank, run ``body`` in this process.  In a rank, join the
group (a file store in a temporary directory), run ``body(args, group,
device)`` and leave the group.
"""
import argparse
import os
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist


def add_rank_args(ap: argparse.ArgumentParser, cpu_ranks: int) -> None:
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--ranks", type=int, default=None,
                    help=f"rank processes (default {cpu_ranks} gloo ranks "
                         f"on the CPU, one a card on cuda)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.set_defaults(cpu_ranks=cpu_ranks)


def _world(args) -> int:
    if args.ranks is not None:
        return args.ranks
    if args.device == "cpu":
        return args.cpu_ranks
    if not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a card; pass --device cpu")
    return torch.cuda.device_count()


def _in_rank(args, body, rank: int, world: int, store: str):
    device = torch.device("cuda", rank) if args.device == "cuda" else \
        torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        return body(args, dist.group.WORLD, device)
    finally:
        dist.destroy_process_group()


def launch(script: str, argv, args, body):
    world = _world(args)
    if args.rank is not None:
        return _in_rank(args, body, args.rank, world, args.store)
    if world == 1:
        with tempfile.TemporaryDirectory() as tmp:
            return _in_rank(args, body, 0, 1, os.path.join(tmp, "store"))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, script, *argv, "--ranks", str(world),
             "--rank", str(r), "--store", store], env=env,
            stdout=None if r == 0 else subprocess.DEVNULL)
            for r in range(world)]
        try:
            codes = [p.wait() for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    bad = [c for c in codes if c]
    if bad:
        sys.exit(bad[0])
    return None
