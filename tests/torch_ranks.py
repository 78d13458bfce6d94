"""Helpers of the port's tests.

Rank processes for the ``torch.distributed`` tests: one Python subprocess
per rank, each waited on with its own timeout, so that no test process
ever joins a process group and no hung collective can hang the suite.

``pin_threads``: the test process's torch thread pools, capped once."""
import os
import subprocess
import sys
from pathlib import Path

import torch

SRC = Path(__file__).resolve().parents[1] / "src"

_PINNED: list = []


def pin_threads(n: int = 1) -> None:
    """Cap this process's torch intra-op and inter-op thread pools at
    ``n``.  Every ``tests/test_torch_*.py`` calls it when imported: the
    suite runs in several worker processes on one host, and torch's
    default pools, each the size of the host, oversubscribe its cores many
    times over.  The first call sets the pools; a later call with the same
    ``n`` does nothing (the inter-op pool can be set once a process), one
    with another ``n`` raises."""
    if _PINNED:
        if _PINNED[0] != n:
            raise ValueError(f"torch threads already pinned to {_PINNED[0]}; "
                             f"got n={n}")
        return
    torch.set_num_threads(n)
    try:
        torch.set_num_interop_threads(n)
    except RuntimeError:
        # The inter-op pool already started (work ran in this process
        # before the first test module was imported): it keeps its size.
        pass
    _PINNED.append(n)


def run_ranks(program: str, world: int, *args: str, timeout: int,
              **env: str) -> list:
    """Run ``program`` (source text) in ``world`` interpreters at once, with
    argv ``rank world *args`` and ``env`` added to the environment.  Returns
    ``(returncode, stdout, stderr)`` per rank; a rank still running after
    ``timeout`` seconds is killed with every other rank, and its return
    code is ``None``."""
    return start_ranks(program, world, *args, timeout=timeout, **env)()


def start_ranks(program: str, world: int, *args: str, timeout: int,
                **env: str):
    """``run_ranks`` without waiting: starts the ranks and returns a
    function that waits for them and gives ``run_ranks``' result (the
    caller can work meanwhile; ``timeout`` counts from the wait)."""
    full_env = dict(os.environ, **env)
    full_env["PYTHONPATH"] = (str(SRC) + os.pathsep
                              + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", program, str(rank),
                               str(world), *args], env=full_env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for rank in range(world)]

    def wait() -> list:
        results = []
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
                results.append((p.returncode, out, err))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                out, err = p.communicate()
                results.append((None, out,
                                err + f"\ntimed out after {timeout} s"))
        return results
    return wait


def failures(results: list) -> str:
    """The stderr tails of the ranks that failed or timed out, or ''."""
    return "\n".join(f"rank {rank}: exit {rc}\n{err[-3000:]}"
                     for rank, (rc, _, err) in enumerate(results) if rc != 0)
