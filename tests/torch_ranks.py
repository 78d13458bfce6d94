"""Rank processes for the port's ``torch.distributed`` tests: one Python
subprocess per rank, each waited on with its own timeout, so that no test
process ever joins a process group and no hung collective can hang the
suite."""
import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


def run_ranks(program: str, world: int, *args: str, timeout: int,
              **env: str) -> list:
    """Run ``program`` (source text) in ``world`` interpreters at once, with
    argv ``rank world *args`` and ``env`` added to the environment.  Returns
    ``(returncode, stdout, stderr)`` per rank; a rank still running after
    ``timeout`` seconds is killed with every other rank, and its return
    code is ``None``."""
    full_env = dict(os.environ, **env)
    full_env["PYTHONPATH"] = (str(SRC) + os.pathsep
                              + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", program, str(rank),
                               str(world), *args], env=full_env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for rank in range(world)]
    results = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=timeout)
            results.append((p.returncode, out, err))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, err = p.communicate()
            results.append((None, out, err + f"\ntimed out after {timeout} s"))
    return results


def failures(results: list) -> str:
    """The stderr tails of the ranks that failed or timed out, or ''."""
    return "\n".join(f"rank {rank}: exit {rc}\n{err[-3000:]}"
                     for rank, (rc, _, err) in enumerate(results) if rc != 0)
