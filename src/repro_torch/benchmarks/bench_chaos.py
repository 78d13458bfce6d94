"""The chaos lane: the streamed ID under a seeded fault plan (counterpart
of the JAX harness's ``bench_chaos``).

    REPRO_CHAOS_SEED=<n> REPRO_CHAOS_P=0.2 python -m \
        repro_torch.benchmarks.bench_chaos [--device cuda|cpu]
        [--json PATH] [--report PATH]

Two claims, both checked bit for bit on every ``IDResult`` field:

  1. retries do not corrupt: under the plan's transient read errors
     (``FaultPlan.from_env``: seed ``$REPRO_CHAOS_SEED``, probability
     ``$REPRO_CHAOS_P``, default 0.2) the run completes through a
     ``RetryPolicy`` and equals the clean run;
  2. a kill is survivable: a job killed (``ProcessKilled``) at a chunk of
     pass 1, resumed, killed again at a chunk of pass 2 and resumed again
     from its checkpoint directory reproduces the clean run
     (``killed_twice_then_resumed``).

One ``bench = "chaos"`` row (to stdout and ``--json``): the clean and
faulted walls (the ``rid_streamed`` root span), the faults that fired
(``FlakySource.injected``), the retry and failure counters, and the
verdicts; ``--report PATH`` writes the plan and the row as JSON.  Exits
non-zero (an ``AssertionError``) unless every verdict holds.
"""
from __future__ import annotations

import argparse
import json
import tempfile

import numpy as np
import torch

from ..core.rng import check_device
from ..obs import tracing
from ..runtime import FaultPlan, FlakySource, ProcessKilled, RetryPolicy
from ..stream import ArraySource, rid_streamed
from .common import append_json_rows, emit

__all__ = ["chaos_run", "fields_equal", "killed_twice_then_resumed", "main"]


def _root_dur(tracer, name: str = "rid_streamed") -> float:
    return next(s.dur for s in tracer.spans if s.name == name)


def fields_equal(a, b) -> bool:
    """Bit equality of two ``IDResult``s in all five fields."""
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in ("B", "P", "J", "Q", "R"))


def killed_twice_then_resumed(A, chunk_rows: int, k: int, dev,
                              seed: int = 0, group=None) -> tuple:
    """``(pass-1 kill fired, pass-2 kill fired, result)`` of one job killed
    twice: first at chunk 3 of pass 1; the resume then carries pass 1 from
    chunk 3 to its end and is killed at chunk 1 of pass 2 (that chunk's
    first read, since the resumed pass 1 began past it); a last resume
    gathers the rest.  Needs at least 4 chunks.  ``group`` shards the job
    (``rid_streamed(..., group=)``); every rank kills at the same reads."""
    with tempfile.TemporaryDirectory() as ckpt_dir:
        fired = []
        for kill_at in (3, 1):
            killer = FlakySource(ArraySource(A, chunk_rows),
                                 FaultPlan(seed=seed, kill_at=(kill_at,)))
            try:
                rid_streamed(1, killer, k, resume_dir=ckpt_dir, device=dev,
                             group=group)
                fired.append(False)
            except ProcessKilled:
                fired.append(True)
        out = rid_streamed(1, ArraySource(A, chunk_rows), k,
                           resume_dir=ckpt_dir, device=dev, group=group)
    return fired[0], fired[1], out


def chaos_run(*, m: int = 8192, n: int = 256, k: int = 32,
              chunk_rows: int = 512, device="cuda", json_path=None,
              report_path=None) -> dict:
    dev = check_device(device)
    A = torch.from_numpy(np.asarray(
        np.random.default_rng(3).standard_normal((m, n)), np.float32))
    src = ArraySource(A, chunk_rows)
    plan = FaultPlan.from_env()

    rid_streamed(1, src, k, device=dev)                  # warm-up
    with tracing() as tr_clean:
        ref = rid_streamed(1, src, k, device=dev)

    flaky = FlakySource(ArraySource(A, chunk_rows), plan)
    pol = RetryPolicy(max_attempts=8, base_delay_s=0.001, seed=plan.seed)
    with tracing() as tr_chaos:
        out = rid_streamed(1, flaky, k, retry=pol, device=dev)
    retry_parity = fields_equal(ref, out)

    killed1, killed2, resumed = killed_twice_then_resumed(
        A, chunk_rows, k, dev, plan.seed)
    resume_parity = fields_equal(ref, resumed)

    row = {
        "bench": "chaos", "device": str(dev), "m": m, "n": n, "k": k,
        "chunk_rows": chunk_rows, "seed": plan.seed,
        "transient_p": plan.transient_p, "injected": dict(flaky.injected),
        "retries": tr_chaos.metrics.counter("stream.retry").value,
        "chunk_failures":
            tr_chaos.metrics.counter("stream.chunk_failures").value,
        "wall_clean_s": _root_dur(tr_clean),
        "wall_chaos_s": _root_dur(tr_chaos),
        "kill_pass1_fired": killed1, "kill_pass2_fired": killed2,
        "retry_parity_bit_exact": retry_parity,
        "resume_parity_bit_exact": resume_parity,
    }
    emit([{kk: v for kk, v in row.items() if kk != "injected"}],
         header=f"chaos lane: seed={plan.seed} p={plan.transient_p} "
                f"injected={row['injected']}")
    if json_path:
        append_json_rows(json_path, [row])
    if report_path:
        with open(report_path, "w") as f:
            json.dump({"plan": {"seed": plan.seed,
                                "transient_p": plan.transient_p},
                       "result": row}, f, indent=1)
    assert row["chunk_failures"] == 0, \
        f"retry budget exhausted {row['chunk_failures']} times"
    assert killed1 and killed2, "a kill plan never fired: the harness is vacuous"
    assert retry_parity, "the faulted run diverged from the clean bits"
    assert resume_parity, "the resumed run diverged from the clean bits"
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="append the chaos row to this JSON list")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write the fault-injection report here")
    args = ap.parse_args(argv)
    chaos_run(device=args.device, json_path=args.json,
              report_path=args.report)


if __name__ == "__main__":
    main()
