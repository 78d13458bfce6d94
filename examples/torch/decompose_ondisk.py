"""Sharded, file-backed, fault-tolerant RID on the port: the 64 GB path
end to end.

The matrix lives in a multi-GB ``.npy`` ON DISK and is never resident
anywhere: ``FileSource`` memory-maps it and read-ahead feeds 4096-row
chunks, ``rid_streamed(group=...)`` streams ``m`` from disk while
column-sharding ``n`` over the ranks of a process group (a one-rank group
here: gloo on the CPU, NCCL on a card), and a checkpoint directory makes
the whole run killable.

The script demonstrates, in order:

  1. flat residency: the same pipeline over a 1/8-size file and the full
     (>= 1 GB) file, with ``MeteredSource`` sampling live device bytes at
     every chunk: the peak is flat in ``m`` while the input grows 8x (a
     card's memory; on the CPU there is no device residency to meter).
     The big run is watched live: a ``ProgressReporter`` publishes atomic
     status JSON a chunk, a ``TelemetryServer`` serves ``/metrics`` while
     the run is in flight (scraped mid-run), and the JSONL trace is
     analyzed afterwards by ``obs.Timeline``;
  2. kill + resume: a seeded ``FlakySource`` kills the small run in pass
     1; resuming against the same file (same ``(path, size, mtime_ns)``
     fingerprint) replays the remaining chunks onto the checkpointed
     accumulator, bit-identical to the uninterrupted run;
  3. fingerprint rejection: after the file is touched, the same
     checkpoint directory refuses to resume ("written by a different
     job"): a changed matrix never mixes into an old decomposition.

Size defaults to ~1 GB on disk; ``ONDISK_GB=4`` etc. changes it.

  PYTHONPATH=src python examples/torch/decompose_ondisk.py [--device cpu]
"""
import argparse
import json
import os
import sys
import tempfile
import urllib.request

import numpy as np
import torch

from ranks import add_rank_args, launch
from repro_torch.core import error_bound
from repro_torch.obs import (MeteredSource, ProgressReporter,
                             TelemetryServer, Timeline, tracing)
from repro_torch.runtime import FaultPlan, FlakySource, ProcessKilled
from repro_torch.stream import FileSource, rid_streamed

GB = float(os.environ.get("ONDISK_GB", "1.0"))
N, K, CHUNK = 2048, 48, 4096
M = max(1, round(GB * 1e9 / (N * 4 * CHUNK))) * CHUNK   # chunk-aligned


def write_lowrank_npy(path, m):
    """Write an approximately rank-K matrix to disk chunk by chunk: the
    writer never holds more than one chunk either."""
    g = torch.Generator().manual_seed(11)
    W = torch.randn((K, N), generator=g)
    out = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                    shape=(m, N))
    for r0 in range(0, m, CHUNK):
        r1 = min(r0 + CHUNK, m)
        a = torch.randn((r1 - r0, K), generator=g) @ W
        a += 1e-4 * torch.randn((r1 - r0, N), generator=g)
        out[r0:r1] = a.numpy()
    out.flush()
    del out
    return path


def body(args, group, dev):
    workdir = tempfile.mkdtemp(prefix="repro_torch_ondisk_")

    def run(path, *, resume_dir=None, wrap=None, progress=None):
        with FileSource(path, CHUNK) as fsrc:
            src = MeteredSource(wrap(fsrc) if wrap else fsrc)
            dec = rid_streamed(8, src, K, group=group, device=dev,
                               resume_dir=resume_dir, progress=progress)
            return dec, src.peak_bytes

    print(f"{dev}: target {GB:.1f} GB on disk -> A is {M}x{N} f32 in "
          f"{workdir}")
    small = write_lowrank_npy(os.path.join(workdir, "small.npy"), M // 8)
    big = write_lowrank_npy(os.path.join(workdir, "big.npy"), M)
    small_gb = os.path.getsize(small) / 1e9
    big_gb = os.path.getsize(big) / 1e9

    # ---- 1. flat residency: 8x the file, the same device working set ---
    dec_small, peak_small = run(small)
    status_path = os.path.join(workdir, "progress.json")
    trace_path = os.path.join(workdir, "trace.jsonl")
    scrapes, dones = [], []

    def watch(status):
        dones.append(status["done"])
        if len(dones) == 3:            # a few chunks in: the run is live
            with urllib.request.urlopen(server.url + "/metrics") as r:
                scrapes.append((r.status, r.read().decode()))
            with open(status_path) as f:      # atomic publish: never torn
                assert json.load(f)["state"] == "running"

    reporter = ProgressReporter(status_path, callbacks=[watch])
    with tracing(jsonl=trace_path) as tr, \
            TelemetryServer(registry=tr.metrics, progress=reporter) as server:
        print(f"\nwatch the big run: curl {server.url}/metrics  "
              f"(or /progress, or cat {status_path})")
        dec_big, peak_big = run(big, progress=reporter)
    code, body_text = scrapes[0]
    assert code == 200 and "repro_stream_chunks_total" in body_text, \
        body_text[:200]
    with open(status_path) as f:
        final = json.load(f)
    assert final["state"] == "done" and final["done"] == final["total"]
    assert len(set(dones)) > M // 8 // CHUNK    # status advanced a chunk
    print(f"live /metrics scrape mid-run: HTTP {code}, "
          f"{len(body_text.splitlines())} metric lines; final status: "
          f"{final['done']}/{final['total']} {final['state']}, "
          f"{final['checkpoints']} checkpoints")

    tl = Timeline.from_jsonl(trace_path)
    thr = tl.throughput()
    top = [f"{name} {sec:.2f}s" for name, sec in tl.critical_path()[:3]]
    print(f"timeline: wall {tl.wall():.2f}s; critical path: "
          f"{', '.join(top)}; throughput {thr['rows_per_s']:.0f} rows/s, "
          f"{thr['bytes_per_s'] / 1e6:.0f} MB/s h2d, psum overlap: "
          f"{tl.psum_overlap()}")
    if dev.type == "cuda":
        print(f"\nresidency: {small_gb:.2f} GB file -> peak "
              f"{peak_small / 1e6:.1f} MB on the card; {big_gb:.2f} GB file "
              f"-> peak {peak_big / 1e6:.1f} MB")
        assert peak_big < 1.5 * peak_small, (peak_big, peak_small)
        print(f"flat in m: 8x the input, {peak_big / peak_small:.2f}x the "
              f"peak")
    else:
        print(f"\nresidency: {small_gb:.2f} GB and {big_gb:.2f} GB files "
              f"streamed; on the CPU there is no device memory to meter")

    # ---- 2. kill in pass 1, resume under the matching fingerprint -------
    ckpt = os.path.join(workdir, "ckpt")
    try:
        run(small, resume_dir=ckpt,
            wrap=lambda s: FlakySource(s, FaultPlan(kill_at=(4,))))
    except ProcessKilled as e:
        print(f"\ninjected kill in pass 1: {e}")
    dec_resumed, _ = run(small, resume_dir=ckpt)
    same = all(torch.equal(getattr(dec_resumed, f), getattr(dec_small, f))
               for f in ("B", "P", "J", "Q", "R"))
    print(f"resumed from {ckpt}: bit-identical to the uninterrupted run "
          f"-> {same}")
    assert same

    # ---- 3. a changed file is a different job ---------------------------
    os.utime(small, ns=(1, 1))
    try:
        run(small, resume_dir=ckpt)
        raise SystemExit("resume against a touched file must be rejected")
    except ValueError as e:
        print(f"\nfile touched -> resume rejected: "
              f"{str(e).splitlines()[0][:76]}")

    # ---- the decomposition itself: residual, streamed from disk --------
    # Power iteration on E = A - B P, one mmap pass an iteration; the
    # exact sigma_{K+1} of the generated matrix is ~1e-4 sqrt(M).
    Bh, Ph = dec_big.B.cpu().numpy(), dec_big.P.cpu().numpy()
    mm = np.load(big, mmap_mode="r")
    v = torch.randn(N, generator=torch.Generator().manual_seed(0)).numpy()
    v /= np.linalg.norm(v)
    for _ in range(4):
        u = np.empty(M, np.float32)
        w = np.zeros(N, np.float32)
        pv = Ph @ v
        for r0 in range(0, M, CHUNK):
            r1 = min(r0 + CHUNK, M)
            ch = np.array(mm[r0:r1])
            u[r0:r1] = ch @ v - Bh[r0:r1] @ pv
            w += ch.T @ u[r0:r1]
        w -= Ph.T @ (Bh.T @ u)
        v = w / max(np.linalg.norm(w), 1e-30)
    err = float(np.linalg.norm(u))
    # sigma_{K+1}(A) is the noise spectrum's edge: 1e-4 (sqrt(M) + sqrt(N))
    bound = error_bound(M, N, K) * 1e-4 * (np.sqrt(M) + np.sqrt(N))
    print(f"\n||A - BP||_2 ~= {err:.3e} on the {big_gb:.2f} GB matrix   "
          f"eq.(3) bound = {bound:.3e}   ok = {err <= bound}")
    assert err <= bound
    print(f"done; files in {workdir}")


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_rank_args(ap, cpu_ranks=1)
    args = ap.parse_args(argv)
    return launch(os.path.abspath(__file__), argv, args, body)


if __name__ == "__main__":
    main()
