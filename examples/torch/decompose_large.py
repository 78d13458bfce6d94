"""Distributed and STREAMED RID on the port: the paper's parallel
experiment over ``torch.distributed`` ranks, then a decomposition whose
input never fits on a device at all.

Part 1 shards A by columns over the ranks (the XMT's "each processor owns
columns": gloo ranks on the CPU, one rank a card over NCCL), sketches
with no communication, factors the sketch with the panel-parallel QRCP
(``qr_impl="panel_parallel"``: each rank keeps only its l x n/ndev shard,
no replicated l x n sketch), solves R1 T = R2 column-parallel, and
checks the error against the paper's eq. (3).

Part 2 (rank 0) grows m 16x past part 1: a ~0.4 GB f64 matrix that is
never materialized: a seeded known-spectrum generator
(``repro_torch.stream.SpectrumSource``) feeds 2048-row chunks to
``rid_streamed``, whose device residency is O(l n + chunk) whatever m.
It runs under ``repro_torch.obs.tracing``, exporting a Chrome trace
(``TRACE_OUT``, default ``decompose_large_trace.json`` in the temporary
directory) with the per-chunk spans; open it at https://ui.perfetto.dev.

  PYTHONPATH=src python examples/torch/decompose_large.py [--device cpu]
"""
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ranks import add_rank_args, launch
from repro_torch.core import (error_bound, expected_sigma_kp1,
                              rid_distributed, shard_columns,
                              spectral_norm_dense)
from repro_torch.obs import tracing
from repro_torch.stream import (SpectrumSource, chunk_bounds, num_chunks,
                                rid_streamed)


def body(args, group, dev):
    ndev, rank = dist.get_world_size(group), dist.get_rank(group)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"group: {ndev} ranks ({dist.get_backend(group)}), column-parallel")

    m, n, k = 4096, 2048, 100          # paper row k=100 at 1/8 linear scale
    g = torch.Generator(device=dev).manual_seed(1)
    A = (torch.randn((m, k), generator=g, dtype=torch.float64, device=dev)
         @ torch.randn((k, n), generator=g, dtype=torch.float64, device=dev))
    A_loc = shard_columns(A, group)
    say(f"A: {m}x{n} f64 rank {k}, column-sharded {n // ndev} cols/rank")
    # panel=16 keeps the panel-greedy pivot quality within the eq. (3)
    # bound at k=100 (tests/test_torch_qr_dist.py)
    dec = rid_distributed(2, A_loc, k, group=group, sketch_kind="gaussian",
                          qr_impl="panel_parallel", qr_panel=16)
    parts = [torch.empty_like(dec.P) for _ in range(ndev)]
    dist.all_gather(parts, dec.P.contiguous(), group=group)
    err = float(spectral_norm_dense(A - dec.B @ torch.cat(parts, 1)))
    bound = error_bound(m, n, k) * expected_sigma_kp1(m, n)
    say(f"||A - BP||_2 = {err:.2e}   eq.(3) bound = {bound:.2e}   "
        f"ok = {err <= bound}")
    say(f"P stays column-sharded: {tuple(dec.P.shape)} a rank; R too "
        f"(panel-parallel QR): {tuple(dec.R.shape)}")
    if rank != 0:
        return

    # ---- part 2: streamed, beyond a single buffer -----------------------
    ms, ns, ks, chunk = 65536, 768, 48, 2048
    src = SpectrumSource(7, ms, ns, "fast_decay", ks, chunk_rows=chunk,
                         dtype=torch.float64, floor=1e-10, device=dev)
    print(f"\nstreamed: {ms}x{ns} f64 (~{ms * ns * 8 / 1e9:.2f} GB input, "
          f"generated {chunk}-row chunks; resident sketch only "
          f"{2 * ks}x{ns})")
    trace_out = os.environ.get("TRACE_OUT", os.path.join(
        tempfile.gettempdir(), "decompose_large_trace.json"))
    with tracing(chrome=trace_out) as tr:
        sdec = rid_streamed(8, src, ks, device=dev)
    n_h2d = sum(s.name == "stream.h2d" for s in tr.spans)
    print(f"trace: {len(tr.spans)} spans ({n_h2d} H2D chunks) -> "
          f"{trace_out} (open in ui.perfetto.dev)")

    # Validation only, host side and chunk-streamed like the decomposition:
    # power iteration on E^T E with E = A - B P, each product re-reading
    # the source one chunk at a time.
    Bh, Ph = np.asarray(sdec.B.cpu()), np.asarray(sdec.P.cpu())
    rng = np.random.default_rng(0)
    v = rng.standard_normal(ns)
    v /= np.linalg.norm(v)
    for _ in range(20):
        u = np.empty(ms)
        w = np.zeros(ns)
        pv = Ph @ v
        for c in range(num_chunks(src)):
            r0, r1 = chunk_bounds(src, c)
            ch = src.chunk(c).cpu().numpy()
            u[r0:r1] = ch @ v - Bh[r0:r1] @ pv            # (E v) rows
            w += ch.T @ u[r0:r1]                          # A^T u
        w -= Ph.T @ (Bh.T @ u)                            # E^T u
        v = w / max(np.linalg.norm(w), 1e-300)
    err_s = float(np.linalg.norm(u))
    bound_s = error_bound(ms, ns, ks) * float(src.sigmas[ks])
    print(f"||A - BP||_2 ~= {err_s:.2e}   eq.(3) bound = {bound_s:.2e}   "
          f"ok = {err_s <= bound_s}")


def main(argv=None):
    import argparse
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_rank_args(ap, cpu_ranks=8)
    args = ap.parse_args(argv)
    return launch(os.path.abspath(__file__), argv, args, body)


if __name__ == "__main__":
    main()
