"""The paper's phase benchmarks on the port (counterparts of the JAX
harness in the repository's ``benchmarks/``, which stays as it is):

  bench_total   -- Table 1: the whole ID, phase by phase
  bench_sketch  -- Table 2: the sketch by backend, the CUDA kernels beside
                   the plain sketches
  bench_qr      -- Table 3: the QR phase by engine, the CGS kernels, and
                   the fused panel step against the split loop
  bench_tsolve  -- Table 4: the factorization of R (triangular solve)
  bench_error   -- Table 5: ||A - BP||_2 against the eq. (3) bound, and
                   the known-spectrum verification grid (--grid)

and the streamed ID's three (``stream_sweep``, ``chaos_run``,
``overlap_gate``; each with ``--device cuda|cpu`` and ``--json``):

  bench_stream  -- peak device memory against m, the copies' overlap
  bench_chaos   -- bit parity under seeded read faults and kill/resume
  bench_overlap -- the share of host -> device traffic the pipeline hides

Each has ``run(grid, ..., device)`` returning one row per grid case and a
CLI, ``python -m repro_torch.benchmarks.bench_<x> [--full] [--device
cuda|cpu]``: ``SMALL_GRID`` in f32/c64 by default, the paper's
``PAPER_GRID`` in f64/c128 with ``--full`` (Table 5 in c128 always).
Times are host seconds around synchronized calls.
"""
