"""The paper's phase benchmarks on the port (counterparts of the JAX
harness in the repository's ``benchmarks/``, which stays as it is):

  bench_total   -- Table 1: the whole ID, phase by phase
  bench_sketch  -- Table 2: the sketch by backend, the CUDA kernels beside
                   the plain sketches
  bench_tsolve  -- Table 4: the factorization of R (triangular solve)

Each has ``run(grid, ..., device)`` returning one row per grid case and a
CLI, ``python -m repro_torch.benchmarks.bench_<x> [--full] [--device
cuda|cpu]``: ``SMALL_GRID`` in f32/c64 by default, the paper's
``PAPER_GRID`` in f64/c128 with ``--full``.  Times are host seconds around
synchronized calls.
"""
