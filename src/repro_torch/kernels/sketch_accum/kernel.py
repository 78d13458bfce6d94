"""Wrapper of the Hopper kernel for the accumulating sketch GEMM
(``csrc/sketch_accum.cu``), which replaces the TPU kernel
``sketch_accum_kernel`` in ``repro/kernels/sketch_accum/kernel.py``.

``out = acc + x @ a`` with the reduction over ``a``'s rows in fixed
``ACCUM_BLOCK``-row blocks, in order: each CTA owns one output tile, loads
its ``acc`` tile once, and walks ``m`` block by block, adding each block's
product (summed from zero) to the running tile.  No split-K, no atomics,
so chunked calls at block multiples give the same bits as one call.

f64, the main path's type, runs on the FP64 tensor cores
(``csrc/dmma_tile.cuh``: 128 x 128 tiles of 256 threads, the running tile
in shared memory beside a ring of ``ACCUM_STAGES`` cp.async stages); f32,
c64 and c128 run the FFMA/DFMA register tile (``gemm_tile``).  Both grids
put the row blocks on ``blockIdx.x``, the fastest index.
"""
from __future__ import annotations

import torch

from .._build import check_status, load_library
# The DMMA tile's constants are attributes here so that the contract can
# pin them to csrc/dmma_tile.cuh.
from ..common import (DMMA_ACCS, DMMA_BK, DMMA_BM, DMMA_BN,  # noqa: F401
                      DMMA_THREADS, DMMA_WM, DMMA_WN, GEMM_THREADS, Launch,
                      LaunchCounter, check_kernel_args, dmma_smem_bytes,
                      dtype_code, product_tile, raster_grid, type_name)

__all__ = ["ACCUM_BLOCK", "ACCUM_STAGES", "sketch_accum_kernel",
           "sketch_accum_launch", "LAUNCHES"]

# The canonical reduction block (rows of ``a`` per accumulate step).  A
# replay constant, not a tuning knob: it fixes the association of the row
# sum, so changing it changes every gaussian sketch.  csrc/sketch_accum.cu
# holds the same value.
ACCUM_BLOCK = 128
# Stages of the f64 kernel's cp.async ring (kAccumStages): with the 128 KB
# running tile they fill 229376 of the 232448 bytes a block may have.
ACCUM_STAGES = 3

LAUNCHES = LaunchCounter("sketch_accum")


def sketch_accum_launch(dtype: torch.dtype, l: int, m: int, n: int) -> Launch:
    """The launch for ``x`` (l, m), ``a`` (m, n): one CTA per output tile,
    row blocks on ``blockIdx.x``.  f64: the DMMA kernel, its ring and
    running tile in dynamic shared memory, with 16-byte copies (the C side
    takes its twin ``<false>``, of the same geometry, with 8-byte copies
    when ``x`` or ``a`` is not 16-byte aligned or has an odd pitch); the
    other types: the register tile, static shared memory only."""
    grid = raster_grid(l, n, product_tile(dtype))
    args = (dtype_code(dtype), None, None, None, None, l, m, n, None)
    if dtype == torch.float64:
        smem = dmma_smem_bytes(ACCUM_STAGES, DMMA_ACCS * DMMA_THREADS * 8)
        return Launch("sketch_accum_dmma_kernel<true>", grid,
                      (DMMA_THREADS, 1, 1), smem, "repro_sketch_accum", args)
    return Launch(f"sketch_accum_kernel<{type_name(dtype)}>", grid,
                  GEMM_THREADS, 0, "repro_sketch_accum", args)


def sketch_accum_kernel(x: torch.Tensor, a: torch.Tensor,
                        acc: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``x`` (l, m), ``a`` (m, n), ``acc`` (l, n), all
    contiguous CUDA tensors of one dtype in ``KERNEL_DTYPES``.  Ragged
    ``l``, ``m`` and ``n`` are masked in the kernel.  Returns a new
    (l, n) tensor; does not synchronize."""
    dev = check_kernel_args("sketch_accum", x, a, acc)
    l, m = x.shape
    m2, n = a.shape
    if m != m2 or tuple(acc.shape) != (l, n):
        raise ValueError(f"sketch_accum: shapes x {tuple(x.shape)}, "
                         f"a {tuple(a.shape)}, acc {tuple(acc.shape)}")
    out = torch.empty_like(acc)
    if l == 0 or n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_sketch_accum(dtype_code(x.dtype), x.data_ptr(),
                                    a.data_ptr(), acc.data_ptr(),
                                    out.data_ptr(), l, m, n, stream)
    check_status("sketch_accum", rc)
    LAUNCHES.add()
    return out
