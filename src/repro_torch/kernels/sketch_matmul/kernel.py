"""Wrapper of the Hopper kernel for the sketch GEMM
(``csrc/sketch_matmul.cu``), which replaces the TPU kernel
``sketch_matmul_kernel`` in ``repro/kernels/sketch_matmul/kernel.py``.

``out = omega @ a``: each CTA owns one output tile and walks ``m`` in
order with one running sum, so the result is deterministic (no split-K, no
atomics).  Complex types run in complex arithmetic in the same single
launch; ragged ``l``, ``m`` and ``n`` are masked in the kernel, so ``a`` is
never padded or copied.

f64, Table 2's type, runs on the FP64 tensor cores (``csrc/dmma_tile.cuh``:
128 x 128 tiles of 256 threads, the accumulator in registers, a ring of
``MATMUL_STAGES`` cp.async stages); f32, c64 and c128 run the FFMA/DFMA
register tile (``gemm_tile``).  Both grids put the row blocks on
``blockIdx.x``, the fastest index.
"""
from __future__ import annotations

import torch

from .._build import check_status, load_library
# The DMMA tile's constants are attributes here so that the contract can
# pin them to csrc/dmma_tile.cuh.
from ..common import (DMMA_BK, DMMA_BM, DMMA_BN,  # noqa: F401
                      DMMA_THREADS, GEMM_THREADS, Launch, LaunchCounter,
                      check_kernel_args, dmma_smem_bytes, dtype_code,
                      product_tile, raster_grid, type_name)

__all__ = ["MATMUL_STAGES", "sketch_matmul_kernel", "sketch_matmul_launch",
           "LAUNCHES"]

# Stages of the f64 kernel's cp.async ring (kMatmulStages): 7 x 32 KB fill
# 229376 of the 232448 bytes a block may have.
MATMUL_STAGES = 7

LAUNCHES = LaunchCounter("sketch_matmul")


def sketch_matmul_launch(dtype: torch.dtype, l: int, m: int,
                         n: int) -> Launch:
    """The launch for ``omega`` (l, m), ``a`` (m, n): one CTA per output
    tile, row blocks on ``blockIdx.x``.  f64: the DMMA kernel, its ring in
    dynamic shared memory, with 16-byte copies (the C side takes its twin
    ``<false>``, of the same geometry, with 8-byte copies when ``omega`` or
    ``a`` is not 16-byte aligned or has an odd pitch); the other types: the
    register tile, static shared memory only."""
    grid = raster_grid(l, n, product_tile(dtype))
    args = (dtype_code(dtype), None, None, None, l, m, n, None)
    if dtype == torch.float64:
        return Launch("sketch_matmul_dmma_kernel<true>", grid,
                      (DMMA_THREADS, 1, 1), dmma_smem_bytes(MATMUL_STAGES),
                      "repro_sketch_matmul", args)
    return Launch(f"sketch_matmul_kernel<{type_name(dtype)}>", grid,
                  GEMM_THREADS, 0, "repro_sketch_matmul", args)


def sketch_matmul_kernel(omega: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``omega`` (l, m) and ``a`` (m, n), contiguous
    CUDA tensors of one dtype in ``KERNEL_DTYPES``.  Returns a new (l, n)
    tensor; does not synchronize."""
    dev = check_kernel_args("sketch_matmul", omega, a)
    l, m = omega.shape
    m2, n = a.shape
    if m != m2:
        raise ValueError(f"sketch_matmul: shapes omega {tuple(omega.shape)}, "
                         f"a {tuple(a.shape)}")
    out = torch.empty((l, n), dtype=a.dtype, device=dev)
    if l == 0 or n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_sketch_matmul(dtype_code(a.dtype), omega.data_ptr(),
                                     a.data_ptr(), out.data_ptr(), l, m, n,
                                     stream)
    check_status("sketch_matmul", rc)
    LAUNCHES.add()
    return out
