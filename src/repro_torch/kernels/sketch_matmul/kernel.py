"""Wrapper of the Hopper kernel for the sketch GEMM
(``csrc/sketch_matmul.cu``), which replaces the TPU kernel
``sketch_matmul_kernel`` in ``repro/kernels/sketch_matmul/kernel.py``.

``out = omega @ a``: each CTA owns one output tile and walks ``m`` in
order with one running sum, so the result is deterministic (no split-K, no
atomics).  Complex types run in complex arithmetic in the same single
launch; ragged ``l``, ``m`` and ``n`` are masked in the kernel, so ``a`` is
never padded or copied.
"""
from __future__ import annotations

import torch

from .._build import check_status, load_library
from ..common import (GEMM_THREADS, Launch, LaunchCounter, check_kernel_args,
                      dtype_code, gemm_grid, type_name)

__all__ = ["sketch_matmul_kernel", "sketch_matmul_launch", "LAUNCHES"]

LAUNCHES = LaunchCounter("sketch_matmul")


def sketch_matmul_launch(dtype: torch.dtype, l: int, m: int,
                         n: int) -> Launch:
    """The launch for ``omega`` (l, m), ``a`` (m, n): one CTA per output
    tile, no dynamic shared memory."""
    return Launch(f"sketch_matmul_kernel<{type_name(dtype)}>",
                  gemm_grid(dtype, l, n), GEMM_THREADS, 0,
                  "repro_sketch_matmul",
                  (dtype_code(dtype), None, None, None, l, m, n, None))


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
