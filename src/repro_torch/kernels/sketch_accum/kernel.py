"""Wrapper of the Hopper kernel for the accumulating sketch GEMM
(``csrc/sketch_accum.cu``), which replaces the TPU kernel
``sketch_accum_kernel`` in ``repro/kernels/sketch_accum/kernel.py``.

``out = acc + x @ a`` with the reduction over ``a``'s rows in fixed
``ACCUM_BLOCK``-row blocks, in order: each CTA owns one output tile, loads
its ``acc`` tile once, and walks ``m`` block by block, adding each block's
product (summed from zero) to the running tile.  No split-K, no atomics,
so chunked calls at block multiples give the same bits as one call.
"""
from __future__ import annotations

import torch

from .._build import check_status, load_library
from ..common import (GEMM_THREADS, Launch, LaunchCounter, check_kernel_args,
                      dtype_code, gemm_grid, type_name)

__all__ = ["ACCUM_BLOCK", "sketch_accum_kernel", "sketch_accum_launch",
           "LAUNCHES"]

# The canonical reduction block (rows of ``a`` per accumulate step).  A
# replay constant, not a tuning knob: it fixes the association of the row
# sum, so changing it changes every gaussian sketch.  csrc/sketch_accum.cu
# holds the same value.
ACCUM_BLOCK = 128

LAUNCHES = LaunchCounter("sketch_accum")


def sketch_accum_launch(dtype: torch.dtype, l: int, m: int, n: int) -> Launch:
    """The launch for ``x`` (l, m), ``a`` (m, n): one CTA per output tile of
    the tiled GEMM, no dynamic shared memory."""
    return Launch(f"sketch_accum_kernel<{type_name(dtype)}>",
                  gemm_grid(dtype, l, n), GEMM_THREADS, 0,
                  "repro_sketch_accum",
                  (dtype_code(dtype), None, None, None, None, l, m, n, None))


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
