"""Wrapper of the Hopper kernel for the column-parallel blocked triangular
solve (``csrc/tsolve.cu``), which replaces the TPU kernel ``tsolve_kernel``
in ``repro/kernels/tsolve/kernel.py``.

One launch, one CTA per 32-column slab of ``r2``: row blocks of 32 from
the bottom, a trailing update from the rows already solved, then the
diagonal block row by row, dividing by the raw diagonal (no clamp).  Only
the upper triangle of ``r1`` is read; ``k`` is masked, never padded.
"""
from __future__ import annotations

import torch

from .._build import check_status, load_library
from ..common import (Launch, LaunchCounter, cdiv, check_kernel_args,
                      dtype_code, type_name)

__all__ = ["tsolve_kernel", "tsolve_launch", "LAUNCHES"]

LAUNCHES = LaunchCounter("tsolve")
# Columns of r2 per CTA and row groups per CTA (csrc/tsolve.cu).
COLS, ROW_GROUPS = 32, 8


def tsolve_launch(dtype: torch.dtype, k: int, n: int) -> Launch:
    """The launch for ``r1`` (k, k), ``r2`` (k, n): one CTA of 32 x 8
    threads per 32-column slab, static shared memory only."""
    return Launch(f"tsolve_kernel<{type_name(dtype)}>", (cdiv(n, COLS), 1, 1),
                  (COLS, ROW_GROUPS, 1), 0, "repro_tsolve",
                  (dtype_code(dtype), None, None, None, k, n, None))


def tsolve_kernel(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``r1`` (k, k) and ``r2`` (k, n), contiguous CUDA
    tensors of one dtype in ``KERNEL_DTYPES``.  Returns ``T`` (k, n) with
    ``triu(r1) @ T = r2``; does not synchronize."""
    dev = check_kernel_args("tsolve", r1, r2)
    k, n = r2.shape
    if tuple(r1.shape) != (k, k):
        raise ValueError(f"tsolve: shapes r1 {tuple(r1.shape)}, "
                         f"r2 {tuple(r2.shape)}")
    t = torch.empty_like(r2)
    if k == 0 or n == 0:
        return t
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_tsolve(dtype_code(r2.dtype), r1.data_ptr(),
                              r2.data_ptr(), t.data_ptr(), k, n, stream)
    check_status("tsolve", rc)
    LAUNCHES.add()
    return t
