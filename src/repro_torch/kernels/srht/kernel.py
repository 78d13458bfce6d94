"""Wrapper of the Hopper kernel for one sweep of the fast Walsh-Hadamard
transform (``csrc/fwht.cu``), which replaces the TPU kernel ``fwht_kernel``
in ``repro/kernels/srht/kernel.py``.

A sweep applies the butterfly stages of one Kronecker factor ``f =
2^f_log2 <= 2^MAX_SLAB_LOG2`` at row stride ``stride`` (the product of the
factors before it): for every group of ``f`` rows ``stride`` apart it runs
the stages ``h = stride, 2 stride, ..., (f/2) stride`` on a slab of 128
contiguous bytes of each row in shared memory, then multiplies by
``scale``.  ``ops.fwht`` chains the sweeps; each launch counts once.
"""
from __future__ import annotations

import torch

from .._build import check_status, load_library
from ..common import (Launch, LaunchCounter, cdiv, check_kernel_args,
                      dtype_code, type_name)

__all__ = ["MAX_SLAB_LOG2", "fwht_pass_kernel", "fwht_pass_launch",
           "LAUNCHES"]

# Largest factor of one sweep: 2^8 rows x 128 bytes = 32 KB of shared
# memory per CTA.  csrc/fwht.cu holds the same value.
MAX_SLAB_LOG2 = 8

LAUNCHES = LaunchCounter("fwht")
# Threads per CTA (csrc/fwht.cu).
THREADS = 256


def fwht_pass_launch(dtype: torch.dtype, m: int, n: int, f_log2: int,
                     stride: int, scale: float) -> Launch:
    """The launch of one sweep over ``x`` (m, n): one CTA per group of
    ``2^f_log2`` rows and 128-byte column slab, static shared memory
    only."""
    itemsize = torch.empty((), dtype=dtype, device="meta").element_size()
    return Launch(f"fwht_kernel<{type_name(dtype)}>",
                  (m >> f_log2, cdiv(n, 128 // itemsize), 1), (THREADS, 1, 1),
                  0, "repro_fwht_pass",
                  (dtype_code(dtype), None, None, m, n, stride, f_log2, scale,
                   None))


def fwht_pass_kernel(x: torch.Tensor, out: torch.Tensor, f_log2: int,
                     stride: int, scale: float) -> torch.Tensor:
    """Launch one sweep from ``x`` (m, n) into ``out`` (same shape; may be
    ``x`` itself), both contiguous CUDA tensors of one dtype in
    ``KERNEL_DTYPES``; ``m`` a power of two divisible by ``2^f_log2 *
    stride``.  Returns ``out``; does not synchronize."""
    dev = check_kernel_args("fwht", x, out)
    m, n = x.shape
    if tuple(out.shape) != (m, n):
        raise ValueError(f"fwht: x {tuple(x.shape)} and out "
                         f"{tuple(out.shape)} differ")
    if not 0 <= f_log2 <= MAX_SLAB_LOG2 or m % ((1 << f_log2) * stride):
        raise ValueError(f"fwht: factor 2^{f_log2} at stride {stride} does "
                         f"not split m={m} (factor at most "
                         f"2^{MAX_SLAB_LOG2})")
    if n == 0:
        return out
    lib = load_library()
    with torch.cuda.device(dev):
        cuda_stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_fwht_pass(dtype_code(x.dtype), x.data_ptr(),
                                 out.data_ptr(), m, n, stride, f_log2,
                                 scale, cuda_stream)
    check_status("fwht", rc)
    LAUNCHES.add()
    return out
