"""Wrapper of the fixture's CUDA copy kernel (``big_copy.cu``), which
replaces the TPU kernel ``big_copy_kernel`` of
``repro/analysis/fixtures/badkernel/kernel.py``: ``o = x`` by column
blocks of ``bn``, each CTA staging the whole operand in shared memory.

The kernel lives in a library of its own (``library``), built from the
source beside this file at first use; it is not part of the production
library.  A request over one block's shared memory is refused by the C
side as a status, which ``check_status`` raises as ``RuntimeError``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from ....kernels._build import check_status, load_extra
from ....kernels.common import (Launch, LaunchCounter, cdiv, check_kernel_args,
                                dtype_code, type_name)

__all__ = ["big_copy_kernel", "big_copy_launch", "library", "LAUNCHES",
           "THREADS"]

LAUNCHES = LaunchCounter("big_copy")
# Threads per CTA (big_copy.cu, kThreads).
THREADS = 256

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# dtype, x, o, m, n, bn, stream
_SIGNATURES = {"repro_big_copy": [_I, _P, _P, _I64, _I64, _I64, _P]}


def library() -> ctypes.CDLL:
    """The fixture's own library, built on first use."""
    return load_extra("badkernel", [Path(__file__).with_name("big_copy.cu")],
                      _SIGNATURES)


def big_copy_launch(dtype: torch.dtype, m: int, n: int, bn: int) -> Launch:
    """The launch for ``x`` (m, n): ``ceil(n / bn)`` CTAs, each asking for
    the whole operand in dynamic shared memory."""
    itemsize = torch.empty((), dtype=dtype, device="meta").element_size()
    return Launch(f"big_copy_kernel<{type_name(dtype)}>", (cdiv(n, bn), 1, 1),
                  (THREADS, 1, 1), itemsize * m * n, "repro_big_copy",
                  (dtype_code(dtype), None, None, m, n, bn, None),
                  library="badkernel")


def big_copy_kernel(x: torch.Tensor, *, bn: int = 2048) -> torch.Tensor:
    """Launch the kernel: ``x`` (m, n) a contiguous CUDA tensor of a dtype
    in ``KERNEL_DTYPES``.  Returns a new (m, n) tensor; does not
    synchronize.  Raises ``RuntimeError`` when the operand does not fit one
    block's shared memory."""
    dev = check_kernel_args("big_copy", x)
    m, n = x.shape
    o = torch.empty_like(x)
    if m == 0 or n == 0:
        return o
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_big_copy(dtype_code(x.dtype), x.data_ptr(),
                                o.data_ptr(), m, n, bn, stream)
    check_status("big_copy", rc, lib)
    LAUNCHES.add()
    return o
