"""Wrapper of the Hopper kernel for the column-parallel blocked triangular
solve (``csrc/tsolve.cu``), which replaces the TPU kernel ``tsolve_kernel``
in ``repro/kernels/tsolve/kernel.py``.

One launch, one CTA of 8 warps per slab of 512 bytes of a row of ``r2``
(f64: 64 columns): row blocks of ``BLOCK_ROWS`` from the bottom, a
trailing update from the rows already solved (R1's band through a ring of
cp.async stages; f64 on the FP64 tensor cores, the other dtypes on a
register tile), then the diagonal block, the threads of one warp a
column from registers, dividing by the raw diagonal (no clamp).  The solved
rows stay in shared memory where ``k`` rows of the slab fit
(``tsolve_geometry``), else they are read back from the output.  Only the
upper triangle of ``r1`` is read; ``k`` is masked, never padded.
"""
from __future__ import annotations

import torch

from .._build import check_status, load_library
from ..common import (SMEM_BUDGET_BYTES, Launch, LaunchCounter, cdiv,
                      check_kernel_args, dtype_code, type_name)
from .ref import BLOCK_ROWS

__all__ = ["tsolve_kernel", "tsolve_geometry", "tsolve_launch", "LAUNCHES"]

LAUNCHES = LaunchCounter("tsolve")
# csrc/tsolve.cu: threads per CTA, bytes of a row of the slab, rows of T a
# ring stage (columns of R1's band tile), stages of the ring.
THREADS, SLAB_BYTES, DEPTH, STAGES = 256, 512, 16, 4


def _smem(item: int, resident: bool, k: int) -> int:
    cols = SLAB_BYTES // item
    slab = (cdiv(k, DEPTH) * DEPTH if resident else BLOCK_ROWS) * cols
    ring = STAGES * (BLOCK_ROWS * DEPTH + (0 if resident else DEPTH * cols))
    return item * (slab + BLOCK_ROWS * (BLOCK_ROWS + 1) + ring)


def tsolve_geometry(dtype: torch.dtype, k: int) -> tuple:
    """``(slab columns, resident, dynamic shared bytes)`` as the C side
    chooses them: the solved rows of T stay in shared memory when ``k``
    rows of the slab, the diagonal triangle and the ring fit one block."""
    item = torch.empty((), dtype=dtype, device="meta").element_size()
    resident = _smem(item, True, k) <= SMEM_BUDGET_BYTES
    return SLAB_BYTES // item, resident, _smem(item, resident, k)


def tsolve_launch(dtype: torch.dtype, k: int, n: int) -> Launch:
    """The launch for ``r1`` (k, k), ``r2`` (k, n): one CTA of ``THREADS``
    per slab (``tsolve_geometry``)."""
    cols, resident, smem = tsolve_geometry(dtype, k)
    return Launch(f"tsolve_kernel<{type_name(dtype)},{str(resident).lower()}>",
                  (cdiv(n, cols), 1, 1), (THREADS, 1, 1), smem, "repro_tsolve",
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
