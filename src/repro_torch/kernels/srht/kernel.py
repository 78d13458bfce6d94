"""Wrapper of the Hopper kernel for one sweep of the fast Walsh-Hadamard
transform (``csrc/fwht.cu``), which replaces the TPU kernel ``fwht_kernel``
in ``repro/kernels/srht/kernel.py``.

A sweep applies the butterfly stages of one Kronecker factor ``F =
2^f_log2 <= 2^MAX_SLAB_LOG2`` at row stride ``stride`` (the product of the
factors before it): for every group of ``F`` rows ``stride`` apart it runs
the stages ``h = stride, 2 stride, ..., (F/2) stride``, then multiplies by
``scale``.  One CTA a tile (a group's ``F`` rows x ``ROW_BYTES`` of each
row, ``TILE_BYTES / F`` at ``F = 2^9``), the column pieces fastest; a
thread holds ``2^REG_LOG2`` rows of one 16-byte vector in registers and the
tile goes through shared memory between rounds (``sweep_rounds``,
``slot_rows``: the map the CUDA source uses).  ``ops.fwht`` chains the
sweeps; each launch counts once.
"""
from __future__ import annotations

import torch

from .._build import check_status, load_library
from ..common import (Launch, LaunchCounter, cdiv, check_kernel_args,
                      dtype_code, type_name)

__all__ = ["MAX_SLAB_LOG2", "REG_LOG2", "ROW_BYTES", "TILE_BYTES",
           "THREADS", "fwht_pass_kernel", "fwht_pass_launch",
           "sweep_rounds", "slot_rows", "LAUNCHES"]

# Largest factor of one sweep: 2^9 rows (csrc/fwht.cu, kMaxSlabLog2).
MAX_SLAB_LOG2 = 9
# Rows a thread holds in registers (2^REG_LOG2), the widest piece of a row
# a tile holds and a tile's bytes at most (csrc/fwht.cu: kFwhtRegLog2,
# kFwhtRowBytes, kFwhtTileBytes); the most threads a CTA (kThreads).
REG_LOG2, ROW_BYTES, TILE_BYTES, THREADS = 4, 256, 65536, 256

LAUNCHES = LaunchCounter("fwht")


def sweep_rounds(f_log2: int) -> list[tuple[int, int, int]]:
    """The rounds of a sweep of factor ``2^f_log2``: ``(P, lo, hi)`` each,
    a thread's register slot bits being tile-row bits ``P .. P + RL - 1``
    (``RL = min(REG_LOG2, f_log2)``) and the round applying the stages of
    slot bits ``lo .. hi - 1`` (row bits ``P + lo ..``) in increasing
    order.  Between rounds the tile goes through shared memory."""
    rl = min(REG_LOG2, f_log2)
    if rl == 0:
        return []
    out = []
    for q in range(cdiv(f_log2, rl)):
        p = min(q * rl, f_log2 - rl)
        out.append((p, q * rl - p, min(q * rl + rl, f_log2) - p))
    return out


def slot_rows(f_log2: int, p: int) -> torch.Tensor:
    """Tile row of each (thread row index, slot) in a round whose slot bits
    start at row bit ``p``: an int64 tensor (2^(f_log2 - RL), 2^RL)."""
    rl = min(REG_LOG2, f_log2)
    rt = torch.arange(1 << (f_log2 - rl))[:, None]
    s = torch.arange(1 << rl)[None, :]
    return (rt & ((1 << p) - 1)) | (s << p) | ((rt >> p) << (p + rl))


def _geometry(dtype: torch.dtype, m: int, n: int, f_log2: int) -> tuple:
    """(register log2, grid, threads, dynamic shared bytes) of one sweep,
    as the C side computes them (``fwht_geometry``)."""
    itemsize = torch.empty((), dtype=dtype, device="meta").element_size()
    piece = min(TILE_BYTES >> f_log2, ROW_BYTES)
    vecs = piece // 16
    rl = min(REG_LOG2, f_log2)
    rounds = len(sweep_rounds(f_log2))
    groups = m >> f_log2
    gy = min(groups, 32768)
    grid = (cdiv(n, vecs * (16 // itemsize)), gy, groups // gy)
    return rl, grid, (1 << (f_log2 - rl)) * vecs, ((1 << f_log2) * piece
                                                   if rounds > 1 else 0)


def fwht_pass_launch(dtype: torch.dtype, m: int, n: int, f_log2: int,
                     stride: int, scale: float) -> Launch:
    """The launch of one sweep over ``x`` (m, n): one CTA per tile, the
    column pieces on ``blockIdx.x`` and the groups on ``y`` and ``z``;
    the tile in dynamic shared memory when a sweep has more than one
    round.  16-byte copies when a row is whole 16 bytes (the bases of
    fresh tensors are aligned)."""
    itemsize = torch.empty((), dtype=dtype, device="meta").element_size()
    rl, grid, threads, smem = _geometry(dtype, m, n, f_log2)
    vec = str((n * itemsize) % 16 == 0).lower()
    return Launch(f"fwht_kernel<{type_name(dtype)},{rl},{vec}>", grid,
                  (threads, 1, 1), smem, "repro_fwht_pass",
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
