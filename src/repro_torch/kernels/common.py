"""Shared helpers for the port's kernel packages (counterpart of
``repro.kernels.common`` without the TPU tiling constants).

Every kernel package also ships a ``contract.py`` declaring a
:class:`KernelContract`, the metadata ``repro_torch.analysis.kernels``
checks: the kernel/ref/ops triple with matching signatures, pinned
constants (Python values, and Python values that must equal a constant of
the CUDA source), a representative example whose declared launches must
fit one block's shared memory, and a known-bad call that must raise
``ValueError`` eagerly.
"""
from __future__ import annotations

import math
import sys
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

__all__ = ["cdiv", "round_up", "pad_to", "acc_dtype_for", "KERNEL_DTYPES",
           "LaunchCounter", "dtype_code", "check_kernel_args",
           "refuse_dtensor", "type_name",
           "Launch", "Example", "KernelContract", "SMEM_BUDGET_BYTES",
           "MAX_THREADS_PER_BLOCK", "GEMM_THREADS", "gemm_tile",
           "DMMA_BM", "DMMA_BN", "DMMA_BK", "DMMA_THREADS", "DMMA_WM",
           "DMMA_WN", "DMMA_ACCS", "dmma_smem_bytes", "product_tile",
           "raster_grid"]

# Hopper (sm_90): the most dynamic shared memory one block may opt in to
# (227 KiB), and the most threads a block may have.
SMEM_BUDGET_BYTES = 232448
MAX_THREADS_PER_BLOCK = 1024

# The element types every hand-written kernel is instantiated for.  A CUDA
# tensor of any other dtype is rejected by the wrappers, never sent to a
# plain version.
KERNEL_DTYPES = (torch.float32, torch.float64, torch.complex64,
                 torch.complex128)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def pad_to(x: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Zero-pad trailing edges of ``x`` up to ``shape``."""
    pads = [t - s for s, t in zip(x.shape, shape)]
    if not any(pads):
        return x
    flat = []
    for p in reversed(pads):            # F.pad wants the last dim first
        flat += [0, p]
    return torch.nn.functional.pad(x, flat)


def acc_dtype_for(dtype: torch.dtype) -> torch.dtype:
    """Accumulator dtype: f64 for f64 input, f32 for every narrower real."""
    return torch.float64 if dtype == torch.float64 else torch.float32


class LaunchCounter:
    """Launches of one kernel in this process: a plain integer that the
    kernel's wrapper bumps once per launch, so a run can show that its main
    path went through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def add(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


def dtype_code(dtype: torch.dtype) -> int:
    """Index of ``dtype`` in ``KERNEL_DTYPES``: the element-type code the C
    entry points switch on (``csrc/common.cuh``, ``enum DType``)."""
    return KERNEL_DTYPES.index(dtype)


def check_kernel_args(name: str, *tensors: torch.Tensor) -> torch.device:
    """Reject what a kernel does not take: tensors off CUDA, on two devices,
    of mixed or unsupported dtype, or not contiguous.  Returns the device."""
    dev = tensors[0].device
    dt = tensors[0].dtype
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every tensor must be on one CUDA "
                             f"device, got {[str(u.device) for u in tensors]}")
        if t.dtype != dt or dt not in KERNEL_DTYPES:
            raise TypeError(f"{name}: dtypes {[u.dtype for u in tensors]}; "
                            f"need one of {KERNEL_DTYPES}, all equal")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return dev


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor, without importing
    ``torch.distributed.tensor`` (a second of import on a path that never
    made one): no DTensor exists before that module is loaded."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def refuse_dtensor(name: str, *tensors) -> None:
    """Raise a ``TypeError`` naming the kernel if any argument is a DTensor:
    a kernel without a sharded wrapper never gathers one quietly (only the
    flash op maps a DTensor to its local shards)."""
    if any(is_dtensor(t) for t in tensors):
        raise TypeError(f"{name}: the kernel takes no DTensor (it has no "
                        f"sharded wrapper); pass local tensors")


# ptxas's names of the element types (kernels/_build.py, parse_ptxas).
_TYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
               torch.complex64: "complex64", torch.complex128: "complex128",
               torch.bfloat16: "bfloat16"}


def type_name(dtype: torch.dtype) -> str:
    return _TYPE_NAMES[dtype]


# The tiled GEMM of csrc/gemm_tile.cuh: a 16 x 16 block, each thread a
# TM x TN micro-tile (GemmTile<T>), so a block covers (16 TM) x (16 TN).
GEMM_THREADS = (16, 16, 1)
_GEMM_TILE = {torch.float32: (8, 8), torch.float64: (4, 8),
              torch.complex64: (4, 4), torch.complex128: (4, 4)}


def gemm_tile(dtype: torch.dtype) -> tuple:
    """(BM, BN): the output tile of one block of the tiled GEMM."""
    tm, tn = _GEMM_TILE[dtype]
    return (GEMM_THREADS[1] * tm, GEMM_THREADS[0] * tn)


def raster_grid(rows: int, cols: int, tile: tuple) -> tuple:
    """Grid of (BM, BN) = ``tile`` output tiles over a (rows, cols)
    output with the row blocks the fastest index: ``blockIdx.x`` over
    ``ceil(rows / BM)``, ``blockIdx.y`` over ``ceil(cols / BN)`` (CUDA
    allows 65535 there; the C entry points refuse more)."""
    return (cdiv(rows, tile[0]), cdiv(cols, tile[1]), 1)


# The FP64 tensor-core tile of csrc/dmma_tile.cuh (the same constexpr
# names there): a block of DMMA_THREADS threads owns a DMMA_BM x DMMA_BN
# output tile, each warp DMMA_WM x DMMA_WN of it with DMMA_ACCS f64
# accumulators a thread, and streams the operands through a ring of
# shared-memory stages of DMMA_BK depth rows (both operands, 32 KB a
# stage).  The kernel packages pin these to the header in their contracts.
DMMA_BM = DMMA_BN = 128
DMMA_BK = 16
DMMA_THREADS = 256
DMMA_WM, DMMA_WN = 64, 32
DMMA_ACCS = (DMMA_WM // 16) * (DMMA_WN // 8) * 4


def dmma_smem_bytes(stages: int, extra: int = 0) -> int:
    """Dynamic shared bytes of a ring of ``stages`` stages plus ``extra``
    (``dmma_smem_bytes`` of the header)."""
    return stages * 2 * DMMA_BM * DMMA_BK * 8 + extra


def product_tile(dtype: torch.dtype) -> tuple:
    """(BM, BN): the output tile one CTA of sketch_accum, sketch_matmul
    or project_out owns: the DMMA tile for f64, the register tile for the
    other types."""
    if dtype == torch.float64:
        return (DMMA_BM, DMMA_BN)
    return gemm_tile(dtype)


@dataclass(frozen=True)
class Launch:
    """One kernel launch that a wrapper issues, as its contract declares
    it: the kernel (by its ``-Xptxas -v`` name), grid, block and dynamic
    shared bytes, and the C entry point call that issues it (``args``
    with every pointer as ``None``) in the library ``library``.  One call
    may issue several launches in order: this is launch ``part`` of the
    ``parts`` that the call issues (each declared, with the same entry and
    args).  The analysis pass holds the declaration to that call on the
    card."""
    kernel: str
    grid: tuple
    threads: tuple
    smem: int
    entry: str
    args: tuple
    library: str = "kernels"
    part: int = 0
    parts: int = 1

    @property
    def threads_per_block(self) -> int:
        return math.prod(self.threads)


@dataclass(frozen=True)
class Example:
    """A representative call ``fn(*args, **kwargs)``, ``args`` as meta
    tensors (shape and dtype only), and the launches it issues."""
    fn: Callable
    args: tuple
    kwargs: dict
    launches: tuple


@dataclass(frozen=True)
class KernelContract:
    """Contract of one ``kernels/<name>/`` package (counterpart of
    ``repro.kernels.common.KernelContract``), checked by
    ``repro_torch.analysis.kernels``.

    ``pairs`` couples each public ops wrapper to its plain version; their
    leading positional parameter names must agree.  ``example`` builds an
    :class:`Example` whose declared launches are computed by the kernel
    module's geometry functions; each must fit ``smem_budget`` bytes of
    shared memory and 1024 threads per block, and on the card it must
    equal what the wrapper calls and what the C side launches.
    ``constants`` pins kernel.py attributes to values; ``c_constants``
    pins kernel.py attributes to a ``constexpr int`` of a CUDA source
    (``{attr: (file under csrc, C name)}``), parsed from the file.
    ``bad_call`` must raise ``ValueError`` eagerly on CPU tensors.
    """
    name: str
    ops: tuple
    kernels: tuple
    refs: tuple
    pairs: tuple = ()
    example: Optional[Callable] = None     # () -> Example
    constants: dict = field(default_factory=dict)
    c_constants: dict = field(default_factory=dict)
    bad_call: Optional[Callable] = None
    smem_budget: int = SMEM_BUDGET_BYTES
    measure_residency: bool = False
