"""Shared helpers for the port's kernel packages (counterpart of
``repro.kernels.common`` without the TPU tiling constants)."""
from __future__ import annotations

import torch

__all__ = ["cdiv", "round_up", "pad_to", "acc_dtype_for", "KERNEL_DTYPES",
           "LaunchCounter", "dtype_code", "check_kernel_args"]

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
