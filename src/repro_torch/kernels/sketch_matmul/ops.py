"""Public wrapper of the sketch GEMM ``Y = Omega @ A`` (counterpart of
``repro.kernels.sketch_matmul.ops``).

The product runs in the accumulator dtype (``accum_dtype_for``: f32 for
narrower reals, f64 for f64, complex as it is) and is returned in the
promoted input dtype, as the reference returns its accumulator cast to the
output dtype.

Dispatch: tensors on the CPU take the plain version (``ref.py``); CUDA
tensors launch the Hopper kernel (``kernel.py``) for every real and
complex dtype, or raise.
"""
from __future__ import annotations

import torch

from ..sketch_accum import accum_dtype_for
from .kernel import sketch_matmul_kernel
from .ref import sketch_matmul_ref

__all__ = ["sketch_matmul"]


def sketch_matmul(omega: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``omega @ a`` for ``omega`` (l, m), ``a`` (m, n), real or complex."""
    if omega.shape[1] != a.shape[0]:
        raise ValueError(f"omega columns ({omega.shape[1]}) must match a "
                         f"rows ({a.shape[0]})")
    if omega.device != a.device:
        raise ValueError(f"omega and a must share one device, got "
                         f"{omega.device} and {a.device}")
    dt = torch.promote_types(omega.dtype, a.dtype)
    adt = accum_dtype_for(dt)
    omega, a = omega.to(adt), a.to(adt)
    if a.device.type == "cpu":
        out = sketch_matmul_ref(omega, a)
    else:
        out = sketch_matmul_kernel(omega.contiguous(), a.contiguous())
    return out.to(dt)
