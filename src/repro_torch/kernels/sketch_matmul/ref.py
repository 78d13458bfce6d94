"""Plain PyTorch version of the sketch GEMM (counterpart of
``repro.kernels.sketch_matmul.ref``): one library product in the
accumulator dtype.  It sums in the library's order, so the kernel agrees
with it to a tolerance, not bit for bit."""
from __future__ import annotations

import torch

__all__ = ["sketch_matmul_ref"]


def sketch_matmul_ref(omega: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``omega @ a``, both already in the accumulator dtype."""
    return omega @ a
