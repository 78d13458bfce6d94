"""Plain PyTorch version of the accumulating sketch GEMM, in the canonical
order (counterpart of ``repro.kernels.sketch_accum.ref``).

It reduces over ``a``'s rows in the same fixed ``ACCUM_BLOCK``-row blocks
as the kernel, one product and one add per block, so chunked calls at
block multiples give the same bits as one call.  Within a block the
product's own summation order is the library's, so the kernel and this
version agree to a tolerance, not bit for bit.
"""
from __future__ import annotations

import torch

from ..common import acc_dtype_for
from .kernel import ACCUM_BLOCK

__all__ = ["accum_dtype_for", "sketch_accum_ref"]


def accum_dtype_for(dtype: torch.dtype) -> torch.dtype:
    """Accumulator dtype incl. complex: c64/c128 accumulate natively; real
    follows ``acc_dtype_for``."""
    if dtype.is_complex:
        return dtype
    return acc_dtype_for(dtype)


def sketch_accum_ref(x: torch.Tensor, a: torch.Tensor,
                     acc: torch.Tensor) -> torch.Tensor:
    """``acc + x @ a`` reduced in canonical ``ACCUM_BLOCK`` row blocks:
    one (l, B) x (B, n) product and one add per block, in order."""
    m = x.shape[1]
    out = acc.clone()
    for r0 in range(0, m, ACCUM_BLOCK):
        out += x[:, r0:r0 + ACCUM_BLOCK] @ a[r0:r0 + ACCUM_BLOCK]
    return out
