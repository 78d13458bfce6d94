"""Public wrapper of the blocked triangular solve (counterpart of
``repro.kernels.tsolve.ops``): ``triu(r1) @ T = r2``, independent per
column of ``r2`` (paper eq. 10).

The reference pads ``k`` with an identity diagonal and sends complex
inputs to XLA; the port masks ``k`` in the kernel and runs every real and
complex dtype through it.  The solve runs in the accumulator dtype
(``accum_dtype_for``) and returns the promoted input dtype.

Dispatch: tensors on the CPU take the plain version (``ref.py``); CUDA
tensors launch the Hopper kernel (``kernel.py``), or raise.
"""
from __future__ import annotations

import torch

from ..common import refuse_dtensor
from ..sketch_accum import accum_dtype_for
from .kernel import tsolve_kernel
from .ref import tsolve_ref

__all__ = ["tsolve"]


def tsolve(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Solve ``triu(r1) @ T = r2``: ``r1`` (k, k), ``r2`` (k, n) -> ``T``
    (k, n).  Only the upper triangle of ``r1`` is read."""
    refuse_dtensor("tsolve", r1, r2)
    k = r2.shape[0]
    if tuple(r1.shape) != (k, k):
        raise ValueError(f"r1 shape {tuple(r1.shape)} must be {(k, k)} for "
                         f"r2 of {k} rows")
    if r1.device != r2.device:
        raise ValueError(f"r1 and r2 must share one device, got {r1.device} "
                         f"and {r2.device}")
    dt = torch.promote_types(r1.dtype, r2.dtype)
    adt = accum_dtype_for(dt)
    r1, r2 = r1.to(adt), r2.to(adt)
    if r2.device.type == "cpu":
        out = tsolve_ref(r1, r2)
    else:
        out = tsolve_kernel(r1.contiguous(), r2.contiguous())
    return out.to(dt)
