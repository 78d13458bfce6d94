"""Public wrapper of the accumulating sketch GEMM (counterpart of
``repro.kernels.sketch_accum.ops``).

``sketch_accum`` is the one boundary both sketch paths share: the
in-memory ``gaussian_sketch`` calls it once over all of ``m`` and the
streamed sketch once per row chunk.  Both reduce in the same canonical
``ACCUM_BLOCK`` blocks, so they give the same bits whenever the chunks are
block multiples.

Dispatch: tensors on the CPU take the plain version (``ref.py``); CUDA
tensors launch the Hopper kernel (``kernel.py``) for every real and
complex dtype, or raise.
"""
from __future__ import annotations

import torch

from .kernel import ACCUM_BLOCK, sketch_accum_kernel
from .ref import accum_dtype_for, sketch_accum_ref

__all__ = ["sketch_accum", "ACCUM_BLOCK", "accum_dtype_for"]


def sketch_accum(x: torch.Tensor, a: torch.Tensor,
                 acc: torch.Tensor | None = None) -> torch.Tensor:
    """``acc + x @ a`` in the accumulator dtype (``accum_dtype_for``), with
    the reduction over ``a``'s rows pinned to canonical ``ACCUM_BLOCK``
    blocks.  ``x``: (l, m) operator columns; ``a``: (m, n) row chunk;
    ``acc``: (l, n) running accumulator (``None`` = zeros)."""
    l, m = x.shape
    m2, n = a.shape
    if m != m2:
        raise ValueError(f"x columns ({m}) must match a rows ({m2})")
    adt = accum_dtype_for(torch.promote_types(x.dtype, a.dtype))
    if acc is None:
        acc = torch.zeros((l, n), dtype=adt, device=x.device)
    if tuple(acc.shape) != (l, n):
        raise ValueError(f"acc shape {tuple(acc.shape)} must be {(l, n)}")
    devices = {x.device, a.device, acc.device}
    if len(devices) != 1:
        raise ValueError(f"x, a and acc must share one device, got "
                         f"{x.device}, {a.device}, {acc.device}")
    x, a, acc = x.to(adt), a.to(adt), acc.to(adt)
    if x.device.type == "cpu":
        return sketch_accum_ref(x, a, acc)
    return sketch_accum_kernel(x.contiguous(), a.contiguous(),
                               acc.contiguous())
