"""Public wrappers of the fast Walsh-Hadamard transform (any power-of-two
length) and the SRHT (counterpart of ``repro.kernels.srht.ops``).

The reference splits ``m > 8192`` (its VMEM budget) into two factors with
transposes between its sweeps.  The port splits every ``m = 2^p`` into
``ceil(p / MAX_SLAB_LOG2)`` near-equal Kronecker factors, low factor
first (two up to ``m = 2^18``), and runs one kernel sweep per factor,
addressing the later factors by their row stride instead of transposing;
the last sweep applies the ``1/sqrt(m)`` scale.  ``srht`` does the sign flip, zero padding, row
gather and scale as tensor ops around the transform, as the reference
does them in jnp around its Pallas call.

Dispatch: tensors on the CPU take the plain versions (``ref.py``); CUDA
tensors launch the Hopper kernel (``kernel.py``) for every real and
complex dtype, or raise.
"""
from __future__ import annotations

import math

import torch

from ..common import cdiv
from .kernel import MAX_SLAB_LOG2, fwht_pass_kernel
from .ref import fwht_ref, next_pow2

__all__ = ["fwht", "fwht_factors", "srht"]


def fwht_factors(m: int) -> list[int]:
    """log2 of the Kronecker factors of ``m`` (a power of two), low factor
    first: one kernel sweep each."""
    p = m.bit_length() - 1
    q = max(1, cdiv(p, MAX_SLAB_LOG2))
    return [p // q + (1 if i < p % q else 0) for i in range(q)]


def fwht(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal FWHT along dim 0 of ``x`` (m, n), ``m`` a power of two."""
    m = x.shape[0]
    if m & (m - 1) or m == 0:
        raise ValueError(f"FWHT length must be a power of two, got {m}")
    if x.device.type == "cpu":
        return fwht_ref(x)
    x = x.contiguous()
    out = torch.empty_like(x)
    factors = fwht_factors(m)
    stride = 1
    for i, f_log2 in enumerate(factors):
        scale = 1.0 / math.sqrt(m) if i == len(factors) - 1 else 1.0
        fwht_pass_kernel(x if i == 0 else out, out, f_log2, stride, scale)
        stride <<= f_log2
    return out


def srht(signs: torch.Tensor, a: torch.Tensor,
         rows: torch.Tensor) -> torch.Tensor:
    """Subsampled randomized Hadamard transform of ``a`` (m, n): ``signs``
    (m,) the +-1 diagonal, ``rows`` (l,) sample indices into the padded
    row space of length ``next_pow2(m)``.  Returns (l, n).  The sign flip,
    padding, gather and scale are tensor ops around ``fwht``, in
    ``srht_ref``'s order: the plain transform on the CPU, the kernel on
    the card."""
    if signs.shape != (a.shape[0],):
        raise ValueError(f"signs shape {tuple(signs.shape)} must be "
                         f"({a.shape[0]},)")
    m = a.shape[0]
    mp = next_pow2(m)
    da = signs.to(a.device, a.dtype)[:, None] * a
    if mp != m:
        da = torch.nn.functional.pad(da, (0, 0, 0, mp - m))
    h = fwht(da)
    return h[rows.to(a.device, torch.int64)] * math.sqrt(mp / rows.shape[0])
