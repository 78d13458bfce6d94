"""Plain PyTorch versions of the fast Walsh-Hadamard transform and the
SRHT (counterpart of ``repro.kernels.srht.ref``).

``fwht_ref`` applies the butterfly stages in increasing-h order and the
``1/sqrt(m)`` scale once at the end, as the kernel's sweeps do; the
butterflies are exact IEEE adds and subtracts of the same values, so for
real dtypes the kernel gives these bits.
"""
from __future__ import annotations

import math

import torch

__all__ = ["fwht_ref", "srht_ref", "next_pow2"]


def next_pow2(m: int) -> int:
    return 1 << max(0, (m - 1)).bit_length()


def fwht_ref(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal fast Walsh-Hadamard transform along dim 0 (its length
    must be a power of two)."""
    m = x.shape[0]
    if m & (m - 1) or m == 0:
        raise ValueError(f"FWHT length must be a power of two, got {m}")
    tail = tuple(x.shape[1:])
    y = x
    h = 1
    while h < m:
        y = y.reshape((m // (2 * h), 2, h) + tail)
        y = torch.stack([y[:, 0] + y[:, 1], y[:, 0] - y[:, 1]], dim=1)
        y = y.reshape((m,) + tail)
        h *= 2
    return y * (1.0 / math.sqrt(m))


def srht_ref(signs: torch.Tensor, a: torch.Tensor,
             rows: torch.Tensor) -> torch.Tensor:
    """Subsampled randomized Hadamard transform of ``a`` (m, n): the sign
    flip ``signs`` (m,) of +-1, zero rows up to the next power of two
    ``mp``, the FWHT down every column, the rows ``rows`` (l,) of the
    padded row space, and the scale ``sqrt(mp / l)``."""
    m = a.shape[0]
    mp = next_pow2(m)
    da = signs.to(a.device, a.dtype)[:, None] * a
    if mp != m:
        da = torch.nn.functional.pad(da, (0, 0, 0, mp - m))
    h = fwht_ref(da)
    return h[rows.to(a.device, torch.int64)] * math.sqrt(mp / rows.shape[0])
