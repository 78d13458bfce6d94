"""numpy <-> torch conversion that keeps the dtype.

This system has no weights; what crosses between the JAX reference and the
port is the matrix itself and the random operators (``Omega``, SRFT phases
and rows, SRHT signs).  The parity tests move them as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.rng import check_device

__all__ = ["to_torch", "to_numpy"]


def to_torch(x, device="cuda") -> torch.Tensor:
    """A tensor on ``device`` with ``x``'s dtype (numpy or array-like in);
    raises for ``device="cuda"`` without a card."""
    dev = check_device(device)
    arr = np.asarray(x)
    if not arr.flags.writeable or not arr.flags.c_contiguous:
        arr = np.array(arr, copy=True, order="C")
    return torch.from_numpy(arr).to(dev)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t`` with the same dtype."""
    return t.detach().cpu().resolve_conj().resolve_neg().numpy()
