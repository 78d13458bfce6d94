"""Public wrapper of the panel Gram pass (counterpart of
``repro.kernels.panel_gram.ops``).

Dispatch: CPU tensors take the plain version (``ref.py``); CUDA tensors
launch the Hopper kernel (``kernel.py``) for every real and complex dtype,
or raise.
"""
from __future__ import annotations

import torch

from .kernel import panel_gram_kernel
from .ref import panel_gram_ref

__all__ = ["panel_gram"]


def panel_gram(c: torch.Tensor, z: torch.Tensor):
    """``(c^H c, c^H z)`` with ``c`` (l x b) a candidate panel and ``z``
    (l x n) the local residual shard, both products from one pass over
    ``z``."""
    if c.shape[0] != z.shape[0]:
        raise ValueError(f"c rows ({c.shape[0]}) must match z rows "
                         f"({z.shape[0]})")
    if c.device != z.device:
        raise ValueError(f"c and z must share one device, got {c.device} "
                         f"and {z.device}")
    dt = torch.promote_types(c.dtype, z.dtype)
    c, z = c.to(dt), z.to(dt)
    if c.device.type == "cpu":
        return panel_gram_ref(c, z)
    return panel_gram_kernel(c.contiguous(), z.contiguous())
