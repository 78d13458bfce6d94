"""Plain PyTorch version of the panel Gram pass (counterpart of
``repro.kernels.panel_gram.ref``)."""
from __future__ import annotations

import torch

__all__ = ["panel_gram_ref"]


def panel_gram_ref(c: torch.Tensor, z: torch.Tensor):
    """Gram of the candidate panel ``c`` (l x b) and its coefficient block
    against the residual shard ``z`` (l x n): ``(c^H c, c^H z)``."""
    ch = c.mH
    return ch @ c, ch @ z
