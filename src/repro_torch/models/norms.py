"""RMS normalization (counterpart of ``repro.models.norms``)."""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["RMSNorm", "rmsnorm"]


class RMSNorm(nn.Module):
    """The ``{"scale": (d,)}`` leaf of the reference as a module."""

    def __init__(self, d: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                  requires_grad=False)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # Normalize in f32 for stability regardless of compute dtype.
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale.float()).to(x.dtype)
