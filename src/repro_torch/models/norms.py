"""Normalization layers (counterpart of ``repro.models.norms``): RMS norm,
and the LayerNorm (scale and bias) that whisper uses for every norm."""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["RMSNorm", "rmsnorm", "LayerNorm", "layernorm"]


class RMSNorm(nn.Module):
    """The ``{"scale": (d,)}`` leaf of the reference as a module."""

    def __init__(self, d: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                  requires_grad=False)


class LayerNorm(nn.Module):
    """The ``{"scale": (d,), "bias": (d,)}`` leaf of the reference."""

    def __init__(self, d: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d, dtype=dtype, device=device),
                                  requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(d, dtype=dtype, device=device),
                                 requires_grad=False)


def rmsnorm(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # Normalize in f32 for stability regardless of compute dtype.
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale.float()).to(x.dtype)


def layernorm(p: LayerNorm, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    # Population variance, as jnp.var (torch.var defaults to Bessel's).
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p.scale.float() + p.bias.float()
    return y.to(x.dtype)
