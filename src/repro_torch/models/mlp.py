"""Feed-forward blocks (counterpart of ``repro.models.mlp``): SwiGLU for the
llama-family archs and the GELU MLP of whisper."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig

__all__ = ["SwiGLU", "GeluMLP", "swiglu", "gelu_mlp", "mlp"]


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _normal_(p: nn.Parameter, gen: torch.Generator, scale: float) -> None:
    """Fill ``p`` with N(0, 1) * scale drawn in f32, then cast, as the
    reference's ``(normal(key, shape) * scale).astype(dtype)``."""
    p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * scale)


class SwiGLU(nn.Module):
    def __init__(self, d: int, d_ff: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.w_gate = _param((d, d_ff), dtype, device)
        self.w_up = _param((d, d_ff), dtype, device)
        self.w_down = _param((d_ff, d), dtype, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "SwiGLU":
        d, d_ff = self.w_gate.shape
        _normal_(self.w_gate, gen, d ** -0.5)
        _normal_(self.w_up, gen, d ** -0.5)
        _normal_(self.w_down, gen, d_ff ** -0.5)
        return self


class GeluMLP(nn.Module):
    def __init__(self, d: int, d_ff: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.w_in = _param((d, d_ff), dtype, device)
        self.b_in = _param((d_ff,), dtype, device)
        self.w_out = _param((d_ff, d), dtype, device)
        self.b_out = _param((d,), dtype, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "GeluMLP":
        d, d_ff = self.w_in.shape
        _normal_(self.w_in, gen, d ** -0.5)
        self.b_in.zero_()
        _normal_(self.w_out, gen, d_ff ** -0.5)
        self.b_out.zero_()
        return self


def swiglu(p: SwiGLU, x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    g = F.silu(x @ p.w_gate.to(cdt))
    u = x @ p.w_up.to(cdt)
    return (g * u) @ p.w_down.to(cdt)


def gelu_mlp(p: GeluMLP, x: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation.
    h = F.gelu(x @ p.w_in.to(cdt) + p.b_in.to(cdt), approximate="tanh")
    return h @ p.w_out.to(cdt) + p.b_out.to(cdt)


def mlp(p, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if isinstance(p, GeluMLP):
        return gelu_mlp(p, x, cfg.compute_dtype)
    return swiglu(p, x, cfg.compute_dtype)
