"""Modality frontends, stubs as in the reference (counterpart of
``repro.models.frontend``).

The ``[audio]`` and ``[vlm]`` configs specify the transformer backbone
only: the model is handed precomputed frame or patch embeddings.  The stubs
here keep the wiring real (a projection, and for audio a learned
positional table, that the backbone consumes) while the conv and patch
towers stay out of scope, as in the reference.
"""
from __future__ import annotations

import torch
from torch import nn

from .config import ModelConfig
from .mlp import _normal_, _param

__all__ = ["AudioFrontend", "VisionFrontend", "audio_frontend",
           "vision_frontend"]


class AudioFrontend(nn.Module):
    """Whisper's stub: ``proj`` (d, d) and learned positions ``pos``
    (n_frontend_tokens, d) for precomputed mel-frame embeddings."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d, pdt = cfg.d_model, cfg.params_dtype
        self.proj = _param((d, d), pdt, device)
        self.pos = _param((cfg.n_frontend_tokens, d), pdt, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "AudioFrontend":
        d = self.proj.shape[0]
        _normal_(self.proj, gen, d ** -0.5)
        _normal_(self.pos, gen, 0.02)
        return self


class VisionFrontend(nn.Module):
    """qwen2-vl's stub: the ``merger`` projection (d, d) of precomputed
    patch embeddings; their dynamic-resolution positions arrive as M-RoPE
    (t, h, w) ids."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.merger = _param((cfg.d_model, cfg.d_model), cfg.params_dtype,
                             device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "VisionFrontend":
        _normal_(self.merger, gen, self.merger.shape[0] ** -0.5)
        return self


def audio_frontend(p: AudioFrontend, cfg: ModelConfig,
                   frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, T, d) precomputed embeddings -> encoder input."""
    cdt = cfg.compute_dtype
    return frames.to(cdt) @ p.proj.to(cdt) + p.pos.to(cdt)[None]


def vision_frontend(p: VisionFrontend, cfg: ModelConfig,
                    patches: torch.Tensor) -> torch.Tensor:
    """patches: (B, T_img, d) precomputed embeddings -> backbone tokens."""
    cdt = cfg.compute_dtype
    return patches.to(cdt) @ p.merger.to(cdt)
