"""Rotary position embeddings, including qwen2-vl's multimodal M-RoPE
(counterpart of ``repro.models.rope``).

M-RoPE splits the head-dim rotation frequencies into (temporal, height,
width) sections, each driven by its own position id.  For text tokens the
three ids coincide, which makes plain RoPE a special case: the backbone
always runs the M-RoPE tables when ``cfg.mrope`` and gets the same numbers
for text-only inputs."""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["rope_freqs", "rope_cos_sin", "mrope_cos_sin", "apply_rope",
           "text_positions", "text_mrope_positions"]


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), f32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer ``positions`` (..., S) -> (..., S, hd//2)."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def mrope_cos_sin(positions3: torch.Tensor, head_dim: int, theta: float,
                  sections: Tuple[int, ...]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """M-RoPE tables.  ``positions3``: (3, B, S) (t, h, w) ids.

    ``sections`` partitions the hd//2 frequency slots; slot ranges take
    their angle from the matching positional axis."""
    if sum(sections) != head_dim // 2:
        raise ValueError(f"mrope sections {tuple(sections)} must sum to "
                         f"head_dim // 2 = {head_dim // 2}")
    cos_t, sin_t = rope_cos_sin(positions3, head_dim, theta)  # (3,B,S,hd//2)
    pieces_c, pieces_s = [], []
    off = 0
    for axis, width in enumerate(sections):
        pieces_c.append(cos_t[axis, ..., off:off + width])
        pieces_s.append(sin_t[axis, ..., off:off + width])
        off += width
    return torch.cat(pieces_c, dim=-1), torch.cat(pieces_s, dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotate ``x`` (B, S, H, hd) by tables (B, S, hd//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def text_positions(batch: int, seq: int, offset=0, device=None
                   ) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    return pos.expand(batch, seq)


def text_mrope_positions(batch: int, seq: int, offset=0, device=None
                         ) -> torch.Tensor:
    """(3, B, S) with t == h == w: text-only M-RoPE ids."""
    return text_positions(batch, seq, offset, device)[None].expand(
        3, batch, seq)
