"""Public wrapper: (B, S, H, hd) attention through the flash kernel
(counterpart of ``repro.kernels.flash.ops``).

Flattens heads to head-major (B*H, S, hd) and scales q by ``hd ** -0.5`` in
q's dtype, as the reference does; the kernel masks the ragged edges itself,
so nothing is padded.  Dispatch: CPU tensors take the plain version
(``ref.py``); CUDA tensors launch the Hopper kernel (``kernel.py``), or
raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import flash_attention_kernel
from .ref import flash_ref

__all__ = ["flash_attention"]


def _packed(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernel loads it."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, T, H, hd) (heads already matched).
    Returns (B, S, H*hd) in q's dtype."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 \
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; need q "
                         f"(B, S, H, hd) and k = v (B, T, H, hd)")
    if not q.device == k.device == v.device:
        raise ValueError(f"flash_attention: q, k, v must share one device, "
                         f"got {q.device}, {k.device}, {v.device}")
    B, S, H, hd = q.shape
    scale = torch.tensor(hd ** -0.5, dtype=q.dtype, device=q.device)

    def tohm(t):
        return t.transpose(1, 2).reshape(B * H, t.shape[1], hd)

    qf, kf, vf = tohm(q) * scale, tohm(k), tohm(v)
    if q.device.type == "cpu":
        out = flash_ref(qf, kf, vf, causal=causal, window=window)
    else:
        out = flash_attention_kernel(_packed(qf), _packed(kf), _packed(vf),
                                     causal=causal, window=window)
    return out.reshape(B, H, S, hd).transpose(1, 2).reshape(B, S, H * hd)
