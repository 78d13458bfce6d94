"""Plain PyTorch version of the flash-attention kernel (counterpart of
``repro.kernels.flash.ref``): dense masked softmax attention in f32."""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["flash_ref", "NEG_INF"]

NEG_INF = -1e30


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              T: Optional[int] = None, causal: bool = True,
              window: Optional[int] = None, return_lse: bool = False):
    """Dense masked attention.  q: (BH, Sq, hd); k/v: (BH, Sk, hd); keys
    at positions ``>= T`` are masked.  Returns (BH, Sq, hd) in q's dtype,
    and with ``return_lse`` also each row's logsumexp of the masked scores
    (BH, Sq) in f32, the kernel's ``lse``."""
    Sq, Sk = q.shape[1], k.shape[1]
    T = Sk if T is None else T
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float())
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = kpos < T
    if causal:
        ok = ok & (kpos <= qpos)
    if window is not None:
        ok = ok & (kpos > qpos - window)
    s = torch.where(ok[None], s, torch.tensor(NEG_INF, dtype=s.dtype,
                                              device=s.device))
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bqk,bkd->bqd", w, v.float()).to(q.dtype)
    return (o, torch.logsumexp(s, dim=-1)) if return_lse else o
