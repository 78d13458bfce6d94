"""Public wrapper: (B, S, H, hd) attention through the flash kernel
(counterpart of ``repro.kernels.flash.ops``), with the gradient of the
reference's hand-written VJP (``_flash_fwd`` / ``_flash_bwd`` in
``repro/models/attention.py``).

Flattens heads to head-major (B*H, S, hd) and scales q by ``hd ** -0.5`` in
q's dtype, as the reference does; the kernel masks the ragged edges itself,
so nothing is padded.  Dispatch (``FlashAttention``): CPU tensors take the
plain version (``ref.py``); CUDA tensors launch the Hopper kernel
(``kernel.py``), or raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from .kernel import flash_attention_kernel
from .ref import flash_ref

__all__ = ["flash_attention", "FlashAttention", "BLOCK_KV"]

# The kv block of the backward, the reference's.
BLOCK_KV = 1024
# The reference's mask value in ``_flash_bwd``.
_MASKED = -1e9


def _packed(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernel loads it."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


class FlashAttention(torch.autograd.Function):
    """The flash op at the head-major level: ``qf`` (BH, S, hd) already
    scaled, ``kf`` and ``vf`` (BH, T, hd).  Returns (BH, S, hd) in qf's
    dtype.

    Forward: the kernel on CUDA tensors, ``flash_ref`` on CPU tensors;
    when a gradient is wanted, both also give each row's logsumexp ``L``,
    and only (q, k, v, out, L) are kept.  Backward: a plain PyTorch port of
    ``_flash_bwd`` that recomputes each probability block ``p = exp(s -
    L)`` over kv blocks of ``block`` keys, under the same mask, every block
    included (the causal future is masked, not skipped, as in the
    reference), and sums dq over the blocks in order in f32: no atomics,
    so the same inputs give the same bits.  The block temporaries are
    updated in place (the reference's are new arrays) to hold the peak to
    two (BH, S, block) f32 slabs.
    """

    @staticmethod
    def forward(ctx, qf, kf, vf, causal: bool, window: Optional[int],
                block: int):
        need_lse = any(ctx.needs_input_grad[:3])
        if qf.device.type == "cpu":
            out = flash_ref(qf, kf, vf, causal=causal, window=window,
                            return_lse=need_lse)
        else:
            out = flash_attention_kernel(_packed(qf), _packed(kf),
                                         _packed(vf), causal=causal,
                                         window=window, return_lse=need_lse)
        if not need_lse:
            return out
        out, lse = out
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.causal, ctx.window, ctx.block = causal, window, block
        return out

    @staticmethod
    def backward(ctx, dout):
        qf, kf, vf, out, lse = ctx.saved_tensors
        causal, window, block = ctx.causal, ctx.window, ctx.block
        S, T = qf.shape[1], kf.shape[1]
        q32, dout = qf.float(), dout.float()
        # D_i = dout_i . out_i, the softmax jacobian's diagonal term.
        D = (dout * out.float()).sum(-1, keepdim=True)
        L = lse[..., None]
        qpos = torch.arange(S, device=qf.device)[:, None]
        dq = torch.zeros_like(q32)
        dks, dvs = [], []
        for k0 in range(0, T, block):
            kj = kf[:, k0:k0 + block].float()
            vj = vf[:, k0:k0 + block].float()
            kpos = torch.arange(k0, k0 + kj.shape[1], device=qf.device)[None]
            ok = torch.ones((S, kj.shape[1]), dtype=torch.bool,
                            device=qf.device)
            if causal:
                ok &= kpos <= qpos
            if window is not None:
                ok &= kpos > qpos - window
            p = torch.einsum("bsd,btd->bst", q32, kj)
            p.masked_fill_(~ok, _MASKED).sub_(L).exp_()     # exact probs
            dvs.append(torch.einsum("bst,bsd->btd", p, dout))
            ds = torch.einsum("bsd,btd->bst", dout, vj)      # dp
            ds.sub_(D).mul_(p)
            del p
            dq += torch.einsum("bst,btd->bsd", ds, kj)
            dks.append(torch.einsum("bst,bsd->btd", ds, q32))
        dk = torch.cat(dks, 1).to(kf.dtype)
        dv = torch.cat(dvs, 1).to(vf.dtype)
        return dq.to(qf.dtype), dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    """q: (B, S, H, hd); k/v: (B, T, H, hd) (heads already matched).
    Returns (B, S, H*hd) in q's dtype; its gradient is ``FlashAttention``'s
    in kv blocks of ``BLOCK_KV``."""
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

    out = FlashAttention.apply(tohm(q) * scale, tohm(k), tohm(v), causal,
                               window, BLOCK_KV)
    return out.reshape(B, H, S, hd).transpose(1, 2).reshape(B, S, H * hd)
