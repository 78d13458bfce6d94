"""Public wrapper: (B, S, H, hd) attention through the flash kernel
(counterpart of ``repro.kernels.flash.ops``), with the gradient of the
reference's hand-written VJP (``_flash_fwd`` / ``_flash_bwd`` in
``repro/models/attention.py``).

Flattens heads to head-major (B*H, S, hd) and scales q by ``hd ** -0.5`` in
q's dtype, as the reference does; the kernel masks the ragged edges itself,
so nothing is padded.  Dispatch (``FlashAttention``): CPU tensors take the
plain version (``ref.py``); CUDA tensors launch the Hopper kernel
(``kernel.py``), or raise.

The forward is the custom op ``repro_torch::flash_fwd``, whose fake kernel
gives the output's and the logsumexp's shapes alone: a dry-run under
``FakeTensorMode`` counts no S x S scores, and ``FLOPS`` is its formula
for ``torch.utils.flop_counter`` (the score and value products of the
(query, key) pairs the mask admits).

DTensors: ``flash_attention`` runs the kernel on each rank's local shard
(heads and batch are independent, so no collective), after laying q, k
and v out alike with only their batch and head dims sharded; the output
carries the same placements.  ``FlashAttention`` itself takes local
tensors and refuses a DTensor.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from ..common import is_dtensor, refuse_dtensor
from .kernel import flash_attention_kernel
from .ref import flash_ref

__all__ = ["flash_attention", "FlashAttention", "BLOCK_KV", "flash_fwd",
           "flash_flops", "map_heads"]

# The kv block of the backward, the reference's.
BLOCK_KV = 1024
# The reference's mask value in ``_flash_bwd``.
_MASKED = -1e9


def _packed(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned, as the kernel loads it."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=())
def flash_fwd(qf: torch.Tensor, kf: torch.Tensor, vf: torch.Tensor,
              causal: bool, window: Optional[int], need_lse: bool
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward at the head-major level: (out, lse), lse empty unless
    ``need_lse``.  CPU tensors: ``flash_ref``; CUDA tensors: the kernel."""
    if qf.device.type == "cpu":
        out = flash_ref(qf, kf, vf, causal=causal, window=window,
                        return_lse=need_lse)
    else:
        out = flash_attention_kernel(_packed(qf), _packed(kf), _packed(vf),
                                     causal=causal, window=window,
                                     return_lse=need_lse)
    return out if need_lse else (out, qf.new_empty((0,), dtype=torch.float32))


@flash_fwd.register_fake
def _flash_fwd_fake(qf, kf, vf, causal, window, need_lse):
    lse_shape = qf.shape[:2] if need_lse else (0,)
    return torch.empty_like(qf), qf.new_empty(lse_shape, dtype=torch.float32)


def _admitted_pairs(S: int, T: int, causal: bool, window) -> int:
    """(query, key) pairs the mask admits: key < T, key <= query
    (causal), key > query - window."""
    s = np.arange(S, dtype=np.int64)
    hi = np.minimum(T, s + 1) if causal else np.full(S, T, dtype=np.int64)
    lo = np.maximum(0, s - window + 1) if window is not None else 0
    return int(np.maximum(0, hi - lo).sum())


def flash_flops(qf_shape, kf_shape, causal: bool, window) -> int:
    """The forward's multiply-adds, two operations each: q k^T and p v over
    the admitted (query, key) pairs."""
    bh, S, hd = qf_shape
    return 4 * bh * hd * _admitted_pairs(S, kf_shape[1], causal, window)


@register_flop_formula(torch.ops.repro_torch.flash_fwd, get_raw=True)
def _flash_fwd_flops(qf, kf, vf, causal, window, need_lse, *args,
                     out_val=None, **kwargs):
    return flash_flops(tuple(qf.shape), tuple(kf.shape), causal, window)


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
        refuse_dtensor("flash", qf, kf, vf)
        need_lse = any(ctx.needs_input_grad[:3])
        out, lse = flash_fwd(qf, kf, vf, causal, window, need_lse)
        if not need_lse:
            return out
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
    if any(is_dtensor(t) for t in (q, k, v)):
        return map_heads(lambda ql, kl, vl: flash_attention(
            ql, kl, vl, causal=causal, window=window), q, k, v)
    B, S, H, hd = q.shape
    scale = torch.tensor(hd ** -0.5, dtype=q.dtype, device=q.device)

    def tohm(t):
        return t.transpose(1, 2).reshape(B * H, t.shape[1], hd)

    out = FlashAttention.apply(tohm(q) * scale, tohm(k), tohm(v), causal,
                               window, BLOCK_KV)
    return out.reshape(B, H, S, hd).transpose(1, 2).reshape(B, S, H * hd)


def map_heads(fn, q, k, v):
    """``fn(q, k, v) -> (B, S, Hq * d)`` run on each rank's local shards
    of DTensors q (B, S, Hq, hd), k and v (B, T, Hk, hd) (plain ones count
    as replicated).  q, k and v are laid out as q is on its batch (0) and
    head (2) dims, every other placement of q made Replicate, and a split
    that does not divide the batch or the ``Hk`` heads (whole groups of
    q's) replicated too; no collective beyond that layout.  The output is
    a DTensor of those placements (its head-major last dim splits with
    the heads)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = next(t.device_mesh for t in (q, k, v) if is_dtensor(t))
    rep = [Replicate()] * mesh.ndim
    q, k, v = (t if is_dtensor(t) else
               DTensor.from_local(t, mesh, rep, run_check=False)
               for t in (q, k, v))
    split = {0: 1, 2: 1}
    pl = []
    for i, p in enumerate(q.placements):
        keep = p.is_shard() and p.dim in split
        pl.append(p if keep else Replicate())
        if keep:
            split[p.dim] *= mesh.size(i)
    for d, units in ((0, q.shape[0]), (2, k.shape[2])):
        if units % split[d]:
            pl = [Replicate() if p.is_shard(d) else p for p in pl]
            split[d] = 1
    q, k, v = (t.redistribute(mesh, pl) for t in (q, k, v))
    out = fn(q.to_local(), k.to_local(), v.to_local())
    B, S = q.shape[:2]
    W = out.shape[-1] * split[2]
    return DTensor.from_local(out, mesh, pl, run_check=False,
                              shape=torch.Size((B, S, W)),
                              stride=(S * W, W, 1))
