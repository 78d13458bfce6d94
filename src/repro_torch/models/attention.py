"""Grouped-query attention (counterpart of ``repro.models.attention``):

  * GQA with arbitrary (n_heads, n_kv_heads) — grouped einsum, no KV
    repeat on the dense path;
  * qk-norm (qwen3), QKV bias (qwen2), sliding window (h2o-danube);
  * causal / non-causal (whisper's encoder), cross-attention against
    encoder states (whisper's decoder: ``attention(..., xattn_kv=)``, and
    ``encoder_kv`` / ``cross_attention_decode`` for serving);
  * sequences longer than ``BLOCKWISE_THRESHOLD`` go through the flash
    kernel (``kernels.flash``), shorter ones through the dense masked path;
    the flash op carries the reference's hand-written VJP
    (``kernels.flash.FlashAttention``);
  * decode against a pre-allocated KV cache (one token per step, a ring
    buffer under a sliding window) and chunked prefill (``attention_extend``).

Under a mesh (``pshard.use_mesh``) the blockwise path lays q, k and v out
with heads over `model` and batch over the dp axes, and pads the heads
with zeros to a multiple of the `model` axis first when it does not
divide them (qwen2-7b's 28, qwen2-vl's 12 on a 16-wide axis), slicing the
padding off the output: the reference's head padding.  Without a mesh
neither happens.

The cache writes are in place: ``attention_decode`` and
``attention_extend`` write the new keys into the given cache's tensors and
return that cache, where the reference returns an updated copy.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..kernels.flash import flash_attention, map_heads
from .config import ModelConfig
from .norms import RMSNorm, rmsnorm
from .pshard import (as_dtensor, axis_sizes, current_mesh, hint, is_dtensor,
                     pad_dim, split_evenly, wrap)
from .rope import apply_rope

__all__ = ["Attention", "KVCache", "attention_init", "attention",
           "init_kv_cache", "attention_decode", "attention_extend",
           "cross_attention_decode", "encoder_kv", "BLOCKWISE_THRESHOLD",
           "NEG_INF"]

NEG_INF = -1e9

# Sequence length above which train/prefill attention switches to the
# blockwise online-softmax path: the flash kernel.
BLOCKWISE_THRESHOLD = 2048


class KVCache(NamedTuple):
    k: torch.Tensor           # (B, L, KV, hd)
    v: torch.Tensor           # (B, L, KV, hd)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Attention(nn.Module):
    """The reference's attention leaf dict as a module: ``wq``, ``wk``,
    ``wv``, ``wo``; ``bq``/``bk``/``bv`` with ``qkv_bias`` unless
    ``cross`` (a cross-attention has no qkv bias); ``q_norm`` and ``k_norm``
    with ``qk_norm``."""

    def __init__(self, cfg: ModelConfig, *, cross: bool = False,
                 device=None):
        super().__init__()
        d, hd = cfg.d_model, cfg.hd
        h, kv = cfg.n_heads, cfg.n_kv_heads
        pdt = cfg.params_dtype
        self.wq = _param((d, h * hd), pdt, device)
        self.wk = _param((d, kv * hd), pdt, device)
        self.wv = _param((d, kv * hd), pdt, device)
        self.wo = _param((h * hd, d), pdt, device)
        if cfg.qkv_bias and not cross:
            self.bq = _param((h * hd,), pdt, device)
            self.bk = _param((kv * hd,), pdt, device)
            self.bv = _param((kv * hd,), pdt, device)
        if cfg.qk_norm:
            self.q_norm = RMSNorm(hd, pdt, device)
            self.k_norm = RMSNorm(hd, pdt, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "Attention":
        d = self.wq.shape[0]
        for w in (self.wq, self.wk, self.wv):
            w.copy_(torch.randn(w.shape, generator=gen, device=w.device)
                    * d ** -0.5)
        self.wo.copy_(torch.randn(self.wo.shape, generator=gen,
                                  device=self.wo.device)
                      * self.wo.shape[0] ** -0.5)
        for name in ("bq", "bk", "bv"):
            if hasattr(self, name):
                getattr(self, name).zero_()
        return self


def attention_init(gen: torch.Generator, cfg: ModelConfig, *,
                   cross: bool = False, device=None) -> Attention:
    """An ``Attention`` drawn from ``gen`` with the reference's shapes and
    scales (``init_params`` fills each layer's in place the same way)."""
    return Attention(cfg, cross=cross, device=device).init_(gen)


def _project_qkv(p: Attention, cfg: ModelConfig, xq: torch.Tensor,
                 xkv: torch.Tensor):
    """Returns q (B,S,H,hd), k/v (B,T,KV,hd)."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cdt = cfg.compute_dtype
    q = xq @ p.wq.to(cdt)
    k = xkv @ p.wk.to(cdt)
    v = xkv @ p.wv.to(cdt)
    if hasattr(p, "bq"):
        q = q + p.bq.to(cdt)
        k = k + p.bk.to(cdt)
        v = v + p.bv.to(cdt)
    q = split_evenly(q, -1, h).reshape(q.shape[:-1] + (h, hd))
    k = split_evenly(k, -1, kv).reshape(k.shape[:-1] + (kv, hd))
    v = split_evenly(v, -1, kv).reshape(v.shape[:-1] + (kv, hd))
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm, q, cfg.norm_eps)
        k = rmsnorm(p.k_norm, k, cfg.norm_eps)
    return q, k, v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, cfg: ModelConfig
                ) -> torch.Tensor:
    """(B,S,H,hd) x (B,T,KV,hd) -> (B,KV,G,S,T) without repeating KV."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, s, kvh, g, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k)
    return scores * (hd ** -0.5)


def _gqa_out(weights: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B,KV,G,S,T) x (B,T,KV,hd) -> (B,S,H*hd)."""
    b, kvh, g, s, _ = weights.shape
    hd = v.shape[-1]
    out = torch.einsum("bkgst,btkh->bskgh", weights, v)
    return out.reshape(b, s, kvh * g * hd)


def _mask_full(s: int, t: int, *, causal: bool, window: Optional[int],
               q_offset=0, device=None) -> torch.Tensor:
    """(S, T) additive mask.  Query i sits at absolute position q_offset+i."""
    qpos = torch.arange(s, device=device)[:, None] + q_offset
    kpos = torch.arange(t, device=device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        ok &= kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _attention_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: Optional[int]
                         ) -> torch.Tensor:
    """Flash attention: q (B, S, H, hd); k/v (B, T, H, hd), KV already
    repeated to full heads.  Returns (B, S, H*hd) in f32.

    The reference scans kv blocks with an online softmax in jnp under a
    custom VJP; here it is the flash op, run by the hand-written kernel on
    the card, with the same VJP (its backward in kv blocks of
    ``kernels.flash.BLOCK_KV``).  q goes in as f32 and unscaled: the op
    scales it by hd^-0.5 in f32, the reference's ``q.astype(f32) *
    hd ** -0.5``, once."""
    return flash_attention(q.float(), k, v, causal=causal, window=window)


def _padded_heads(H: int) -> int:
    """H rounded up to a multiple of the active mesh's `model` axis (H
    itself without a mesh or without that axis)."""
    mesh = current_mesh()
    if mesh is None:
        return H
    ms = axis_sizes(mesh).get("model", 1)
    return -(-H // ms) * ms


def _repeat_kv(t: torch.Tensor, g: int) -> torch.Tensor:
    """(B, T, KV, hd) -> (B, T, KV*g, hd), each kv head ``g`` times in a
    row (``repeat_interleave`` on dim 2) as a broadcast, whose gradient is
    a sum over the copies rather than an index_add with atomics."""
    B, T, KV, hd = t.shape
    return t[:, :, :, None].expand(B, T, KV, g, hd).reshape(B, T, KV * g, hd)


def attention(p: Attention, cfg: ModelConfig, x: torch.Tensor,
              cos: Optional[torch.Tensor], sin: Optional[torch.Tensor], *,
              causal: bool = True,
              xattn_kv: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention (train / prefill).  ``xattn_kv`` switches to
    cross-attention against encoder states (no mask, no rope); a ``cos``
    of None means no rope.  Long key sequences take the blockwise path
    (the flash kernel)."""
    cdt = cfg.compute_dtype
    cross = xattn_kv is not None
    q, k, v = _project_qkv(p, cfg, x, xattn_kv if cross else x)
    if not cross and cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    T = k.shape[1]
    window = None if cross else cfg.sliding_window
    if T > BLOCKWISE_THRESHOLD:
        g = cfg.n_heads // cfg.n_kv_heads
        kr, vr = _repeat_kv(k, g), _repeat_kv(v, g)     # KV -> H heads
        H = q.shape[2]
        Hp = _padded_heads(H)
        if Hp != H:
            # Zero heads are exact: q = k = v = 0 gives a uniform softmax
            # over zero values, a zero output, sliced off below.
            q, kr, vr = (pad_dim(t, 2, Hp - H) for t in (q, kr, vr))
        q, kr, vr = (hint(t, "dp", None, "model", None) for t in (q, kr, vr))
        out = _attention_blockwise(q, kr, vr, causal=causal and not cross,
                                   window=window)
        if Hp != H:
            out = out[..., :H * cfg.hd]
        return out.to(cdt) @ p.wo.to(cdt)
    def dense(q, k, v):
        scores = _gqa_scores(q, k, cfg).float()
        if not cross:
            mask = _mask_full(q.shape[1], T, causal=causal, window=window,
                              device=x.device)
            scores = scores + mask[None, None, None]
        w = torch.softmax(scores, dim=-1).to(cdt)
        return _gqa_out(w, v)

    # Under a mesh each rank attends over its own batch rows and heads.
    out = map_heads(dense, q, k, v) if is_dtensor(q) else dense(q, k, v)
    return out @ p.wo.to(cdt)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device=None) -> KVCache:
    """Decode cache.  SWA archs cap the cache at the window size."""
    if cfg.sliding_window is not None:
        max_len = min(max_len, cfg.sliding_window)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return KVCache(k=torch.zeros(shape, dtype=cfg.compute_dtype,
                                 device=device),
                   v=torch.zeros(shape, dtype=cfg.compute_dtype,
                                 device=device))


def attention_decode(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                     pos: torch.Tensor, cache: KVCache,
                     cos: Optional[torch.Tensor], sin: Optional[torch.Tensor],
                     ) -> tuple[torch.Tensor, KVCache]:
    """One decode step.  ``x``: (B, 1, d); ``pos``: (B,) absolute position
    PER SEQUENCE (continuous batching: slots decode at different depths).

    With a sliding window the cache is a ring buffer of size ``window``;
    masking handles both the not-yet-filled and the wrapped cases.
    """
    B = x.shape[0]
    q, k_new, v_new = _project_qkv(p, cfg, x, x)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
    L = cache.k.shape[1]
    pos = pos.long()
    slot = pos if cfg.sliding_window is None else pos % L     # (B,)
    if is_dtensor(cache.k):
        out = _decode_sharded(cfg, q, k_new, v_new, pos, slot, cache)
        return out @ p.wo.to(cfg.compute_dtype), cache
    rows = torch.arange(B, device=x.device)
    cache.k[rows, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[rows, slot] = v_new[:, 0].to(cache.v.dtype)
    out = _decode_attend(cfg, q, pos, cache.k, cache.v)
    return out @ p.wo.to(cfg.compute_dtype), cache


def _decode_attend(cfg: ModelConfig, q, pos, k, v) -> torch.Tensor:
    """The decode step's attention of q (B, 1, H, hd) over a whole cache
    k, v (B, L, KV, hd): (B, 1, H*hd)."""
    L = k.shape[1]
    scores = _gqa_scores(q, k, cfg).float()                 # (B,KV,G,1,L)
    kpos = torch.arange(L, device=q.device)[None, :]        # (1, L)
    posb = pos[:, None]                                     # (B, 1)
    if cfg.sliding_window is None:
        ok = kpos <= posb
    else:
        # Ring buffer of size L == min(window, max_len): slot s holds
        # absolute position pos - ((pos - s) mod L), always within the
        # window; it is invalid only when nothing was written there yet.
        ok = torch.remainder(posb - kpos, L) <= posb
    mask = torch.where(ok, 0.0, NEG_INF).to(torch.float32)
    scores = scores + mask[:, None, None, None, :]
    w = torch.softmax(scores, dim=-1).to(cfg.compute_dtype)
    return _gqa_out(w, v)


def _decode_sharded(cfg: ModelConfig, q, k_new, v_new, pos, slot,
                    cache: KVCache):
    """``attention_decode``'s write and attention on a laid-out cache
    (``launch.sharding.cache_specs``: batch over the dp axes, the key
    sequence over `model`, or over every axis when the batch cannot
    split), on each rank's local block.  The new key lands on the rank
    that holds its slot (a select, in place); each rank takes the softmax
    of its keys and their statistics, and the maximum, the normalizer and
    the weighted values are reduced over the sequence's mesh axes (the
    reference leaves the same reductions to GSPMD).  Returns (B, 1, H*hd)
    laid out as the cache's batch."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import Replicate
    mesh = cache.k.device_mesh
    pl = [p if p.is_shard(0) else Replicate() for p in cache.k.placements]
    seq_dims = [i for i, p in enumerate(cache.k.placements) if p.is_shard(1)]
    q, k_new, v_new, pos, slot = (
        as_dtensor(t, mesh).redistribute(mesh, pl).to_local()
        for t in (q, k_new, v_new, pos, slot))
    ck, cv = cache.k.to_local(), cache.v.to_local()
    L, Ll = cache.k.shape[1], ck.shape[1]
    B = cache.k.shape[0]
    W = cfg.n_heads * cfg.hd
    chunk = 0
    coord = mesh.get_coordinate()
    for i in seq_dims:                       # major to minor, as DTensor
        chunk = chunk * mesh.size(i) + coord[i]
    kpos = chunk * Ll + torch.arange(Ll, device=ck.device)    # global slots
    hit = (kpos[None, :] == slot[:, None])[:, :, None, None]
    ck.copy_(torch.where(hit, k_new.to(ck.dtype), ck))
    cv.copy_(torch.where(hit, v_new.to(cv.dtype), cv))
    scores = _gqa_scores(q, ck, cfg).float()                  # (b,KV,G,1,Ll)
    posb = pos[:, None]
    if cfg.sliding_window is None:
        ok = kpos[None, :] <= posb
    else:
        ok = torch.remainder(posb - kpos[None, :], L) <= posb
    scores = scores + torch.where(ok, 0.0, NEG_INF).to(torch.float32)[
        :, None, None, None, :]

    def reduce(t, op):
        for i in seq_dims:
            if mesh.size(i) > 1:
                t = funcol.all_reduce(t, op, (mesh, i))
        return t

    # Each rank's softmax over its keys (torch's own arithmetic), scaled
    # by its share of the whole normalizer, l_r exp(m_r - m) / sum: where
    # the sequence is whole the share is l / l, exactly 1, so the weights
    # are ``_decode_attend``'s bits.
    m_r = scores.amax(-1, keepdim=True)
    l_r = torch.exp(scores - m_r).sum(-1, keepdim=True)
    c = l_r * torch.exp(m_r - reduce(m_r, "max"))
    w = torch.softmax(scores, dim=-1) * (c / reduce(c, "sum"))
    out = reduce(_gqa_out(w.to(cfg.compute_dtype), cv), "sum")
    return wrap(out, mesh, pl, (B, 1, W))


def attention_extend(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                     pos0: int, cache: KVCache,
                     cos: Optional[torch.Tensor], sin: Optional[torch.Tensor],
                     ) -> tuple[torch.Tensor, KVCache]:
    """One CHUNK of prefill against a partially-filled cache: ``x`` is
    (B, S, d) at absolute positions ``[pos0, pos0 + S)``; the cache already
    holds keys for ``[0, pos0)``.  Dense: each chunk attends to the cached
    prefix and (causally) to itself.  No sliding-window support: SWA archs
    keep the one-shot prefill.
    """
    S = x.shape[1]
    q, k_new, v_new = _project_qkv(p, cfg, x, x)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k_new = apply_rope(k_new, cos, sin)
    L = cache.k.shape[1]
    if not 0 <= pos0 <= L - S:
        raise ValueError(f"chunk at pos0={pos0} of {S} tokens does not fit "
                         f"the cache of max_len={L}")
    cache.k[:, pos0:pos0 + S] = k_new.to(cache.k.dtype)
    cache.v[:, pos0:pos0 + S] = v_new.to(cache.v.dtype)
    scores = _gqa_scores(q, cache.k, cfg).float()            # (B,KV,G,S,L)
    # Query i (absolute pos0 + i) sees keys at kpos <= pos0 + i; slots past
    # the chunk are unwritten but masked by the same causal predicate.
    mask = _mask_full(S, L, causal=True, window=None, q_offset=pos0,
                      device=x.device)
    scores = scores + mask[None, None, None]
    w = torch.softmax(scores, dim=-1).to(cfg.compute_dtype)
    out = _gqa_out(w, cache.v)
    return out @ p.wo.to(cfg.compute_dtype), cache


def cross_attention_decode(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                           enc_kv: tuple[torch.Tensor, torch.Tensor]
                           ) -> torch.Tensor:
    """Decoder cross-attention against precomputed encoder K/V (whisper).
    x: (B, S, d); enc_kv: k and v (B, T, KV, hd)."""
    k, v = enc_kv
    h, hd = cfg.n_heads, cfg.hd
    cdt = cfg.compute_dtype
    q = split_evenly(x @ p.wq.to(cdt), -1, h).reshape(
        x.shape[0], x.shape[1], h, hd)
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm, q, cfg.norm_eps)

    def dense(q, k, v):
        scores = _gqa_scores(q, k, cfg).float()
        w = torch.softmax(scores, dim=-1).to(cdt)
        return _gqa_out(w, v)

    out = map_heads(dense, q, k, v) if is_dtensor(q) else dense(q, k, v)
    return out @ p.wo.to(cdt)


def encoder_kv(p: Attention, cfg: ModelConfig, enc_out: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V of the encoder states, once a sequence (whisper
    decode): (B, T, KV, hd) each."""
    kv, hd = cfg.n_kv_heads, cfg.hd
    cdt = cfg.compute_dtype
    B = enc_out.shape[0]
    k = split_evenly(enc_out @ p.wk.to(cdt), -1, kv).reshape(B, -1, kv, hd)
    v = split_evenly(enc_out @ p.wv.to(cdt), -1, kv).reshape(B, -1, kv, hd)
    if cfg.qk_norm:
        k = rmsnorm(p.k_norm, k, cfg.norm_eps)
    return k, v
