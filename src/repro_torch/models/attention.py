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

The reference's ``pshard`` hints and mesh head-padding are sharding; on one
card there is nothing to shard, so they are dropped.

The cache writes are in place: ``attention_decode`` and
``attention_extend`` write the new keys into the given cache's tensors and
return that cache, where the reference returns an updated copy.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..kernels.flash import flash_attention
from .config import ModelConfig
from .norms import RMSNorm, rmsnorm
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
    q = q.reshape(q.shape[:-1] + (h, hd))
    k = k.reshape(k.shape[:-1] + (kv, hd))
    v = v.reshape(v.shape[:-1] + (kv, hd))
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
        out = _attention_blockwise(q, kr, vr, causal=causal and not cross,
                                   window=window)
        return out.to(cdt) @ p.wo.to(cdt)
    scores = _gqa_scores(q, k, cfg).float()
    if not cross:
        mask = _mask_full(q.shape[1], T, causal=causal, window=window,
                          device=x.device)
        scores = scores + mask[None, None, None]
    w = torch.softmax(scores, dim=-1).to(cdt)
    out = _gqa_out(w, v)
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
    rows = torch.arange(B, device=x.device)
    cache.k[rows, slot] = k_new[:, 0].to(cache.k.dtype)
    cache.v[rows, slot] = v_new[:, 0].to(cache.v.dtype)
    scores = _gqa_scores(q, cache.k, cfg).float()           # (B,KV,G,1,L)
    kpos = torch.arange(L, device=x.device)[None, :]        # (1, L)
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
    out = _gqa_out(w, cache.v)
    return out @ p.wo.to(cfg.compute_dtype), cache


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
    q = (x @ p.wq.to(cdt)).reshape(x.shape[0], x.shape[1], h, hd)
    if cfg.qk_norm:
        q = rmsnorm(p.q_norm, q, cfg.norm_eps)
    scores = _gqa_scores(q, k, cfg).float()
    w = torch.softmax(scores, dim=-1).to(cdt)
    out = _gqa_out(w, v)
    return out @ p.wo.to(cdt)


def encoder_kv(p: Attention, cfg: ModelConfig, enc_out: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V of the encoder states, once a sequence (whisper
    decode): (B, T, KV, hd) each."""
    kv, hd = cfg.n_kv_heads, cfg.hd
    cdt = cfg.compute_dtype
    B = enc_out.shape[0]
    k = (enc_out @ p.wk.to(cdt)).reshape(B, -1, kv, hd)
    v = (enc_out @ p.wv.to(cdt)).reshape(B, -1, kv, hd)
    if cfg.qk_norm:
        k = rmsnorm(p.k_norm, k, cfg.norm_eps)
    return k, v
