"""The LM: every architecture of the reference behind one API: attention,
Mamba and xLSTM mixers, dense or MoE FFNs, whisper's encoder-decoder and
qwen2-vl's vision stub with M-RoPE (counterpart of
``repro.models.transformer``).

The reference stacks each pattern position's parameters across its
superblocks and walks the stack with ``lax.scan``; here the model is an
``nn.Module``, a ``Transformer`` with one ``Block`` per layer, walked by a
Python loop.  Layer ``i``'s mixer is attention, Mamba, mLSTM or sLSTM as
``cfg.layer_kind(i)`` says (jamba: attention at ``i % 8 == 4``; xlstm:
sLSTM at ``cfg.slstm_at``).  Attention and Mamba layers have an FFN
sublayer, ``moe`` where ``cfg.layer_is_moe(i)``, else ``mlp`` (GELU under
``cfg.encdec``, SwiGLU otherwise); an xLSTM layer carries its own up and
down projections and has none.  Where ``cfg.encdec`` (whisper) every norm
is a LayerNorm, each decoder block adds ``ln_x`` and a ``cross``
attention, and the model has an audio ``frontend``, ``enc_blocks``
(non-causal attention, no rope) and ``enc_norm``; where ``cfg.family ==
"vlm"`` (qwen2-vl) it has a vision ``frontend`` whose patch embeddings are
added to the token embeddings, and ``cfg.mrope`` turns the rope tables to
M-RoPE's (t, h, w) sections.

Parameter names follow the reference's tree (``embed.tok``,
``blocks.<i>.ln1.scale``, ``blocks.<i>.mixer.wq`` or ``.in_proj`` or
``.up_proj`` or ``.w_in``, ``blocks.<i>.mlp.w_up`` or
``blocks.<i>.moe.w_up``, ``blocks.<i>.cross.wq``, ``final_norm.scale``,
``lm_head``, ``frontend.proj``, ``enc_blocks``, ``enc_norm``), so
``params_from_jax`` and ``params_to_numpy`` carry weights across by name:
the reference's pattern position ``i % p`` at superblock ``i // p`` is
the port's layer ``i``, for a pattern period ``p`` (``pattern_period``),
and its encoder stack's index ``j`` the port's ``enc_blocks[j]``.

Public surface:
  init_params                       -- random init from a seed or generator
  forward                           -- logits over a full sequence
  loss_fn                           -- next-token CE (+ z-loss) for training
  prefill / prefill_chunk / decode_step -- with per-layer caches: a KVCache
                                       per attention layer, a MambaState,
                                       MLSTMState or SLSTMState per
                                       recurrent layer, and under encdec
                                       the encoder's cross K/V per layer
  init_caches, supports_chunked_prefill
  params_shape / caches_shape       -- the model and the caches on the
                                       ``meta`` device: the dry-run's
                                       stand-ins, allocating nothing
  layer_signature, pattern_period, pattern, n_superblocks
  params_from_jax / params_to_numpy -- the reference's tree <-> the module

The serving functions run under ``torch.inference_mode``;
``prefill_chunk`` and ``decode_step`` write into the caches they are
given, in place, and return them.

Parameters are created with ``requires_grad=False``: serving needs no
graph.  Training turns them on (``launch.steps.init_train_state``);
``forward`` and ``loss_fn`` then build the graph, with each block
recomputed in the backward under ``cfg.remat`` (the reference's
``jax.checkpoint``).
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.rng import as_generator, check_device
from . import attention as attn_mod
from . import mamba as mamba_mod
from . import xlstm as xlstm_mod
from .attention import Attention, KVCache
from .config import ATTN, MAMBA, MLSTM, SLSTM, ModelConfig
from .frontend import (AudioFrontend, VisionFrontend, audio_frontend,
                       vision_frontend)
from .mamba import Mamba
from .mlp import GeluMLP, SwiGLU, mlp
from .moe import MoE, MoEAux, moe_ffn
from .norms import LayerNorm, RMSNorm, layernorm, rmsnorm
from .pshard import (as_dtensor, compute_params, hint, is_dtensor, pad_dim,
                     wrap)
from .rope import (mrope_cos_sin, rope_cos_sin, text_mrope_positions,
                   text_positions)
from .xlstm import MLSTM as MLSTMMixer
from .xlstm import SLSTM as SLSTMMixer

__all__ = ["Block", "Transformer", "MoEAux", "init_params", "forward",
           "loss_fn", "MOE_AUX_COEF", "Z_LOSS_COEF",
           "embed_tokens", "lm_logits", "init_caches", "prefill",
           "supports_chunked_prefill", "prefill_chunk", "decode_step",
           "params_from_jax", "params_to_numpy", "params_shape",
           "caches_shape", "layer_signature", "pattern_period", "pattern",
           "n_superblocks"]


MOE_AUX_COEF = 0.01
Z_LOSS_COEF = 1e-4

# The mixer module of each layer kind.
_MIXERS = {ATTN: Attention, MAMBA: Mamba, MLSTM: MLSTMMixer,
           SLSTM: SLSTMMixer}
# (forward, prefill, decode) of each recurrent mixer; attention's take
# rope tables and a KV cache instead.
_RECURRENT = {
    Mamba: (mamba_mod.mamba_forward, mamba_mod.mamba_prefill,
            mamba_mod.mamba_decode),
    MLSTMMixer: (xlstm_mod.mlstm_forward, xlstm_mod.mlstm_prefill,
                 xlstm_mod.mlstm_decode),
    SLSTMMixer: (xlstm_mod.slstm_forward, xlstm_mod.slstm_prefill,
                 xlstm_mod.slstm_decode)}


# ---------------------------------------------------------------- pattern

def layer_signature(cfg: ModelConfig, i: int) -> tuple[str, bool]:
    return (cfg.layer_kind(i), cfg.layer_is_moe(i))


def pattern_period(cfg: ModelConfig) -> int:
    """The least ``p`` dividing ``n_layers`` with every layer's signature
    that of layer ``i % p``: the reference's stacking period."""
    sigs = [layer_signature(cfg, i) for i in range(cfg.n_layers)]
    for p in range(1, cfg.n_layers + 1):
        if cfg.n_layers % p == 0 and all(
                sigs[i] == sigs[i % p] for i in range(cfg.n_layers)):
            return p
    return cfg.n_layers


def pattern(cfg: ModelConfig) -> tuple[tuple[str, bool], ...]:
    p = pattern_period(cfg)
    return tuple(layer_signature(cfg, i) for i in range(p))


def n_superblocks(cfg: ModelConfig) -> int:
    return cfg.n_layers // pattern_period(cfg)


def _norm_module(cfg: ModelConfig, device):
    """LayerNorm (scale and bias) under ``cfg.encdec``, else RMSNorm."""
    cls = LayerNorm if cfg.encdec else RMSNorm
    return cls(cfg.d_model, cfg.params_dtype, device)


class Block(nn.Module):
    """One layer of signature ``(kind, is_moe)``: ``ln1`` and the
    ``mixer`` (``Attention``, ``Mamba``, ``MLSTM`` or ``SLSTM``); with
    ``cross`` (whisper's decoder) ``ln_x`` and a ``cross`` attention; for
    an attention or Mamba mixer ``ln2`` and the FFN, ``moe`` if
    ``is_moe``, else ``mlp``.  An xLSTM mixer carries its own projections
    and has no FFN sublayer."""

    def __init__(self, cfg: ModelConfig, kind: str, is_moe: bool, *,
                 cross: bool = False, device=None):
        super().__init__()
        self.ln1 = _norm_module(cfg, device)
        self.mixer = _MIXERS[kind](cfg, device=device)
        if cross:
            self.ln_x = _norm_module(cfg, device)
            self.cross = Attention(cfg, cross=True, device=device)
        if kind in (ATTN, MAMBA):
            self.ln2 = _norm_module(cfg, device)
            if is_moe:
                self.moe = MoE(cfg, device=device)
            else:
                cls = GeluMLP if cfg.encdec else SwiGLU
                self.mlp = cls(cfg.d_model, cfg.d_ff, cfg.params_dtype,
                               device)

    @property
    def ffn(self):
        """The FFN sublayer, or None for an xLSTM layer."""
        return getattr(self, "moe", getattr(self, "mlp", None))


class Embed(nn.Module):
    def __init__(self, vocab: int, d: int, dtype, device=None):
        super().__init__()
        self.tok = nn.Parameter(torch.empty((vocab, d), dtype=dtype,
                                            device=device),
                                requires_grad=False)


class Transformer(nn.Module):
    """The model: ``embed.tok`` (padded vocab, d), ``blocks``,
    ``final_norm`` and, without tied embeddings, ``lm_head`` (d, padded
    vocab); under ``cfg.encdec`` also ``frontend`` (audio),
    ``enc_blocks`` and ``enc_norm``, and for the vlm family ``frontend``
    (vision).  Its tensors are uninitialized until ``init_params`` or
    ``params_from_jax`` fills them."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        pdt = cfg.params_dtype
        d, Vp = cfg.d_model, cfg.padded_vocab
        self.embed = Embed(Vp, d, pdt, device)
        self.blocks = nn.ModuleList(
            Block(cfg, *layer_signature(cfg, i), cross=cfg.encdec,
                  device=device) for i in range(cfg.n_layers))
        self.final_norm = _norm_module(cfg, device)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty((d, Vp), dtype=pdt,
                                                    device=device),
                                        requires_grad=False)
        if cfg.encdec:
            self.frontend = AudioFrontend(cfg, device=device)
            self.enc_blocks = nn.ModuleList(
                Block(cfg, ATTN, False, device=device)
                for _ in range(cfg.n_encoder_layers))
            self.enc_norm = _norm_module(cfg, device)
        if cfg.family == "vlm":
            self.frontend = VisionFrontend(cfg, device=device)

    def forward(self, tokens: torch.Tensor, **kw):
        return forward(self, self.cfg, tokens, **kw)


@torch.no_grad()
def _init_block(blk: Block, gen: torch.Generator) -> None:
    blk.mixer.init_(gen)
    if hasattr(blk, "cross"):
        blk.cross.init_(gen)
    if blk.ffn is not None:
        blk.ffn.init_(gen)


@torch.no_grad()
def init_params(gen_or_seed, cfg: ModelConfig, *,
                device="cuda") -> Transformer:
    """A model with the reference's shapes and scales, drawn from
    ``gen_or_seed`` (an int seed or a generator on ``device``).  Norms are
    ones (and LayerNorm biases zeros) from construction."""
    dev = check_device(device)
    gen = as_generator(gen_or_seed, dev)
    model = Transformer(cfg, device=dev)
    d = cfg.d_model
    for blk in model.blocks:
        _init_block(blk, gen)
    model.embed.tok.copy_(torch.randn(model.embed.tok.shape, generator=gen,
                                      device=dev) * d ** -0.5)
    if not cfg.tie_embeddings:
        model.lm_head.copy_(torch.randn(model.lm_head.shape, generator=gen,
                                        device=dev) * d ** -0.5)
    if hasattr(model, "frontend"):
        model.frontend.init_(gen)
    for blk in getattr(model, "enc_blocks", ()):
        _init_block(blk, gen)
    return model


def params_shape(cfg: ModelConfig) -> Transformer:
    """The model on the ``meta`` device: every parameter's shape and dtype,
    nothing allocated (the reference's ``jax.eval_shape`` stand-in)."""
    return Transformer(cfg, device="meta")


# ---------------------------------------------------------------- forward

def _rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    if cfg.mrope:
        return mrope_cos_sin(positions, cfg.hd, cfg.rope_theta,
                             cfg.mrope_sections)
    return rope_cos_sin(positions, cfg.hd, cfg.rope_theta)


def _default_positions(cfg: ModelConfig, B: int, S: int, device):
    return (text_mrope_positions(B, S, device=device) if cfg.mrope
            else text_positions(B, S, device=device))


def _norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    if isinstance(p, LayerNorm):
        return layernorm(p, x, cfg.norm_eps)
    return rmsnorm(p, x, cfg.norm_eps)


def embed_tokens(params: Transformer, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    if is_dtensor(params.embed.tok):
        return _embed_sharded(params.embed.tok, tokens).to(cfg.compute_dtype)
    return params.embed.tok[tokens.long()].to(cfg.compute_dtype)


def _embed_sharded(tok, tokens):
    """The lookup under a mesh, on each rank's own tokens (batch over dp)
    against the whole table, the same gather as without one; the table's
    gradient is a partial sum over the axes that split the batch.
    DTensor's own index backward fails on a laid-out table."""
    from torch.distributed.tensor import Partial, Replicate
    mesh = tok.device_mesh
    tokens = as_dtensor(hint(tokens, "dp", None), mesh)
    pl = [q if q.is_shard(0) else Replicate() for q in tokens.placements]
    tokens = tokens.redistribute(mesh, pl)
    table = tok.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if q.is_shard(0) else Replicate()
                         for q in pl])
    out = table[tokens.to_local().long()]
    return wrap(out, mesh, pl, tuple(tokens.shape) + (tok.shape[1],))


def lm_logits(params: Transformer, cfg: ModelConfig,
              x: torch.Tensor) -> torch.Tensor:
    head = params.embed.tok.T if cfg.tie_embeddings else params.lm_head
    return x.float() @ head.float()


def _ffn(cfg: ModelConfig, bp: Block, x, group_size=None):
    """The block's FFN sublayer on ``x``: (output, MoEAux or None)."""
    h = _norm(cfg, bp.ln2, x)
    if hasattr(bp, "moe"):
        return moe_ffn(bp.moe, cfg, h, group_size=group_size)
    return mlp(bp.mlp, cfg, h), None


def _mixer_forward(cfg: ModelConfig, bp: Block, h, cos, sin):
    if type(bp.mixer) in _RECURRENT:
        return _RECURRENT[type(bp.mixer)][0](bp.mixer, cfg, h)
    return attn_mod.attention(bp.mixer, cfg, h, cos, sin, causal=True)


def _sublayers(cfg: ModelConfig, bp: Block, x, enc_out, group_size=None):
    """What follows the mixer: the cross-attention (against ``enc_out``)
    and the FFN.  Returns (x, MoEAux or None)."""
    if hasattr(bp, "cross") and enc_out is not None:
        h = _norm(cfg, bp.ln_x, x)
        x = x + attn_mod.attention(bp.cross, cfg, h, None, None,
                                   xattn_kv=enc_out)
    if bp.ffn is None:
        return x, None
    h, aux = _ffn(cfg, bp, x, group_size)
    return x + h, aux


def _block_forward(cfg: ModelConfig, bp: Block, x, cos, sin, enc_out=None):
    with compute_params(bp):
        x = x + _mixer_forward(cfg, bp, _norm(cfg, bp.ln1, x), cos, sin)
        return _sublayers(cfg, bp, x, enc_out)


def _enc_block(cfg: ModelConfig, bp: Block, x):
    with compute_params(bp):
        x = x + attn_mod.attention(bp.mixer, cfg, _norm(cfg, bp.ln1, x),
                                   None, None, causal=False)
        return _sublayers(cfg, bp, x, None)[0]


def _encode(params: Transformer, cfg: ModelConfig, frames: torch.Tensor,
            remat: bool = False) -> torch.Tensor:
    """Whisper's encoder: the frontend stub, non-causal self-attention
    without rope, then ``enc_norm``."""
    if frames is None:
        raise ValueError(f"arch {cfg.name!r} is an encoder-decoder: pass "
                         f"frames= (B, {cfg.n_frontend_tokens}, "
                         f"{cfg.d_model}) encoder embeddings")
    x = audio_frontend(params.frontend, cfg, frames)
    for bp in params.enc_blocks:
        x = (checkpoint(_enc_block, cfg, bp, x, use_reentrant=False)
             if remat else _enc_block(cfg, bp, x))
    return _norm(cfg, params.enc_norm, x)


def _top_params(fn):
    """``fn(params, cfg, ...)`` with the model's own parameters (those
    outside its blocks) gathered for compute under a mesh
    (``pshard.compute_params``); the blocks gather theirs one at a time."""
    @functools.wraps(fn)
    def wrapped(params, cfg, *args, **kwargs):
        with compute_params(params, skip=("blocks", "enc_blocks")):
            return fn(params, cfg, *args, **kwargs)
    return wrapped


@_top_params
def forward(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None,
            patches: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, MoEAux]:
    """Full-sequence logits (B, S, padded vocab) in f32, and the auxiliary
    losses summed over the MoE layers and divided by their number (zero
    on a dense stack).  ``frames``: whisper's encoder input (B, T, d);
    ``patches``: qwen2-vl's image-token embeddings (B, S, d), added to the
    token embeddings through the vision frontend; ``positions``: (B, S)
    ids, or (3, B, S) (t, h, w) ids under M-RoPE.  With gradients on and
    ``cfg.remat``, each block keeps only its input and is recomputed in the
    backward (the reference's per-superblock ``jax.checkpoint``; its sqrt
    grouping is a memory layout of the scan, not arithmetic).  The
    recompute gives the first pass's bits: the flash kernel sums in a
    fixed order."""
    B, S = tokens.shape
    remat = cfg.remat and torch.is_grad_enabled()
    x = embed_tokens(params, cfg, tokens)
    if patches is not None:
        x = x + vision_frontend(params.frontend, cfg, patches)
    if positions is None:
        positions = _default_positions(cfg, B, S, tokens.device)
    cos, sin = _rope_tables(cfg, positions)
    enc_out = _encode(params, cfg, frames, remat) if cfg.encdec else None
    lb = dr = torch.zeros((), dtype=torch.float32, device=x.device)
    n_moe = 0
    p = pattern_period(cfg)
    for i, bp in enumerate(params.blocks):
        if i % p == 0:
            # Under a mesh, pin the residual stream (batch over dp) at each
            # superblock's boundary, the reference's remat boundary; no
            # mesh, nothing.
            x = hint(x, "dp", None, None)
        if remat:
            x, aux = checkpoint(_block_forward, cfg, bp, x, cos, sin,
                                enc_out, use_reentrant=False)
        else:
            x, aux = _block_forward(cfg, bp, x, cos, sin, enc_out)
        if aux is not None:
            lb, dr = lb + aux.load_balance_loss, dr + aux.dropped_fraction
            n_moe += 1
    x = hint(x, "dp", None, None)
    x = _norm(cfg, params.final_norm, x)
    n_moe = max(1, n_moe)
    return lm_logits(params, cfg, x), MoEAux(lb / n_moe, dr / n_moe)


# ------------------------------------------------------------------- loss

def loss_fn(params: Transformer, cfg: ModelConfig, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Next-token CE with ignore-index -1, plus MoE aux and z-loss (the
    reference's ``loss_fn``).  ``batch``: ``tokens`` and ``labels`` (B, S),
    optionally ``positions``, ``frames`` and ``patches`` (as ``forward``
    takes them).  Returns (total loss, metrics), scalars in f32."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          positions=batch.get("positions"),
                          frames=batch.get("frames"),
                          patches=batch.get("patches"))
    labels = batch["labels"]
    mask = (labels >= 0).float()
    lab = labels.clamp_min(0).long()
    if is_dtensor(logits):
        lse, gold = _vocab_parallel_terms(logits, lab)
    else:
        lse, gold = _ce_terms(logits, lab)
    ce = (lse - gold) * mask
    denom = mask.sum().clamp_min(1.0)
    ce_loss = ce.sum() / denom
    z_loss = Z_LOSS_COEF * ((lse * mask) ** 2).sum() / denom
    total = ce_loss + z_loss + MOE_AUX_COEF * aux.load_balance_loss
    metrics = {"loss": ce_loss, "z_loss": z_loss,
               "moe_lb": aux.load_balance_loss,
               "moe_drop": aux.dropped_fraction, "total_loss": total}
    return total, metrics


def _ce_terms(logits, lab):
    """(logsumexp, gold logit) of each row.  The gold logits are a gather
    of one entry a row, so its backward adds once into each place it
    writes: no two adds meet."""
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lab[..., None])[..., 0]
    return lse, gold


class _SplitLogSumExp(torch.autograd.Function):
    """``torch.logsumexp`` over the last dim of a rank's block of logits
    whose last dim is split over the mesh dims ``axes``: the row maximum
    and the sum of exponentials are reduced over them (small (B, S)
    all-reduces).  Forward and backward are ``logsumexp``'s own arithmetic
    (``log(sum(exp(x - max))) + max``; ``g * exp(x - lse)``), so with no
    axis the bits are its bits, and so are the gradients an optimizer
    step amplifies."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        import torch.distributed._functional_collectives as funcol
        m = x.amax(-1, keepdim=True)
        for i in axes:
            m = funcol.all_reduce(m, "max", (mesh, i))
        s = torch.exp(x - m).sum(-1)
        for i in axes:
            s = funcol.all_reduce(s, "sum", (mesh, i))
        lse = torch.log(s) + m[..., 0]
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g[..., None] * torch.exp(x - lse[..., None]), None, None


def _vocab_parallel_terms(logits, lab):
    """(logsumexp, gold logit) of DTensor logits, on every layout, without
    gathering a vocab dim split over `model`: the logsumexp on each rank's
    block (``_SplitLogSumExp``), and the gold logit a select of each
    rank's block against its own vocab ids, laid out as the logits are,
    summed over the split.  The same values as ``_ce_terms``.  Both are
    built on local blocks: DTensor's own gather along a split dim
    mis-reduces 3-D operands, and torch 2.11's strategy for ``lab == ids``
    replicates the vocab (a (B, S, V) select a device)."""
    from torch.distributed.tensor import Replicate
    mesh, d = logits.device_mesh, logits.dim() - 1
    if any(p.is_partial() for p in logits.placements):
        logits = logits.redistribute(mesh, [
            Replicate() if p.is_partial() else p for p in logits.placements])
    pl = logits.placements
    split = [i for i, p in enumerate(pl) if p.is_shard(d)]
    rows = [Replicate() if p.is_shard(d) else p for p in pl]
    x = logits.to_local()
    lse = wrap(_SplitLogSumExp.apply(
        x, mesh, [i for i in split if mesh.size(i) > 1]), mesh, rows,
        logits.shape[:-1])
    chunk, coord = 0, mesh.get_coordinate()
    for i in split:                          # major to minor, as DTensor
        chunk = chunk * mesh.size(i) + coord[i]
    ids = chunk * x.shape[-1] + torch.arange(x.shape[-1], device=x.device)
    lab = as_dtensor(lab, mesh).redistribute(mesh, rows).to_local()
    hit = wrap(lab[..., None] == ids, mesh, pl, logits.shape)
    gold = hint(torch.where(hit, logits, 0.0).sum(-1), "dp", None)
    return lse, gold


# ----------------------------------------------------------------- caches

def _cache_for(cfg: ModelConfig, kind: str, batch: int, max_len: int, dev):
    if kind == ATTN:
        return attn_mod.init_kv_cache(cfg, batch, max_len, dev)
    if kind == MAMBA:
        return mamba_mod.mamba_init_state(cfg, batch, dev)
    if kind == MLSTM:
        return xlstm_mod.mlstm_init_state(cfg, batch, dev)
    return xlstm_mod.slstm_init_state(cfg, batch, dev)


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device="cuda") -> dict:
    """``{"self": [one state per layer]}`` (the reference's ``_cache_for``):
    for an attention layer a KVCache, each (batch, L, KV, hd) in the
    compute dtype, ``L = max_len`` (capped at the window under SWA); for a
    Mamba, mLSTM or sLSTM layer its zero state.  Under ``cfg.encdec`` also
    ``"cross"``: a zero (k, v) pair a layer, each (batch,
    n_frontend_tokens, KV, hd), that ``prefill`` fills from the encoder."""
    dev = check_device(device)
    caches = {"self": [_cache_for(cfg, cfg.layer_kind(i), batch, max_len,
                                  dev) for i in range(cfg.n_layers)]}
    if cfg.encdec:
        shape = (batch, cfg.n_frontend_tokens, cfg.n_kv_heads, cfg.hd)
        caches["cross"] = [
            tuple(torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)
                  for _ in range(2)) for _ in range(cfg.n_layers)]
    return caches


def caches_shape(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """``init_caches``' tree on the ``meta`` device (shapes and dtypes)."""
    return init_caches(cfg, batch, max_len, device="meta")


# ---------------------------------------------------------------- prefill

def _attn_prefill_cache(cfg: ModelConfig, bp: Block, h, cos, sin,
                        max_len: int) -> tuple[torch.Tensor, KVCache]:
    """Run full attention AND fill the decode cache with the trailing keys."""
    out = attn_mod.attention(bp.mixer, cfg, h, cos, sin, causal=True)
    _, k, v = attn_mod._project_qkv(bp.mixer, cfg, h, h)
    if cos is not None:
        k = attn_mod.apply_rope(k, cos, sin)
    S = h.shape[1]
    if is_dtensor(k):
        return out, _kv_cache_of(cfg, k, v, S, max_len)
    cache = attn_mod.init_kv_cache(cfg, h.shape[0], max_len, h.device)
    L = cache.k.shape[1]
    if cfg.sliding_window is not None and S > L:
        slots = torch.arange(S - L, S, device=h.device) % L
        cache.k[:, slots] = k[:, -L:].to(cache.k.dtype)
        cache.v[:, slots] = v[:, -L:].to(cache.v.dtype)
    else:
        if S > L:
            raise ValueError(f"prompt of {S} tokens does not fit the cache "
                             f"of max_len={L}")
        cache.k[:, :S] = k.to(cache.k.dtype)
        cache.v[:, :S] = v.to(cache.v.dtype)
    return out, cache


def _kv_cache_of(cfg: ModelConfig, k, v, S: int, max_len: int) -> KVCache:
    """The prefill's cache built from DTensor keys without writing into a
    buffer (DTensor takes no slice assignment): the prompt's keys padded
    to the cache's length, or under a sliding window the last L keys in
    their ring slots ``pos % L``; the same values as the in-place path."""
    L = (min(max_len, cfg.sliding_window) if cfg.sliding_window is not None
         else max_len)
    cdt = cfg.compute_dtype
    if cfg.sliding_window is not None and S > L:
        idx = (torch.arange(L, device=k.device) - (S - L)) % L
        return KVCache(k=k[:, -L:][:, idx].to(cdt),
                       v=v[:, -L:][:, idx].to(cdt))
    if S > L:
        raise ValueError(f"prompt of {S} tokens does not fit the cache "
                         f"of max_len={L}")
    return KVCache(k=pad_dim(k.to(cdt), 1, L - S),
                   v=pad_dim(v.to(cdt), 1, L - S))


def _mixer_prefill(cfg: ModelConfig, bp: Block, h, cos, sin, max_len):
    if type(bp.mixer) in _RECURRENT:
        return _RECURRENT[type(bp.mixer)][1](bp.mixer, cfg, h)
    return _attn_prefill_cache(cfg, bp, h, cos, sin, max_len)


@torch.inference_mode()
@_top_params
def prefill(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor, *,
            max_len: int, frames: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None):
    """Process the prompt; return (last-token logits (B, 1, V), caches).
    Only the final position's logits are materialized.  An
    encoder-decoder needs ``frames``; its caches gain ``"cross"``, the
    encoder's K/V for every decoder layer (``encoder_kv``)."""
    B, S = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    if positions is None:
        positions = _default_positions(cfg, B, S, tokens.device)
    cos, sin = _rope_tables(cfg, positions)
    enc_out = _encode(params, cfg, frames) if cfg.encdec else None
    caches, cross = [], []
    for bp in params.blocks:
        with compute_params(bp):
            h, cache = _mixer_prefill(cfg, bp, _norm(cfg, bp.ln1, x), cos,
                                      sin, max_len)
            x, _ = _sublayers(cfg, bp, x + h, enc_out)
            caches.append(cache)
            if enc_out is not None:
                cross.append(attn_mod.encoder_kv(bp.cross, cfg, enc_out))
    x_last = _norm(cfg, params.final_norm, x[:, -1:])
    out = {"self": caches}
    if cfg.encdec:
        out["cross"] = cross
    return lm_logits(params, cfg, x_last), out


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Chunked prefill needs every mixer to extend a positional cache in
    place: attention-only stacks, no encoder-decoder frontend, no mrope,
    no sliding window (ring-buffer slots are position-dependent).
    Recurrent mixers (Mamba, xLSTM) have only the full-sequence prefill
    and the one-token decode, so they keep the one-shot path."""
    return (all(kind == ATTN for kind, _ in pattern(cfg))
            and not cfg.encdec and not cfg.mrope
            and cfg.sliding_window is None)


@torch.inference_mode()
def prefill_chunk(params: Transformer, cfg: ModelConfig,
                  tokens: torch.Tensor, pos0: int, caches: dict):
    """One CHUNK of the prompt: ``tokens`` (B, S) at absolute positions
    ``[pos0, pos0 + S)`` against caches already filled for ``[0, pos0)``;
    returns (last-chunk-token logits, the caches, extended in place).
    Consecutive chunks are the incremental equivalent of one ``prefill``.
    Only for ``supports_chunked_prefill`` configs."""
    if not supports_chunked_prefill(cfg):
        raise ValueError(f"chunked prefill unsupported for arch "
                         f"{cfg.name!r} (needs an attention-only stack, "
                         f"no encdec/mrope/sliding window)")
    B, S = tokens.shape
    pos0 = int(pos0)
    x = embed_tokens(params, cfg, tokens)
    positions = text_positions(B, S, pos0, device=tokens.device)
    cos, sin = _rope_tables(cfg, positions)
    for bp, cache in zip(params.blocks, caches["self"]):
        h, _ = attn_mod.attention_extend(bp.mixer, cfg,
                                         _norm(cfg, bp.ln1, x), pos0, cache,
                                         cos, sin)
        x = x + h
        x = x + _ffn(cfg, bp, x)[0]
    x_last = _norm(cfg, params.final_norm, x[:, -1:])
    return lm_logits(params, cfg, x_last), caches


# ------------------------------------------------------------ decode step

def _mixer_decode(cfg: ModelConfig, bp: Block, h, pos, cache, cos, sin):
    if type(bp.mixer) in _RECURRENT:
        return _RECURRENT[type(bp.mixer)][2](bp.mixer, cfg, h, cache)[0]
    return attn_mod.attention_decode(bp.mixer, cfg, h, pos, cache, cos,
                                     sin)[0]


@torch.inference_mode()
@_top_params
def decode_step(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
                pos, caches: dict):
    """One token for every sequence in the batch.

    tokens: (B, 1) int; pos: (B,) int absolute position per sequence
    (continuous batching); a scalar is broadcast; recurrent layers ignore
    it; under M-RoPE its (t, h, w) ids are all ``pos``.  Decoder layers of
    an encoder-decoder attend to ``caches["cross"]``.
    Returns (logits (B, 1, V), the caches, written in place)."""
    B = tokens.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int64, device=tokens.device)
    pos = pos.expand(B) if pos.dim() == 0 else pos
    x = embed_tokens(params, cfg, tokens)
    p = pos[:, None]
    cos, sin = _rope_tables(cfg, p[None].expand(3, B, 1) if cfg.mrope else p)
    cross = caches.get("cross")
    for i, (bp, cache) in enumerate(zip(params.blocks, caches["self"])):
        with compute_params(bp):
            x = x + _mixer_decode(cfg, bp, _norm(cfg, bp.ln1, x), pos,
                                  cache, cos, sin)
            if cross is not None and hasattr(bp, "cross"):
                h = _norm(cfg, bp.ln_x, x)
                x = x + attn_mod.cross_attention_decode(bp.cross, cfg, h,
                                                        cross[i])
            if bp.ffn is not None:
                # The whole batch is one dispatch group (the reference's).
                x = x + _ffn(cfg, bp, x, group_size=B)[0]
    x = _norm(cfg, params.final_norm, x)
    return lm_logits(params, cfg, x), caches


# ------------------------------------------------- weights from the reference

def _tree(module: nn.Module) -> dict:
    """The reference's leaf dict of ``module``: its parameters nested by
    the dotted names (``moe.shared.w_gate``, ``mixer.q_norm.scale``)."""
    out: dict = {}
    for name, t in module.named_parameters():
        node = out
        *heads, leaf = name.split(".")
        for key in heads:
            node = node.setdefault(key, {})
        node[leaf] = t
    return out


def _block_leaves(bp: Block) -> dict:
    """The reference's per-layer leaf dict of one block, as tensors."""
    return _tree(bp)


def _top_leaves(model: Transformer) -> dict:
    """The reference's tree without ``blocks`` and ``enc_blocks``."""
    tree = _tree(model)
    tree.pop("blocks")
    tree.pop("enc_blocks", None)
    return tree


def _pairs(dst: dict, src: dict, path: str):
    """(tensor, array, path) for every leaf of ``dst``; the key sets of
    the two trees must agree."""
    if set(dst) != set(src):
        raise ValueError(f"params tree at {path or 'root'}: keys "
                         f"{sorted(src)} do not match the port's "
                         f"{sorted(dst)}")
    for key, t in dst.items():
        if isinstance(t, dict):
            yield from _pairs(t, src[key], f"{path}.{key}")
        else:
            yield t, src[key], f"{path}.{key}"


@torch.no_grad()
def params_from_jax(params_np: dict, cfg: ModelConfig,
                    device="cuda") -> Transformer:
    """The port's model holding the reference's weights.

    ``params_np``: the tree of ``repro.models.init_params`` with numpy
    leaves (``jax.tree.map(np.asarray, params)``).  ``params["blocks"]``
    holds one stacked tree per pattern position (``pattern_period``
    ``p`` of them); layer ``i`` is index ``i // p`` of position ``i % p``.
    ``params["enc_blocks"]`` (encoder-decoders) is one tree stacked over
    the encoder's layers.  The embedding keeps its padded vocab."""
    model = Transformer(cfg, device=check_device(device))
    blocks = params_np["blocks"]
    p = pattern_period(cfg)
    if len(blocks) != p:
        raise ValueError(f"params['blocks'] has {len(blocks)} pattern "
                         f"positions; arch {cfg.name!r} has a pattern "
                         f"period of {p}")
    pairs = list(_pairs(_top_leaves(model),
                        {k: v for k, v in params_np.items()
                         if k not in ("blocks", "enc_blocks")}, ""))
    for i, bp in enumerate(model.blocks):
        pairs += _pairs(_block_leaves(bp), _take_layer(blocks[i % p], i // p),
                        f".blocks.{i}")
    for j, bp in enumerate(getattr(model, "enc_blocks", ())):
        pairs += _pairs(_block_leaves(bp),
                        _take_layer(params_np["enc_blocks"], j),
                        f".enc_blocks.{j}")
    for t, a, path in pairs:
        a = np.asarray(a)
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"params{path}: shape {a.shape}, the port's "
                             f"is {tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.array(a, dtype=np.float32)).to(t.dtype))
    return model


def _take_layer(tree: dict, i: int) -> dict:
    return {k: (_take_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def params_to_numpy(model: Transformer) -> dict:
    """The inverse of ``params_from_jax``: the reference's tree (one tree
    a pattern position, its layers stacked along a leading axis; the
    encoder's layers stacked likewise) with f32 numpy leaves."""
    def host(t):
        return t.detach().float().cpu().numpy()

    def stack(trees):
        first = trees[0]
        return {k: (stack([t[k] for t in trees]) if isinstance(first[k], dict)
                    else np.stack([host(t[k]) for t in trees]))
                for k in first}

    def tree_host(tree):
        return {k: (tree_host(v) if isinstance(v, dict) else host(v))
                for k, v in tree.items()}

    p = pattern_period(model.cfg)
    out = tree_host(_top_leaves(model))
    out["blocks"] = tuple(stack([_block_leaves(bp)
                                 for bp in model.blocks[pos::p]])
                          for pos in range(p))
    if hasattr(model, "enc_blocks"):
        out["enc_blocks"] = stack([_block_leaves(bp)
                                   for bp in model.enc_blocks])
    return out
