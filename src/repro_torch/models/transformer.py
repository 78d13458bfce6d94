"""The LM's attention-only path, dense or MoE (counterpart of
``repro.models.transformer``).

The reference stacks each pattern position's parameters across layers and
walks the stack with ``lax.scan``; here the model is an ``nn.Module``, a
``Transformer`` with one ``Block`` per layer, walked by a Python loop.
Parameter names follow the reference's tree (``embed.tok``,
``blocks.<i>.ln1.scale``, ``blocks.<i>.mixer.wq``, ``blocks.<i>.mlp.w_up``
or ``blocks.<i>.moe.w_up``, ``final_norm.scale``, ``lm_head``), so
``params_from_jax`` and ``params_to_numpy`` carry weights across by name.

Public surface:
  init_params                       -- random init from a seed or generator
  forward                           -- logits over a full sequence
  loss_fn                           -- next-token CE (+ z-loss) for training
  prefill / prefill_chunk / decode_step -- with per-layer KV caches
  init_caches, supports_chunked_prefill
  params_from_jax / params_to_numpy -- the reference's tree <-> the module

Mamba and xLSTM mixers, MoE on some layers only (jamba's period), the
encoder-decoder (whisper) and vision (qwen2-vl) frontends and M-RoPE are
not ported yet: their configs raise ``NotImplementedError`` here.  The
serving functions run under ``torch.inference_mode``; ``prefill_chunk``
and ``decode_step`` write into the caches they are given, in place, and
return them.

Parameters are created with ``requires_grad=False``: serving needs no
graph.  Training turns them on (``launch.steps.init_train_state``);
``forward`` and ``loss_fn`` then build the graph, with each block
recomputed in the backward under ``cfg.remat`` (the reference's
``jax.checkpoint``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.rng import as_generator, check_device
from . import attention as attn_mod
from .attention import Attention, KVCache
from .config import ModelConfig
from .mlp import SwiGLU, mlp
from .moe import MoE, MoEAux, moe_ffn
from .norms import RMSNorm, rmsnorm
from .rope import rope_cos_sin, text_positions

__all__ = ["Block", "Transformer", "MoEAux", "init_params", "forward",
           "loss_fn", "MOE_AUX_COEF", "Z_LOSS_COEF",
           "embed_tokens", "lm_logits", "init_caches", "prefill",
           "supports_chunked_prefill", "prefill_chunk", "decode_step",
           "params_from_jax", "params_to_numpy", "check_supported"]


MOE_AUX_COEF = 0.01
Z_LOSS_COEF = 1e-4


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port's models do not run yet."""
    missing = []
    if any(cfg.layer_kind(i) != "attn" for i in range(cfg.n_layers)):
        missing.append("Mamba/xLSTM mixers")
    if cfg.moe and cfg.moe_layer_period != 1:
        missing.append("MoE on every moe_layer_period-th layer only")
    if cfg.encdec:
        missing.append("the encoder-decoder (whisper) frontend")
    if cfg.family == "vlm" or cfg.mrope:
        missing.append("the vision frontend and M-RoPE")
    if missing:
        raise NotImplementedError(
            f"arch {cfg.name!r} needs {', '.join(missing)}, which a later "
            f"slice of the port brings (ROADMAP Queue A item 3); the port "
            f"runs attention-only stacks, MoE on every layer or none, so far")


class Block(nn.Module):
    """Layer ``i``: ``ln1``, the attention ``mixer``, ``ln2``, and the FFN:
    ``moe`` where ``cfg.layer_is_moe(i)``, else ``mlp``."""

    def __init__(self, cfg: ModelConfig, i: int, *, device=None):
        super().__init__()
        pdt = cfg.params_dtype
        self.ln1 = RMSNorm(cfg.d_model, pdt, device)
        self.mixer = Attention(cfg, device=device)
        self.ln2 = RMSNorm(cfg.d_model, pdt, device)
        if cfg.layer_is_moe(i):
            self.moe = MoE(cfg, device=device)
        else:
            self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, pdt, device)

    @property
    def ffn(self):
        return self.moe if hasattr(self, "moe") else self.mlp


class Embed(nn.Module):
    def __init__(self, vocab: int, d: int, dtype, device=None):
        super().__init__()
        self.tok = nn.Parameter(torch.empty((vocab, d), dtype=dtype,
                                            device=device),
                                requires_grad=False)


class Transformer(nn.Module):
    """The model: ``embed.tok`` (padded vocab, d), ``blocks``,
    ``final_norm`` and, without tied embeddings, ``lm_head`` (d, padded
    vocab).  Its tensors are uninitialized until ``init_params`` or
    ``params_from_jax`` fills them."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        pdt = cfg.params_dtype
        d, Vp = cfg.d_model, cfg.padded_vocab
        self.embed = Embed(Vp, d, pdt, device)
        self.blocks = nn.ModuleList(Block(cfg, i, device=device)
                                    for i in range(cfg.n_layers))
        self.final_norm = RMSNorm(d, pdt, device)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty((d, Vp), dtype=pdt,
                                                    device=device),
                                        requires_grad=False)

    def forward(self, tokens: torch.Tensor):
        return forward(self, self.cfg, tokens)


@torch.no_grad()
def init_params(gen_or_seed, cfg: ModelConfig, *,
                device="cuda") -> Transformer:
    """A model with the reference's shapes and scales, drawn from
    ``gen_or_seed`` (an int seed or a generator on ``device``)."""
    dev = check_device(device)
    gen = as_generator(gen_or_seed, dev)
    model = Transformer(cfg, device=dev)
    d = cfg.d_model
    for blk in model.blocks:
        blk.mixer.init_(gen)
        blk.ffn.init_(gen)
    model.embed.tok.copy_(torch.randn(model.embed.tok.shape, generator=gen,
                                      device=dev) * d ** -0.5)
    if not cfg.tie_embeddings:
        model.lm_head.copy_(torch.randn(model.lm_head.shape, generator=gen,
                                        device=dev) * d ** -0.5)
    return model


# ---------------------------------------------------------------- forward

def _rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    return rope_cos_sin(positions, cfg.hd, cfg.rope_theta)


def _norm(cfg: ModelConfig, p: RMSNorm, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x, cfg.norm_eps)


def embed_tokens(params: Transformer, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    return params.embed.tok[tokens.long()].to(cfg.compute_dtype)


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


def _block_forward(cfg: ModelConfig, bp: Block, x, cos, sin):
    h = attn_mod.attention(bp.mixer, cfg, _norm(cfg, bp.ln1, x), cos, sin,
                           causal=True)
    x = x + h
    h, aux = _ffn(cfg, bp, x)
    return x + h, aux


def forward(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor, *,
            positions: Optional[torch.Tensor] = None
            ) -> tuple[torch.Tensor, MoEAux]:
    """Full-sequence logits (B, S, padded vocab) in f32, and the auxiliary
    losses summed over the MoE layers and divided by their number (zero
    on a dense stack).  With gradients on and ``cfg.remat``, each block
    keeps only its input and is recomputed in the backward (the
    reference's per-superblock ``jax.checkpoint``; its sqrt grouping is a
    memory layout of the scan, not arithmetic).  The recompute gives the
    first pass's bits: the flash kernel sums in a fixed order."""
    B, S = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    if positions is None:
        positions = text_positions(B, S, device=tokens.device)
    cos, sin = _rope_tables(cfg, positions)
    remat = cfg.remat and torch.is_grad_enabled()
    lb = dr = torch.zeros((), dtype=torch.float32, device=x.device)
    n_moe = 0
    for bp in params.blocks:
        if remat:
            x, aux = checkpoint(_block_forward, cfg, bp, x, cos, sin,
                                use_reentrant=False)
        else:
            x, aux = _block_forward(cfg, bp, x, cos, sin)
        if aux is not None:
            lb, dr = lb + aux.load_balance_loss, dr + aux.dropped_fraction
            n_moe += 1
    x = _norm(cfg, params.final_norm, x)
    n_moe = max(1, n_moe)
    return lm_logits(params, cfg, x), MoEAux(lb / n_moe, dr / n_moe)


# ------------------------------------------------------------------- loss

def loss_fn(params: Transformer, cfg: ModelConfig, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Next-token CE with ignore-index -1, plus MoE aux and z-loss (the
    reference's ``loss_fn``).  ``batch``: ``tokens`` and ``labels`` (B, S),
    optionally ``positions``.  Returns (total loss, metrics), scalars in
    f32."""
    logits, aux = forward(params, cfg, batch["tokens"],
                          positions=batch.get("positions"))
    labels = batch["labels"]
    # The gold logits are a gather of one entry a row, so its backward adds
    # once into each place it writes: no two adds meet.
    mask = (labels >= 0).float()
    lab = labels.clamp_min(0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lab[..., None])[..., 0]
    ce = (lse - gold) * mask
    denom = mask.sum().clamp_min(1.0)
    ce_loss = ce.sum() / denom
    z_loss = Z_LOSS_COEF * ((lse * mask) ** 2).sum() / denom
    total = ce_loss + z_loss + MOE_AUX_COEF * aux.load_balance_loss
    metrics = {"loss": ce_loss, "z_loss": z_loss,
               "moe_lb": aux.load_balance_loss,
               "moe_drop": aux.dropped_fraction, "total_loss": total}
    return total, metrics


# ----------------------------------------------------------------- caches

def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                device="cuda") -> dict:
    """``{"self": [KVCache per layer]}``, each (batch, L, KV, hd) in the
    compute dtype, ``L = max_len`` (capped at the window under SWA)."""
    check_supported(cfg)
    dev = check_device(device)
    return {"self": [attn_mod.init_kv_cache(cfg, batch, max_len, dev)
                     for _ in range(cfg.n_layers)]}


# ---------------------------------------------------------------- prefill

def _attn_prefill_cache(cfg: ModelConfig, bp: Block, h, cos, sin,
                        max_len: int) -> tuple[torch.Tensor, KVCache]:
    """Run full attention AND fill the decode cache with the trailing keys."""
    out = attn_mod.attention(bp.mixer, cfg, h, cos, sin, causal=True)
    _, k, v = attn_mod._project_qkv(bp.mixer, cfg, h, h)
    if cos is not None:
        k = attn_mod.apply_rope(k, cos, sin)
    S = h.shape[1]
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


@torch.inference_mode()
def prefill(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor, *,
            max_len: int, positions: Optional[torch.Tensor] = None):
    """Process the prompt; return (last-token logits (B, 1, V), caches).
    Only the final position's logits are materialized."""
    B, S = tokens.shape
    x = embed_tokens(params, cfg, tokens)
    if positions is None:
        positions = text_positions(B, S, device=tokens.device)
    cos, sin = _rope_tables(cfg, positions)
    caches = []
    for bp in params.blocks:
        h, cache = _attn_prefill_cache(cfg, bp, _norm(cfg, bp.ln1, x), cos,
                                       sin, max_len)
        x = x + h
        x = x + _ffn(cfg, bp, x)[0]
        caches.append(cache)
    x_last = _norm(cfg, params.final_norm, x[:, -1:])
    return lm_logits(params, cfg, x_last), {"self": caches}


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Chunked prefill needs every mixer to extend a positional cache in
    place: attention-only stacks, no encoder-decoder frontend, no mrope,
    no sliding window (ring-buffer slots are position-dependent)."""
    return (all(cfg.layer_kind(i) == "attn" for i in range(cfg.n_layers))
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

@torch.inference_mode()
def decode_step(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
                pos, caches: dict):
    """One token for every sequence in the batch.

    tokens: (B, 1) int; pos: (B,) int absolute position per sequence
    (continuous batching); a scalar is broadcast.  Returns (logits
    (B, 1, V), the caches, written in place)."""
    B = tokens.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int64, device=tokens.device)
    pos = pos.expand(B) if pos.dim() == 0 else pos
    x = embed_tokens(params, cfg, tokens)
    cos, sin = _rope_tables(cfg, pos[:, None])
    for bp, cache in zip(params.blocks, caches["self"]):
        h, _ = attn_mod.attention_decode(bp.mixer, cfg,
                                         _norm(cfg, bp.ln1, x), pos, cache,
                                         cos, sin)
        x = x + h
        # The whole batch is one dispatch group (the reference's).
        x = x + _ffn(cfg, bp, x, group_size=B)[0]
    x = _norm(cfg, params.final_norm, x)
    return lm_logits(params, cfg, x), caches


# ------------------------------------------------- weights from the reference

def _block_leaves(bp: Block) -> dict:
    """The reference's per-layer leaf dict of one block, as tensors."""
    ffn = {}
    for name, t in bp.ffn.named_parameters():
        node = ffn
        *heads, leaf = name.split(".")
        for key in heads:                   # moe.shared.w_gate and the like
            node = node.setdefault(key, {})
        node[leaf] = t
    out = {"ln1": {"scale": bp.ln1.scale}, "ln2": {"scale": bp.ln2.scale},
           "mixer": {}, "moe" if hasattr(bp, "moe") else "mlp": ffn}
    for name, t in bp.mixer.named_parameters(recurse=False):
        out["mixer"][name] = t
    for name in ("q_norm", "k_norm"):
        if hasattr(bp.mixer, name):
            out["mixer"][name] = {"scale": getattr(bp.mixer, name).scale}
    return out


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
    leaves (``jax.tree.map(np.asarray, params)``).  The leading
    ``n_layers`` axis of ``params["blocks"][0]`` is unstacked into one
    ``Block`` per layer; the embedding keeps its padded vocab."""
    model = Transformer(cfg, device=check_device(device))
    blocks = params_np["blocks"]
    if len(blocks) != 1:
        raise ValueError(f"params['blocks'] has {len(blocks)} pattern "
                         f"positions; the port's stacks have 1")
    top = {"embed": {"tok": model.embed.tok},
           "final_norm": {"scale": model.final_norm.scale}}
    if not cfg.tie_embeddings:
        top["lm_head"] = model.lm_head
    pairs = list(_pairs(top, {k: v for k, v in params_np.items()
                              if k != "blocks"}, ""))
    for i, bp in enumerate(model.blocks):
        pairs += _pairs(_block_leaves(bp), _take_layer(blocks[0], i),
                        f".blocks.{i}")
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
    """The inverse of ``params_from_jax``: the reference's tree (blocks
    stacked along a leading layer axis) with f32 numpy leaves."""
    def host(t):
        return t.detach().float().cpu().numpy()

    def stack(trees):
        first = trees[0]
        return {k: (stack([t[k] for t in trees]) if isinstance(first[k], dict)
                    else np.stack([host(t[k]) for t in trees]))
                for k in first}

    out = {"embed": {"tok": host(model.embed.tok)},
           "blocks": (stack([_block_leaves(bp) for bp in model.blocks]),),
           "final_norm": {"scale": host(model.final_norm.scale)}}
    if not model.cfg.tie_embeddings:
        out["lm_head"] = host(model.lm_head)
    return out
