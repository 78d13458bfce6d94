"""Layout rules: parameter, activation and cache specs (counterpart of
``repro.launch.sharding``).

Logical layout:
  * ``model``  -- tensor parallelism: attention heads / d_ff / experts /
                 d_inner; vocab dim of the embedding and LM head.
  * ``data``   -- FSDP: the non-TP dim of every large weight (so optimizer
                 state is ZeRO-sharded for free); batch dim of activations.
  * ``pod``    -- pure DP between pods (gradients mean-reduced, optionally
                 RandLR-compressed); params replicated across pods.

A spec is a tuple with one entry per tensor dim, each a mesh-axis name, a
tuple of names or None (the reference's ``PartitionSpec``);
``models.pshard.placements`` turns it into DTensor placements.

The port's trees are per layer where the reference's are stacked.  Its
``Transformer`` holds one ``Block`` a layer, and its caches one state a
layer; the reference stacks each pattern position's leaves over a
leading ``n_super`` dim.  The rules below apply to the TRAILING dims, as
in the reference, so a per-layer spec is the reference's stacked spec
with its leading None removed, and every dim index of ``cache_specs``
sits one lower than the reference's.  Mode ``"fsdp"`` decides on the
stacked leaf as the reference does (its size threshold and its largest
divisible dim), from the per-layer shape and the stack's depth.

``distribute_params`` lays a model out on a mesh in place: each parameter
becomes a DTensor ``nn.Parameter`` of its spec, so the module tree stays.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch
from torch import nn

from ..models.attention import KVCache
from ..models.config import ModelConfig
from ..models.mamba import MambaState
from ..models.pshard import distribute, placements
from ..models.xlstm import MLSTMState, SLSTMState
from .mesh import axis_names, axis_sizes, dp_axes, model_axis_size

__all__ = ["NamedSharding", "param_specs", "param_shardings",
           "distribute_params", "batch_spec", "train_batch_specs",
           "cache_specs", "cache_shardings", "lay_out_caches"]

# (parent_match, name) -> trailing-dim axes; None entries replicate a dim.
# "F" = fsdp axis ("data"), "T" = tensor axis ("model"), "E" = expert axis.
_RULES: list[tuple[Optional[str], str, tuple[Optional[str], ...]]] = [
    ("embed", "tok", ("T", "F")),
    (None, "lm_head", ("F", "T")),
    (None, "pos", (None, None)),
    ("frontend", "proj", ("F", "T")),
    ("frontend", "merger", ("F", "T")),
    # attention
    (None, "wq", ("F", "T")),
    (None, "wk", ("F", "T")),
    (None, "wv", ("F", "T")),
    (None, "wo", ("T", "F")),
    (None, "bq", ("T",)),
    (None, "bk", ("T",)),
    (None, "bv", ("T",)),
    # dense mlp / whisper / slstm projections
    ("moe", "router", ("F", None)),
    ("moe", "w_gate", ("E", "F", "Tmoe")),
    ("moe", "w_up", ("E", "F", "Tmoe")),
    ("moe", "w_down", ("E", "Tmoe", "F")),
    ("moe", "shared_gate", ("F", None)),
    (None, "w_gate", ("F", "T")),
    (None, "w_up", ("F", "T")),
    (None, "w_down", ("T", "F")),
    (None, "w_in", ("F", "T")),
    (None, "b_in", ("T",)),
    (None, "w_out", ("T", "F")),
    (None, "b_out", (None,)),
    # mamba
    (None, "in_proj", ("F", "T")),
    (None, "conv_w", (None, "T")),
    (None, "conv_b", ("T",)),
    (None, "x_proj", ("T", None)),
    (None, "dt_proj", (None, "T")),
    (None, "dt_bias", ("T",)),
    (None, "A_log", ("T", None)),
    (None, "D", ("T",)),
    (None, "out_proj", ("T", "F")),
    # mlstm
    (None, "up_proj", ("F", "T")),
    (None, "down_proj", ("T", "F")),
    (None, "cq", ("T", None)),
    (None, "ck", ("T", None)),
    (None, "cv", ("T", None)),
    (None, "w_igate", ("T", None)),
    (None, "w_fgate", ("T", None)),
]


class NamedSharding(NamedTuple):
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _path_keys(name: str) -> list[str]:
    """The reference's dict keys of a parameter: its dotted name without
    the layer indices (``blocks.3.mixer.wq`` -> blocks, mixer, wq)."""
    return [k for k in name.split(".") if not k.isdigit()]


def _stack_depth(cfg: ModelConfig, name: str) -> int:
    """How many layers the reference stacks this parameter over: the
    superblocks for ``blocks``, the encoder's layers for ``enc_blocks``,
    else 0 (an unstacked leaf)."""
    from ..models.transformer import n_superblocks
    head = name.split(".", 1)[0]
    if head == "blocks":
        return n_superblocks(cfg)
    if head == "enc_blocks":
        return cfg.n_encoder_layers
    return 0


def _axis_size(sizes: dict, ax) -> int:
    if ax is None:
        return 1
    if isinstance(ax, tuple):
        return math.prod(sizes[a] for a in ax)
    return sizes[ax]


def _spec_for(name: str, shape: tuple, cfg: ModelConfig, mesh,
              mode: str = "tp", depth: int = 0) -> tuple:
    """``mode``:
      * "tp"   -- Megatron TP over `model` + FSDP over `data` (default).
      * "fsdp" -- pure ZeRO-3: every large dim sharded over (data, model),
        no tensor parallelism.
    ``depth``: the reference's stack depth of the leaf (0: unstacked)."""
    keys = _path_keys(name)
    leaf = keys[-1] if keys else ""
    names, sizes = axis_names(mesh), axis_sizes(mesh)
    nd = len(shape)
    ep_mode = cfg.moe and cfg.n_experts % model_axis_size(mesh) == 0
    if mode == "fsdp":
        # ZeRO-3: shard the largest divisible dim of every big leaf over
        # ALL device axes; small leaves replicate.  Decided on the
        # reference's stacked leaf.
        fsdp_axes = tuple(a for a in ("data", "model") if a in names)
        n = _axis_size(sizes, fsdp_axes)
        full = ((depth,) if depth else ()) + tuple(shape)
        if nd == 0 or math.prod(full) < (1 << 16):
            return (None,) * nd
        for i in sorted(range(len(full)), key=lambda i: -full[i]):
            if full[i] % n == 0:
                spec = [None] * len(full)
                spec[i] = fsdp_axes
                return _unstack(tuple(spec), depth, name)
        return (None,) * nd
    for pmatch, nmatch, axes in _RULES:
        if nmatch != leaf:
            continue
        if pmatch is not None and pmatch not in keys:
            continue
        trans = []
        for a in axes:
            if a == "F":
                trans.append("data" if "data" in names else None)
            elif a == "T":
                trans.append("model" if "model" in names else None)
            elif a == "E":      # expert dim: sharded under EP, replicated
                                # under TP-MoE
                trans.append("model" if ep_mode else None)
            elif a == "Tmoe":   # expert hidden dim: sharded under TP-MoE
                trans.append(None if ep_mode else "model")
            else:
                trans.append(None)
        full = ((depth,) if depth else ()) + tuple(shape)
        if len(trans) > len(full):
            trans = trans[-len(full):]
        spec = (None,) * (len(full) - len(trans)) + tuple(trans)
        # Drop axes that do not divide the dim (e.g. 28 heads on model=16).
        spec = tuple(ax if (ax is None or full[i] % _axis_size(sizes, ax) == 0)
                     else None for i, ax in enumerate(spec))
        return _unstack(spec, depth, name)
    return (None,) * nd     # replicate by default (norm scales, biases, gates)


def _unstack(spec: tuple, depth: int, name: str) -> tuple:
    """The per-layer spec of a stacked spec: its leading entry removed.

    That entry is None but in one case: under EP the shared expert's
    SwiGLU (``moe.shared.w_gate`` ...) matches the three-dim expert rule,
    whose expert axis then lands on the reference's layer stack (qwen2-moe
    where `model` divides its 60 experts).  A layer of the port cannot be
    split over a mesh axis; it is replicated over that axis instead
    (ROADMAP Queue C)."""
    return spec[1:] if depth else spec


def _named_shapes(model_or_shapes) -> dict:
    """``{name: shape}`` of a module's parameters or of a dict."""
    if isinstance(model_or_shapes, nn.Module):
        return {k: tuple(p.shape)
                for k, p in model_or_shapes.named_parameters()}
    return {k: tuple(v.shape) if hasattr(v, "shape") else tuple(v)
            for k, v in model_or_shapes.items()}


def param_specs(cfg: ModelConfig, model_or_shapes, mesh,
                mode: str = "tp") -> dict:
    """``{parameter name: spec}`` for a model (real or on the ``meta``
    device) or a ``{name: shape}`` dict."""
    return {k: _spec_for(k, s, cfg, mesh, mode, _stack_depth(cfg, k))
            for k, s in _named_shapes(model_or_shapes).items()}


def param_shardings(cfg: ModelConfig, model_or_shapes, mesh,
                    mode: str = "tp") -> dict:
    return {k: NamedSharding(mesh, s)
            for k, s in param_specs(cfg, model_or_shapes, mesh, mode).items()}


@torch.no_grad()
def distribute_params(model: nn.Module, mesh, cfg: ModelConfig = None,
                      mode: str = "tp", shardings: dict = None) -> nn.Module:
    """Lay ``model`` out on ``mesh`` in place: each parameter becomes a
    DTensor ``nn.Parameter`` of its spec (``param_specs``, or
    ``shardings``), keeping ``requires_grad``.  Every rank must hold the
    same full weights (``init_params`` from one seed): each keeps its own
    block, with no communication."""
    cfg = cfg or model.cfg
    if shardings is None:
        shardings = param_shardings(cfg, model, mesh, mode)
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        d = distribute(p.detach(), mesh, shardings[name].placements)
        setattr(mod, leaf, nn.Parameter(d, requires_grad=p.requires_grad))
    return model


# -------------------------------------------------------------- activations

def batch_spec(mesh, global_batch: int, mode: str = "tp") -> tuple:
    """Batch-dim sharding: over ("pod","data") when divisible, else fewer.
    In fsdp mode the (otherwise idle) model axis joins the batch axes."""
    sizes = axis_sizes(mesh)
    axes = list(dp_axes(mesh))
    if mode == "fsdp" and "model" in sizes:
        axes = axes + ["model"]
    while axes and global_batch % math.prod(sizes[a] for a in axes):
        axes = axes[1:]     # drop the pod axis first, then data
    return (_group(axes),)


def _group(axes):
    """A spec entry of mesh axes as ``PartitionSpec`` normalizes it: None,
    one name, or a tuple of two or more."""
    axes = tuple(axes)
    return None if not axes else axes[0] if len(axes) == 1 else axes


def train_batch_specs(cfg: ModelConfig, mesh, global_batch: int,
                      mode: str = "tp") -> dict:
    b = batch_spec(mesh, global_batch, mode)
    specs = {"tokens": (b[0], None), "labels": (b[0], None)}
    if cfg.encdec:
        specs["frames"] = (b[0], None, None)
    return specs


# ------------------------------------------------------------------ caches

def cache_specs(cfg: ModelConfig, caches, mesh, batch: int) -> dict:
    """Specs for the decode caches (``init_caches``' tree).

    KV caches: batch over the dp axes when divisible; the SEQUENCE dim over
    ``model`` (any kv-head count); when the batch cannot shard (long_500k,
    B=1) the sequence takes the dp axes too.  SSM/xLSTM states: batch over
    dp, feature (d_inner / head-dim) over ``model``.  Each dim index is
    the reference's less one (no stacked dim)."""
    sizes = axis_sizes(mesh)
    b_ax = batch_spec(mesh, batch)[0]
    seq_ax: Any = "model"
    if b_ax is None:
        seq_ax = _group(tuple(dp_axes(mesh)) + ("model",))

    def kv_spec(leaf):
        # (B, L, KV, hd)
        split = leaf.shape[1] % _axis_size(sizes, seq_ax) == 0
        seq = seq_ax if split else None
        return (b_ax, seq, None, None)

    def generic(leaf, feature_axes: dict[int, str]):
        spec: list = [None] * leaf.dim()
        spec[0] = b_ax
        for dim, ax in feature_axes.items():
            if leaf.shape[dim] % sizes[ax] == 0:
                spec[dim] = ax
        return tuple(spec)

    def one(cache):
        if isinstance(cache, KVCache):
            return KVCache(k=kv_spec(cache.k), v=kv_spec(cache.v))
        if isinstance(cache, MambaState):
            return MambaState(conv=generic(cache.conv, {2: "model"}),
                              ssm=generic(cache.ssm, {1: "model"}))
        if isinstance(cache, MLSTMState):
            return MLSTMState(C=generic(cache.C, {2: "model"}),
                              n=generic(cache.n, {2: "model"}),
                              m=generic(cache.m, {}),
                              conv=generic(cache.conv, {2: "model"}))
        if isinstance(cache, SLSTMState):
            return SLSTMState(**{f: generic(getattr(cache, f), {2: "model"})
                                 for f in ("c", "n", "h", "m")})
        if isinstance(cache, tuple):    # whisper cross-attn (k, v) pair
            return tuple((b_ax, None, None, None) for _ in cache)
        raise TypeError(type(cache))

    return {key: [one(c) for c in states] for key, states in caches.items()}


def cache_shardings(cfg: ModelConfig, caches, mesh, batch: int) -> dict:
    def wrap(state_specs):
        # a state NamedTuple of specs, or whisper's plain (k, v) pair
        out = [NamedSharding(mesh, s) for s in state_specs]
        return (type(state_specs)(*out) if hasattr(state_specs, "_fields")
                else tuple(out))
    return {key: [wrap(s) for s in states]
            for key, states in cache_specs(cfg, caches, mesh, batch).items()}


def lay_out_caches(caches: dict, shardings: dict, lay) -> dict:
    """``caches`` (``init_caches``' tree) with ``lay(tensor, sharding)``
    applied to each tensor of each state (a state NamedTuple, or whisper's
    plain (k, v) pair) against ``cache_shardings``' tree."""
    def one(state, shd):
        items = [lay(t, s) for t, s in zip(state, shd)]
        return (type(state)(*items) if hasattr(state, "_fields")
                else tuple(items))
    return {key: [one(s, h) for s, h in zip(caches[key], shardings[key])]
            for key in caches}
