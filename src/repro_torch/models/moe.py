"""Mixture-of-experts FFN (counterpart of ``repro.models.moe``): phi3.5-moe
and qwen2-moe.

Token-choice top-k routing with a fixed per-group capacity, as scatter /
gather dispatch.  Tokens are cut into ``G`` groups of ``s``; within a
group each (token, k) pair's expert slot is its running count among the
pairs that chose the same expert, in token-major, k-minor order, and a
pair whose slot reaches the capacity is dropped (weight 0).  The experts
are one SwiGLU batched over a leading ``E`` axis; the reference's ``hint``
for expert or hidden-dim sharding has nothing to shard on one card.

Every shape on the path follows from the input's and the config's: no
``.item()``, ``nonzero`` or boolean-mask indexing, so a decode step makes
no host sync here.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from .config import ModelConfig
from .mlp import SwiGLU, _normal_, _param, swiglu

__all__ = ["MoEAux", "MoE", "moe_capacity", "route", "dispatch_indices",
           "moe_ffn"]


class MoEAux(NamedTuple):
    """The reference's auxiliary losses; zero on a dense stack."""
    load_balance_loss: torch.Tensor    # switch-style aux loss
    dropped_fraction: torch.Tensor     # fraction of (token, k) pairs dropped


class MoE(nn.Module):
    """The reference's MoE leaf dict as a module: ``router`` (d, E) in f32
    whatever the params dtype; the stacked expert SwiGLU ``w_gate``,
    ``w_up`` (E, d, f) and ``w_down`` (E, f, d); with shared experts a
    ``shared`` SwiGLU of width ``f * n_shared_experts`` and its
    ``shared_gate`` (d, 1)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        pdt = cfg.params_dtype
        self.router = _param((d, E), torch.float32, device)
        self.w_gate = _param((E, d, f), pdt, device)
        self.w_up = _param((E, d, f), pdt, device)
        self.w_down = _param((E, f, d), pdt, device)
        if cfg.n_shared_experts:
            self.shared = SwiGLU(d, f * cfg.n_shared_experts, pdt, device)
            self.shared_gate = _param((d, 1), pdt, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "MoE":
        """The reference's scales: d^-0.5 for the router and the input
        projections, f^-0.5 for ``w_down``."""
        d, f = self.w_gate.shape[1:]
        _normal_(self.router, gen, d ** -0.5)
        _normal_(self.w_gate, gen, d ** -0.5)
        _normal_(self.w_up, gen, d ** -0.5)
        _normal_(self.w_down, gen, f ** -0.5)
        if hasattr(self, "shared"):
            self.shared.init_(gen)
            _normal_(self.shared_gate, gen, d ** -0.5)
        return self


def moe_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Slots per expert per group; a multiple of 8, as the reference's."""
    c = math.ceil(tokens_per_group * cfg.n_experts_active / cfg.n_experts
                  * cfg.moe_capacity_factor)
    return max(8, -(-c // 8) * 8)


def route(p: MoE, cfg: ModelConfig, xt: torch.Tensor):
    """The router on ``xt`` (G, s, d), in f32: (probs (G, s, E), top_p,
    top_i (G, s, K)), the k largest probabilities in descending order.

    Top-k order and ties: ``jax.lax.top_k`` puts the larger first and,
    among equal values, the lower index first, and that order sets the
    dispatch order (which pairs a full expert drops).  ``torch.topk``
    promises no order among ties on CUDA, so the k come from a stable
    descending sort, which keeps equal values in index order everywhere."""
    logits = xt.float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.n_experts_active
    return probs, vals[..., :K], idx[..., :K]


def dispatch_indices(e_flat: torch.Tensor, E: int, capacity: int):
    """Per-group slots.  ``e_flat`` (G, s*K): the chosen experts in token
    order.  Returns (slot, keep): ``slot[g, i]`` is the running count of
    ``e_flat[g, i]`` among the group's first i entries; keep = slot <
    capacity.  The count is an integer cumsum (exact, and allowed under
    ``torch.use_deterministic_algorithms`` on the card, where a floating
    one is not), taken along the innermost axis of a (G, E, sK) one-hot:
    along an outer axis the card's scan runs each of the E columns as one
    sequential thread."""
    experts = torch.arange(E, device=e_flat.device)[None, :, None]
    onehot = e_flat[:, None, :] == experts                 # (G, E, sK)
    pos = torch.cumsum(onehot, dim=2, dtype=torch.int32) - 1
    slot = torch.gather(pos, 1, e_flat[:, None, :])[:, 0]
    return slot, slot < capacity


def moe_ffn(p: MoE, cfg: ModelConfig, x: torch.Tensor, *,
            group_size: Optional[int] = None
            ) -> tuple[torch.Tensor, MoEAux]:
    """Top-k routed SwiGLU experts.  ``x``: (B, S, d) -> same shape, in the
    compute dtype, and the aux values.

    ``group_size``: tokens per dispatch group (defaults to S, one group a
    batch row; decode passes the whole batch as one group, so the
    capacity stays tight at S=1).  Groups change the result wherever the
    capacity drops pairs: one-shot and chunked prefill differ there, as
    in the reference.
    """
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.n_experts_active
    cdt = cfg.compute_dtype
    N = B * S
    gs = min(S if group_size is None else group_size, N)
    G = N // gs
    if G * gs != N:
        raise ValueError(f"group_size {gs} does not divide the {N} tokens "
                         f"of a ({B}, {S}) batch")
    xt = x.reshape(G, gs, d)
    probs, top_p, top_i = route(p, cfg, xt)
    gates = (top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)).to(cdt)

    C = moe_capacity(cfg, gs)
    e_flat = top_i.reshape(G, gs * K)
    slot, keep = dispatch_indices(e_flat, E, C)
    xc = xt.to(cdt)
    x_rep = xc[:, :, None].expand(G, gs, K, d).reshape(G, gs * K, d)
    # The scatter.  The reference adds every pair into buf[e, min(slot,
    # C-1)], a dropped pair adding zeros.  Written instead of added, a
    # dropped pair's zeros could overwrite the kept pair in slot C-1; so
    # dropped pairs go to a sink row, slot C of an (E, C+1) buffer that is
    # cut off, and every row that stays is written once: the same values,
    # in any order of the writes, forward and backward.
    g_idx = torch.arange(G, device=x.device)[:, None].expand(G, gs * K)
    buf = torch.zeros((G, E, C + 1, d), dtype=cdt, device=x.device)
    buf = buf.index_put((g_idx, e_flat, torch.where(keep, slot, C)), x_rep)
    buf = buf[:, :, :C]

    # Expert SwiGLU batched over E.  The stacks are cast to the compute
    # dtype on every call, as the reference does.  The profiler range
    # "moe.casts" holds those casts, "moe.experts" the three batched GEMMs
    # and the gate.
    with record_function("moe.casts"):
        wg, wu, wd = (p.w_gate.to(cdt), p.w_up.to(cdt), p.w_down.to(cdt))
    with record_function("moe.experts"):
        h = F.silu(torch.einsum("gecd,edf->gecf", buf, wg)) \
            * torch.einsum("gecd,edf->gecf", buf, wu)
        buf_out = torch.einsum("gecf,efd->gecd", h, wd)      # (G, E, C, d)

    # The combine: each pair reads its slot (a dropped pair reads slot C-1
    # with weight 0, as in the reference) and the k are summed by gate.
    w = torch.where(keep, gates.reshape(G, gs * K), 0.0)
    y = buf_out[g_idx, e_flat, slot.clamp_max(C - 1)] * w[..., None]
    y = y.reshape(G, gs, K, d).sum(dim=2).reshape(B, S, d)

    if hasattr(p, "shared"):
        xs = xc.reshape(N, d)
        sh = swiglu(p.shared, xs, cdt)
        # qwen2-moe gates its shared expert.
        sh = sh * torch.sigmoid(xs @ p.shared_gate.to(cdt))
        y = y + sh.reshape(B, S, d)

    # Switch aux loss: E * sum_e (fraction of tokens whose top-1 is e) *
    # (mean probability of e); and the share of pairs dropped.
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(top_i[..., 0], E).float().mean(dim=(0, 1))
    lb = E * torch.sum(me * ce)
    dropped = 1.0 - keep.float().mean()
    return y, MoEAux(load_balance_loss=lb, dropped_fraction=dropped)
