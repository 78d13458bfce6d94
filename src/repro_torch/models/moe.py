"""Mixture-of-experts FFN (counterpart of ``repro.models.moe``): phi3.5-moe
and qwen2-moe.

Token-choice top-k routing with a fixed per-group capacity, as scatter /
gather dispatch.  Tokens are cut into ``G`` groups of ``s``; within a
group each (token, k) pair's expert slot is its running count among the
pairs that chose the same expert, in token-major, k-minor order, and a
pair whose slot reaches the capacity is dropped (weight 0).  The experts
are one SwiGLU batched over a leading ``E`` axis.  Under a mesh the
dispatch buffer is hinted over `model` on its expert dim (``pshard``), as
in the reference: experts over `model` (EP) when the axis divides E, else
the expert hidden dim (TP-MoE), as ``launch.sharding`` lays the weights.

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
from .pshard import contiguous_grad, hint, is_dtensor, wrap

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
    return _route(p.router, cfg, xt)


def _route(router: torch.Tensor, cfg: ModelConfig, xt: torch.Tensor):
    logits = xt.float() @ router
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


def _expert_mm(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(G, E, C, a) x (E, a, b) -> (G, E, C, b), batched over the experts.
    DTensors go through an explicit batched matmul over an (E, G*C, a)
    layout: the einsum's backward views a sharded expert dim in a way
    DTensor's local shards cannot take."""
    if not (is_dtensor(buf) or is_dtensor(w)):
        return torch.einsum("gecd,edf->gecf", buf, w)
    G, E, C, a = buf.shape
    x = buf.permute(1, 0, 2, 3).reshape(E, G * C, a)
    y = contiguous_grad(torch.bmm(x, w).reshape(E, G, C, -1))
    return y.permute(1, 0, 2, 3)


def moe_ffn(p: MoE, cfg: ModelConfig, x: torch.Tensor, *,
            group_size: Optional[int] = None
            ) -> tuple[torch.Tensor, MoEAux]:
    """Top-k routed SwiGLU experts.  ``x``: (B, S, d) -> same shape, in the
    compute dtype, and the aux values.

    ``group_size``: tokens per dispatch group (defaults to S, one group a
    batch row; decode passes the whole batch as one group, so the
    capacity stays tight at S=1).  Groups change the result wherever the
    capacity drops pairs: one-shot and chunked prefill differ there, as
    in the reference.  A DTensor ``x`` takes ``_moe_ffn_sharded``.
    """
    B, S, d = x.shape
    N = B * S
    gs = min(S if group_size is None else group_size, N)
    G = N // gs
    if G * gs != N:
        raise ValueError(f"group_size {gs} does not divide the {N} tokens "
                         f"of a ({B}, {S}) batch")
    if is_dtensor(x):
        return _moe_ffn_sharded(p, cfg, x, gs)
    cdt = cfg.compute_dtype
    xt = x.reshape(G, gs, d)
    probs, top_p, top_i = route(p, cfg, xt)
    gates = (top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)).to(cdt)
    C = moe_capacity(cfg, gs)
    xc, e_flat, slot, keep, buf = _dispatch(cfg, xt, top_i, C)
    buf_out = _experts(p, cfg, buf)
    y = _combine(buf_out, e_flat, slot, keep, gates).reshape(B, S, d)
    if hasattr(p, "shared"):
        y = y + _shared(p, cfg, xc.reshape(N, d)).reshape(B, S, d)
    me, ce, kept = _aux_terms(cfg, probs, top_i, keep)
    lb = cfg.n_experts * torch.sum(me * ce)
    return y, MoEAux(load_balance_loss=lb, dropped_fraction=1.0 - kept)


def _dispatch(cfg: ModelConfig, xt: torch.Tensor, top_i: torch.Tensor,
              C: int):
    """(xc, e_flat, slot, keep, buf (G, E, C, d)) of the groups ``xt``."""
    G, gs, d = xt.shape
    E, K = cfg.n_experts, cfg.n_experts_active
    cdt = cfg.compute_dtype
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
    g_idx = torch.arange(G, device=xt.device)[:, None].expand(G, gs * K)
    buf = torch.zeros((G, E, C + 1, d), dtype=cdt, device=xt.device)
    buf = buf.index_put((g_idx, e_flat, torch.where(keep, slot, C)), x_rep)
    return xc, e_flat, slot, keep, buf[:, :, :C]


def _experts(p: MoE, cfg: ModelConfig, buf: torch.Tensor) -> torch.Tensor:
    """The expert SwiGLU batched over E: (G, E, C, d) -> (G, E, C, d).
    The stacks are cast to the compute dtype on every call, as the
    reference does.  The profiler range "moe.casts" holds those casts,
    "moe.experts" the three batched GEMMs and the gate."""
    cdt = cfg.compute_dtype
    with record_function("moe.casts"):
        wg, wu, wd = (p.w_gate.to(cdt), p.w_up.to(cdt), p.w_down.to(cdt))
    with record_function("moe.experts"):
        h = F.silu(_expert_mm(buf, wg)) * _expert_mm(buf, wu)
        return _expert_mm(h, wd)


def _combine(buf_out, e_flat, slot, keep, gates) -> torch.Tensor:
    """Each pair reads its slot (a dropped pair reads slot C-1 with weight
    0, as in the reference) and the k are summed by gate: (G, s, d)."""
    G, E, C, d = buf_out.shape
    gs, K = gates.shape[1], gates.shape[2]
    g_idx = torch.arange(G, device=buf_out.device)[:, None].expand(G, gs * K)
    w = torch.where(keep, gates.reshape(G, gs * K), 0.0)
    y = buf_out[g_idx, e_flat, slot.clamp_max(C - 1)] * w[..., None]
    return y.reshape(G, gs, K, d).sum(dim=2)


def _shared(p: MoE, cfg: ModelConfig, xs: torch.Tensor) -> torch.Tensor:
    """The shared expert on (N, d), gated (qwen2-moe gates it)."""
    cdt = cfg.compute_dtype
    sh = swiglu(p.shared, xs, cdt)
    return sh * torch.sigmoid(xs @ p.shared_gate.to(cdt))


def _aux_terms(cfg: ModelConfig, probs, top_i, keep):
    """(mean probability of each expert, fraction of tokens whose top-1 is
    each expert, fraction of pairs kept): the switch aux loss is E *
    sum(me * ce)."""
    me = probs.mean(dim=(0, 1))
    # (one_hot's own values, as a comparison)
    top1 = top_i[..., :1] == torch.arange(cfg.n_experts, device=top_i.device)
    ce = top1.float().mean(dim=(0, 1))
    return me, ce, keep.float().mean()


def _moe_ffn_sharded(p: MoE, cfg: ModelConfig, x, gs: int):
    """``moe_ffn`` on a DTensor: the tokens split over the dp axes, each
    rank routes and dispatches its own groups on local tensors (the
    router whole; its gradient a partial sum over those axes), the
    dispatch buffer becomes a DTensor hinted over `model` on its expert
    dim, the expert SwiGLU runs on DTensors as the weights are laid out
    (EP: experts over `model`; TP-MoE: the hidden dim), and the output is
    laid back out as the local groups for the local combine: the
    collective of EP is then an all-gather of the expert outputs, of
    TP-MoE a reduction.  A group that would straddle ranks (decode's one
    group over the batch) gathers the tokens whole first.  The aux values
    are the means of the ranks' local means."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.n_experts_active
    cdt = cfg.compute_dtype
    x = hint(x, "dp", None, None)
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    split = [i for i, q in enumerate(x.placements) if q.is_shard(0)]
    n_split = math.prod(mesh.size(i) for i in split)
    if (B // n_split * S) % gs:          # a group would straddle ranks
        split, n_split = [], 1
    pl = [Shard(0) if i in split else Replicate() for i in range(mesh.ndim)]
    x = x.redistribute(mesh, pl)
    partial = [Partial() if i in split else Replicate()
               for i in range(mesh.ndim)]
    xl = x.to_local()
    Gl = xl.shape[0] * S // gs
    router = p.router.redistribute(mesh, rep).to_local(
        grad_placements=partial)
    xt = xl.reshape(Gl, gs, d)
    probs, top_p, top_i = _route(router, cfg, xt)
    gates = (top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)).to(cdt)
    C = moe_capacity(cfg, gs)
    _, e_flat, slot, keep, buf_l = _dispatch(cfg, xt, top_i, C)
    G = Gl * n_split
    buf = wrap(buf_l, mesh, pl, (G, E, C, d))
    # EP: experts over `model`; TP-MoE (E % model != 0): E replicated, the
    # expert hidden dim split by the weights' layout.
    buf = hint(buf, "dp", "model", None, None)
    bo = _experts(p, cfg, buf).redistribute(mesh, pl).to_local()
    y_l = _combine(bo, e_flat, slot, keep, gates).reshape(xl.shape)
    y = wrap(y_l, mesh, pl, x.shape)
    if hasattr(p, "shared"):
        y = y + _shared(p, cfg, x.to(cdt).reshape(B * S, d)).reshape(B, S, d)

    def mean_over_ranks(t):
        return DTensor.from_local(t / n_split, mesh, partial,
                                  run_check=False).redistribute(mesh, rep)

    me, ce, kept = (mean_over_ranks(t)
                    for t in _aux_terms(cfg, probs, top_i, keep))
    lb = E * torch.sum(me * ce)
    return y, MoEAux(load_balance_loss=lb, dropped_fraction=1.0 - kept)
