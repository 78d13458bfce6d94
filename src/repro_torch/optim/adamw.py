"""AdamW with decoupled weight decay (counterpart of ``repro.optim.adamw``).

A tree here is a dict of tensors keyed by parameter name (the model's
``named_parameters()``).  Moments are f32 whatever the parameter's dtype,
and the update is the reference's arithmetic, leaf by leaf.  Unlike the
reference, which returns new arrays, ``adamw_update`` and
``clip_by_global_norm`` write into the tensors they are given: at
granite-3-2b's width the parameters and the two moments are 30 GB in f32,
and a second copy of them would not fit the card beside the gradients.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm",
           "clip_by_global_norm"]


class AdamWState(NamedTuple):
    mu: dict
    nu: dict
    count: torch.Tensor        # int32 scalar


def adamw_init(params: dict) -> AdamWState:
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    dev = next(iter(params.values())).device
    return AdamWState(mu={k: zeros(p) for k, p in params.items()},
                      nu={k: zeros(p) for k, p in params.items()},
                      count=torch.zeros((), dtype=torch.int32, device=dev))


@torch.no_grad()
def adamw_update(grads: dict, state: AdamWState, params: dict, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> tuple[dict, AdamWState]:
    """Returns ``(params, state)``, both updated in place.  ``lr`` may be
    a tensor scalar.  Decay applies to every leaf, as in the reference."""
    c = state.count + 1
    cf = c.float()
    bc1 = 1.0 - b1 ** cf
    bc2 = 1.0 - b2 ** cf
    for name, p in params.items():
        g, m, v = grads[name].float(), state.mu[name], state.nu[name]
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        pf = p.float()
        upd += weight_decay * pf
        p.copy_(pf - lr * upd)
    return params, AdamWState(mu=state.mu, nu=state.nu, count=c)


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree.values()))


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float
                        ) -> tuple[dict, torch.Tensor]:
    """Scale ``grads`` in place (in f32, cast back) so their global norm
    is at most ``max_norm``; returns ``(grads, norm before clipping)``."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    for g in grads.values():
        g.copy_(g.float() * scale)
    return grads, gn
