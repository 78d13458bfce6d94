"""Offline low-rank weight compression with the paper's randomized ID
(counterpart of ``repro.serving.compress``).

A weight ``W (m x n) ~= B P`` replaces one m x n product with two skinny
ones.  Each candidate is probed with the port's ``rsvd`` (gaussian sketch:
the ``sketch_accum`` and ``panel_step`` kernels on the card), and a matrix
is factored only if rank ``k`` keeps ``energy_keep`` of its Frobenius
mass; freshly initialized weights are not compressible, which the report
shows.

The reference's models cannot consume a ``LowRankWeight`` leaf: they call
``.astype`` on every projection, which the factored leaf does not have.
The port mirrors that and adds nothing: its models call ``.to`` on their
weights, which a ``LowRankWeight`` does not have either
(ROADMAP Queue C).

The tree may be nested dicts, lists and tuples of tensors or an
``nn.Module`` (the port's ``Transformer``): a module's leaves are its
parameters, named by their dotted path.  Only 2-D leaves are eligible:
the port's model holds one weight per layer, where the reference stacks
each weight over the layers and factors the stack slice by slice.
"""
from __future__ import annotations

import copy
from typing import Any, NamedTuple

import torch
from torch import nn

from ..core import rsvd
from ..core.rng import block_seed

__all__ = ["LowRankWeight", "low_rank_targets", "compress_params",
           "apply_low_rank", "compression_report"]

# Leaf names eligible for weight factorization (2-D projections).
_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "w_in",
            "w_out", "in_proj", "out_proj", "up_proj", "down_proj",
            "cq", "ck", "cv")


class LowRankWeight(NamedTuple):
    """Drop-in factored weight: ``x @ W`` becomes ``(x @ B) @ P``."""
    B: torch.Tensor       # (m, k)
    P: torch.Tensor       # (k, n)

    @property
    def shape(self):
        return (self.B.shape[0], self.P.shape[1])

    def materialize(self) -> torch.Tensor:
        return self.B @ self.P


def _leaves(tree, path=()):
    """(path, leaf) pairs in a fixed order: a module's own parameters,
    then its children; a dict's items; a list's or tuple's entries."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters(recurse=False):
            yield path + (name,), p
        for name, child in tree.named_children():
            yield from _leaves(child, path + (name,))
    elif isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _leaves(sub, path + (i,))
    else:
        yield path, tree


def _name(path) -> str:
    return ".".join(str(p) for p in path)


def _eligible(path, leaf) -> bool:
    return bool(path) and path[-1] in _TARGETS and leaf.dim() == 2


def low_rank_targets(params: Any) -> list[str]:
    return [_name(path) for path, leaf in _leaves(params)
            if _eligible(path, leaf)]


def _maybe_compress(seed: int, W: torch.Tensor, rank: int,
                    energy_keep: float, qr_impl: str):
    """RSVD-probe one matrix; factor if rank-k keeps enough energy."""
    m, n = W.shape
    k = min(rank, m, n)
    if k * (m + n) >= m * n:      # factorization would not shrink anything
        return None
    Wf = W.detach().float()
    dec = rsvd(seed, Wf, k, sketch_kind="gaussian", qr_impl=qr_impl)
    total = torch.sum(Wf ** 2)
    kept = torch.sum(dec.S ** 2)
    if float(kept / torch.clamp(total, min=1e-30)) < energy_keep:
        return None
    B = (dec.U * dec.S[None, :]).to(W.dtype)
    P = dec.Vh.to(W.dtype)
    return LowRankWeight(B=B, P=P)


def _with_leaf(tree, path, value):
    """``tree`` with the leaf at ``path`` replaced by ``value`` (modules
    are changed in place; dicts, lists and tuples are rebuilt)."""
    if not path:
        return value
    head, rest = path[0], path[1:]
    if isinstance(tree, nn.Module):
        if rest:
            _with_leaf(getattr(tree, head), rest, value)
        else:
            del tree._parameters[head]      # a plain attribute from now on
            setattr(tree, head, value)
        return tree
    if isinstance(tree, dict):
        return {**tree, head: _with_leaf(tree[head], rest, value)}
    items = list(tree)
    items[head] = _with_leaf(items[head], rest, value)
    return type(tree)(items)


def compress_params(gen_or_seed: int, params: Any, *, rank: int,
                    energy_keep: float = 0.95,
                    qr_impl: str = "blocked") -> tuple[Any, dict]:
    """Replace eligible leaves with LowRankWeight factors.  Returns (tree,
    report); the input is not modified (a module is copied before its
    first factored leaf is set).
    ``qr_impl`` selects the pivoted-QR engine of the probing RSVD
    ('blocked' production default | 'cgs2' oracle).  Leaf ``i`` is probed
    with the seed ``block_seed(seed, i)``."""
    if isinstance(gen_or_seed, torch.Generator):
        raise TypeError("compress_params takes an int seed (one per leaf "
                        "is derived from it), not a generator")
    found = list(_leaves(params))
    out, report = params, {}
    for i, (path, leaf) in enumerate(found):
        if not _eligible(path, leaf):
            continue
        lw = _maybe_compress(block_seed(gen_or_seed, i), leaf, rank,
                             energy_keep, qr_impl)
        name = _name(path)
        if lw is None:
            report[name] = {"compressed": False}
        else:
            if out is params and isinstance(params, nn.Module):
                out = copy.deepcopy(params)     # copied on the first factor
            out = _with_leaf(out, path, lw)
            report[name] = {"compressed": True,
                            "dense_elems": int(leaf.numel()),
                            "factored_elems": int(lw.B.numel()
                                                  + lw.P.numel())}
    return out, report


def apply_low_rank(x: torch.Tensor, W) -> torch.Tensor:
    """``x @ W`` for dense or factored weights (two skinny products)."""
    if isinstance(W, LowRankWeight):
        return (x @ W.B) @ W.P
    return x @ W


def compression_report(report: dict) -> str:
    dense = sum(r.get("dense_elems", 0) for r in report.values()
                if r["compressed"])
    fact = sum(r.get("factored_elems", 0) for r in report.values()
               if r["compressed"])
    n_c = sum(1 for r in report.values() if r["compressed"])
    n_t = len(report)
    lines = [f"compressed {n_c}/{n_t} eligible weight matrices"]
    if dense:
        lines.append(f"factored elements: {fact:,} / {dense:,} "
                     f"({fact / dense:.1%} of dense)")
    return "\n".join(lines)
