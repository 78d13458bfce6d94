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
parameters, named by their dotted path.  A leaf of a target name with 2
or more dimensions is eligible; one with more than 2 (the port's (E, m, n)
expert stacks) is factored one (m, n) slice at a time, as the reference
factors its stacked leaves.  The port's model holds one weight per layer,
where the reference stacks each projection over the layers;
``compress_params`` therefore groups the layers' leaves of one projection
(``blocks.<i>.mixer.wq`` for every ``i`` is the projection
``blocks.*.mixer.wq``) and, as the reference does with a stack, factors
every slice of it, over every layer and every expert, or none.
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
    """Drop-in factored weight: ``x @ W`` becomes ``(x @ B) @ P``; a
    stacked weight (E, m, n) has B (E, m, k) and P (E, k, n)."""
    B: torch.Tensor       # (..., m, k)
    P: torch.Tensor       # (..., k, n)

    @property
    def shape(self):
        return tuple(self.B.shape[:-1]) + (self.P.shape[-1],)

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
    return bool(path) and path[-1] in _TARGETS and leaf.dim() >= 2


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


def _compress_leaf(seed: int, i: int, W: torch.Tensor, rank: int,
                   energy_keep: float, qr_impl: str):
    """Leaf ``i``: a matrix probed with ``block_seed(seed, i)``; a stacked
    leaf slice by slice, slice ``j`` with ``block_seed(seed, i * 997 + j)``
    (the reference's ``fold_in(key, i * 997 + j)``), factored only if every
    slice passes."""
    if W.dim() == 2:
        return _maybe_compress(block_seed(seed, i), W, rank, energy_keep,
                               qr_impl)
    m, n = W.shape[-2:]
    slices = W.reshape(-1, m, n)
    lws = []
    for j in range(slices.shape[0]):
        lw = _maybe_compress(block_seed(seed, i * 997 + j), slices[j], rank,
                             energy_keep, qr_impl)
        if lw is None:
            return None
        lws.append(lw)
    lead = tuple(W.shape[:-2])
    return LowRankWeight(B=torch.stack([lw.B for lw in lws]).reshape(
                             lead + (m, -1)),
                         P=torch.stack([lw.P for lw in lws]).reshape(
                             lead + (-1, n)))


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


def _projection(path) -> str:
    """Name of the projection a leaf belongs to: its path with the layer
    index after ``blocks`` written ``*`` (the reference's stacked leaf)."""
    parts = [str(p) for p in path]
    for j in range(1, len(parts)):
        if parts[j - 1] == "blocks" and parts[j].isdigit():
            parts[j] = "*"
    return ".".join(parts)


def compress_params(gen_or_seed: int, params: Any, *, rank: int,
                    energy_keep: float = 0.95,
                    qr_impl: str = "blocked") -> tuple[Any, dict]:
    """Replace eligible leaves with LowRankWeight factors.  Returns (tree,
    report); the input is not modified (a module is copied before its
    first factored leaf is set).

    The layers of one projection (``_projection``), and the slices of a
    stacked leaf, are factored together or not at all, as the reference
    factors a stacked leaf only if every slice passes the energy test; the
    report has one entry per projection, with ``dense_elems`` and
    ``factored_elems`` summed over its layers.  ``qr_impl`` selects the
    pivoted-QR engine of the probing RSVD ('blocked' production default |
    'cgs2' oracle).  Seeds: ``_compress_leaf``."""
    if isinstance(gen_or_seed, torch.Generator):
        raise TypeError("compress_params takes an int seed (one per leaf "
                        "is derived from it), not a generator")
    groups: dict = {}
    for i, (path, leaf) in enumerate(_leaves(params)):
        if _eligible(path, leaf):
            groups.setdefault(_projection(path), []).append((i, path, leaf))
    out, report = params, {}
    for name, members in groups.items():
        lws = [_compress_leaf(gen_or_seed, i, leaf, rank, energy_keep,
                              qr_impl)
               for i, _, leaf in members]
        if any(lw is None for lw in lws):
            report[name] = {"compressed": False}
            continue
        if out is params and isinstance(params, nn.Module):
            out = copy.deepcopy(params)         # copied on the first factor
        for (_, path, _), lw in zip(members, lws):
            out = _with_leaf(out, path, lw)
        report[name] = {
            "compressed": True,
            "dense_elems": sum(int(leaf.numel()) for _, _, leaf in members),
            "factored_elems": sum(int(lw.B.numel() + lw.P.numel())
                                  for lw in lws)}
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
