"""RandLR gradient compression (counterpart of ``repro.optim.compress``):
the paper's randomized range finder as the data-parallel gradient
collective, PowerSGD-style with one shared basis.

For each large 2-D gradient block, with the EF-corrected per-pod gradients
``g_p + e_p`` stacked on a leading ``npods`` axis:

  1. ``W = mean_p (g_p + e_p) Omega^T`` (m x r), Omega shared by the pods;
  2. ``Q = orth(W)`` by CholeskyQR2 with a trace ridge (``_ridged_orth``);
  3. ``P = mean_p Q^T (g_p + e_p)`` (r x n);
  4. ``g_hat = Q P``, and ``e_p <- (g_p + e_p) - g_hat``.

The two means are the pod collectives (``m r`` and ``r n`` elements in place
of ``m n``); on one process they are means over the leading axis.

A tree is a dict of tensors keyed by parameter name.  The reference stacks
each layer's weights into one leaf and draws one Omega per leaf; the port
keeps one tensor per layer, so layers that the reference stacks share
their Omega here too: it is drawn per stacked name (``blocks.<i>.`` with
the layer index dropped), numbered in the reference's leaf order.  Omega
comes from the port's generator (``core.rng.block_seed`` of the step's
seed and that number), not from threefry; ``_block_compress`` takes it
injected, so tests hold it to the reference on the same Omega.
"""
from __future__ import annotations

import math
import re
from typing import NamedTuple

import torch

from ..core.rng import block_seed

__all__ = ["CompressorConfig", "ef_init", "compress_grads"]

_LAYER = re.compile(r"^blocks\.\d+\.")


class CompressorConfig(NamedTuple):
    rank: int = 16               # r, the paper's k, per gradient block
    min_dim: int = 128           # only compress blocks with min(m, n) >= this
    min_numel: int = 1 << 16     # ... and at least this many elements
    error_feedback: bool = True


def _is_compressible(leaf: torch.Tensor, cfg: CompressorConfig) -> bool:
    if leaf.dim() < 2:
        return False
    m, n = leaf.shape[-2], leaf.shape[-1]
    return (min(m, n) >= cfg.min_dim and m * n >= cfg.min_numel
            and leaf.dtype.is_floating_point)


def ef_init(params: dict, cfg: CompressorConfig, npods: int) -> dict:
    """Per-pod error-feedback buffers (npods, *shape) in f32; a scalar zero
    for leaves that are not compressed."""
    def leaf(p):
        if cfg.error_feedback and _is_compressible(p, cfg):
            return torch.zeros((npods,) + tuple(p.shape),
                               dtype=torch.float32, device=p.device)
        return torch.zeros((), dtype=torch.float32, device=p.device)
    return {k: leaf(p) for k, p in params.items()}


def _ridged_orth(W: torch.Tensor) -> torch.Tensor:
    """CholeskyQR2 with a trace ridge: an orthonormal range basis that
    stays finite for (near-)zero sketches, where plain Cholesky would give
    NaN."""
    def one_round(Q):
        G = Q.T @ Q
        r = G.shape[0]
        ridge = 1e-6 * torch.trace(G) / r + 1e-30
        C = torch.linalg.cholesky(
            G + ridge * torch.eye(r, dtype=G.dtype, device=G.device))
        return torch.linalg.solve(C, Q.T).T
    return one_round(one_round(W))


def _block_compress(g: torch.Tensor, e: torch.Tensor, omega: torch.Tensor,
                    r: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One (m, n) block: ``g`` (npods, m, n), ``e`` its EF buffer (or a
    broadcastable zero), ``omega`` (r, n).  Returns ``(g_hat, new_e)``."""
    gf = g.float() + e                                       # (npods, m, n)
    W = torch.einsum("pmn,rn->pmr", gf, omega).mean(0)       # collective 1
    Q = _ridged_orth(W)                                      # (m, r)
    P = torch.einsum("mr,pmn->prn", Q, gf).mean(0)           # collective 2
    g_hat = Q @ P
    return g_hat, gf - g_hat[None]


def _omega(seed: int, index: int, r: int, n: int, device) -> torch.Tensor:
    """The shared test matrix (r, n) of the leaf numbered ``index``:
    N(0, 1/n) entries from ``block_seed(seed, index)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(block_seed(seed, index))
    return torch.randn((r, n), generator=gen, dtype=torch.float32,
                       device=device) * n ** -0.5


def _stacked_names(names) -> list:
    """The reference's leaf names (layer index dropped), in its flatten
    order: nested dict keys sorted at every level."""
    return sorted({_LAYER.sub("blocks.", k) for k in names},
                  key=lambda k: k.split("."))


def compress_grads(seed: int, grads_per_pod: dict, ef_state: dict,
                   cfg: CompressorConfig) -> tuple[dict, dict, dict]:
    """``grads_per_pod``: a leading ``npods`` axis on every leaf.

    Returns ``(mean_grads, new_ef_state, stats)``.  Compressible leaves go
    through the low-rank path with Omega drawn from ``seed`` (per stacked
    name, see the module docstring); the others are a plain mean over
    pods."""
    index = {k: i for i, k in enumerate(_stacked_names(grads_per_pod))}
    out, new_ef = {}, {}
    dense_bytes = comp_bytes = 0
    for name, g in grads_per_pod.items():
        e = ef_state[name]
        gl = g[0]
        if not _is_compressible(gl, cfg):
            out[name] = g.mean(0)
            new_ef[name] = e
            continue
        m, n = gl.shape[-2], gl.shape[-1]
        r = min(cfg.rank, m, n)
        omega = _omega(seed, index[_LAYER.sub("blocks.", name)], r, n,
                       g.device)
        lead = gl.shape[:-2]
        gle = g.reshape((g.shape[0], -1, m, n))              # (p, L, m, n)
        ee = e.reshape(gle.shape) if e.dim() else e.expand(gle.shape)
        ghs, nes = zip(*(_block_compress(gle[:, i], ee[:, i], omega, r)
                         for i in range(gle.shape[1])))
        out[name] = torch.stack(ghs).reshape(lead + (m, n)).to(gl.dtype)
        new_ef[name] = (torch.stack(nes, 1).reshape(g.shape)
                        if cfg.error_feedback else e)
        L = math.prod(lead) if lead else 1
        dense_bytes += L * m * n * 4
        comp_bytes += L * (m + n) * r * 4
    stats = {"dense_bytes": dense_bytes, "compressed_bytes": comp_bytes,
             "ratio": comp_bytes / max(1, dense_bytes)}
    return out, new_ef, stats
