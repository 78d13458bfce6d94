"""Mamba-1 selective SSM mixer, jamba's non-attention layers (counterpart
of ``repro.models.mamba``).

The reference is jnp, with no Pallas kernel, so this is plain PyTorch.  It
keeps the reference's structure: a CHUNKED scan.  Within a chunk of Q
tokens the elementwise linear recurrence

    h_t = Abar_t * h_{t-1} + dt_t * B_t * x_t        (diagonal A)

is an inclusive scan of the pairs ``(Abar_t, Bx_t)`` under ``(a1, b1) .
(a2, b2) = (a1 a2, a2 b1 + b2)``, taken here by log-depth doubling over
the Q axis (the reference's ``lax.associative_scan``); a Python loop over
the chunks carries the (B, d_inner, d_state) state (its ``lax.scan``).
``Abar`` and ``Bx`` are formed one chunk at a time, not as whole
(B, S, d_inner, d_state) f32 tensors (2.15 GB each at jamba's width and
S=4096); per element the arithmetic is the reference's.  The scan never
forms ``exp(cumsum(dt A))`` to divide by it: over a 128-token chunk that
product underflows f32 (dt reaches 0.1 and |A| 16 at init).

``dt_bias``, ``A_log`` and ``D`` stay f32 whatever the params dtype, and
``x_proj``, ``dt_proj`` and the recurrence run in f32, as the reference
does.  As the reference asserts, a sequence longer than the chunk must be
a multiple of it; here that is a ``ValueError`` that names the rule.

``mamba_decode`` writes the new state into the ``MambaState`` it is given,
in place, and returns it (the port's caches are written in place; the
reference returns a new state).

The profiler range ``mamba.scan`` holds the recurrence: the chunk loop of
a prefill (discretization, the doubling scan, the state carried, the read
out by C) and a decode step's one-token update (there with the small
``x_proj`` and ``dt_proj`` products that feed it); the large projections,
the conv and the gate stay outside it.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from .config import ModelConfig
from .mlp import _normal_, _param

__all__ = ["MambaState", "Mamba", "mamba_init", "mamba_forward",
           "mamba_prefill", "mamba_init_state", "mamba_decode",
           "MAMBA_CHUNK"]

# Tokens a chunk of the scan (the reference's default ``chunk``).
MAMBA_CHUNK = 128


class MambaState(NamedTuple):
    conv: torch.Tensor    # (B, d_conv - 1, d_inner) rolling conv window
    ssm: torch.Tensor     # (B, d_inner, d_state), f32


class Mamba(nn.Module):
    """The reference's Mamba leaf dict as a module: ``in_proj`` (d, 2 dI),
    ``conv_w`` (dc, dI), ``conv_b`` (dI,), ``x_proj`` (dI, dt_rank + 2 dS),
    ``dt_proj`` (dt_rank, dI) and ``out_proj`` (dI, d) in the params
    dtype; ``dt_bias`` (dI,), ``A_log`` (dI, dS) and ``D`` (dI,) in f32."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d, dI = cfg.d_model, cfg.d_inner
        dS, dc = cfg.mamba_d_state, cfg.mamba_d_conv
        dt_rank = max(1, math.ceil(d / 16))
        pdt, f32 = cfg.params_dtype, torch.float32
        self.in_proj = _param((d, 2 * dI), pdt, device)
        self.conv_w = _param((dc, dI), pdt, device)
        self.conv_b = _param((dI,), pdt, device)
        self.x_proj = _param((dI, dt_rank + 2 * dS), pdt, device)
        self.dt_proj = _param((dt_rank, dI), pdt, device)
        self.dt_bias = _param((dI,), f32, device)
        self.A_log = _param((dI, dS), f32, device)
        self.D = _param((dI,), f32, device)
        self.out_proj = _param((dI, d), pdt, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "Mamba":
        """The reference's init: N(0, 1) projections at fan-in scales, a
        zero conv bias, S4D-real ``A`` (``A_log = log(1..dS)`` on every
        row), ``D = 1``, and ``dt_bias`` the inverse softplus of a dt drawn
        log-uniform in [1e-3, 0.1]."""
        d, dI = self.in_proj.shape[0], self.in_proj.shape[1] // 2
        dc, dS = self.conv_w.shape[0], self.A_log.shape[1]
        dt_rank = self.dt_proj.shape[0]
        dev = self.in_proj.device
        _normal_(self.in_proj, gen, d ** -0.5)
        _normal_(self.conv_w, gen, dc ** -0.5)
        self.conv_b.zero_()
        _normal_(self.x_proj, gen, dI ** -0.5)
        _normal_(self.dt_proj, gen, dt_rank ** -0.5)
        u = torch.rand((dI,), generator=gen, device=dev)
        dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
        self.dt_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
        self.A_log.copy_(torch.log(torch.arange(
            1, dS + 1, dtype=torch.float32, device=dev)).expand(dI, dS))
        self.D.fill_(1.0)
        _normal_(self.out_proj, gen, dI ** -0.5)
        return self


@torch.no_grad()
def mamba_init(gen: torch.Generator, cfg: ModelConfig) -> Mamba:
    """A ``Mamba`` with the reference's scales, drawn from ``gen``, on the
    generator's device."""
    return Mamba(cfg, device=gen.device).init_(gen)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 history: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv along S.  x: (B, S, dI); w: (dc, dI).

    ``history``: (B, dc-1, dI) previous tokens (decode), else zero-pad.
    """
    dc = w.shape[0]
    B, S, dI = x.shape
    if history is None:
        history = torch.zeros((B, dc - 1, dI), dtype=x.dtype,
                              device=x.device)
    xp = torch.cat([history.to(x.dtype), x], dim=1)        # (B, S+dc-1, dI)
    out = xp[:, 0:S] * w[0]
    for i in range(1, dc):
        out = out + xp[:, i:i + S] * w[i]
    return out + b


def _ssm_terms(p: Mamba, cfg: ModelConfig, xc: torch.Tensor):
    """The per-token terms of the recurrence from the conv'd ``xc``, in
    f32: (dt (..., dI), A (dI, dS), Bc (..., dS), Cc (..., dS))."""
    dS = cfg.mamba_d_state
    dt_rank = p.dt_proj.shape[0]
    dbc = xc.float() @ p.x_proj.float()
    dt, Bc, Cc = torch.split(dbc, [dt_rank, dS, dS], dim=-1)
    dt = F.softplus(dt @ p.dt_proj.float() + p.dt_bias)
    return dt, -torch.exp(p.A_log), Bc, Cc


def _ssm_inputs(p: Mamba, cfg: ModelConfig, xc: torch.Tensor):
    """Per-token (Abar, Bx, C) from the conv'd ``xc``, all f32: Abar and
    Bx (..., dI, dS), C (..., dS)."""
    dt, A, Bc, Cc = _ssm_terms(p, cfg, xc)
    Abar, Bx = _discretize(dt, A, Bc, xc)
    return Abar, Bx, Cc


def _discretize(dt, A, Bc, xc):
    """(Abar, Bx) = (exp(dt A), dt x B) for the tokens given."""
    Abar = torch.exp(dt[..., None] * A)
    Bx = (dt * xc.float())[..., None] * Bc[..., None, :]
    return Abar, Bx


def _scan_chunk(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of (a, b) along axis 1 under (a1, b1) . (a2, b2) =
    (a1 a2, a2 b1 + b2), by doubling: log2(Q) rounds.  Returns (P, S): the
    products of the a's and the states from a zero start."""
    Q = a.shape[1]
    off = 1
    while off < Q:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]],
                      dim=1)
        a = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], dim=1)
        off *= 2
    return a, b


def _check_chunk(S: int, chunk: int) -> int:
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(
            f"mamba scan: a sequence longer than chunk={chunk} must be a "
            f"multiple of it (the reference asserts S % chunk == 0); got "
            f"S={S}, S % {Q} = {S % Q}")
    return Q


def _mamba_scan(p: Mamba, cfg: ModelConfig, x: torch.Tensor, chunk: int):
    """Shared body: returns (out (B, S, d), final MambaState)."""
    B, S, d = x.shape
    Q = _check_chunk(S, chunk)
    cdt = cfg.compute_dtype
    xz = x @ p.in_proj.to(cdt)
    x1, z = torch.chunk(xz, 2, dim=-1)
    xc = F.silu(_causal_conv(x1, p.conv_w.to(cdt), p.conv_b.to(cdt)))
    dt, A, Bc, Cc = _ssm_terms(p, cfg, xc)

    h = torch.zeros((B, cfg.d_inner, cfg.mamba_d_state),
                    dtype=torch.float32, device=x.device)
    ys = []
    with record_function("mamba.scan"):
        for s0 in range(0, S, Q):
            sl = slice(s0, s0 + Q)
            Abar, Bx = _discretize(dt[:, sl], A, Bc[:, sl], xc[:, sl])
            Pt, St = _scan_chunk(Abar, Bx)                 # (B, Q, dI, dS)
            hs = Pt * h[:, None] + St
            ys.append(torch.einsum("bqds,bqs->bqd", hs, Cc[:, sl]))
            h = hs[:, -1]
        y = torch.cat(ys, dim=1)
    y = (y + p.D * xc.float()).to(cdt)
    y = y * F.silu(z)
    out = y @ p.out_proj.to(cdt)
    dc = cfg.mamba_d_conv
    conv_hist = x1[:, S - (dc - 1):] if S >= dc - 1 else F.pad(
        x1, (0, 0, dc - 1 - S, 0))
    return out, MambaState(conv=conv_hist.to(cdt), ssm=h.contiguous())


def mamba_forward(p: Mamba, cfg: ModelConfig, x: torch.Tensor, *,
                  chunk: int = MAMBA_CHUNK) -> torch.Tensor:
    """Full-sequence mixer.  x: (B, S, d) -> (B, S, d)."""
    return _mamba_scan(p, cfg, x, chunk)[0]


def mamba_prefill(p: Mamba, cfg: ModelConfig, x: torch.Tensor, *,
                  chunk: int = MAMBA_CHUNK
                  ) -> tuple[torch.Tensor, MambaState]:
    """Forward over the prompt AND the O(1) decode state at its end."""
    return _mamba_scan(p, cfg, x, chunk)


def mamba_init_state(cfg: ModelConfig, batch: int,
                     device=None) -> MambaState:
    return MambaState(
        conv=torch.zeros((batch, cfg.mamba_d_conv - 1, cfg.d_inner),
                         dtype=cfg.compute_dtype, device=device),
        ssm=torch.zeros((batch, cfg.d_inner, cfg.mamba_d_state),
                        dtype=torch.float32, device=device))


def mamba_decode(p: Mamba, cfg: ModelConfig, x: torch.Tensor,
                 state: MambaState) -> tuple[torch.Tensor, MambaState]:
    """One token.  x: (B, 1, d).  The O(1) state is updated in place."""
    cdt = cfg.compute_dtype
    xz = x @ p.in_proj.to(cdt)
    x1, z = torch.chunk(xz, 2, dim=-1)                      # (B, 1, dI)
    xc = F.silu(_causal_conv(x1, p.conv_w.to(cdt), p.conv_b.to(cdt),
                             history=state.conv))
    new_conv = torch.cat([state.conv[:, 1:], x1.to(state.conv.dtype)], dim=1)
    with record_function("mamba.scan"):
        Abar, Bx, Cc = _ssm_inputs(p, cfg, xc)              # (B, 1, dI, dS)
        h = Abar[:, 0] * state.ssm + Bx[:, 0]               # (B, dI, dS)
        y = torch.einsum("bds,bs->bd", h, Cc[:, 0])[:, None]
    y = (y + p.D * xc.float()).to(cdt)
    y = y * F.silu(z)
    state.conv.copy_(new_conv)
    state.ssm.copy_(h)
    return y @ p.out_proj.to(cdt), state
