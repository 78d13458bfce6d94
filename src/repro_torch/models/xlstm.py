"""xLSTM mixers, xlstm-125m's layers: the chunkwise-parallel mLSTM and the
sequential sLSTM (counterpart of ``repro.models.xlstm``).

The reference is jnp, with no Pallas kernel, so this is plain PyTorch.  It
keeps the reference's structure.  The mLSTM matrix-memory recurrence

    C_t = f_t C_{t-1} + i_t v_t k_t^T,   h_t = C_t q_t / max(|n_t q_t|, e^{-m_t})

is evaluated CHUNKWISE: inside a Q-token chunk the contribution is an
attention-shaped (Q x Q) masked product with log-gate weights, and a
Python loop over the chunks (the reference's ``lax.scan``) carries the
per-head (hd x hd) state ``(C, n, m)``.  The exponential gates are
stabilized with the running max ``m`` by the reference's algebra, term
for term; nothing is rewritten as an ``exp(cumsum)`` divided out.  The
mLSTM head dim is ``d_inner // n_heads`` (1536 / 4 = 384 at xlstm-125m's
width), not ``cfg.hd``.

The sLSTM has a genuine sequential dependency through its block-diagonal
recurrent matrix and runs as a Python loop over time (the reference's
``lax.scan``): a prompt of S tokens is S steps a layer.

As the reference asserts, an mLSTM sequence longer than the chunk must be
a multiple of it; here that is a ``ValueError`` that names the rule.
``w_igate``, ``b_igate``, ``w_fgate``, ``b_fgate`` and the sLSTM's
``b_in`` stay f32 whatever the params dtype, and both recurrences run in
f32, as the reference does.

``mlstm_decode`` and ``slstm_decode`` write the new state into the state
they are given, in place, and return it (the port's caches are written in
place; the reference returns a new state).

The profiler range ``xlstm.mlstm`` holds the mLSTM recurrence (a
prefill's chunk loop, a decode step's one-token update); ``xlstm.slstm``
holds the sLSTM's time loop (one cell a decode step).  The projections,
the conv, the head norm and the gates' output products stay outside them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from .config import ModelConfig
from .mamba import _causal_conv
from .mlp import _normal_, _param
from .pshard import contiguous_grad, hint, is_dtensor

__all__ = ["MLSTMState", "SLSTMState", "MLSTM", "SLSTM", "mlstm_init",
           "slstm_init", "mlstm_forward", "mlstm_prefill",
           "mlstm_init_state", "mlstm_decode", "slstm_forward",
           "slstm_prefill", "slstm_init_state", "slstm_decode",
           "MLSTM_CHUNK"]

# Tokens a chunk of the mLSTM scan (the reference's default ``chunk``).
MLSTM_CHUNK = 64
_CONV_K = 4


class MLSTMState(NamedTuple):
    C: torch.Tensor       # (B, nh, hd, hd) stabilized matrix memory, f32
    n: torch.Tensor       # (B, nh, hd)     stabilized normalizer, f32
    m: torch.Tensor       # (B, nh)         log-space stabilizer, f32
    conv: torch.Tensor    # (B, dc-1, dI)   rolling conv window


class SLSTMState(NamedTuple):
    c: torch.Tensor       # (B, nh, hd), f32
    n: torch.Tensor       # (B, nh, hd)
    h: torch.Tensor       # (B, nh, hd)
    m: torch.Tensor       # (B, nh, hd)


def _mlstm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    """(d_inner, n_heads, head dim) of the mLSTM."""
    dI = int(cfg.xlstm_proj_factor * cfg.d_model)
    return dI, cfg.n_heads, dI // cfg.n_heads


# --------------------------------------------------------------------- mLSTM

class MLSTM(nn.Module):
    """The reference's mLSTM leaf dict as a module: ``up_proj`` (d, 2 dI),
    ``conv_w`` (4, dI), ``conv_b`` (dI,), ``cq``/``ck``/``cv`` (dI, dI),
    ``gn_scale`` (dI,) and ``down_proj`` (dI, d) in the params dtype;
    ``w_igate``/``w_fgate`` (dI, nh) and ``b_igate``/``b_fgate`` (nh,) in
    f32."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d = cfg.d_model
        dI, nh, _ = _mlstm_dims(cfg)
        pdt, f32 = cfg.params_dtype, torch.float32
        self.up_proj = _param((d, 2 * dI), pdt, device)
        self.conv_w = _param((_CONV_K, dI), pdt, device)
        self.conv_b = _param((dI,), pdt, device)
        self.cq = _param((dI, dI), pdt, device)
        self.ck = _param((dI, dI), pdt, device)
        self.cv = _param((dI, dI), pdt, device)
        self.w_igate = _param((dI, nh), f32, device)
        self.b_igate = _param((nh,), f32, device)
        self.w_fgate = _param((dI, nh), f32, device)
        self.b_fgate = _param((nh,), f32, device)
        self.gn_scale = _param((dI,), pdt, device)
        self.down_proj = _param((dI, d), pdt, device)

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "MLSTM":
        """The reference's init: N(0, 1) at fan-in scales, a zero conv
        bias, the input gate's bias -3 and the forget gate's +3 (open at
        init), a unit head-norm scale."""
        d, dI = self.up_proj.shape[0], self.cq.shape[0]
        _normal_(self.up_proj, gen, d ** -0.5)
        _normal_(self.conv_w, gen, _CONV_K ** -0.5)
        self.conv_b.zero_()
        for w in (self.cq, self.ck, self.cv):
            _normal_(w, gen, dI ** -0.5)
        _normal_(self.w_igate, gen, dI ** -0.5)
        self.b_igate.fill_(-3.0)
        _normal_(self.w_fgate, gen, dI ** -0.5)
        self.b_fgate.fill_(3.0)
        self.gn_scale.fill_(1.0)
        _normal_(self.down_proj, gen, dI ** -0.5)
        return self


@torch.no_grad()
def mlstm_init(gen: torch.Generator, cfg: ModelConfig) -> MLSTM:
    """An ``MLSTM`` with the reference's scales, drawn from ``gen``, on the
    generator's device."""
    return MLSTM(cfg, device=gen.device).init_(gen)


def _mlstm_qkvif(p: MLSTM, cfg: ModelConfig, x: torch.Tensor,
                 conv_hist=None):
    """Shared projections.  x: (B, S, d) -> q, k, v (B, nh, S, hd) in the
    compute dtype, i, f (B, nh, S) in f32, and xm, z, xc (B, S, dI)."""
    cdt = cfg.compute_dtype
    _, nh, hd = _mlstm_dims(cfg)
    xz = x @ p.up_proj.to(cdt)
    xm, z = torch.chunk(xz, 2, dim=-1)                          # (B,S,dI)
    xc = F.silu(_causal_conv(xm, p.conv_w.to(cdt), p.conv_b.to(cdt),
                             history=conv_hist))

    # (contiguous_grad: under a mesh, the transposes' gradients made
    # contiguous for the views of the products' backward; else nothing)
    def tohead(t):
        t = t.reshape(t.shape[0], t.shape[1], nh, hd)
        return contiguous_grad(t).transpose(1, 2)

    q = tohead(xc @ p.cq.to(cdt))
    k = tohead(xc @ p.ck.to(cdt)) * (hd ** -0.5)
    v = tohead(xm @ p.cv.to(cdt))
    xf = xc.float()
    ig = contiguous_grad(xf @ p.w_igate + p.b_igate).transpose(1, 2)
    fz = xf @ p.w_fgate + p.b_fgate
    # log sigmoid; a DTensor has no rule for its backward, so there the
    # same function as -softplus(-z)
    fg = contiguous_grad(-F.softplus(-fz) if is_dtensor(fz)
                         else F.logsigmoid(fz)).transpose(1, 2)
    return q, k, v, ig, fg, xm, z, xc


def _headnorm(h: torch.Tensor, scale: torch.Tensor, nh: int) -> torch.Tensor:
    """Per-head group norm (the official mLSTM post-cell norm): eps 1e-6,
    population variance."""
    B, S, dI = h.shape
    hf = h.reshape(B, S, nh, dI // nh).float()
    mu = hf.mean(-1, keepdim=True)
    var = hf.var(-1, keepdim=True, unbiased=False)
    hf = (hf - mu) * torch.rsqrt(var + 1e-6)
    return (hf.reshape(B, S, dI) * scale.float()).to(h.dtype)


def _check_chunk(S: int, chunk: int) -> int:
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(
            f"mlstm scan: a sequence longer than chunk={chunk} must be a "
            f"multiple of it (the reference asserts S % chunk == 0); got "
            f"S={S}, S % {Q} = {S % Q}")
    return Q


def _conv_tail(xm: torch.Tensor, cdt: torch.dtype) -> torch.Tensor:
    """The last ``_CONV_K - 1`` rows of ``xm`` along S, zero-padded in
    front when S is shorter: the decode state's conv window."""
    S = xm.shape[1]
    hist = xm[:, S - (_CONV_K - 1):] if S >= _CONV_K - 1 else F.pad(
        xm, (0, 0, _CONV_K - 1 - S, 0))
    return hist.to(cdt)


def _mlstm_scan(p: MLSTM, cfg: ModelConfig, x: torch.Tensor, chunk: int):
    """Shared body: returns (out (B, S, d), final MLSTMState)."""
    B, S, _ = x.shape
    dI, nh, hd = _mlstm_dims(cfg)
    cdt = cfg.compute_dtype
    Q = _check_chunk(S, chunk)
    q, k, v, ig, fg, xm, z, _ = _mlstm_qkvif(p, cfg, x)
    qf, kf, vf = q.float(), k.float(), v.float()
    dev = x.device
    C = hint(torch.zeros((B, nh, hd, hd), dtype=torch.float32, device=dev),
             "dp", None, "model", None)
    n = hint(torch.zeros((B, nh, hd), dtype=torch.float32, device=dev),
             "dp", None, "model")
    m = hint(torch.zeros((B, nh), dtype=torch.float32, device=dev),
             "dp", None)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.float32, device=dev))
    hs = []
    with record_function("xlstm.mlstm"):
        for s0 in range(0, S, Q):
            sl = slice(s0, s0 + Q)
            qc, kc, vc = qf[:, :, sl], kf[:, :, sl], vf[:, :, sl]
            igc, fgc = ig[:, :, sl], fg[:, :, sl]
            b = torch.cumsum(fgc, dim=-1)                       # log decay
            a = igc - b
            M = torch.maximum(m[..., None],
                              torch.cummax(a, dim=2).values)    # (B,nh,Q)
            mt = b + M
            # Intra-chunk: masked attention-shaped product, log-gate weights.
            w = torch.exp(a[:, :, None, :] - M[:, :, :, None])  # (B,nh,t,j)
            scores = torch.einsum("bhtd,bhjd->bhtj", qc, kc) * w * tri
            num = torch.einsum("bhtj,bhjd->bhtd", scores, vc)
            den = scores.sum(-1)                                # (B,nh,Q)
            # Inter-chunk: the carried state scaled by exp(m0 - M_t).
            inter = torch.exp(m[..., None] - M)                 # (B,nh,Q)
            num = num + inter[..., None] * torch.einsum("bhde,bhtd->bhte",
                                                        C, qc)
            den = den + inter * torch.einsum("bhd,bhtd->bht", n, qc)
            hs.append(num / torch.maximum(den.abs(),
                                          torch.exp(-mt))[..., None])
            # The state to the chunk's end.
            wQ = torch.exp(a - M[..., -1:])                     # (B,nh,Q)
            sQ = torch.exp(m - M[..., -1])                      # (B,nh)
            C = sQ[..., None, None] * C + torch.einsum(
                "bhj,bhjd,bhje->bhde", wQ, kc, vc)
            n = sQ[..., None] * n + torch.einsum("bhj,bhjd->bhd", wQ, kc)
            m = mt[..., -1]
        h = torch.cat(hs, dim=2)                                # (B,nh,S,hd)
    h = h.transpose(1, 2).reshape(B, S, dI).to(cdt)
    h = _headnorm(h, p.gn_scale, nh)
    h = h * F.silu(z)
    out = h @ p.down_proj.to(cdt)
    return out, MLSTMState(C=C, n=n, m=m.contiguous(),
                           conv=_conv_tail(xm, cdt))


def mlstm_forward(p: MLSTM, cfg: ModelConfig, x: torch.Tensor, *,
                  chunk: int = MLSTM_CHUNK) -> torch.Tensor:
    """Chunkwise-parallel mLSTM.  x: (B, S, d) -> (B, S, d)."""
    return _mlstm_scan(p, cfg, x, chunk)[0]


def mlstm_prefill(p: MLSTM, cfg: ModelConfig, x: torch.Tensor, *,
                  chunk: int = MLSTM_CHUNK
                  ) -> tuple[torch.Tensor, MLSTMState]:
    """Forward over the prompt AND the O(1) decode state at its end."""
    return _mlstm_scan(p, cfg, x, chunk)


def mlstm_init_state(cfg: ModelConfig, batch: int,
                     device=None) -> MLSTMState:
    dI, nh, hd = _mlstm_dims(cfg)
    f32 = torch.float32
    return MLSTMState(
        C=torch.zeros((batch, nh, hd, hd), dtype=f32, device=device),
        n=torch.zeros((batch, nh, hd), dtype=f32, device=device),
        m=torch.zeros((batch, nh), dtype=f32, device=device),
        conv=torch.zeros((batch, _CONV_K - 1, dI), dtype=cfg.compute_dtype,
                         device=device))


def mlstm_decode(p: MLSTM, cfg: ModelConfig, x: torch.Tensor,
                 state: MLSTMState) -> tuple[torch.Tensor, MLSTMState]:
    """One token, O(1) state, updated in place.  x: (B, 1, d)."""
    B = x.shape[0]
    dI, nh, _ = _mlstm_dims(cfg)
    cdt = cfg.compute_dtype
    q, k, v, ig, fg, xm, z, _ = _mlstm_qkvif(p, cfg, x,
                                             conv_hist=state.conv)
    new_conv = torch.cat([state.conv[:, 1:], xm.to(state.conv.dtype)], dim=1)
    with record_function("xlstm.mlstm"):
        qf, kf, vf = (t[:, :, 0].float() for t in (q, k, v))    # (B,nh,hd)
        igt, fgt = ig[:, :, 0], fg[:, :, 0]                     # (B,nh)
        m1 = torch.maximum(fgt + state.m, igt)
        fw = torch.exp(fgt + state.m - m1)
        iw = torch.exp(igt - m1)
        C1 = fw[..., None, None] * state.C + iw[..., None, None] * \
            torch.einsum("bhd,bhe->bhde", kf, vf)
        n1 = fw[..., None] * state.n + iw[..., None] * kf
        num = torch.einsum("bhde,bhd->bhe", C1, qf)
        den = torch.maximum(torch.einsum("bhd,bhd->bh", n1, qf).abs(),
                            torch.exp(-m1))
        h = (num / den[..., None]).reshape(B, 1, dI).to(cdt)
    h = _headnorm(h, p.gn_scale, nh)
    h = h * F.silu(z)
    state.C.copy_(C1)
    state.n.copy_(n1)
    state.m.copy_(m1)
    state.conv.copy_(new_conv)
    return h @ p.down_proj.to(cdt), state


# --------------------------------------------------------------------- sLSTM

class SLSTM(nn.Module):
    """The reference's sLSTM leaf dict as a module: ``w_in`` (d, 4d),
    ``r_blocks`` (4, nh, hd, hd), ``gn_scale`` (d,), and the post-cell
    feed-forward ``w_up`` (d, 2 dI) and ``w_down`` (dI, d) in the params
    dtype; ``b_in`` (4d,) in f32 (the gates z, i, f, o in that order)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        d, nh = cfg.d_model, cfg.n_heads
        hd = d // nh
        dI = int(cfg.xlstm_proj_factor * d)
        pdt = cfg.params_dtype
        self.w_in = _param((d, 4 * d), pdt, device)
        self.b_in = _param((4 * d,), torch.float32, device)
        self.r_blocks = _param((4, nh, hd, hd), pdt, device)
        self.gn_scale = _param((d,), pdt, device)
        self.w_up = _param((d, 2 * dI), pdt, device)
        self.w_down = _param((dI, d), pdt, device)
        self._pf = cfg.xlstm_proj_factor

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> "SLSTM":
        """The reference's init: N(0, 1) at fan-in scales (``w_down`` at
        ``(proj_factor d)^-0.5``), ``b_in`` zero for z and o, -3 for the
        input gate, +3 for the forget gate, a unit head-norm scale."""
        d = self.w_in.shape[0]
        hd = self.r_blocks.shape[-1]
        _normal_(self.w_in, gen, d ** -0.5)
        self.b_in.zero_()
        self.b_in[d:2 * d] = -3.0
        self.b_in[2 * d:3 * d] = 3.0
        _normal_(self.r_blocks, gen, hd ** -0.5)
        self.gn_scale.fill_(1.0)
        _normal_(self.w_up, gen, d ** -0.5)
        _normal_(self.w_down, gen, (self._pf * d) ** -0.5)
        return self


@torch.no_grad()
def slstm_init(gen: torch.Generator, cfg: ModelConfig) -> SLSTM:
    """An ``SLSTM`` with the reference's scales, drawn from ``gen``, on the
    generator's device."""
    return SLSTM(cfg, device=gen.device).init_(gen)


def slstm_init_state(cfg: ModelConfig, batch: int,
                     device=None) -> SLSTMState:
    """Zero c, n and h (four tensors of their own: decode writes them in
    place) and the stabilizer m at -10, as the reference."""
    shape = (batch, cfg.n_heads, cfg.d_model // cfg.n_heads)

    def zero():
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return SLSTMState(c=zero(), n=zero(), h=zero(), m=zero() - 10.0)


def _slstm_cell(cfg: ModelConfig, rb: torch.Tensor, xw: torch.Tensor,
                st: SLSTMState) -> tuple[torch.Tensor, SLSTMState]:
    """One step.  ``rb``: the recurrent blocks in f32 (4, nh, hd, hd);
    ``xw``: (B, 4d) the input projection, pre-computed."""
    nh, d = cfg.n_heads, cfg.d_model
    hd = d // nh
    B = xw.shape[0]
    rec = torch.einsum("bhd,ghde->gbhe", st.h, rb)              # (4,B,nh,hd)
    gates = xw.float().reshape(B, 4, nh, hd).transpose(0, 1) + rec
    zt = torch.tanh(gates[0])
    it = gates[1]
    ft = gates[2]
    ot = torch.sigmoid(gates[3])
    m1 = torch.maximum(ft + st.m, it)
    iw = torch.exp(it - m1)
    fw = torch.exp(ft + st.m - m1)
    c1 = fw * st.c + iw * zt
    n1 = torch.clamp_min(fw * st.n + iw, 1e-6)
    h1 = ot * c1 / n1
    return h1.reshape(B, d), SLSTMState(c=c1, n=n1, h=h1, m=m1)


def _slstm_out(p: SLSTM, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """Head norm and the post-cell gated feed-forward.  h: (B, S, d)."""
    cdt = cfg.compute_dtype
    h = _headnorm(h.to(cdt), p.gn_scale, cfg.n_heads)
    u, g = torch.chunk(h @ p.w_up.to(cdt), 2, dim=-1)
    return (u * F.silu(g)) @ p.w_down.to(cdt)


def _slstm_run(p: SLSTM, cfg: ModelConfig, x: torch.Tensor):
    B, S, _ = x.shape
    cdt = cfg.compute_dtype
    xw = (x @ p.w_in.to(cdt)).float() + p.b_in
    st = slstm_init_state(cfg, B, x.device)
    hs = []
    with record_function("xlstm.slstm"):
        # The recurrent blocks in f32 once a call; the reference casts them
        # in every step, to the same values.
        rb = p.r_blocks.float()
        for t in range(S):
            h, st = _slstm_cell(cfg, rb, xw[:, t], st)
            hs.append(h)
        h = torch.stack(hs, dim=1)                              # (B,S,d)
    return _slstm_out(p, cfg, h), st


def slstm_forward(p: SLSTM, cfg: ModelConfig, x: torch.Tensor
                  ) -> torch.Tensor:
    """Sequential loop over time (inherently serial).  x: (B, S, d)."""
    return _slstm_run(p, cfg, x)[0]


def slstm_prefill(p: SLSTM, cfg: ModelConfig, x: torch.Tensor
                  ) -> tuple[torch.Tensor, SLSTMState]:
    return _slstm_run(p, cfg, x)


def slstm_decode(p: SLSTM, cfg: ModelConfig, x: torch.Tensor,
                 st: SLSTMState) -> tuple[torch.Tensor, SLSTMState]:
    """One token, the state updated in place.  x: (B, 1, d)."""
    cdt = cfg.compute_dtype
    xw = (x[:, 0] @ p.w_in.to(cdt)).float() + p.b_in
    with record_function("xlstm.slstm"):
        h, st1 = _slstm_cell(cfg, p.r_blocks.float(), xw, st)
    for dst, src in zip(st, st1):
        dst.copy_(src)
    return _slstm_out(p, cfg, h[:, None]), st
