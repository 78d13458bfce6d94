"""The plain reference of the randomized ID, and its lower-precision control.

Plain PyTorch only: this module imports nothing of the program under test
(``repro_torch``) nor of the JAX package.  Everything the timed path derives
from the seed and from ``A`` is worked out again here:

* the sketch operator, from frozen copies of the program's seeding rule
  (``block_seed``, the per-block gaussian draws, the SRFT's phases and rows);
* the sketch ``Y`` as a plain matrix product: ``Omega A / sqrt(2l)`` for the
  gaussian sketch, and for the SRFT the ``l`` kept rows of the DFT matrix,
  written out entry by entry, times ``D A``, over ``sqrt(l)``;
* the blocked greedy pivoting (top ``b`` residual column norms a panel,
  recomputed from scratch against the basis so far), each panel
  orthonormalized by Householder QR with the diagonal of ``R`` made real and
  positive, ``R = Q^H Y``;
* ``P = R1^{-1} R`` by a general solve, with the identity in the pivots;
* ``B = A[:, J]``.

``spectral_error`` and ``error_bound`` are frozen copies of the paper's eq.
(3) arithmetic.  The check holds the residual to eq. (3) with
``sigma_{k+1}(A)`` bounded from below by ``sigma_kp1_lower``: for the cells'
``A``, the product ``B0 P0`` rounded once, that is
``sigma_{2k+1}(A - B0 P0)``, the rounding's own spectrum, with ``B0 P0``
formed exactly (Weyl's inequality; see the function).

``decompose(..., dtype=)`` in the next lower precision (complex64 for
complex128, as ``limits/<dtype>.json`` names it), with the operator drawn
exactly as for the stated dtype and rounded, is the control: it stands in
the program's place to show that the comparison catches a drop in
precision.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["ACCUM_BLOCK", "block_seed", "gaussian_omega", "srft_operator",
           "sketch", "pivoted_qr", "interp", "decompose",
           "spectral_error", "error_bound", "sigma_kp1_lower", "splitmix64",
           "Decomposition"]

_MASK64 = (1 << 64) - 1
# The program's canonical row block of the gaussian operator: block b of
# Omega^T (ACCUM_BLOCK x l) is drawn from a generator of its own.
ACCUM_BLOCK = 128


class Decomposition(NamedTuple):
    """What one ID hands back: ``A ~= B P``, ``B = A[:, J]``, and the
    sketch-space factors ``Q`` (l x k) and ``R = Q^H Y`` (k x n)."""

    B: torch.Tensor
    P: torch.Tensor
    J: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor


def splitmix64(seed: int, i: int) -> int:
    """The splitmix64 finalizer of ``seed * 0x9E3779B97F4A7C15 + i + 1``."""
    z = (int(seed) * 0x9E3779B97F4A7C15 + int(i) + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


# The program's seed of the gaussian operator's row block ``b``.
block_seed = splitmix64


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & _MASK64)
    return g


def gaussian_omega(seed: int, l: int, m: int, dtype: torch.dtype,
                   device) -> torch.Tensor:
    """The unscaled gaussian operator ``Omega`` (l x m): block ``b`` of
    ``Omega^T`` is ``ACCUM_BLOCK x l`` standard normals (real, then
    imaginary part for a complex dtype) from a generator seeded with
    ``block_seed(seed, b)``."""
    rdt = dtype.to_real() if dtype.is_complex else dtype
    blocks = []
    for b in range(-(-m // ACCUM_BLOCK)):
        g = _generator(block_seed(int(seed) & _MASK64, b), device)
        re = torch.randn((ACCUM_BLOCK, l), generator=g, dtype=rdt,
                         device=device)
        if dtype.is_complex:
            im = torch.randn((ACCUM_BLOCK, l), generator=g, dtype=rdt,
                             device=device)
            re = torch.complex(re, im)
        blocks.append(re)
    return torch.cat(blocks)[:m].T


def srft_operator(seed: int, l: int, m: int, dtype: torch.dtype, device):
    """The SRFT's unit phases ``D`` (m,) and kept rows (l,), drawn as the
    program draws them: one generator seeded with ``seed``, ``m`` uniforms
    in the real dtype of the complex working type, then ``l`` row indices."""
    cdt = (torch.complex128 if dtype in (torch.float64, torch.complex128)
           else torch.complex64)
    g = _generator(seed, device)
    phi = torch.rand(m, generator=g, dtype=cdt.to_real(), device=device)
    phases = torch.polar(torch.ones_like(phi), (2 * math.pi) * phi)
    rows = torch.randint(0, m, (l,), generator=g, device=device)
    return phases, rows


def _dft_rows(rows: torch.Tensor, m: int, dtype: torch.dtype) -> torch.Tensor:
    """Rows ``rows`` of the unnormalized DFT matrix of size ``m``:
    ``exp(-2 pi i r j / m)``, the product ``r j`` reduced mod ``m`` in
    integers so that every angle is exact before the float conversion."""
    j = torch.arange(m, device=rows.device, dtype=torch.int64)
    rj = (rows.to(torch.int64)[:, None] * j[None, :]) % m
    ang = rj.to(dtype.to_real()) * (-2 * math.pi / m)
    return torch.polar(torch.ones_like(ang), ang)


def sketch(kind: str, seed: int, A: torch.Tensor, l: int,
           op_dtype: torch.dtype, dtype: torch.dtype) -> torch.Tensor:
    """``Y = Phi A`` in ``dtype``, with ``Phi`` drawn for ``op_dtype`` (the
    stated dtype) and rounded to ``dtype``."""
    m = A.shape[0]
    A_ = A.to(dtype)
    if kind == "gaussian":
        omega = gaussian_omega(seed, l, m, op_dtype, A.device).to(dtype)
        scale = 1.0 / math.sqrt(2 * l if op_dtype.is_complex else l)
        return (omega @ A_) * scale
    if kind == "srft":
        phases, rows = srft_operator(seed, l, m, op_dtype, A.device)
        cdt = dtype if dtype.is_complex else (
            torch.complex128 if dtype == torch.float64 else torch.complex64)
        F = _dft_rows(rows, m, cdt) * phases.to(cdt)[None, :]
        return (F @ A_.to(cdt)) * (1.0 / math.sqrt(l))
    raise ValueError(f"the reference has no sketch {kind!r}")


def _project_out(Q: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return X - Q @ (Q.mH @ X) if Q.shape[1] else X


def pivoted_qr(Y: torch.Tensor, k: int, panel: int):
    """Blocked greedy pivoting: per panel the top ``b`` unpicked columns by
    residual norm, the residual taken against the basis so far (twice
    projected), then their orthonormal basis.  Returns ``(Q, R, J)``."""
    l, n = Y.shape
    rdt = Y.real.dtype
    Q = Y.new_zeros((l, 0))
    picked = torch.zeros(n, dtype=torch.bool, device=Y.device)
    J, off = [], 0
    while off < k:
        b = min(panel, k - off)
        Z = _project_out(Q, _project_out(Q, Y))
        res2 = (Z.abs() ** 2).sum(0).to(rdt)
        res2 = torch.where(picked, torch.full_like(res2, -1.0), res2)
        idx = torch.topk(res2, b).indices
        C = _project_out(Q, Z.index_select(1, idx))
        Qp, Rp = torch.linalg.qr(C)
        d = torch.diagonal(Rp)
        phase = d / d.abs().clamp(min=torch.finfo(rdt).tiny)
        Q = torch.cat([Q, Qp * phase[None, :]], 1)
        picked[idx] = True
        J.append(idx)
        off += b
    return Q, Q.mH @ Y, torch.cat(J)


def interp(R: torch.Tensor, J: torch.Tensor) -> torch.Tensor:
    """``P = R1^{-1} R`` with ``R1 = R[:, J]``, exact ``I_k`` in ``J``."""
    k = R.shape[0]
    P = torch.linalg.solve(R.index_select(1, J), R)
    P[:, J] = torch.eye(k, dtype=P.dtype, device=P.device)
    return P


def decompose(kind: str, seed: int, A: torch.Tensor, k: int, l: int,
              panel: int, dtype: torch.dtype | None = None):
    """The reference ID of ``A`` in ``dtype`` (``A``'s own by default),
    and its sketch ``Y``."""
    op_dtype = A.dtype
    dtype = op_dtype if dtype is None else dtype
    Y = sketch(kind, seed, A, l, op_dtype, dtype)
    Q, R, J = pivoted_qr(Y, k, panel)
    P = interp(R, J)
    if P.is_complex() and not dtype.is_complex:
        P = P.real
    B = A.to(dtype).index_select(1, J)
    return Decomposition(B=B, P=P, J=J, Q=Q, R=R), Y


# ------------------------------------------------------------ eq. (3)

def spectral_error(seed: int, A: torch.Tensor, B: torch.Tensor,
                   P: torch.Tensor, iters: int = 50) -> float:
    """Power-iteration estimate of ``||A - B P||_2`` in ``A``'s dtype (or
    ``P``'s, where that is complex), never forming ``A - B P``."""
    n = A.shape[1]
    dtype = P.dtype if P.dtype.is_complex else A.dtype
    A_, B_, P_ = A.to(dtype), B.to(dtype), P.to(dtype)
    rdtype = dtype.to_real() if dtype.is_complex else dtype
    tiny = torch.finfo(rdtype).tiny

    def e_mv(x):
        return A_ @ x - B_ @ (P_ @ x)

    def eh_mv(y):
        return A_.mH @ y - P_.mH @ (B_.mH @ y)

    g = _generator(seed, A.device)
    v = torch.randn(n, generator=g, dtype=rdtype, device=A.device).to(dtype)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        w = eh_mv(e_mv(v))
        v = w / torch.clamp(torch.linalg.vector_norm(w), min=tiny)
    return float(torch.linalg.vector_norm(e_mv(v)))


def _mantissa(dtype: torch.dtype) -> int:
    """Bits of the significand, the leading one included (53 for f64)."""
    return round(-math.log2(torch.finfo(dtype).eps)) + 1


def _split(X: torch.Tensor, dim: int, bits: int):
    """``X = head + rest`` exactly, each real and imaginary entry of
    ``head`` a multiple of ``2^(e - bits)``, where ``2^e`` bounds the
    magnitudes along ``dim`` (Rump, Ogita and Oishi's extraction)."""
    R = torch.view_as_real(X) if X.is_complex() else X[..., None]
    mu = R.abs().amax(dim=(dim, -1), keepdim=True)
    e = torch.ceil(torch.log2(torch.where(mu > 0, mu, torch.ones_like(mu))))
    shift = torch.exp2(e + (_mantissa(R.dtype) - bits))
    head = (R + shift) - shift
    head = torch.view_as_complex(head) if X.is_complex() else head[..., 0]
    return head, X - head


# Pieces a factor is cut into: the products left out are under
# ``2^(-4 bits)``, some 1e-24, of ``|B0| |P0|``.
PIECES = 4


def exact_product_residual(A: torch.Tensor, B0: torch.Tensor,
                           P0: torch.Tensor) -> torch.Tensor:
    """``A - B0 P0`` with the product formed without rounding, to within
    ``2^(-PIECES * bits)`` of ``|B0| |P0|`` (Ozaki's splitting): ``B0`` is
    cut into pieces along its rows and ``P0`` along its columns, each of
    ``bits`` bits on a common grid, so that every product of two pieces
    sums exactly in the working precision whatever the summation order."""
    k = B0.shape[1]
    terms = 2 * k if B0.is_complex() else k
    bits = (_mantissa(A.real.dtype) - math.ceil(math.log2(terms))) // 2 - 1
    Bs, Ps, rb, rp = [], [], B0, P0
    for _ in range(PIECES):
        hb, rb = _split(rb, 1, bits)
        hp, rp = _split(rp, 0, bits)
        Bs.append(hb)
        Ps.append(hp)
    E = A - Bs[0] @ Ps[0]
    for s in range(1, PIECES):
        for i in range(s + 1):
            E -= Bs[i] @ Ps[s - i]
    return E


def sigma_kp1_lower(A: torch.Tensor, B0: torch.Tensor, P0: torch.Tensor,
                    k: int, cols: int = 4096) -> float:
    """A lower bound of ``sigma_{k+1}(A)`` where ``B0 P0`` has rank ``k``.

    Weyl's inequality gives ``sigma_{2k+1}(A - X) <= sigma_{k+1}(A) +
    sigma_{k+1}(X)`` and ``sigma_{k+1}(X) = 0`` for ``X = B0 P0``; leaving
    out columns lowers every singular value.  So the ``(2k+1)``-th singular
    value of the leading ``cols`` columns of ``A - B0 P0`` bounds it.  That
    difference is the rounding of ``A`` as stored: it is formed with the
    product exact (``exact_product_residual``), and its singular values
    come from its own Gram matrix, whose condition is that of a tall noise
    matrix, so the bound is computed to a few digits and not to within the
    rounding of ``A``'s own scale."""
    m, n = A.shape
    c = min(n, max(cols, 2 * k + 1))
    if min(m, c) <= 2 * k:
        raise ValueError(f"no sigma_{{2k+1}} for k={k} in a {m} x {n} matrix")
    E = exact_product_residual(A[:, :c], B0, P0[:, :c])
    lam = torch.linalg.eigvalsh(E.mH @ E)        # ascending
    return float(lam[c - 2 * k - 1].clamp(min=0).sqrt())


def error_bound(m: int, n: int, k: int, eps: float = 1e-20) -> float:
    """Right-hand side of eq. (3) for ``sigma_{k+1} = 1``."""
    return 50.0 * math.sqrt(m * n) * (1.0 / eps) ** (1.0 / k)
