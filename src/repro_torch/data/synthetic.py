"""Known-spectrum test matrices for the eq. (3) verification grid, and the
LM stack's token generator (counterpart of ``repro.data.synthetic``).

``spectrum_sigmas`` / ``spectrum_matrix`` build matrices ``A = U S V^H``
with an exactly known singular spectrum, so eq. (3), which bounds
``||A - BP||_2`` by a multiple of ``sigma_{k+1}``, can be checked against
the true ``sigma_{k+1}`` instead of the paper's noise-floor estimate.
Three shapes cover the failure modes of the blocked and distributed QRCP
engines:

  fast_decay -- geometric decay down to ``floor``: the residual-norm
                downdate drift case in f32;
  cliff      -- flat at 1.0 through index k-1, then a hard drop: the pivot
                quality case (missing one leading column costs 1/gap);
  noisy_tail -- polynomial decay into a flat noise plateau: the near-tie
                case.

``spectrum_sigmas`` is the reference's numpy code as it is, so the two
packages give the same singular values bit for bit.  ``spectrum_matrix``
draws its orthonormal factors from a ``torch.Generator`` (Philox), so its
bits differ from the reference's (threefry); its singular values do not.

``spectrum_factors`` / ``spectrum_rows`` are the streaming analogue: a
factorization ``A = D U S V^H`` whose rows are evaluated in closed form
for any row range (``SpectrumFactors``), so a chunk source can scale
``m`` past device and host memory with the exact singular values in
hand.  Its random parts follow the port's own rules: the frequencies and
``V``'s Gaussian are drawn from a CPU generator seeded with the int seed
(so the matrix is a function of the seed, whatever the device), and the
row diagonal ``D`` is a splitmix64 hash of ``(seed, global row index)``
(``row_diagonal``), evaluated vectorised on the rows' device.

``SyntheticConfig`` / ``batch_for_step`` / ``make_batch_iterator`` are the
training data: a learnable periodic token pattern with noise, each batch a
pure function of ``(seed, step, host)`` (drawn on the host from a CPU
generator seeded with ``block_seed(block_seed(seed, step), host)``, the
counterpart of the reference's ``fold_in``), so a run resumed at step s
replays the same batches on any device.  The pattern and the noise are the
reference's; the random bits are Philox's, not threefry's.
"""
from __future__ import annotations

import math
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

from ..core.rng import as_generator, block_seed, check_device, seed_of

__all__ = ["SPECTRA", "DTYPE_FLOORS", "spectrum_sigmas", "spectrum_matrix",
           "SpectrumFactors", "spectrum_factors", "spectrum_rows",
           "row_diagonal", "spectrum_id_error", "SyntheticConfig",
           "batch_for_step", "make_batch_iterator"]

SPECTRA = ("fast_decay", "cliff", "noisy_tail")

# Smallest spectrum floor per dtype that keeps sigma_{k+1} well above the
# working precision's cancellation level (the reference's values).
DTYPE_FLOORS = {"float32": 1e-5, "complex64": 1e-5,
                "float64": 1e-12, "complex128": 1e-12}


def spectrum_sigmas(spectrum: str, r: int, k: int, *,
                    floor: float = 1e-6) -> np.ndarray:
    """The ``r`` singular values of a synthetic ``spectrum`` (see module
    docstring), scaled so ``sigma_0 = 1``; ``floor`` sets the smallest
    value (pick it well above the working dtype's cancellation level:
    ~1e-5 for f32, ~1e-12 for f64)."""
    if spectrum not in SPECTRA:
        raise ValueError(f"unknown spectrum {spectrum!r}; expected one of "
                         f"{SPECTRA}")
    if not (0 < k < r):
        raise ValueError(f"need 0 < k < r, got k={k}, r={r}")
    i = np.arange(r, dtype=np.float64)
    if spectrum == "fast_decay":
        return floor ** (i / (r - 1))
    if spectrum == "cliff":
        # sqrt(floor) keeps the post-cliff block itself well-conditioned
        # relative to the dtype while the k|k+1 gap stays hard.
        return np.where(i < k, 1.0, np.sqrt(floor))
    # noisy_tail: polynomial decay into a flat plateau at sqrt(floor)
    return np.maximum((i + 1.0) ** -1.5, np.sqrt(floor))


def _orthonormal(g: torch.Generator, rows: int, r: int, cplx: bool,
                 device) -> torch.Tensor:
    """Q of the QR of a seeded (rows, r) Gaussian, f64 or c128."""
    x = torch.randn((rows, r), generator=g, dtype=torch.float64,
                    device=device)
    if cplx:
        x = torch.complex(x, torch.randn((rows, r), generator=g,
                                         dtype=torch.float64, device=device))
    return torch.linalg.qr(x).Q


def spectrum_matrix(gen_or_seed, m: int, n: int, spectrum: str, k: int, *,
                    r: Optional[int] = None,
                    dtype: torch.dtype = torch.float64, floor: float = 1e-6,
                    device="cuda") -> tuple[torch.Tensor, np.ndarray]:
    """``(A, sigmas)``: an ``m x n`` matrix of rank ``r`` (default
    ``min(2 * k + 16, m, n)``) on ``device`` with exactly the singular
    values ``spectrum_sigmas(spectrum, r, k, floor=floor)`` (up to the
    rounding of two orthonormal factors, formed in f64 / c128), in
    ``dtype`` (real or complex).  The true ``sigma_{k+1}`` is
    ``sigmas[k]``, the eq. (3) reference.  ``gen_or_seed`` is an int seed
    or a ``torch.Generator`` on ``device``."""
    dev = check_device(device)
    r = min(2 * k + 16, m, n) if r is None else r
    sig = spectrum_sigmas(spectrum, r, k, floor=floor)
    g = as_generator(gen_or_seed, dev)
    U = _orthonormal(g, m, r, dtype.is_complex, dev)
    V = _orthonormal(g, n, r, dtype.is_complex, dev)
    s = torch.as_tensor(sig, dtype=torch.float64, device=dev)
    A = (U * s[None, :].to(U.dtype)) @ V.mH
    return A.to(dtype), sig


class SpectrumFactors(NamedTuple):
    """Row-generable factorization ``A = D U S V^H`` with exact singular
    values (``spectrum_rows`` evaluates any row range in closed form):

      ``U`` -- ``r`` distinct orthonormal DCT-II (real) / DFT (complex)
               basis columns at the frequencies ``freqs``: row ``i`` of
               column ``j`` is a cosine / phasor at ``(i, freqs[j])``, so
               a chunk of rows never needs the rest of the matrix;
      ``D`` -- a unit-modulus row diagonal (signs / phases) hashed from
               ``(seed, global row index)`` (``row_diagonal``), which
               randomises the row space without touching the spectrum;
      ``V`` -- dense orthonormal ``n x r`` (f64 / c128) on ``V.device``.
    """

    freqs: np.ndarray       # (r,) int64 host array of distinct frequencies
    V: torch.Tensor         # (n, r) orthonormal right factor
    sig: np.ndarray         # (r,) exact singular values, descending
    seed: int               # seed of the row diagonal
    m: int
    dtype: torch.dtype


def _distinct_ints(g: torch.Generator, r: int, lo: int, hi: int) -> np.ndarray:
    """``r`` distinct integers in ``[lo, hi)`` with O(r) memory (a
    permutation of ``[lo, hi)`` would be O(hi), the very ``m`` this
    exists for): uniform f64 draws (exact integers below 2^53) from ``g``,
    deduplicated, in rounds until ``r`` are distinct.  Host int64, sorted:
    frequencies reach ``m``, past int32 at streaming scales."""
    if hi - lo < r:
        raise ValueError(f"need hi - lo >= r, got [{lo}, {hi}) for r={r}")
    vals = np.empty(0, np.int64)
    while vals.size < r:
        u = torch.rand(2 * r, generator=g, dtype=torch.float64).numpy()
        draw = lo + np.floor(u * (hi - lo)).astype(np.int64)
        vals = np.unique(np.concatenate([vals, draw]))
    return vals[:r]


def spectrum_factors(gen_or_seed, m: int, n: int, spectrum: str, k: int, *,
                     r: Optional[int] = None,
                     dtype: torch.dtype = torch.float64, floor: float = 1e-6,
                     device="cuda") -> SpectrumFactors:
    """The row-generable known-spectrum factorization (``SpectrumFactors``)
    of an ``m x n`` matrix of rank ``r`` (default ``min(2 k + 16, m - 1,
    n)``: the real DCT basis has only ``m - 1`` nonzero frequencies).
    ``gen_or_seed`` is an int seed, or a generator from which one is
    drawn; ``V`` lives on ``device``."""
    dev = check_device(device)
    r = min(2 * k + 16, m - 1, n) if r is None else r
    if r > min(m - 1, n):
        raise ValueError(f"need r <= min(m - 1, n), got r={r}, m={m}, n={n}")
    sig = spectrum_sigmas(spectrum, r, k, floor=floor)
    seed = seed_of(gen_or_seed)
    g = torch.Generator()
    g.manual_seed(block_seed(seed, 0))
    freqs = _distinct_ints(g, r, 0 if dtype.is_complex else 1, m)
    V = torch.randn((n, r), generator=g, dtype=torch.float64)
    if dtype.is_complex:
        V = torch.complex(V, torch.randn((n, r), generator=g,
                                         dtype=torch.float64))
    V = torch.linalg.qr(V.to(dev)).Q
    return SpectrumFactors(freqs=freqs, V=V, sig=sig, seed=seed, m=m,
                           dtype=dtype)


# splitmix64's multipliers as signed int64 (torch has no uint64 arithmetic
# on every device): products wrap mod 2^64, and the right shifts are made
# logical with a mask.
_MASK64 = (1 << 64) - 1
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)


def _signed(x: int) -> int:
    x &= _MASK64
    return x - (1 << 64) if x >> 63 else x


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    return (z >> s) & ((1 << (64 - s)) - 1)


def _row_hash(seed: int, i: torch.Tensor) -> torch.Tensor:
    """``rng.block_seed(seed, i)`` for every entry of ``i`` (int64), as
    int64 bits: the splitmix64 finalizer of ``seed * golden + i + 1``."""
    z = i + _signed(seed * 0x9E3779B97F4A7C15 + 1)
    z = (z ^ _shr(z, 30)) * _MIX1
    z = (z ^ _shr(z, 27)) * _MIX2
    return z ^ _shr(z, 31)


def row_diagonal(seed: int, r0: int, r1: int, dtype: torch.dtype,
                 device) -> torch.Tensor:
    """Entries ``[r0, r1)`` of the unit-modulus row diagonal: each a
    function of ``(seed, global row index)`` alone, through
    ``block_seed`` (splitmix64).  Real: ``+1`` or ``-1`` by the hash's top
    bit; complex: ``exp(2 pi i u)`` with ``u`` the hash's top 53 bits over
    2^53 (exact in f64).  f64 / c128."""
    i = torch.arange(r0, r1, dtype=torch.int64, device=device)
    h = _row_hash(seed, i)
    if dtype.is_complex:
        u = _shr(h, 11).to(torch.float64) * 2.0 ** -53
        return torch.polar(torch.ones_like(u), (2.0 * math.pi) * u)
    return 1.0 - 2.0 * _shr(h, 63).to(torch.float64)


def spectrum_rows(f: SpectrumFactors, r0: int, r1: int, *,
                  diag: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows ``[r0, r1)`` of the factored matrix, in ``f.dtype``, on
    ``f.V``'s device.  Each row depends only on its global index, so any
    chunking of ``[0, m)`` concatenates to the same matrix.  ``diag``
    (``r1 - r0`` entries) replaces the hashed row diagonal (the parity
    tests give it the reference's)."""
    dev = f.V.device
    if diag is None:
        diag = row_diagonal(f.seed, r0, r1, f.dtype, dev)
    d = diag.to(dev, torch.complex128 if f.dtype.is_complex
                else torch.float64)
    # i * f reaches ~m^2: form the products in f64 (exact below 2^53) and
    # reduce them modulo the basis period before the 2 pi scaling, so the
    # trig arguments stay small and full-precision at any streaming m.
    fi = torch.arange(r0, r1, dtype=torch.float64, device=dev)
    ff = torch.as_tensor(np.asarray(f.freqs, np.float64), device=dev)
    if f.dtype.is_complex:
        frac = torch.remainder(fi[:, None] * ff[None, :], float(f.m)) / f.m
        U = d[:, None] * torch.polar(torch.ones_like(frac),
                                     (2.0 * math.pi) * frac) / math.sqrt(f.m)
    else:
        # cos(pi (i + 1/2) f / m) has period 4m in (2i + 1) f
        t = torch.remainder((2.0 * fi + 1.0)[:, None] * ff[None, :],
                            4.0 * f.m)
        U = d[:, None] * torch.cos((math.pi / (2.0 * f.m)) * t) \
            * math.sqrt(2.0 / f.m)
    s = torch.as_tensor(f.sig, dtype=torch.float64, device=dev)
    rows = (U * s[None, :].to(U.dtype)) @ f.V.mH
    return rows.to(f.dtype)


def spectrum_id_error(f: SpectrumFactors, J: torch.Tensor,
                      P: torch.Tensor) -> float:
    """``||A - B P||_2`` of an ID ``B = A[:, J]`` of the factored matrix, in
    closed form: ``A - B P = D U diag(sig) V^H (I - S_J P)`` with ``D U``
    orthonormal, so it is the norm of the ``r x n`` matrix
    ``M - M[:, J] P``, ``M = diag(sig) V^H`` (no row of ``A`` formed)."""
    dev = f.V.device
    M = (torch.as_tensor(f.sig, dtype=torch.float64, device=dev)[:, None]
         .to(f.V.dtype) * f.V.mH)
    E = M - M[:, J.to(dev)] @ P.to(dev, M.dtype)
    # ||E||_2 = ||R||_2 for E^H = Q R: an r x r SVD in place of r x n.
    return float(torch.linalg.svdvals(torch.linalg.qr(E.mH, mode="r").R)[0])


# ------------------------------------------------------- LM training data

class SyntheticConfig(NamedTuple):
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05          # fraction of tokens replaced with noise
    period: int = 17             # base period of the learnable pattern


def _pattern_tokens(gen: torch.Generator, cfg: SyntheticConfig,
                    batch: int) -> torch.Tensor:
    """(batch, seq_len + 1) int32 tokens on the host: per-row phase +
    periodic ramp + noise, drawn from ``gen`` (a CPU generator)."""
    S = cfg.seq_len + 1
    phase = torch.randint(0, cfg.period, (batch, 1), generator=gen)
    pos = torch.arange(S)[None, :]
    base = (phase * 31 + pos * 7) % (cfg.period * 13)
    toks = base % cfg.vocab_size
    noise_mask = torch.rand((batch, S), generator=gen) < cfg.noise
    noise_val = torch.randint(0, cfg.vocab_size, (batch, S), generator=gen)
    return torch.where(noise_mask, noise_val, toks).to(torch.int32)


def batch_for_step(cfg: SyntheticConfig, step: int, *, host: int = 0,
                   n_hosts: int = 1, device="cuda") -> dict:
    """The batch (or this host's shard of it) for global step ``step``:
    ``tokens`` and ``labels`` (the tokens shifted by one), int32 on
    ``device``."""
    if cfg.global_batch % n_hosts:
        raise ValueError(f"global_batch={cfg.global_batch} does not split "
                         f"over {n_hosts} hosts")
    dev = check_device(device)
    gen = torch.Generator()
    gen.manual_seed(block_seed(block_seed(cfg.seed, step), host))
    toks = _pattern_tokens(gen, cfg, cfg.global_batch // n_hosts).to(dev)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_batch_iterator(cfg: SyntheticConfig, *, start_step: int = 0,
                        host: int = 0, n_hosts: int = 1,
                        device="cuda") -> Iterator[dict]:
    step = start_step
    while True:
        yield batch_for_step(cfg, step, host=host, n_hosts=n_hosts,
                             device=device)
        step += 1
