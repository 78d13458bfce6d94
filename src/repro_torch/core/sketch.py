"""Randomized sketching operators ``Y = Phi @ A`` with ``Phi`` l x m
(counterpart of ``repro.core.sketch``).

* ``srft``     -- the paper's ``Y = S F D A`` (eq. 4-7): random unit phases
                  per row, a DFT down every column (``torch.fft``), ``l``
                  rows drawn uniformly with replacement, scale ``1/sqrt(l)``.
* ``srht``     -- the real analogue: random signs, a Walsh-Hadamard
                  transform on rows zero-padded to a power of two, through
                  ``kernels/srht`` (the ``fwht`` kernel on the card, the
                  plain version on the CPU; bit-equal in the real dtypes).
* ``gaussian`` -- ``Y = Omega A`` through the port's ``sketch_accum``.

Each backend accepts its random operator injected (``phases=``/``rows=``,
``signs=``/``rows=``, ``omega=``), so the parity tests can feed it the JAX
reference's own draws.

The gaussian operator is seeded per canonical ``ACCUM_BLOCK``-row block:
block ``b`` of ``Omega`` is drawn from a generator seeded with
``rng.block_seed(seed, b)``, a function of ``(seed, b)`` alone (the
counterpart of ``fold_in(key, b)``).  With the fixed-block reduction of
``sketch_accum`` that lets a streamed sketch replay any row range and get
the in-memory sketch's bits (on the same device: CPU and CUDA generators
draw different numbers).
"""
from __future__ import annotations

import math

import torch

from ..kernels.common import cdiv
from ..kernels.sketch_accum import ACCUM_BLOCK, sketch_accum
from ..kernels.srht import fwht, srht
from ..kernels.srht.ref import next_pow2
from .rng import as_generator, block_seed, check_device, seed_of
from .types import SketchResult

__all__ = ["sketch", "srft_sketch", "srht_sketch", "gaussian_sketch",
           "gaussian_omega_cols", "finalize_gaussian_sketch", "fwht",
           "next_pow2"]


def _complex_for(dtype: torch.dtype) -> torch.dtype:
    return (torch.complex128 if dtype in (torch.float64, torch.complex128)
            else torch.complex64)


def srft_sketch(gen_or_seed, A: torch.Tensor, l: int, *,
                phases: torch.Tensor | None = None,
                rows: torch.Tensor | None = None) -> torch.Tensor:
    """Paper eq. (4): ``Y = S F D A``.  ``phases`` (m,) are the unit-modulus
    entries of ``D``, ``rows`` (l,) the indices ``S`` keeps; each is drawn
    from ``gen_or_seed`` when not given.  The output is complex."""
    m = A.shape[0]
    cdtype = _complex_for(A.dtype)
    if phases is None or rows is None:
        gen = as_generator(gen_or_seed, A.device)
    if phases is None:
        phi = torch.rand(m, generator=gen, dtype=cdtype.to_real(),
                         device=A.device)
        phases = torch.polar(torch.ones_like(phi), (2 * math.pi) * phi)
    if rows is None:
        rows = torch.randint(0, m, (l,), generator=gen, device=A.device)
    DA = phases.to(cdtype)[:, None] * A.to(cdtype)
    FDA = torch.fft.fft(DA, dim=0)
    scale = 1.0 / math.sqrt(l * m) * math.sqrt(m)          # = 1/sqrt(l)
    return FDA[rows.to(A.device, torch.int64)] * scale


def srht_sketch(gen_or_seed, A: torch.Tensor, l: int, *,
                signs: torch.Tensor | None = None,
                rows: torch.Tensor | None = None) -> torch.Tensor:
    """Real subsampled randomized Hadamard transform.  Rows are zero-padded
    to the next power of two ``mp``; ``signs`` (m,) are +-1, ``rows`` (l,)
    indices into ``mp``."""
    m = A.shape[0]
    mp = next_pow2(m)
    if signs is None or rows is None:
        gen = as_generator(gen_or_seed, A.device)
    if signs is None:
        signs = torch.randint(0, 2, (m,), generator=gen,
                              device=A.device) * 2 - 1
    if rows is None:
        rows = torch.randint(0, mp, (l,), generator=gen, device=A.device)
    return srht(signs.to(A.device), A, rows)


def _omega_block(seed: int, b: int, l: int, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """Block ``b`` of ``Omega^T``, (ACCUM_BLOCK, l), unscaled: standard
    normal entries (real and imaginary parts each standard normal for a
    complex dtype, JAX's convention)."""
    g = torch.Generator(device=device)
    g.manual_seed(block_seed(seed, b))
    if dtype.is_complex:
        rdt = dtype.to_real()
        re = torch.randn((ACCUM_BLOCK, l), generator=g, dtype=rdt,
                         device=device)
        im = torch.randn((ACCUM_BLOCK, l), generator=g, dtype=rdt,
                         device=device)
        return torch.complex(re, im)
    return torch.randn((ACCUM_BLOCK, l), generator=g, dtype=dtype,
                       device=device)


def gaussian_omega_cols(seed: int, r0: int, r1: int, l: int,
                        dtype: torch.dtype, device="cuda") -> torch.Tensor:
    """Columns ``[r0, r1)`` of the unscaled gaussian operator ``Omega``
    (l x m) on ``device``; ``r0`` must sit on a block boundary."""
    if r0 % ACCUM_BLOCK:
        raise ValueError(f"need r0 a multiple of ACCUM_BLOCK={ACCUM_BLOCK}, "
                         f"got r0={r0}")
    dev = check_device(device)
    b0, nb = r0 // ACCUM_BLOCK, cdiv(r1 - r0, ACCUM_BLOCK)
    omega_t = torch.cat([_omega_block(seed, b, l, dtype, dev)
                         for b in range(b0, b0 + nb)])
    return omega_t[:r1 - r0].T.contiguous()


def finalize_gaussian_sketch(acc: torch.Tensor, l: int,
                             dtype: torch.dtype) -> torch.Tensor:
    """Scale the canonical accumulator into the sketch: ``1/sqrt(l)``
    (``1/sqrt(2l)`` for complex, so each entry of ``Omega`` has variance
    ``1/l``) and cast to the input dtype."""
    scale = 1.0 / math.sqrt(2 * l if dtype.is_complex else l)
    return (acc * scale).to(dtype)


def gaussian_sketch(gen_or_seed, A: torch.Tensor, l: int, *,
                    omega: torch.Tensor | None = None) -> torch.Tensor:
    """``Y = Omega A`` through the canonical accumulation path: block-seeded
    operator columns (or the unscaled ``omega`` given, l x m), the
    fixed-block reduction of ``sketch_accum``, one final scale."""
    m = A.shape[0]
    if omega is None:
        omega = gaussian_omega_cols(seed_of(gen_or_seed), 0, m, l, A.dtype,
                                    A.device)
    return finalize_gaussian_sketch(sketch_accum(omega.to(A.device), A), l,
                                    A.dtype)


_BACKENDS = {
    "srft": srft_sketch,
    "srht": srht_sketch,
    "gaussian": gaussian_sketch,
}


def sketch(gen_or_seed, A: torch.Tensor, l: int, kind: str = "srft",
           **operator) -> SketchResult:
    """Dispatch to a sketch backend, ``kind in {'srft','srht','gaussian'}``;
    ``operator`` holds the backend's injected operator, if any."""
    try:
        fn = _BACKENDS[kind]
    except KeyError:
        raise ValueError(f"unknown sketch kind {kind!r}; pick from "
                         f"{sorted(_BACKENDS)}") from None
    return SketchResult(Y=fn(gen_or_seed, A, l, **operator), kind=kind)
