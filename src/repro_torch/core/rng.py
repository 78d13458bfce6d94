"""Explicit random state for the port: ``torch.Generator`` in place of
JAX keys.

Entry points take ``gen_or_seed``: an ``int`` seed or a generator.  A seed
makes a fresh generator on the device of the tensors involved, so the same
seed on the same device reproduces the same decomposition bit for bit.
CPU and CUDA generators give different numbers from the same seed.
"""
from __future__ import annotations

import torch

__all__ = ["as_generator", "seed_of", "block_seed", "check_device"]

_MASK64 = (1 << 64) - 1


def check_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there
    is no card (functions that create tensors never fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device!r} requested but "
                           f"torch.cuda.is_available() is False")
    return dev


def as_generator(gen_or_seed, device) -> torch.Generator:
    """A generator on ``device``: ``gen_or_seed`` itself, or a fresh one
    seeded with the int ``gen_or_seed``."""
    if isinstance(gen_or_seed, torch.Generator):
        if torch.device(gen_or_seed.device).type != torch.device(device).type:
            raise ValueError(f"generator on {gen_or_seed.device} cannot draw "
                             f"for tensors on {device}")
        return gen_or_seed
    g = torch.Generator(device=device)
    g.manual_seed(int(gen_or_seed) & _MASK64)
    return g


def seed_of(gen_or_seed) -> int:
    """An int seed: ``gen_or_seed`` itself, or one drawn from the generator
    (advancing it), for operators that are seeded per block."""
    if isinstance(gen_or_seed, torch.Generator):
        return int(torch.randint(0, 1 << 62, (1,), generator=gen_or_seed,
                                 device=gen_or_seed.device).item())
    return int(gen_or_seed) & _MASK64


def block_seed(seed: int, b: int) -> int:
    """Seed of canonical block ``b`` under ``seed``: the splitmix64
    finalizer of ``seed * 0x9E3779B97F4A7C15 + b + 1`` (mod 2^64).  It
    depends on ``(seed, b)`` alone, the counterpart of ``fold_in(key, b)``,
    so any block can be regenerated without the others."""
    z = (seed * 0x9E3779B97F4A7C15 + b + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)
