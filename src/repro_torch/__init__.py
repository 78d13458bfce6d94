"""PyTorch/CUDA port of ``repro``: the randomized interpolative
decomposition, and the LM stack's serving path, on an NVIDIA H100.

The JAX package ``repro`` is the reference; this package mirrors its
layout (``core/``, ``kernels/``, ``models/``, ``serving/``, ``obs/``,
``launch/``) so each function has an obvious counterpart.  Its
hand-written Hopper kernels live under ``csrc/`` and are built at first
use (``kernels/_build.py``).  Nothing here imports ``jax`` or ``repro``.
"""
