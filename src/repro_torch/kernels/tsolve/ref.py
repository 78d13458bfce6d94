"""Plain PyTorch version of the blocked triangular solve (counterpart of
``repro.kernels.tsolve.ref``): the kernel's row-blocked back substitution
in tensor ops, bottom-up blocks of ``BLOCK_ROWS`` rows, a trailing update
from the rows already solved, then the diagonal block row by row with the
raw diagonal.  Its sums run in the library's order, so the kernel agrees
with it to a tolerance that grows with the condition of ``r1``."""
from __future__ import annotations

import torch

__all__ = ["BLOCK_ROWS", "tsolve_ref"]

# Rows per block, as in csrc/tsolve.cu (kSolveRows; the kernel contract
# holds the two equal).
BLOCK_ROWS = 32


def tsolve_ref(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """``T`` with ``triu(r1) @ T = r2``; ``r1`` (k, k), ``r2`` (k, n)."""
    k = r1.shape[0]
    u = torch.triu(r1)
    t = torch.zeros_like(r2)
    for r0 in reversed(range(0, k, BLOCK_ROWS)):
        r1_ = min(r0 + BLOCK_ROWS, k)
        b = r2[r0:r1_] - u[r0:r1_, r1_:] @ t[r1_:]
        for i in reversed(range(r0, r1_)):
            acc = u[i, i + 1:r1_] @ t[i + 1:r1_]
            t[i] = (b[i - r0] - acc) / u[i, i]
    return t
