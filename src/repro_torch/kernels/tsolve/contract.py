"""Contract of the triangular interpolation solver (counterpart of
``repro/kernels/tsolve/contract.py``; see ``kernels.common.KernelContract``
for the fields)."""
from __future__ import annotations

import torch

from ..common import Example, KernelContract
from .kernel import tsolve_launch

f32 = torch.float32


def _example() -> Example:
    from .ops import tsolve
    k, n = 64, 4096
    r1 = torch.empty((k, k), dtype=f32, device="meta")
    r2 = torch.empty((k, n), dtype=f32, device="meta")
    return Example(tsolve, (r1, r2), {}, (tsolve_launch(f32, k, n),))


def _bad_call():
    # r1 (32 x 32) does not match r2's 64 rows.
    from .ops import tsolve
    tsolve(torch.eye(32), torch.ones((64, 8)))


CONTRACT = KernelContract(
    name="tsolve",
    ops=("tsolve",),
    kernels=("tsolve_kernel",),
    refs=("tsolve_ref",),
    pairs=(("tsolve", "tsolve_ref"),),
    example=_example,
    c_constants={"THREADS": ("tsolve.cu", "kSolveThreads"),
                 "BLOCK_ROWS": ("tsolve.cu", "kSolveRows"),
                 "DEPTH": ("tsolve.cu", "kSolveDepth"),
                 "STAGES": ("tsolve.cu", "kSolveStages"),
                 "SLAB_BYTES": ("tsolve.cu", "kSolveSlabBytes")},
    bad_call=_bad_call,
)
