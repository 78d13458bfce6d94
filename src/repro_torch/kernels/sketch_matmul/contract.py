"""Contract of the tiled sketch matmul (counterpart of
``repro/kernels/sketch_matmul/contract.py``; see ``kernels.common.KernelContract``
for the fields).

The example runs the f64 kernel, Table 2's type, whose geometry (tile,
threads, stages, dynamic shared bytes) the wrapper computes from constants
pinned to ``csrc/sketch_matmul.cu`` and ``csrc/dmma_tile.cuh``.
"""
from __future__ import annotations

import torch

from ..common import Example, KernelContract
from .kernel import sketch_matmul_launch

f64 = torch.float64


def _example() -> Example:
    from .ops import sketch_matmul
    l, m, n = 128, 1024, 512
    omega = torch.empty((l, m), dtype=f64, device="meta")
    a = torch.empty((m, n), dtype=f64, device="meta")
    return Example(sketch_matmul, (omega, a), {},
                   (sketch_matmul_launch(f64, l, m, n),))


def _bad_call():
    from .ops import sketch_matmul
    sketch_matmul(torch.ones((8, 64)), torch.ones((128, 16)))


CONTRACT = KernelContract(
    name="sketch_matmul",
    ops=("sketch_matmul",),
    kernels=("sketch_matmul_kernel",),
    refs=("sketch_matmul_ref",),
    pairs=(("sketch_matmul", "sketch_matmul_ref"),),
    example=_example,
    c_constants={"MATMUL_STAGES": ("sketch_matmul.cu", "kMatmulStages"),
                 "DMMA_BM": ("dmma_tile.cuh", "kDmmaBM"),
                 "DMMA_BN": ("dmma_tile.cuh", "kDmmaBN"),
                 "DMMA_BK": ("dmma_tile.cuh", "kDmmaBK"),
                 "DMMA_THREADS": ("dmma_tile.cuh", "kDmmaThreads")},
    bad_call=_bad_call,
)
