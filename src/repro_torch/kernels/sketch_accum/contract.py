"""Contract of the canonically blocked sketch accumulator (counterpart of
``repro/kernels/sketch_accum/contract.py``; see ``kernels.common.KernelContract``
for the fields).

``ACCUM_BLOCK`` is pinned twice: to 128, the replay constant every stored
gaussian sketch depends on, and to ``kAccumBlock`` of
``csrc/sketch_accum.cu``, which the kernel reduces by.  The example runs
the f64 kernel, the main path's type, whose geometry (tile, threads,
stages, dynamic shared bytes) the wrapper computes from constants pinned
to ``csrc/sketch_accum.cu`` and ``csrc/dmma_tile.cuh``.
"""
from __future__ import annotations

import torch

from ..common import Example, KernelContract
from .kernel import sketch_accum_launch

f64 = torch.float64


def _example() -> Example:
    from .ops import sketch_accum
    l, m, n = 96, 1024, 512
    x = torch.empty((l, m), dtype=f64, device="meta")
    a = torch.empty((m, n), dtype=f64, device="meta")
    return Example(sketch_accum, (x, a), {},
                   (sketch_accum_launch(f64, l, m, n),))


def _bad_call():
    # x columns (64) disagree with a rows (128): ops.py must reject this
    # eagerly with both values named.
    from .ops import sketch_accum
    sketch_accum(torch.ones((96, 64)), torch.ones((128, 512)))


CONTRACT = KernelContract(
    name="sketch_accum",
    ops=("sketch_accum",),
    kernels=("sketch_accum_kernel",),
    refs=("sketch_accum_ref",),
    pairs=(("sketch_accum", "sketch_accum_ref"),),
    example=_example,
    constants={"ACCUM_BLOCK": 128},
    c_constants={"ACCUM_BLOCK": ("sketch_accum.cu", "kAccumBlock"),
                 "ACCUM_STAGES": ("sketch_accum.cu", "kAccumStages"),
                 "DMMA_BM": ("dmma_tile.cuh", "kDmmaBM"),
                 "DMMA_BN": ("dmma_tile.cuh", "kDmmaBN"),
                 "DMMA_BK": ("dmma_tile.cuh", "kDmmaBK"),
                 "DMMA_THREADS": ("dmma_tile.cuh", "kDmmaThreads"),
                 "DMMA_WM": ("dmma_tile.cuh", "kDmmaWM"),
                 "DMMA_WN": ("dmma_tile.cuh", "kDmmaWN")},
    bad_call=_bad_call,
    measure_residency=True,
)
