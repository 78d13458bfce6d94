"""Contract of the hostile fixture kernel (counterpart of
``repro/analysis/fixtures/badkernel/contract.py``): a 4096 x 4096 f32
example with ``bn`` = 2048, whose every block asks for the whole 64 MiB
operand in shared memory, far over the 232448 B budget.
``kernels.check_package`` must emit ``kernels.smem-overflow`` here,
proving the estimator is not vacuous."""
from __future__ import annotations

import torch

from ....kernels.common import Example, KernelContract
from .kernel import big_copy_launch


def _example() -> Example:
    from .ops import big_copy
    m, n, bn = 4096, 4096, 2048
    x = torch.empty((m, n), dtype=torch.float32, device="meta")
    return Example(big_copy, (x,), {"bn": bn},
                   (big_copy_launch(torch.float32, m, n, bn),))


CONTRACT = KernelContract(
    name="badkernel",
    ops=("big_copy",),
    kernels=("big_copy_kernel",),
    refs=("big_copy_ref",),
    pairs=(("big_copy", "big_copy_ref"),),
    example=_example,
    c_constants={"THREADS": ("big_copy.cu", "kThreads")},
)
