"""Contract of the tiled sketch matmul (counterpart of
``repro/kernels/sketch_matmul/contract.py``; see ``kernels.common.KernelContract``
for the fields)."""
from __future__ import annotations

import torch

from ..common import Example, KernelContract
from .kernel import sketch_matmul_launch

f32 = torch.float32


def _example() -> Example:
    from .ops import sketch_matmul
    l, m, n = 128, 1024, 512
    omega = torch.empty((l, m), dtype=f32, device="meta")
    a = torch.empty((m, n), dtype=f32, device="meta")
    return Example(sketch_matmul, (omega, a), {},
                   (sketch_matmul_launch(f32, l, m, n),))


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
    bad_call=_bad_call,
)
