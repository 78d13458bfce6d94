"""Contract of the fused panel-Gram kernel (counterpart of
``repro/kernels/panel_gram/contract.py``; see ``kernels.common.KernelContract``
for the fields)."""
from __future__ import annotations

import torch

from ..common import Example, KernelContract
from .kernel import panel_gram_launch

f32 = torch.float32


def _example() -> Example:
    from .ops import panel_gram
    l, b, n = 256, 32, 4096
    c = torch.empty((l, b), dtype=f32, device="meta")
    z = torch.empty((l, n), dtype=f32, device="meta")
    return Example(panel_gram, (c, z), {}, (panel_gram_launch(f32, l, b, n),))


def _bad_call():
    from .ops import panel_gram
    panel_gram(torch.ones((8, 4)), torch.ones((16, 32)))


CONTRACT = KernelContract(
    name="panel_gram",
    ops=("panel_gram",),
    kernels=("panel_gram_kernel",),
    refs=("panel_gram_ref",),
    pairs=(("panel_gram", "panel_gram_ref"),),
    example=_example,
    bad_call=_bad_call,
)
