"""Contract of the CGS block-deflation kernels (counterpart of
``repro/kernels/cgs/contract.py``; see ``kernels.common.KernelContract``
for the fields)."""
from __future__ import annotations

import torch

from ..common import Example, KernelContract
from .kernel import panel_deflate_launch

f32 = torch.float32


def _example() -> Example:
    from .ops import panel_deflate
    l, b, n = 256, 32, 4096
    q = torch.empty((l, b), dtype=f32, device="meta")
    z = torch.empty((l, n), dtype=f32, device="meta")
    return Example(panel_deflate, (q, z), {},
                   (panel_deflate_launch(f32, l, b, n),))


def _bad_call():
    from .ops import project_out
    project_out(torch.ones((8, 4)), torch.ones((16, 32)))


CONTRACT = KernelContract(
    name="cgs",
    ops=("project_out", "panel_deflate"),
    kernels=("project_out_kernel", "panel_deflate_kernel"),
    refs=("project_out_ref", "panel_deflate_ref"),
    pairs=(("project_out", "project_out_ref"),
           ("panel_deflate", "panel_deflate_ref")),
    example=_example,
    bad_call=_bad_call,
)
