"""Contract of the fused panel-Gram kernel (counterpart of
``repro/kernels/panel_gram/contract.py``; see ``kernels.common.KernelContract``
for the fields).

The example runs f64 at the gram path's panel width; the wrapper computes
its geometry (CTAs, threads, dynamic shared bytes) from constants pinned
to ``csrc/panel_gram.cu`` and ``csrc/panel_common.cuh``.
"""
from __future__ import annotations

import torch

from ..common import Example, KernelContract
from .kernel import panel_gram_launch

f64 = torch.float64


def _example() -> Example:
    from .ops import panel_gram
    l, b, n = 256, 32, 4096
    c = torch.empty((l, b), dtype=f64, device="meta")
    z = torch.empty((l, n), dtype=f64, device="meta")
    return Example(panel_gram, (c, z), {}, (panel_gram_launch(f64, l, b, n),))


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
    c_constants={"GRAM_ROWS": ("panel_gram.cu", "kGramRows"),
                 "GRAM_STAGES": ("panel_gram.cu", "kGramStages"),
                 "GRAM_WARP_ROWS": ("panel_gram.cu", "kGramWarpRows"),
                 "GRAM_COLS": ("panel_gram.cu", "kGramCols"),
                 "GRAM_WARPS": ("panel_gram.cu", "kGramWarps"),
                 "MAX_PANEL": ("panel_common.cuh", "kMaxPanel")},
    bad_call=_bad_call,
)
