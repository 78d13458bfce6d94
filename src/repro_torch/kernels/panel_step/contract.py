"""Contract of the fused panel-step kernels (counterpart of
``repro/kernels/panel_step/contract.py``; see ``kernels.common.KernelContract``
for the fields)."""
from __future__ import annotations

import torch

from ..common import Example, KernelContract
from .kernel import step_launches

f32 = torch.float32


def _example() -> Example:
    from .ops import panel_step
    l, b, n = 256, 32, 4096
    c = torch.empty((l, b), dtype=f32, device="meta")
    z = torch.empty((l, n), dtype=f32, device="meta")
    return Example(panel_step, (c, z), {}, step_launches(f32, l, b, n))


def _bad_call():
    # c has 8 rows, z 16: ops.py must reject it before any dispatch.
    from .ops import panel_step
    panel_step(torch.ones((8, 4)), torch.ones((16, 32)))


CONTRACT = KernelContract(
    name="panel_step",
    ops=("panel_step", "panel_coeff", "panel_apply"),
    kernels=("panel_step_kernel", "panel_coeff_kernel",
             "panel_apply_kernel"),
    refs=("panel_step_ref", "panel_coeff_ref", "panel_apply_ref"),
    pairs=(("panel_step", "panel_step_ref"),
           ("panel_coeff", "panel_coeff_ref"),
           ("panel_apply", "panel_apply_ref")),
    example=_example,
    c_constants={"MAX_PANEL": ("panel_common.cuh", "kMaxPanel"),
                 "FACTOR_THREADS": ("panel_step.cu", "kFactorThreads"),
                 "APPLY_NORM_GROUPS": ("panel_apply.cu", "kApplyNormGroups"),
                 "APPLY_ROWS": ("panel_apply.cu", "kApplyRows"),
                 "APPLY_STAGES": ("panel_apply.cu", "kApplyStages"),
                 "APPLY_MIN_CTAS": ("panel_apply.cu", "kApplyMinCtas")},
    bad_call=_bad_call,
)
