"""Contract of the CGS block-deflation kernels (counterpart of
``repro/kernels/cgs/contract.py``; see ``kernels.common.KernelContract``
for the fields).

The example makes one call of each wrapper: ``panel_deflate`` (f32, one
launch) and ``project_out`` (f64, the main path's type: its two launches,
``W = Q^H Z`` and ``O = Z - Q W``), so that all three launches are held to
the C side.  The f64 ring's stage count and the DMMA tile are pinned to
``csrc/cgs.cu`` and ``csrc/dmma_tile.cuh``, panel_deflate's block, ring and
slab width to ``csrc/panel_deflate.cu``.
"""
from __future__ import annotations

import torch

from ..common import Example, KernelContract
from .kernel import panel_deflate_launch, project_out_launch

f32, f64 = torch.float32, torch.float64


def _deflate_then_project(qp, z, q, z64):
    from .ops import panel_deflate, project_out
    return panel_deflate(qp, z), project_out(q, z64)


def _example() -> Example:
    l, b, k, n = 256, 32, 400, 4096
    qp = torch.empty((l, b), dtype=f32, device="meta")
    z = torch.empty((l, n), dtype=f32, device="meta")
    q = torch.empty((l, k), dtype=f64, device="meta")
    z64 = torch.empty((l, n), dtype=f64, device="meta")
    return Example(_deflate_then_project, (qp, z, q, z64), {},
                   (panel_deflate_launch(f32, l, b, n),
                    *project_out_launch(f64, l, k, n)))


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
    c_constants={"PROJECT_STAGES": ("cgs.cu", "kProjectStages"),
                 "DEFLATE_THREADS": ("panel_deflate.cu", "kDeflateThreads"),
                 "DEFLATE_ROWS": ("panel_deflate.cu", "kDeflateRows"),
                 "DEFLATE_STAGES": ("panel_deflate.cu", "kDeflateStages"),
                 "DEFLATE_DMMA_STAGES": ("panel_deflate.cu",
                                         "kDeflateDmmaStages"),
                 "DEFLATE_COLS": ("panel_deflate.cu", "kDeflateCols"),
                 "DMMA_BM": ("dmma_tile.cuh", "kDmmaBM"),
                 "DMMA_BN": ("dmma_tile.cuh", "kDmmaBN"),
                 "DMMA_BK": ("dmma_tile.cuh", "kDmmaBK"),
                 "DMMA_THREADS": ("dmma_tile.cuh", "kDmmaThreads")},
    bad_call=_bad_call,
)
