"""Contract of the FWHT / SRHT kernels (counterpart of
``repro/kernels/srht/contract.py``; see ``kernels.common.KernelContract``
for the fields)."""
from __future__ import annotations

import torch

from ..common import Example, KernelContract
import math

from .kernel import fwht_pass_launch
from .ops import fwht_factors
from .ref import next_pow2

f32 = torch.float32


def _example() -> Example:
    # srht of a 1000-row operand: the FWHT runs on its 1024-row padding,
    # one sweep per Kronecker factor, the last one scaled.
    from .ops import srht
    m, n, l = 1000, 512, 64
    signs = torch.empty((m,), dtype=f32, device="meta")
    a = torch.empty((m, n), dtype=f32, device="meta")
    rows = torch.empty((l,), dtype=torch.int64, device="meta")
    mp = next_pow2(m)
    factors = fwht_factors(mp)
    launches, stride = [], 1
    for i, f_log2 in enumerate(factors):
        scale = 1.0 / math.sqrt(mp) if i == len(factors) - 1 else 1.0
        launches.append(fwht_pass_launch(f32, mp, n, f_log2, stride, scale))
        stride <<= f_log2
    return Example(srht, (signs, a, rows), {}, tuple(launches))


def _bad_call():
    # FWHT length 100 is not a power of two: fwht must reject it eagerly
    # with the offending length named.
    from .ops import fwht
    fwht(torch.ones((100, 8)))


CONTRACT = KernelContract(
    name="srht",
    ops=("fwht", "srht"),
    kernels=("fwht_pass_kernel",),
    refs=("fwht_ref", "srht_ref"),
    pairs=(("fwht", "fwht_ref"), ("srht", "srht_ref")),
    example=_example,
    c_constants={"MAX_SLAB_LOG2": ("fwht.cu", "kMaxSlabLog2"),
                 "REG_LOG2": ("fwht.cu", "kFwhtRegLog2"),
                 "ROW_BYTES": ("fwht.cu", "kFwhtRowBytes"),
                 "TILE_BYTES": ("fwht.cu", "kFwhtTileBytes"),
                 "THREADS": ("fwht.cu", "kThreads")},
    bad_call=_bad_call,
)
