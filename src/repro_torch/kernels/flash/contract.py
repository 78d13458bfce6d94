"""Contract of the flash-attention kernel (counterpart of
``repro/kernels/flash/contract.py``; see ``kernels.common.KernelContract``
for the fields).

The example is at hd 256 in f32, the widest head the kernel takes and its
largest tiles: the q tile and two stages of 32-row k and v tiles ask for
201728 B of shared memory, under the 232448 B a Hopper block may have, so
a wider tile would trip ``kernels.smem-overflow``.
"""
from __future__ import annotations

import torch

from ..common import Example, KernelContract
from .kernel import flash_launch

f32 = torch.float32


def _example() -> Example:
    from .ops import flash_attention
    b, s, h, hd = 1, 512, 4, 256
    q = torch.empty((b, s, h, hd), dtype=f32, device="meta")
    k = torch.empty((b, s, h, hd), dtype=f32, device="meta")
    v = torch.empty((b, s, h, hd), dtype=f32, device="meta")
    return Example(flash_attention, (q, k, v), {},
                   (flash_launch(f32, f32, b * h, s, s, hd),))


def _bad_call():
    # q is 3-D: ops.py must reject it with the shapes named.
    from .ops import flash_attention
    x = torch.ones((2, 8, 16))
    flash_attention(x, x, x)


CONTRACT = KernelContract(
    name="flash",
    ops=("flash_attention",),
    kernels=("flash_attention_kernel",),
    refs=("flash_ref",),
    pairs=(("flash_attention", "flash_ref"),),
    example=_example,
    c_constants={"BQ": ("flash.cu", "kBQ"), "BK": ("flash.cu", "kBK"),
                 "BK_WIDE": ("flash.cu", "kBKWide"),
                 "THREADS": ("flash.cu", "kThreads"),
                 "STAGES": ("flash.cu", "kStages")},
    bad_call=_bad_call,
)
