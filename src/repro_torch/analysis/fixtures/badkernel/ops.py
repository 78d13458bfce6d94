"""Public wrapper of the fixture kernel (counterpart of
``repro.analysis.fixtures.badkernel.ops``).  CPU tensors take the plain
version (``ref.py``); CUDA tensors launch the kernel (``kernel.py``) or
raise, never the plain version."""
from __future__ import annotations

import torch

from .kernel import big_copy_kernel
from .ref import big_copy_ref

__all__ = ["big_copy"]


def big_copy(x: torch.Tensor, *, bn: int = 2048) -> torch.Tensor:
    """``x`` copied by column blocks of ``bn``; ``x`` is (m, n)."""
    if x.dim() != 2:
        raise ValueError(f"big_copy: x must be 2-D, got shape "
                         f"{tuple(x.shape)}")
    if bn < 1:
        raise ValueError(f"big_copy: need bn >= 1, got bn={bn}")
    if x.device.type == "cpu":
        return big_copy_ref(x)
    return big_copy_kernel(x.contiguous(), bn=bn)
