"""Plain version of the fixture kernel (counterpart of
``repro.analysis.fixtures.badkernel.ref``): the identity."""
from __future__ import annotations

import torch

__all__ = ["big_copy_ref"]


def big_copy_ref(x: torch.Tensor) -> torch.Tensor:
    return x
