"""Wrapper of the Hopper kernel for the panel Gram pass
(``csrc/panel_gram.cu``), which replaces the TPU kernel
``panel_gram_kernel`` in ``repro/kernels/panel_gram/kernel.py``.

One launch of ``1 + ceil(n / 32)`` CTAs: CTA 0 forms ``G = C^H C`` (b x b)
once, every other CTA ``V = C^H Z`` for one 32-column slab of ``Z``, with
the ragged last slab masked in the kernel.
"""
from __future__ import annotations

import torch

from .._build import check_status, load_library
from ..common import (Launch, LaunchCounter, cdiv, check_kernel_args,
                      dtype_code, type_name)
from ..panel_step.kernel import (MAX_PANEL, SWEEP_COLS, SWEEP_ROWS,
                                 SWEEP_THREADS)

__all__ = ["panel_gram_kernel", "panel_gram_launch", "LAUNCHES"]

LAUNCHES = LaunchCounter("panel_gram")


def panel_gram_launch(dtype: torch.dtype, l: int, b: int, n: int) -> Launch:
    """The launch for ``c`` (l, b), ``z`` (l, n): ``1 + ceil(n / 32)``
    CTAs, each staging a 32-row chunk of ``c`` and of a ``z`` slab."""
    itemsize = torch.empty((), dtype=dtype, device="meta").element_size()
    return Launch(f"panel_gram_kernel<{type_name(dtype)}>",
                  (1 + cdiv(n, SWEEP_COLS), 1, 1), (SWEEP_THREADS, 1, 1),
                  itemsize * (SWEEP_ROWS * b + SWEEP_ROWS * SWEEP_COLS),
                  "repro_panel_gram",
                  (dtype_code(dtype), None, None, None, None, l, b, n, None))


def panel_gram_kernel(c: torch.Tensor, z: torch.Tensor):
    """Launch the kernel: ``c`` (l, b) with ``1 <= b <= MAX_PANEL`` and
    ``z`` (l, n), contiguous CUDA tensors of one dtype.  Returns
    ``(G, V)``; does not synchronize."""
    dev = check_kernel_args("panel_gram", c, z)
    l, b = c.shape
    l2, n = z.shape
    if l != l2:
        raise ValueError(f"panel_gram: c {tuple(c.shape)} and z "
                         f"{tuple(z.shape)} disagree on rows")
    if not 1 <= b <= MAX_PANEL:
        raise ValueError(f"panel_gram: need 1 <= b <= {MAX_PANEL}, got b={b}")
    g = torch.empty((b, b), dtype=c.dtype, device=dev)
    v = torch.empty((b, n), dtype=c.dtype, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_panel_gram(dtype_code(c.dtype), c.data_ptr(),
                                  z.data_ptr(), g.data_ptr(), v.data_ptr(),
                                  l, b, n, stream)
    check_status("panel_gram", rc)
    LAUNCHES.add()
    return g, v
