"""Wrappers of the Hopper kernels for the classical Gram-Schmidt block
deflation, which replace the two TPU kernels of
``repro/kernels/cgs/kernel.py``:

  project_out_kernel   ``Z - Q (Q^H Z)`` for a basis ``Q`` (l x k) of any
                       width (``csrc/cgs.cu``): one CTA per column slab of
                       ``Z``, ``W`` through a (k, n) workspace allocated
                       here;
  panel_deflate_kernel ``(Z - Q_p W, W = Q_p^H Z)`` for one panel ``Q_p``
                       (l x b, ``b <= MAX_PANEL``): the panel sweep of
                       ``csrc/panel_step.cu`` with ``W`` stored and no
                       norms.

Each has its own launch count.
"""
from __future__ import annotations

import torch

from .._build import check_status, load_library
from ..common import (GEMM_THREADS, Launch, LaunchCounter, check_kernel_args,
                      dtype_code, gemm_grid, type_name)
from ..panel_step.kernel import MAX_PANEL, sweep_launch

__all__ = ["project_out_kernel", "panel_deflate_kernel", "project_out_launch",
           "panel_deflate_launch", "LAUNCHES", "DEFLATE_LAUNCHES"]

LAUNCHES = LaunchCounter("project_out")
DEFLATE_LAUNCHES = LaunchCounter("panel_deflate")


def project_out_launch(dtype: torch.dtype, l: int, k: int, n: int) -> Launch:
    """The launch for ``q`` (l, k), ``z`` (l, n): one CTA per column slab
    of the tiled GEMM's width, no dynamic shared memory."""
    return Launch(f"project_out_kernel<{type_name(dtype)}>",
                  (gemm_grid(dtype, 1, n)[0], 1, 1), GEMM_THREADS, 0,
                  "repro_project_out",
                  (dtype_code(dtype), None, None, None, None, l, k, n, None))


def panel_deflate_launch(dtype: torch.dtype, l: int, b: int,
                         n: int) -> Launch:
    """The launch for ``q`` (l, b), ``z`` (l, n): the panel step's sweep
    with ``W`` stored (``panel_step.kernel.sweep_launch``)."""
    return sweep_launch("deflate", dtype, l, b, n)


def _check_rows(name: str, q: torch.Tensor, z: torch.Tensor) -> None:
    if q.shape[0] != z.shape[0]:
        raise ValueError(f"{name}: q {tuple(q.shape)} and z "
                         f"{tuple(z.shape)} disagree on rows")


def project_out_kernel(q: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``q`` (l, k) and ``z`` (l, n), contiguous CUDA
    tensors of one dtype in ``KERNEL_DTYPES``.  Returns a new (l, n)
    tensor; does not synchronize."""
    dev = check_kernel_args("project_out", q, z)
    _check_rows("project_out", q, z)
    (l, k), n = q.shape, z.shape[1]
    o = torch.empty_like(z)
    if n == 0:
        return o
    w = torch.empty((k, n), dtype=z.dtype, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_project_out(dtype_code(z.dtype), q.data_ptr(),
                                   z.data_ptr(), w.data_ptr(), o.data_ptr(),
                                   l, k, n, stream)
    check_status("project_out", rc)
    LAUNCHES.add()
    return o


def panel_deflate_kernel(q: torch.Tensor, z: torch.Tensor):
    """Launch the kernel: ``q`` (l, b) with ``1 <= b <= MAX_PANEL`` and
    ``z`` (l, n), contiguous CUDA tensors of one dtype.  Returns ``(O, W)``;
    does not synchronize."""
    dev = check_kernel_args("panel_deflate", q, z)
    _check_rows("panel_deflate", q, z)
    (l, b), n = q.shape, z.shape[1]
    if not 1 <= b <= MAX_PANEL:
        raise ValueError(f"panel_deflate: need 1 <= b <= {MAX_PANEL}, "
                         f"got b={b}")
    o = torch.empty_like(z)
    w = torch.empty((b, n), dtype=z.dtype, device=dev)
    if n == 0:
        return o, w
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_panel_deflate(dtype_code(z.dtype), q.data_ptr(),
                                     z.data_ptr(), o.data_ptr(),
                                     w.data_ptr(), l, b, n, stream)
    check_status("panel_deflate", rc)
    DEFLATE_LAUNCHES.add()
    return o, w
