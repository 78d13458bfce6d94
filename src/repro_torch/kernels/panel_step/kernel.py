"""Wrapper of the Hopper kernels for the fused panel step
(``csrc/panel_step.cu``), which replace the TPU kernel
``panel_step_kernel`` in ``repro/kernels/panel_step/kernel.py``.

The TPU kernel factors the panel on grid step 0 and keeps ``Q_p`` in VMEM
for every later slab.  Hopper blocks share nothing, so the port runs two
launches per call:

  (a) ``panel_factor`` -- one CTA: CholeskyQR2 of ``C`` with the clamped
      Cholesky of ``ref.chol_clamped``, ``Q_p`` to global memory;
  (b) ``panel_sweep``  -- one CTA per 32-column slab of ``Z``:
      ``W = Q_p^H Z``, ``O = Z - Q_p W``, ``colnorms^2(O)`` from the
      unrounded ``O``; ``W`` is stored only when ``emit_w``.

One call of ``panel_step_kernel`` is one launch of the ported kernel in
the launch count (the pair is counted once).
"""
from __future__ import annotations

import torch

from .._build import check_status, load_library
from ..common import LaunchCounter, check_kernel_args, dtype_code

__all__ = ["MAX_PANEL", "panel_step_kernel", "LAUNCHES"]

# Widest panel the kernels take (csrc/panel_step.cu, kMaxPanel).
MAX_PANEL = 64

LAUNCHES = LaunchCounter("panel_step")


def panel_step_kernel(c: torch.Tensor, z: torch.Tensor, *,
                      emit_w: bool = True):
    """Launch the factor and the sweep: ``c`` (l, b) with
    ``1 <= b <= MAX_PANEL``, ``z`` (l, n), contiguous CUDA tensors of one
    dtype.  Returns ``(Q_p, O, W or None, r2)``, ``r2`` real; does not
    synchronize."""
    dev = check_kernel_args("panel_step", c, z)
    l, b = c.shape
    l2, n = z.shape
    if l != l2:
        raise ValueError(f"panel_step: c {tuple(c.shape)} and z "
                         f"{tuple(z.shape)} disagree on rows")
    if not 1 <= b <= MAX_PANEL:
        raise ValueError(f"panel_step: need 1 <= b <= {MAX_PANEL}, got b={b}")
    rdtype = c.real.dtype if c.is_complex() else c.dtype
    qp = torch.empty_like(c)
    o = torch.empty_like(z)
    w = torch.empty((b, n), dtype=z.dtype, device=dev) if emit_w else None
    r2 = torch.empty((n,), dtype=rdtype, device=dev)
    lib = load_library()
    code = dtype_code(c.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.repro_panel_factor(code, c.data_ptr(), qp.data_ptr(), l, b,
                                    stream)
        check_status("panel_step (factor)", rc)
        if n:
            rc = lib.repro_panel_sweep(code, qp.data_ptr(), z.data_ptr(),
                                       o.data_ptr(),
                                       w.data_ptr() if emit_w else None,
                                       r2.data_ptr(), l, b, n, stream)
            check_status("panel_step (sweep)", rc)
    LAUNCHES.add()
    return qp, o, w, r2
