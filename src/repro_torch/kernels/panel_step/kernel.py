"""Wrappers of the Hopper panel kernels (``csrc/panel_step.cu``), which
replace three TPU kernels of ``repro/kernels/panel_step/kernel.py``:
``panel_step_kernel``, ``panel_coeff_kernel`` and ``panel_apply_kernel``.

The TPU kernels factor the panel on grid step 0 and keep ``Q_p`` in VMEM
for every later slab.  Hopper blocks share nothing, so the factor is a
launch of its own:

  (a) ``panel_factor`` -- one CTA: CholeskyQR2 of ``C`` with the clamped
      Cholesky of ``ref.chol_clamped``, ``Q_p`` to global memory;
  (b) ``panel_sweep``  -- one CTA per 32-column slab of ``Z``, in three
      instantiations:
        panel_step:  ``W = Q_p^H Z``, ``O = Z - Q_p W``, ``colnorms^2(O)``
                     from the unrounded ``O``; ``W`` stored only when
                     ``emit_w``;
        panel_coeff: ``W`` and the downdate ``max(r2 - colnorms^2(W), 0)``,
                     no ``O`` (stage A of the distributed panel);
        panel_apply: ``O = Z - Q_p W`` with ``W`` read, and
                     ``colnorms^2(O)`` with ``emit_norms`` (stage B).

``panel_step`` and ``panel_coeff`` are (a) then (b); ``panel_apply`` is (b)
alone.  One call is one launch of the ported kernel in its launch count
(a factor + sweep pair is counted once).
"""
from __future__ import annotations

import torch

from .._build import check_status, load_library
from ..common import (Launch, LaunchCounter, cdiv, check_kernel_args,
                      dtype_code, type_name)

__all__ = ["MAX_PANEL", "panel_step_kernel", "panel_coeff_kernel",
           "panel_apply_kernel", "factor_launch", "sweep_launch", "LAUNCHES",
           "COEFF_LAUNCHES", "APPLY_LAUNCHES", "APPLY_NORMS_LAUNCHES"]

# Widest panel the kernels take (csrc/panel_common.cuh, kMaxPanel; the
# kernel contract holds the two equal).
MAX_PANEL = 64
# The sweep's tile (csrc/panel_common.cuh): 32 columns of Z per CTA, one
# per lane, 8 warps, l staged in 32-row chunks; the factor's CTA size
# (csrc/panel_step.cu).
SWEEP_COLS, SWEEP_ROWS, SWEEP_WARPS = 32, 32, 8
SWEEP_THREADS = SWEEP_COLS * SWEEP_WARPS
FACTOR_THREADS = 512

LAUNCHES = LaunchCounter("panel_step")
COEFF_LAUNCHES = LaunchCounter("panel_coeff")
APPLY_LAUNCHES = LaunchCounter("panel_apply")
# The subset of APPLY_LAUNCHES made with emit_norms=True.
APPLY_NORMS_LAUNCHES = LaunchCounter("panel_apply(emit_norms)")


def _real_dtype(t: torch.Tensor) -> torch.dtype:
    return t.real.dtype if t.is_complex() else t.dtype


def _sizes(dtype: torch.dtype) -> tuple[int, int]:
    """Bytes of one element and of its real part."""
    t = torch.empty((), dtype=dtype, device="meta")
    return t.element_size(), _real_dtype(t).itemsize


def factor_launch(dtype: torch.dtype, l: int, b: int) -> Launch:
    """The factor's launch for a panel ``c`` (l, b): one CTA; G (b x b),
    one column and the real pivots in shared memory."""
    item, ritem = _sizes(dtype)
    return Launch(f"panel_factor_kernel<{type_name(dtype)}>", (1, 1, 1),
                  (FACTOR_THREADS, 1, 1), item * (b * b + b) + ritem * b,
                  "repro_panel_factor",
                  (dtype_code(dtype), None, None, l, b, None))


# Sweep variants: template flags (computes W, emits O) and C entry point.
_SWEEPS = {"step": ("true,true", "repro_panel_sweep", 5),
           "coeff": ("true,false", "repro_panel_coeff_sweep", 5),
           "apply": ("false,true", "repro_panel_apply", 5)}


def sweep_launch(variant: str, dtype: torch.dtype, l: int, b: int,
                 n: int) -> Launch:
    """A sweep's launch (``variant`` one of ``_SWEEPS``) over ``z`` (l, n)
    with a panel of ``b`` columns: one CTA per 32-column slab, a 32-row
    chunk of the panel and of the slab, ``W`` and the warps' norm partials
    in shared memory."""
    flags, entry, pointers = _SWEEPS[variant]
    item, ritem = _sizes(dtype)
    smem = (item * (SWEEP_ROWS * b + SWEEP_ROWS * SWEEP_COLS
                    + b * SWEEP_COLS) + ritem * SWEEP_WARPS * SWEEP_COLS)
    return Launch(f"panel_sweep_kernel<{type_name(dtype)},{flags}>",
                  (cdiv(n, SWEEP_COLS), 1, 1), (SWEEP_THREADS, 1, 1), smem,
                  entry, (dtype_code(dtype),) + (None,) * pointers
                  + (l, b, n, None))


def _check_panel(name: str, panel: torch.Tensor, z: torch.Tensor) -> None:
    l, b = panel.shape
    if l != z.shape[0]:
        raise ValueError(f"{name}: panel {tuple(panel.shape)} and z "
                         f"{tuple(z.shape)} disagree on rows")
    if not 1 <= b <= MAX_PANEL:
        raise ValueError(f"{name}: need 1 <= b <= {MAX_PANEL}, got b={b}")


def _factor(lib, code: int, c: torch.Tensor, stream: int) -> torch.Tensor:
    qp = torch.empty_like(c)
    rc = lib.repro_panel_factor(code, c.data_ptr(), qp.data_ptr(), c.shape[0],
                                c.shape[1], stream)
    check_status("panel factor", rc)
    return qp


def panel_step_kernel(c: torch.Tensor, z: torch.Tensor, *,
                      emit_w: bool = True):
    """Launch the factor and the sweep: ``c`` (l, b) with
    ``1 <= b <= MAX_PANEL``, ``z`` (l, n), contiguous CUDA tensors of one
    dtype.  Returns ``(Q_p, O, W or None, r2)``, ``r2`` real; does not
    synchronize."""
    dev = check_kernel_args("panel_step", c, z)
    _check_panel("panel_step", c, z)
    (l, b), n = c.shape, z.shape[1]
    o = torch.empty_like(z)
    w = torch.empty((b, n), dtype=z.dtype, device=dev) if emit_w else None
    r2 = torch.empty((n,), dtype=_real_dtype(c), device=dev)
    lib = load_library()
    code = dtype_code(c.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        qp = _factor(lib, code, c, stream)
        if n:
            rc = lib.repro_panel_sweep(code, qp.data_ptr(), z.data_ptr(),
                                       o.data_ptr(),
                                       w.data_ptr() if emit_w else None,
                                       r2.data_ptr(), l, b, n, stream)
            check_status("panel_step (sweep)", rc)
    LAUNCHES.add()
    return qp, o, w, r2


def panel_coeff_kernel(c: torch.Tensor, z: torch.Tensor, r2: torch.Tensor):
    """Launch the factor and the coefficient sweep: ``c`` (l, b), ``z``
    (l, n) contiguous CUDA tensors of one dtype, ``r2`` (n,) contiguous in
    its real dtype.  Returns ``(Q_p, W, max(r2 - colnorms^2(W), 0))``;
    does not synchronize."""
    dev = check_kernel_args("panel_coeff", c, z)
    _check_panel("panel_coeff", c, z)
    (l, b), n = c.shape, z.shape[1]
    rdtype = _real_dtype(c)
    if (r2.device != dev or r2.dtype != rdtype or tuple(r2.shape) != (n,)
            or not r2.is_contiguous()):
        raise ValueError(f"panel_coeff: r2 must be a contiguous ({n},) "
                         f"{rdtype} tensor on {dev}, got "
                         f"{tuple(r2.shape)} {r2.dtype} on {r2.device}")
    w = torch.empty((b, n), dtype=z.dtype, device=dev)
    r2_out = torch.empty((n,), dtype=rdtype, device=dev)
    lib = load_library()
    code = dtype_code(c.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        qp = _factor(lib, code, c, stream)
        if n:
            rc = lib.repro_panel_coeff_sweep(code, qp.data_ptr(), z.data_ptr(),
                                             r2.data_ptr(), w.data_ptr(),
                                             r2_out.data_ptr(), l, b, n,
                                             stream)
            check_status("panel_coeff (sweep)", rc)
    COEFF_LAUNCHES.add()
    return qp, w, r2_out


def panel_apply_kernel(qp: torch.Tensor, w: torch.Tensor, z: torch.Tensor,
                       *, emit_norms: bool = False):
    """Launch the deflation sweep: ``qp`` (l, b), ``w`` (b, n), ``z``
    (l, n), contiguous CUDA tensors of one dtype.  Returns ``O = Z - Q_p W``,
    or ``(O, colnorms^2(O))`` with ``emit_norms``; does not synchronize."""
    dev = check_kernel_args("panel_apply", qp, w, z)
    _check_panel("panel_apply", qp, z)
    (l, b), n = qp.shape, z.shape[1]
    if tuple(w.shape) != (b, n):
        raise ValueError(f"panel_apply: w {tuple(w.shape)} must be {(b, n)}")
    o = torch.empty_like(z)
    r2 = (torch.empty((n,), dtype=_real_dtype(z), device=dev)
          if emit_norms else None)
    if n:
        lib = load_library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.repro_panel_apply(dtype_code(z.dtype), qp.data_ptr(),
                                       w.data_ptr(), z.data_ptr(),
                                       o.data_ptr(),
                                       r2.data_ptr() if emit_norms else None,
                                       l, b, n, stream)
        check_status("panel_apply", rc)
        APPLY_LAUNCHES.add()
        if emit_norms:
            APPLY_NORMS_LAUNCHES.add()
    return (o, r2) if emit_norms else o
