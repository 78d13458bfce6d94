"""Wrappers of the Hopper panel kernels (``csrc/panel_step.cu``,
``csrc/panel_apply.cu``, and ``csrc/panel_gram.cu``'s pass), which replace
three TPU kernels of ``repro/kernels/panel_step/kernel.py``:
``panel_step_kernel``, ``panel_coeff_kernel`` and ``panel_apply_kernel``.

The TPU kernels factor the panel on grid step 0 and keep ``Q_p`` in VMEM
for every later slab.  Hopper blocks share nothing, so the factor is a
launch of its own:

  (a) ``panel_factor`` -- one CTA: CholeskyQR2 of ``C`` with the clamped
      Cholesky of ``ref.chol_clamped``, both rounds on the panel resident
      in shared memory where it fits (``factor_launch``), ``Q_p`` to
      global memory;
  (b) ``panel_step``'s sweep -- one C entry, two launches: ``W = Q_p^H Z``
      by panel_gram's pass over ``Z`` (no Gram tile), then ``O = Z - Q_p
      W`` and ``colnorms^2(O)`` by panel_apply's kernel (``step_launches``;
      ``W`` returned only when ``emit_w``);
  (c) ``panel_coeff``'s sweep -- one launch of panel_gram's pass over
      ``Z`` (no Gram tile) that also writes the downdate ``max(r2 -
      colnorms^2(W), 0)`` from each CTA's unrounded ``W`` tile, no ``O``
      (stage A of the distributed panel; ``coeff_launches``).

``panel_step`` is (a) then (b); ``panel_coeff`` is (a) then (c).  All of
them sum in the parent's order, so they keep its bits.  ``panel_apply``
(stage B: ``O = Z - Q_p W`` with ``W`` given, and ``colnorms^2(O)`` with
``emit_norms``) is one launch of a kernel of its own (``apply_launch``):
slabs of 16, 32 or 64 16-byte vectors a row, chunks of ``Q_p`` and ``Z``
through a ring of cp.async stages, the sweep's arithmetic and sum order,
so its bits.  One call is one launch of the ported kernel in its launch
count (the factor and the sweep are counted once).
"""
from __future__ import annotations

import dataclasses

import torch

from .._build import check_status, load_library
from ..common import (SMEM_BUDGET_BYTES, Launch, LaunchCounter, cdiv,
                      check_kernel_args, dtype_code, round_up, type_name)
from ..panel_gram.kernel import panel_gram_launch

__all__ = ["MAX_PANEL", "panel_step_kernel", "panel_coeff_kernel",
           "panel_apply_kernel", "factor_launch", "factor_resident",
           "coeff_launches", "step_launches",
           "apply_geometry", "apply_threads", "apply_launch", "LAUNCHES",
           "COEFF_LAUNCHES", "APPLY_LAUNCHES", "APPLY_NORMS_LAUNCHES"]

# Widest panel the kernels take (csrc/panel_common.cuh, kMaxPanel; the
# kernel contract holds the two equal).
MAX_PANEL = 64
# The factor's CTA size (csrc/panel_step.cu).
FACTOR_THREADS = 512
# panel_apply (csrc/panel_apply.cu): the column norms in APPLY_NORM_GROUPS
# partials (rows = g mod 8), 32-row chunks through a ring of APPLY_STAGES
# stages, a wider slab only while it gives APPLY_MIN_CTAS CTAs and fits
# one block's shared memory.
APPLY_NORM_GROUPS, APPLY_ROWS, APPLY_STAGES, APPLY_MIN_CTAS = 8, 32, 3, 128

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


def _factor_smem(dtype: torch.dtype, l: int, b: int, resident: bool) -> int:
    item, ritem = _sizes(dtype)
    gp = b | 1                  # G's row pitch (odd: no bank conflicts)
    # the panel's: even (aligned column pairs), odd in c128
    xp = (b | 1) if item == 16 else round_up(b, 2) + 2
    return item * ((l * xp if resident else 0) + b * gp + b) + ritem * b


def factor_resident(dtype: torch.dtype, l: int, b: int) -> bool:
    """Whether the factor keeps the panel in shared memory (row pitch
    ``round_up(b, 2) + 2``, ``b | 1`` in c128) beside G, one column and the
    real pivots."""
    return _factor_smem(dtype, l, b, True) <= SMEM_BUDGET_BYTES


def factor_launch(dtype: torch.dtype, l: int, b: int) -> Launch:
    """The factor's launch for a panel ``c`` (l, b): one CTA; G (b x b),
    one column and the real pivots in shared memory, and the panel itself
    where it fits (``factor_resident``)."""
    res = factor_resident(dtype, l, b)
    return Launch(f"panel_factor_kernel<{type_name(dtype)},{str(res).lower()}>",
                  (1, 1, 1), (FACTOR_THREADS, 1, 1),
                  _factor_smem(dtype, l, b, res), "repro_panel_factor",
                  (dtype_code(dtype), None, None, l, b, None))


def _apply_smem(dtype: torch.dtype, cols: int, b: int) -> int:
    item, ritem = _sizes(dtype)
    vec = 16 // item
    bq = cdiv(b, vec) * vec
    return (item * (bq * cols + APPLY_STAGES * APPLY_ROWS * (bq + cols))
            + ritem * APPLY_NORM_GROUPS * cols)


def apply_geometry(dtype: torch.dtype, b: int, n: int) -> int:
    """Slab columns as the C side chooses them, one 16-byte vector a
    thread a row: the widest of 64 and 32 vectors that still gives
    ``APPLY_MIN_CTAS`` CTAs and fits one block's shared memory, else 16."""
    vec = 16 // _sizes(dtype)[0]
    for cols in (64 * vec, 32 * vec):
        if (cdiv(n, cols) >= APPLY_MIN_CTAS
                and _apply_smem(dtype, cols, b) <= SMEM_BUDGET_BYTES):
            return cols
    return 16 * vec


def apply_threads(dtype: torch.dtype, cols: int) -> int:
    """Threads of a CTA over ``cols`` slab columns: a thread a vector of a
    row, in 4 row groups at 64 vectors, else 8 (256, 256 and 128)."""
    vecs = cols // (16 // _sizes(dtype)[0])
    return vecs * (4 if vecs == 64 else 8)


def apply_launch(dtype: torch.dtype, l: int, b: int, n: int) -> Launch:
    """``panel_apply``'s launch for ``qp`` (l, b), ``w`` (b, n), ``z``
    (l, n): one CTA per column slab (``apply_geometry``); W's slab, the
    ring's chunks of ``Q_p`` and ``Z`` and the norm partials in shared
    memory; 16-byte copies (the C side takes the twin ``<..., false>``
    when a base is not 16-byte aligned or a row of ``qp`` or ``z`` is not
    whole 16 bytes; here the shapes decide the latter)."""
    cols = apply_geometry(dtype, b, n)
    item = _sizes(dtype)[0]
    vec = str((b * item) % 16 == 0 and (n * item) % 16 == 0).lower()
    return Launch(f"panel_apply_kernel<{type_name(dtype)},{cols},{vec}>",
                  (cdiv(n, cols), 1, 1), (apply_threads(dtype, cols), 1, 1),
                  _apply_smem(dtype, cols, b), "repro_panel_apply",
                  (dtype_code(dtype),) + (None,) * 5 + (l, b, n, None))


def coeff_launches(dtype: torch.dtype, l: int, b: int, n: int) -> tuple:
    """The launches of one ``panel_coeff`` call: the factor, then (n > 0)
    its sweep, panel_gram's kernel with ``c = Q_p`` (its Gram CTA idle) and
    the downdate in its epilogue, issued by ``repro_panel_coeff_sweep``."""
    fac = factor_launch(dtype, l, b)
    if not n:
        return (fac,)
    return (fac, dataclasses.replace(
        panel_gram_launch(dtype, l, b, n), entry="repro_panel_coeff_sweep",
        args=(dtype_code(dtype),) + (None,) * 5 + (l, b, n, None)))


def step_launches(dtype: torch.dtype, l: int, b: int, n: int) -> tuple:
    """The launches of one ``panel_step`` call: the factor, then (n > 0)
    its sweep's two, both issued by ``repro_panel_sweep``: panel_gram's
    kernel with ``c = Q_p`` (its Gram CTA idle) and panel_apply's."""
    fac = factor_launch(dtype, l, b)
    if not n:
        return (fac,)
    args = (dtype_code(dtype),) + (None,) * 5 + (l, b, n, None)
    return (fac,) + tuple(
        dataclasses.replace(ln, entry="repro_panel_sweep", args=args,
                            part=i, parts=2)
        for i, ln in enumerate((panel_gram_launch(dtype, l, b, n),
                                apply_launch(dtype, l, b, n))))


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
    synchronize.  ``W`` is formed either way (the sweep's second launch
    reads it)."""
    dev = check_kernel_args("panel_step", c, z)
    _check_panel("panel_step", c, z)
    (l, b), n = c.shape, z.shape[1]
    o = torch.empty_like(z)
    w = torch.empty((b, n), dtype=z.dtype, device=dev)
    r2 = torch.empty((n,), dtype=_real_dtype(c), device=dev)
    lib = load_library()
    code = dtype_code(c.dtype)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        qp = _factor(lib, code, c, stream)
        if n:
            rc = lib.repro_panel_sweep(code, qp.data_ptr(), z.data_ptr(),
                                       o.data_ptr(), w.data_ptr(),
                                       r2.data_ptr(), l, b, n, stream)
            check_status("panel_step (sweep)", rc)
    LAUNCHES.add()
    return qp, o, (w if emit_w else None), r2


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
    """Launch the deflation kernel (``apply_launch``): ``qp`` (l, b), ``w``
    (b, n), ``z`` (l, n), contiguous CUDA tensors of one dtype.  Returns
    ``O = Z - Q_p W``, or ``(O, colnorms^2(O))`` with ``emit_norms``; does
    not synchronize."""
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
