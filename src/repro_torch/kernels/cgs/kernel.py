"""Wrappers of the Hopper kernels for the classical Gram-Schmidt block
deflation, which replace the two TPU kernels of
``repro/kernels/cgs/kernel.py``:

  project_out_kernel   ``Z - Q (Q^H Z)`` for a basis ``Q`` (l x k) of any
                       width (``csrc/cgs.cu``): two launches of one C
                       call, ``W = Q^H Z`` into a (k, n) workspace
                       allocated here, then ``O = Z - Q W``; each a grid
                       of output tiles with the row blocks fastest, f64 on
                       the FP64 tensor cores (``csrc/dmma_tile.cuh``), the
                       other types on the register tile;
  panel_deflate_kernel ``(Z - Q_p W, W = Q_p^H Z)`` for one panel ``Q_p``
                       (l x b, ``b <= MAX_PANEL``, ``csrc/panel_deflate.cu``):
                       one CTA per column slab of ``Z``, the slab resident
                       in shared memory so that ``Z`` is read once, ``W``
                       formed over ``l`` in order, then ``O`` from the
                       slab; f64 on the FP64 tensor cores, the other types
                       on a register tile.  A slab that does not fit takes
                       the re-reading geometry (``Z`` streamed in both
                       passes); ``panel_deflate_launch`` says which.

Each has its own launch count, one per call.
"""
from __future__ import annotations

import torch

from .._build import check_status, load_library
# The DMMA tile's constants are attributes here so that the contract can
# pin them to csrc/dmma_tile.cuh.
from ..common import (DMMA_BK, DMMA_BM, DMMA_BN, DMMA_THREADS,  # noqa: F401
                      GEMM_THREADS, SMEM_BUDGET_BYTES, Launch, LaunchCounter,
                      cdiv, check_kernel_args, dmma_smem_bytes, dtype_code,
                      product_tile, raster_grid, round_up, type_name)
from ..panel_step.kernel import MAX_PANEL

__all__ = ["project_out_kernel", "panel_deflate_kernel", "project_out_launch",
           "panel_deflate_launch", "deflate_geometry", "PROJECT_STAGES",
           "DEFLATE_COLS", "DEFLATE_THREADS", "DEFLATE_ROWS",
           "DEFLATE_STAGES", "DEFLATE_DMMA_STAGES", "LAUNCHES",
           "DEFLATE_LAUNCHES"]

LAUNCHES = LaunchCounter("project_out")
DEFLATE_LAUNCHES = LaunchCounter("panel_deflate")

# Stages of the f64 kernels' cp.async ring (kProjectStages in csrc/cgs.cu).
PROJECT_STAGES = 4
# csrc/panel_deflate.cu: 8 warps a CTA, ring stages of 32 rows, 2 of them
# (f64: 3, in pass 1 only), the preferred slab width (c128: 16), the panel
# padded to a multiple of 16 columns.
DEFLATE_THREADS, DEFLATE_ROWS = 256, 32
DEFLATE_STAGES, DEFLATE_DMMA_STAGES, DEFLATE_COLS = 2, 3, 32


def project_out_launch(dtype: torch.dtype, l: int, k: int, n: int) -> tuple:
    """The launches of one call for ``q`` (l, k), ``z`` (l, n), in order:
    ``W = Q^H Z`` over a (k, n) grid of tiles (when ``k > 0``), then
    ``O = Z - Q W`` over an (l, n) grid (when ``l > 0``).  f64: the DMMA
    kernels with their ring in dynamic shared memory, 16-byte copies (the
    C side takes their twins ``<false>``, of the same geometry, when ``q``,
    ``z`` or the workspace is not 16-byte aligned or has an odd pitch); the
    other types: the register tile, static shared memory only."""
    tile = product_tile(dtype)
    if dtype == torch.float64:
        names = ("project_w_dmma_kernel<true>", "project_o_dmma_kernel<true>")
        threads, smem = (DMMA_THREADS, 1, 1), dmma_smem_bytes(PROJECT_STAGES)
    else:
        names = (f"project_w_kernel<{type_name(dtype)}>",
                 f"project_o_kernel<{type_name(dtype)}>")
        threads, smem = GEMM_THREADS, 0
    passes = [(name, raster_grid(rows, n, tile))
              for name, rows in zip(names, (k, l)) if rows > 0]
    args = (dtype_code(dtype), None, None, None, None, l, k, n, None)
    return tuple(Launch(name, grid, threads, smem, "repro_project_out", args,
                        part=i, parts=len(passes))
                 for i, (name, grid) in enumerate(passes))


def _deflate_max_cols(dtype: torch.dtype) -> int:
    return 16 if dtype == torch.complex128 else 32


def _deflate_smem(dtype: torch.dtype, nc: int, resident: bool, l: int,
                  b: int) -> int:
    """Dynamic shared bytes: the resident slab, W, the ring of stages of
    the panel's rows (and of the slab's when not resident); f64 keeps W in
    the ring's place."""
    item = torch.empty((), dtype=dtype, device="meta").element_size()
    f64 = dtype == torch.float64
    stages = DEFLATE_DMMA_STAGES if f64 else DEFLATE_STAGES
    bp = round_up(b, 16)
    slab = round_up(l, DEFLATE_ROWS) * nc if resident else 0
    ring = stages * DEFLATE_ROWS * (bp + (0 if resident else nc))
    return item * (slab + (max(ring, bp * nc) if f64 else ring + bp * nc))


def deflate_geometry(dtype: torch.dtype, l: int, b: int) -> tuple:
    """``(slab columns, resident)`` as the C side chooses them:
    ``DEFLATE_COLS`` (c128 16) resident when its slab fits one block's
    shared memory, then 16 resident, then ``DEFLATE_COLS`` re-reading."""
    nc = min(DEFLATE_COLS, _deflate_max_cols(dtype))
    resident = _deflate_smem(dtype, nc, True, l, b) <= SMEM_BUDGET_BYTES
    if (not resident and nc == 32
            and _deflate_smem(dtype, 16, True, l, b) <= SMEM_BUDGET_BYTES):
        nc, resident = 16, True
    return nc, resident


def panel_deflate_launch(dtype: torch.dtype, l: int, b: int,
                         n: int) -> Launch:
    """The launch for ``q`` (l, b), ``z`` (l, n): one CTA per column slab
    (``deflate_geometry``), with 16-byte copies (the C side takes the twin
    ``<..., false>`` of the same geometry when ``q``, ``z`` or ``o`` is not
    16-byte aligned or a row of ``q`` or ``z`` is not whole 16 bytes; here
    the shapes decide the latter)."""
    nc, resident = deflate_geometry(dtype, l, b)
    item = torch.empty((), dtype=dtype, device="meta").element_size()
    vec = (b * item) % 16 == 0 and (n * item) % 16 == 0
    flags = ",".join(str(f).lower() for f in (resident, vec))
    return Launch(f"panel_deflate_kernel<{type_name(dtype)},{nc},{flags}>",
                  (cdiv(n, nc), 1, 1), (DEFLATE_THREADS, 1, 1),
                  _deflate_smem(dtype, nc, resident, l, b),
                  "repro_panel_deflate",
                  (dtype_code(dtype),) + (None,) * 4 + (l, b, n, None))


def _check_rows(name: str, q: torch.Tensor, z: torch.Tensor) -> None:
    if q.shape[0] != z.shape[0]:
        raise ValueError(f"{name}: q {tuple(q.shape)} and z "
                         f"{tuple(z.shape)} disagree on rows")


def project_out_kernel(q: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Launch the kernels (``project_out_launch``): ``q`` (l, k) and ``z``
    (l, n), contiguous CUDA tensors of one dtype in ``KERNEL_DTYPES``.
    Returns a new (l, n) tensor; does not synchronize."""
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
    """Launch the kernel (``panel_deflate_launch``): ``q`` (l, b) with
    ``1 <= b <= MAX_PANEL`` and ``z`` (l, n), contiguous CUDA tensors of
    one dtype.  Returns ``(O, W)``; does not synchronize."""
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
                                     z.data_ptr(), o.data_ptr(), w.data_ptr(),
                                     l, b, n, stream)
    check_status("panel_deflate", rc)
    DEFLATE_LAUNCHES.add()
    return o, w
