"""Wrapper of the Hopper kernel for the panel Gram pass
(``csrc/panel_gram.cu``), which replaces the TPU kernel
``panel_gram_kernel`` in ``repro/kernels/panel_gram/kernel.py``.

One launch computes ``C^H [C | Z]``: CTA 0 the Gram ``G = C^H C`` (b x b),
CTA ``1 + s`` the slab ``s`` of ``V = C^H Z`` (``gram_cols(dtype)``
columns), all on one loop that walks ``l`` in order through a ring of
cp.async stages, so each output element is one in-order sum over ``l``.
A CTA's warps split its tile into row groups of ``GRAM_WARP_ROWS`` panel
columns and up to ``GRAM_WARPS`` warps' worth of column groups
(``gram_warps``).
"""
from __future__ import annotations

import torch

from .._build import check_status, load_library
from ..common import (Launch, LaunchCounter, cdiv, check_kernel_args,
                      dtype_code, round_up, type_name)

__all__ = ["GRAM_COLS", "GRAM_ROWS", "GRAM_STAGES", "GRAM_WARP_ROWS",
           "GRAM_WARPS", "MAX_PANEL", "gram_cols", "gram_warps",
           "panel_gram_kernel", "panel_gram_launch", "LAUNCHES"]

# The geometry of csrc/panel_gram.cu (the contract pins each to its C
# name): rows of l a stage (kGramRows), stages of the cp.async ring
# (kGramStages), output rows a warp owns (kGramWarpRows), operand columns
# a CTA (kGramCols; complex128 takes half, for its registers), the most
# warps a CTA (kGramWarps), and the widest panel (kMaxPanel of
# panel_common.cuh).
GRAM_ROWS = 32
GRAM_STAGES = 3
GRAM_WARP_ROWS = 8
GRAM_COLS = 128
GRAM_WARPS = 8
MAX_PANEL = 64

LAUNCHES = LaunchCounter("panel_gram")


def gram_cols(dtype: torch.dtype) -> int:
    """Columns of the right operand one CTA owns."""
    return GRAM_COLS // 2 if dtype == torch.complex128 else GRAM_COLS


def gram_warps(dtype: torch.dtype, b: int) -> tuple:
    """``(gp, gc, tj)``: the row groups (``ceil(b / GRAM_WARP_ROWS)``), the
    column groups (``min(GRAM_WARPS // gp, NC / 32)``) and the columns a
    lane owns (``NC / 32 / gc``) of one CTA; it has ``gp * gc`` warps."""
    gp = cdiv(b, GRAM_WARP_ROWS)
    lanes = gram_cols(dtype) // 32
    gc = min(GRAM_WARPS // gp, lanes)
    return gp, gc, lanes // gc


def panel_gram_launch(dtype: torch.dtype, l: int, b: int, n: int) -> Launch:
    """The launch for ``c`` (l, b), ``z`` (l, n): ``1 + ceil(n / NC)``
    CTAs of ``gp * gc`` warps (``gram_warps``), each staging
    ``GRAM_STAGES`` chunks of ``GRAM_ROWS`` rows of ``c`` (padded to a
    multiple of ``GRAM_WARP_ROWS`` columns) and of its ``NC``-column
    operand.  The kernel named is the 16-byte-copy one; the C side takes
    its twin ``<..., false, tj>``, of the same geometry, when a base is not
    16-byte aligned or a pitch not a multiple of 16 bytes."""
    itemsize = torch.empty((), dtype=dtype, device="meta").element_size()
    bp, nc = round_up(b, GRAM_WARP_ROWS), gram_cols(dtype)
    gp, gc, tj = gram_warps(dtype, b)
    return Launch(f"panel_gram_kernel<{type_name(dtype)},true,{tj}>",
                  (1 + cdiv(n, nc), 1, 1), (32 * gp * gc, 1, 1),
                  itemsize * GRAM_STAGES * GRAM_ROWS * (bp + nc),
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
