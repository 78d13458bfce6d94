"""Wrapper of the Hopper flash-attention kernel (``csrc/flash.cu``), which
replaces the TPU kernel ``flash_kernel`` in ``repro/kernels/flash/kernel.py``.

One launch, one CTA per (batch * head, 64-row q block), walking the kv
blocks of 64 rows in order with an online softmax; kv blocks wholly in the
causal future or outside the window are skipped before they are loaded.
q is f32 or bf16, k and v one of the two (the model passes f32 q and bf16
k, v); sums are f32 FFMA.  S and T are masked in the kernel, not padded.
"""
from __future__ import annotations

from typing import Optional

import torch

from .._build import check_status, load_library
from ..common import Launch, LaunchCounter, cdiv, type_name

__all__ = ["flash_attention_kernel", "flash_launch", "LAUNCHES",
           "FLASH_DTYPES", "MAX_HD"]

LAUNCHES = LaunchCounter("flash")
# Element-type codes of csrc/flash.cu (enum FlashDType), in this order.
FLASH_DTYPES = (torch.float32, torch.bfloat16)
MAX_HD = 256
# Tile of csrc/flash.cu: 64 q rows per CTA, kv blocks of 64 rows, 256
# threads.
BQ, BK, THREADS = 64, 64, 256


def flash_launch(q_dtype: torch.dtype, kv_dtype: torch.dtype, bh: int,
                 s: int, t: int, hd: int, causal: bool = True,
                 window: Optional[int] = None) -> Launch:
    """The launch for ``q`` (bh, s, hd), ``k`` and ``v`` (bh, t, hd): one
    CTA per (bh, 64-row q block); the q tile, a k and a v tile (rows of
    hd + 1 floats) and the 64 x 65 p tile in shared memory."""
    nj = 4 if hd <= 64 else 8 if hd <= 128 else 16
    smem = 4 * ((BQ + 2 * BK) * (hd + 1) + BQ * (BK + 1))
    return Launch(f"flash_fwd_kernel<{type_name(q_dtype)},"
                  f"{type_name(kv_dtype)},{nj}>", (cdiv(s, BQ), bh, 1),
                  (THREADS, 1, 1), smem, "repro_flash_attention",
                  (FLASH_DTYPES.index(q_dtype), FLASH_DTYPES.index(kv_dtype),
                   None, None, None, None, bh, s, t, hd, int(causal),
                   -1 if window is None else int(window), None))


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    ts = (q, k, v)
    if any(t.device.type != "cuda" or t.device != q.device for t in ts):
        raise ValueError(f"flash: q, k, v must be on one CUDA device, got "
                         f"{[str(t.device) for t in ts]}")
    if q.dtype not in FLASH_DTYPES or k.dtype not in FLASH_DTYPES \
            or v.dtype != k.dtype:
        raise TypeError(f"flash: dtypes q {q.dtype}, k {k.dtype}, v "
                        f"{v.dtype}; need q and k = v each one of "
                        f"{FLASH_DTYPES}")
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3 \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; need q "
                         f"(BH, S, hd) and k = v (BH, T, hd)")
    hd = q.shape[2]
    if hd % 8 or not 8 <= hd <= MAX_HD:
        raise ValueError(f"flash: head dim hd={hd}; need a multiple of 8 "
                         f"in [8, {MAX_HD}]")
    if not 1 <= q.shape[0] <= 65535:
        raise ValueError(f"flash: BH={q.shape[0]}; need 1 <= BH <= 65535")
    for name, t in zip("qkv", ts):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash: {name} must be contiguous and 16-byte "
                             f"aligned, got shape {tuple(t.shape)}, strides "
                             f"{t.stride()}, data_ptr % 16 = "
                             f"{t.data_ptr() % 16}")


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: Optional[int] = None) -> torch.Tensor:
    """Launch the kernel: ``q`` (BH, S, hd) already scaled, ``k`` and ``v``
    (BH, T, hd), contiguous CUDA tensors.  Returns (BH, S, hd) in q's
    dtype; does not synchronize."""
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"flash: window={window}; need None or >= 1")
    o = torch.empty_like(q)
    bh, s, hd = q.shape
    t = k.shape[1]
    if s == 0 or t == 0:
        return o.zero_()
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.repro_flash_attention(
            FLASH_DTYPES.index(q.dtype), FLASH_DTYPES.index(k.dtype),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, s, t,
            hd, int(causal), -1 if window is None else int(window), stream)
    check_status("flash", rc)
    LAUNCHES.add()
    return o
