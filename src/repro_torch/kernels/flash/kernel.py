"""Wrapper of the Hopper flash-attention kernel (``csrc/flash.cu``), which
replaces the TPU kernel ``flash_kernel`` in ``repro/kernels/flash/kernel.py``.

One launch, one CTA of 4 warps per (batch * head, 64-row q block), walking
the live kv blocks (64 rows; 32 for hd > 128) in order with an online
softmax, k and v through a two-stage cp.async ring; kv blocks wholly in
the causal future or outside the window are skipped before they are
loaded.  q is f32 or bf16, k and v one of the two (the model passes f32 q
and bf16 k, v).  Both products run on the tensor cores in TF32 with f32
operands split into hi + lo (bf16 operands are exact in TF32), the small
terms first, sums in f32.  S and T are masked in the kernel, not padded.
With ``return_lse`` it also writes each row's logsumexp of the scaled
scores (f32), from which the training path's backward recomputes the
probabilities (``ops.FlashAttention``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .._build import check_status, load_library
from ..common import Launch, LaunchCounter, cdiv, type_name
from .ref import NEG_INF

__all__ = ["flash_attention_kernel", "flash_launch", "flash_smem", "LAUNCHES",
           "FLASH_DTYPES", "MAX_HD"]

LAUNCHES = LaunchCounter("flash")
# Element-type codes of csrc/flash.cu (enum FlashDType), in this order.
FLASH_DTYPES = (torch.float32, torch.bfloat16)
MAX_HD = 256
# Tile of csrc/flash.cu: 64 q rows per CTA (16 a warp), kv blocks of 64
# rows (BK_WIDE for hd > 128), 128 threads, a k/v ring of STAGES stages.
BQ, BK, BK_WIDE, THREADS, STAGES = 64, 64, 32, 128, 2


def _pitch_pairs(c: int) -> int:
    return c + (6 - c % 4) % 4


def _pitch_odd(c: int) -> int:
    return c | 1


def flash_smem(q_dtype: torch.dtype, kv_dtype: torch.dtype, hd: int) -> int:
    """Dynamic shared bytes: the q tile and the ring's k and v tiles, raw,
    each row padded to a pitch of 16-byte chunks that keeps the warps'
    fragment reads free of bank conflicts (2 mod 4 chunks for rows read as
    float2 pairs, f32 q and k; odd for the others)."""
    f32 = torch.float32
    qc, kvc = hd * q_dtype.itemsize // 16, hd * kv_dtype.itemsize // 16
    pq = _pitch_pairs(qc) if q_dtype == f32 else _pitch_odd(qc)
    pk = _pitch_pairs(kvc) if kv_dtype == f32 else _pitch_odd(kvc)
    pv = _pitch_odd(kvc)
    bk = BK_WIDE if hd > 128 else BK
    return 16 * (BQ * pq + STAGES * bk * (pk + pv))


def flash_launch(q_dtype: torch.dtype, kv_dtype: torch.dtype, bh: int,
                 s: int, t: int, hd: int, causal: bool = True,
                 window: Optional[int] = None) -> Launch:
    """The launch for ``q`` (bh, s, hd), ``k`` and ``v`` (bh, t, hd): one
    CTA per (bh, 64-row q block), the kernel instantiated for hd <= 64,
    128 or 256 (``flash_smem`` for its shared bytes)."""
    hd_class = 64 if hd <= 64 else 128 if hd <= 128 else 256
    return Launch(f"flash_fwd_kernel<{type_name(q_dtype)},"
                  f"{type_name(kv_dtype)},{hd_class}>", (cdiv(s, BQ), bh, 1),
                  (THREADS, 1, 1), flash_smem(q_dtype, kv_dtype, hd),
                  "repro_flash_attention",
                  (FLASH_DTYPES.index(q_dtype), FLASH_DTYPES.index(kv_dtype),
                   None, None, None, None, None, bh, s, t, hd, int(causal),
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
                           window: Optional[int] = None,
                           return_lse: bool = False):
    """Launch the kernel: ``q`` (BH, S, hd) already scaled, ``k`` and ``v``
    (BH, T, hd), contiguous CUDA tensors.  Returns (BH, S, hd) in q's
    dtype, and with ``return_lse`` also the rows' logsumexp (BH, S) in f32;
    does not synchronize."""
    _check(q, k, v)
    if window is not None and window < 1:
        raise ValueError(f"flash: window={window}; need None or >= 1")
    o = torch.empty_like(q)
    bh, s, hd = q.shape
    t = k.shape[1]
    lse = (torch.empty((bh, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if s == 0 or t == 0:
        o.zero_()
        if lse is not None:
            lse.fill_(NEG_INF)
        return (o, lse) if return_lse else o
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.repro_flash_attention(
            FLASH_DTYPES.index(q.dtype), FLASH_DTYPES.index(k.dtype),
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lse is None else lse.data_ptr(), bh, s, t, hd,
            int(causal), -1 if window is None else int(window), stream)
    check_status("flash", rc)
    LAUNCHES.add()
    return (o, lse) if return_lse else o
