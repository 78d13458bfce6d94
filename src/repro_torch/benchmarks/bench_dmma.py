"""The FP64 tensor-core tile of ``csrc/dmma_tile.cuh``, the kernels on it,
the panel Gram, the panel deflation and application, the triangular solve
and flash attention, on the card.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_dmma \
        [--parts probe kernels shapes gram deflate coeff split apply tsolve
                 flash fwht rid] \
        [--json PATH] [--against PATH]

Prints one JSON line per measurement (and appends them to ``--json``):

  probe    -- ``frag``: each ``mma.sync`` f64 shape (m8n8k4, m16n8k4,
              m16n8k8, m16n8k16) on one warp against a known product, its
              operands loaded by the fragment maps of the tile; ``rate``:
              each shape's rate on registers alone, 132 and 264 CTAs of 8
              warps, 16 independent tiles a warp;
  kernels  -- ``sketch_accum`` and ``sketch_matmul`` (l=800, m=2^16,
              n=2^14) and ``project_out`` (l=800, k=400, n=2^14) through
              their wrappers in f32, f64, c64 and c128, beside
              ``torch.addmm``, ``torch.matmul`` and the ``q.mH @ z`` /
              ``addmm`` pair on the same inputs;
  shapes   -- the f64 kernels at other l (sketch_accum, sketch_matmul at
              768 / 800 / 1024) and k (project_out): how the time follows
              the number of 128-row tiles;
  gram     -- ``panel_gram`` (l=800, b=16 / 32 / 64, n=2^14) in the four
              dtypes, and the Gram alone (n=0), beside
              ``c.mH @ cat([c, z], 1)``, with a SHA-256 digest of G and V;
              then the gram oracle's pivoted QR (f64, k=400 of an 800 x
              2^14 sketch, one-rank group), warm host seconds;
  deflate  -- ``panel_deflate`` in f64 and f32 at the main shape (l=800,
              b=32, n=2^14) and the split sweep's (l=256, b=16 / 32 / 64,
              n=4096), beside the ``q.mH @ z`` / ``addmm`` pair, with
              digests of O and W; then ``panel_step``,
              ``panel_coeff`` and ``panel_apply`` at l=800, n=2^14 and
              b = 16 / 32 / 64 in the four dtypes, with digests of their
              outputs, and panel_step's factor and sweep launches timed
              apart through their C entry points (``sweep`` rows);
  coeff    -- ``panel_coeff`` at l=800, n=2^14 and b = 1 / 17 / 32 / 33
              / 64, at a ragged l and n (777, 17, 1001) and in the factor's
              re-reading geometry (l=4000, b=32), in the four dtypes, with
              NaN and negative entries in r2: the call's ms and its sweep's
              alone (through its C entry), the sweep's byte bound and
              share, and digests of Q_p, W and r2;
  split    -- ``bench_qr``'s fused-vs-split panel loop (l=256, n=4096,
              k=128, f32) at b = 16 / 32 / 64: each path's host seconds
              (``time_fn``, ``SPLIT_ROUNDS`` rounds, the paths alternating)
              and one traced call of each (``torch.profiler``): device busy
              ms, idle share, the kernels by device time;
  apply    -- ``panel_apply`` with ``emit_norms`` (and without: ``ms``) at
              the distributed main shape (l=800, b=32, n=2^14), a 4-rank
              shard (n=4096) and the split sweep's shapes (l=256, b=16 /
              32 / 64, n=4096) in the four dtypes, beside
              ``torch.addmm(z, qp, w, alpha=-1)``, with GB/s, the byte
              bound and digests of O and colnorms^2(O);
  tsolve   -- ``tsolve`` (n=2^14, k=100 / 400 / 1000) in the four dtypes
              on the R of a QR, beside ``torch.linalg.solve_triangular``:
              TFLOP/s, the bound and the error against ``tsolve_ref``;
  flash    -- ``flash_attention_kernel`` at granite-3-2b's prefill (32
              heads, hd 64, S=T=4000, causal) and h2o-danube-1.8b's (32
              heads, hd 80, S=T=6144, window 4096), f32 q and bf16 k/v as
              the model passes them, beside
              ``F.scaled_dot_product_attention`` in f32 on the same inputs;
  fwht     -- ``fwht`` at m=2^16, n=2^14 in f32, f64 and c64, c128 at
              n=2^12 (as the smoke), f64 at m=2^18, n=2^12: ms, launches,
              the bytes its sweeps move a second, the one-pass byte bound
              and its share, and a digest of the output;
  rid      -- the main row's ``rid(0, A, 400, sketch_kind="gaussian")``
              (f64, m=2^16, n=2^14, A from seed 1000), then the same
              matrix through ``rid_distributed(...,
              qr_impl="panel_parallel")`` on a one-rank group: the warm
              median host seconds and digests of J and P.

``--against PATH`` compares the ``gram``, ``sweep``, ``coeff``, ``apply``,
``fwht`` and ``rid`` rows' digests with those of an earlier run's ``--json`` file
(same inputs: each dtype draws from its own seed) and exits 1 unless every
such row is bit-equal.

Needs a card (and nvcc).  All parts but ``probe`` use only the wrappers'
public signatures, so the same file times an older checkout's kernels
when copied into its ``repro_torch/benchmarks/``.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import sys
import time
from pathlib import Path

import torch

from .common import append_json_rows, randn, time_fn

__all__ = ["PARTS", "run", "parity", "deflate_work", "apply_work",
           "coeff_work", "fwht_work",
           "tsolve_work", "flash_work", "live_pairs", "device_summary"]

PARTS = ("probe", "kernels", "shapes", "gram", "deflate", "coeff", "split",
         "apply", "tsolve", "flash", "fwht", "rid")
DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128)
L, M, N, K = 800, 2 ** 16, 2 ** 14, 400
GRAM_BS = (16, 32, 64)
# panel_deflate: (l, b, n) of Table 3's main row and of the split sweep.
DEFLATE_SHAPES = ((L, 32, N), (256, 16, 4096), (256, 32, 4096),
                  (256, 64, 4096))
SPLIT_ROUNDS = 5
# panel_apply: (l, b, n) of the distributed main row, a 4-rank shard of it
# and the split sweep's.
APPLY_SHAPES = ((L, 32, N), (L, 32, 4096), (256, 16, 4096), (256, 32, 4096),
                (256, 64, 4096))
# panel_coeff: (l, b, n) of the distributed main row at five panel widths,
# a ragged shape and the factor's re-reading geometry.
COEFF_SHAPES = ((L, 32, N), (L, 1, N), (L, 17, N), (L, 33, N), (L, 64, N),
                (777, 17, 1001), (4000, 32, N))
TSOLVE_KS = (100, K, 1000)
SWEEP_BS = (16, 32, 64)
# fwht: (dtype, m, n); c128 at a quarter of n, as the smoke runs it.
FWHT_SHAPES = ((torch.float32, M, N), (torch.float64, M, N),
               (torch.complex64, M, N), (torch.complex128, M, N // 4),
               (torch.float64, 4 * M, N // 4))
# flash: (case, B*H, S=T, hd, window) of the two models' long prefills.
FLASH_SHAPES = (("granite-3-2b prefill", 32, 4000, 64, None),
                ("h2o-danube-1.8b prefill", 32, 6144, 80, 4096))
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, f32 FFMA, TF32
# tensor-core and FP64 tensor-core FLOP/s.
HBM_BYTES_PER_S, PEAK_F32, PEAK_TF32, PEAK_F64 = 3.35e12, 67e12, 495e12, 67e12

_PROBE = Path(__file__).resolve().with_name("dmma_probe.cu")


def _cuda_ms(fn, reps: int, rounds: int = 2) -> float:
    """Least mean ms a call over ``rounds`` rounds of ``reps`` calls, after
    one warm-up call; CUDA events."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        best = min(best, e0.elapsed_time(e1) / reps)
    return best


def _shape_name(shape: int) -> str:
    return "m8n8k4" if shape == 0 else f"m16n8k{shape}"


def _probe(dev, gen, out: list) -> None:
    from ..kernels import _build
    lib = _build.load_extra("dmmaprobe", [_PROBE], {"repro_dmma_probe": [
        ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
        + [ctypes.c_void_p]})
    stream = torch.cuda.current_stream(dev).cuda_stream
    f64 = torch.float64
    for shape in (0, 4, 8, 16):
        rows, depth = (8, 4) if shape == 0 else (16, shape)
        a, b, c = (randn(gen, s, f64, dev)
                   for s in ((rows, depth), (depth, 8), (rows, 8)))
        d = torch.full((rows, 8), float("nan"), dtype=f64, device=dev)
        rc = lib.repro_dmma_probe(shape, a.data_ptr(), b.data_ptr(),
                                  c.data_ptr(), d.data_ptr(), None, 0, 0,
                                  stream)
        _build.check_status("dmma_probe", rc, lib)
        torch.cuda.synchronize()
        out.append({"what": "frag", "shape": _shape_name(shape),
                    "max_abs_err": float((d - (c + a @ b)).abs().max())})
    sink = torch.empty(264 * 256, dtype=f64, device=dev)
    iters = 2000
    for shape in (0, 4, 8, 16):
        for blocks in (132, 264):
            ms = _cuda_ms(lambda: _build.check_status(
                "dmma_probe", lib.repro_dmma_probe(
                    shape, None, None, None, None, sink.data_ptr(), blocks,
                    iters, stream), lib), 1, 1)
            rows, depth = (8, 4) if shape == 0 else (16, shape)
            flops = 2.0 * rows * 8 * depth * 16 * iters * 8 * blocks
            out.append({"what": "rate", "shape": _shape_name(shape),
                        "ctas": blocks, "ms": ms,
                        "tflops": flops / ms / 1e9})


def _rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _real_flops(dtype, madds: float) -> float:
    """Real operations of ``madds`` multiply-adds in ``dtype``."""
    return (8.0 if dtype.is_complex else 2.0) * madds


def _sketch_rows(kernel, dev, gen, dtypes, rows_list, out: list) -> None:
    """``kernel`` ("sketch_accum" or "sketch_matmul") at each l in
    ``rows_list``, beside ``torch.addmm`` or ``torch.matmul`` at l = L."""
    from ..kernels.sketch_accum import sketch_accum
    from ..kernels.sketch_matmul import sketch_matmul
    for dtype in dtypes:
        x = randn(gen, (max(rows_list), M), dtype, dev)
        a = randn(gen, (M, N), dtype, dev)
        for rows in rows_list:
            xr = x[:rows]
            if kernel == "sketch_accum":
                acc = randn(gen, (rows, N), dtype, dev)

                def call():
                    return sketch_accum(xr, a, acc)

                def library():
                    return torch.addmm(acc, xr, a)
            else:
                def call():
                    return sketch_matmul(xr, a)

                def library():
                    return torch.matmul(xr, a)
            ms = _cuda_ms(call, 3)
            want = library()
            row = {"what": "kernel", "kernel": kernel,
                   "dtype": str(dtype).removeprefix("torch."), "l": rows,
                   "m": M, "n": N, "ms": ms,
                   "tflops": _real_flops(dtype, rows * M * N) / ms / 1e9,
                   "rel_err_vs_library": _rel_err(call(), want)}
            if rows == L:
                row["library_ms"] = _cuda_ms(library, 3)
            out.append(row)
            del want
        del x, a
        torch.cuda.empty_cache()


def _project_out_rows(dev, gen, dtypes, ks, out: list) -> None:
    from ..kernels import project_out
    for dtype in dtypes:
        z = randn(gen, (L, N), dtype, dev)
        q_all = torch.linalg.qr(randn(gen, (L, max(ks)), dtype, dev)).Q
        for k in ks:
            q = q_all[:, :k].contiguous()

            def pair():
                return torch.addmm(z, q, q.mH @ z, alpha=-1)

            ms = _cuda_ms(lambda: project_out(q, z), 20)
            row = {"what": "kernel", "kernel": "project_out",
                   "dtype": str(dtype).removeprefix("torch."), "l": L,
                   "k": k, "n": N, "ms": ms,
                   "tflops": _real_flops(dtype, 2.0 * L * k * N) / ms / 1e9,
                   "rel_err_vs_library": _rel_err(project_out(q, z), pair())}
            if k == K:
                row["library_ms"] = _cuda_ms(pair, 20)
            out.append(row)
        del z, q_all
        torch.cuda.empty_cache()


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()
                          ).hexdigest()


def _gram_rows(dev, out: list) -> None:
    """``panel_gram`` at (L, b, N) for b in ``GRAM_BS`` and at n = 0 (the
    Gram alone), beside ``c.mH @ cat([c, z], 1)``; each dtype draws its
    inputs from its own seed, so two runs of this part see the same data."""
    from ..kernels.panel_gram import panel_gram
    for i, dtype in enumerate(DTYPES):
        gen = torch.Generator(device=dev)
        gen.manual_seed(100 + i)
        z = randn(gen, (L, N), dtype, dev)
        for b in GRAM_BS:
            c = randn(gen, (L, b), dtype, dev)
            for n in (N, 0):
                zn = z[:, :n]

                def call():
                    return panel_gram(c, zn)

                def library():
                    return c.mH @ torch.cat([c, zn], 1)

                g, v = call()
                item = c.element_size()
                nbytes = item * (L * b + L * n + b * b + b * n)
                ms = _cuda_ms(call, 20)
                out.append({
                    "what": "gram", "kernel": "panel_gram",
                    "dtype": str(dtype).removeprefix("torch."), "l": L,
                    "b": b, "n": n, "ms": ms, "library_ms": _cuda_ms(library, 20),
                    "gbs": nbytes / ms / 1e6,
                    "rel_err_vs_library": _rel_err(torch.cat([g, v], 1),
                                                   library()),
                    "g_sha256": _digest(g), "v_sha256": _digest(v)})
        del z
        torch.cuda.empty_cache()
    # The gram oracle's pivoted QR, which launches panel_gram once a
    # panel: host seconds (median of 5 after 2 warm-ups) on a one-rank group.
    from ..core import panel_parallel_pivoted_qr
    from .bench_error import one_rank_group
    gen = torch.Generator(device=dev)
    gen.manual_seed(200)
    y = randn(gen, (L, N), torch.float64, dev)
    with one_rank_group(dev) as g:
        s = time_fn(lambda: panel_parallel_pivoted_qr(y, K, group=g,
                                                      panel_impl="gram"))
    out.append({"what": "gram_qr", "call": "panel_parallel_pivoted_qr(Y, 400, "
                "group=g, panel_impl='gram')", "l": L, "n": N, "k": K,
                "dtype": "float64", "warm_median_s": s})


def deflate_work(dtype: torch.dtype, l: int, b: int, n: int) -> tuple:
    """(real flops, bytes) of one ``panel_deflate``: ``W = Q_p^H Z`` and
    ``O = Z - Q_p W`` (l b n multiply-adds each); ``Q_p`` and ``Z`` read
    once, ``O`` and ``W`` written once."""
    item = torch.empty((), dtype=dtype, device="meta").element_size()
    return (_real_flops(dtype, 2.0 * l * b * n),
            item * (l * b + 2 * l * n + b * n))


def apply_work(dtype: torch.dtype, l: int, b: int, n: int) -> tuple:
    """(real flops, bytes) of one ``panel_apply``: ``O = Z - Q_p W`` (l b n
    multiply-adds); ``Q_p``, ``W`` and ``Z`` read once, ``O`` written once
    (the norms' n reals not counted)."""
    item = torch.empty((), dtype=dtype, device="meta").element_size()
    return (_real_flops(dtype, 1.0 * l * b * n),
            item * (l * b + b * n + 2 * l * n))


def tsolve_work(dtype: torch.dtype, k: int, n: int) -> tuple:
    """(real flops, bytes) of one ``tsolve``: k (k + 1) / 2 n multiply-adds;
    ``R1``'s upper triangle and ``R2`` read once, ``T`` written once."""
    item = torch.empty((), dtype=dtype, device="meta").element_size()
    return (_real_flops(dtype, k * (k + 1) / 2 * n),
            item * (k * (k + 1) // 2 + 2 * k * n))


def live_pairs(s: int, t: int, causal: bool, window) -> int:
    """(q, k) pairs of one head that the mask keeps."""
    total = 0
    for i in range(s):
        hi = min(i, t - 1) if causal else t - 1
        lo = max(i - window + 1, 0) if window else 0
        total += max(hi - lo + 1, 0)
    return total


def flash_work(bh: int, s: int, t: int, hd: int, causal: bool, window,
               q_dtype: torch.dtype, kv_dtype: torch.dtype) -> tuple:
    """(live pairs, flops, bytes) of one flash call: 4 hd flops a live
    pair (q k^T and p v); q, k, v read once, o written once."""
    pairs = bh * live_pairs(s, t, causal, window)
    return (pairs, 4.0 * hd * pairs,
            bh * hd * (2 * s * q_dtype.itemsize + 2 * t * kv_dtype.itemsize))


def _deflate_rows(dev, out: list) -> None:
    """``panel_deflate`` at ``DEFLATE_SHAPES`` in f64 and f32 beside the
    library pair; then the panel sweep's three kernels (which ``--against``
    holds to an earlier run's digests) at the main shape."""
    from ..kernels.cgs.kernel import panel_deflate_kernel
    from ..kernels.panel_step import panel_apply, panel_coeff, panel_step
    from ..kernels.panel_step.ref import colnorms2
    for i, dtype in enumerate((torch.float64, torch.float32)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(300 + i)
        for l, b, n in DEFLATE_SHAPES:
            q = torch.linalg.qr(randn(gen, (l, b), dtype, dev)).Q.contiguous()
            z = randn(gen, (l, n), dtype, dev)

            def pair():
                return torch.addmm(z, q, q.mH @ z, alpha=-1)

            flops, nbytes = deflate_work(dtype, l, b, n)
            library_ms = _cuda_ms(pair, 20)
            o, w = panel_deflate_kernel(q, z)
            ms = _cuda_ms(lambda: panel_deflate_kernel(q, z), 20)
            out.append({
                "what": "deflate", "kernel": "panel_deflate",
                "dtype": str(dtype).removeprefix("torch."), "l": l, "b": b,
                "n": n, "ms": ms, "library_ms": library_ms,
                "gbs": nbytes / ms / 1e6,
                "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                "tflops": flops / ms / 1e9,
                "rel_err_vs_library": _rel_err(o, pair()),
                "o_sha256": _digest(o), "w_sha256": _digest(w)})
            del q, z
            torch.cuda.empty_cache()
    from ..kernels import _build
    from ..kernels.common import dtype_code
    lib = _build.load_library()
    for i, dtype in enumerate(DTYPES):
        gen = torch.Generator(device=dev)
        gen.manual_seed(400 + i)
        for b in SWEEP_BS:
            c = randn(gen, (L, b), dtype, dev)
            z = randn(gen, (L, N), dtype, dev)
            qp, o, w, r2 = panel_step(c, z)
            r2in = colnorms2(z)
            _, cw, cr2 = panel_coeff(c, z, r2in)
            ao, ar2 = panel_apply(qp, w, z, emit_norms=True)
            # panel_step's two launches apart, through their C entries.
            code, stream = dtype_code(dtype), torch.cuda.current_stream(
                dev).cuda_stream
            q2, o2, w2, r22 = (torch.empty_like(qp), torch.empty_like(o),
                               torch.empty_like(w), torch.empty_like(r2))

            def factor():
                _build.check_status("panel_factor", lib.repro_panel_factor(
                    code, c.data_ptr(), q2.data_ptr(), L, b, stream))

            def sweep():
                _build.check_status("panel_sweep", lib.repro_panel_sweep(
                    code, qp.data_ptr(), z.data_ptr(), o2.data_ptr(),
                    w2.data_ptr(), r22.data_ptr(), L, b, N, stream))
            factor_ms, sweep_ms = _cuda_ms(factor, 20), _cuda_ms(sweep, 20)
            torch.cuda.synchronize()
            apart = bool(torch.equal(q2, qp) and torch.equal(o2, o)
                         and torch.equal(w2, w) and torch.equal(r22, r2))
            for kernel, outs, call in (
                    ("panel_step", (qp, o, w, r2), lambda: panel_step(c, z)),
                    ("panel_coeff", (cw, cr2),
                     lambda: panel_coeff(c, z, r2in)),
                    ("panel_apply", (ao, ar2),
                     lambda: panel_apply(qp, w, z, emit_norms=True))):
                row = {"what": "sweep", "kernel": kernel,
                       "dtype": str(dtype).removeprefix("torch."), "l": L,
                       "b": b, "n": N, "ms": _cuda_ms(call, 20),
                       "outputs_sha256": [_digest(t) for t in outs]}
                if kernel == "panel_step":
                    row.update(factor_ms=factor_ms, sweep_ms=sweep_ms,
                               apart_same_bits=apart)
                out.append(row)
            del c, z, qp, o, w, r2, r2in, cw, cr2, ao, ar2, q2, o2, w2, r22
            torch.cuda.empty_cache()


def coeff_work(dtype: torch.dtype, l: int, b: int, n: int) -> tuple:
    """(flops, bytes) of ``panel_coeff``'s sweep: W = Q_p^H Z and the
    downdate; Q_p and Z read once, r2 in, W and r2 out."""
    t = torch.empty((), dtype=dtype, device="meta")
    item = t.element_size()
    ritem = t.real.element_size() if dtype.is_complex else item
    flops = _real_flops(dtype, float(l) * b * n)
    return flops, item * (l * b + l * n + b * n) + 2.0 * ritem * n


def _coeff_rows(dev, out: list) -> None:
    """``panel_coeff`` at ``COEFF_SHAPES`` in the four dtypes; each dtype
    draws from its own seed, so two runs of this part (an older tree's
    included) see the same data."""
    from ..kernels import _build
    from ..kernels.common import dtype_code
    from ..kernels.panel_step import panel_coeff
    from ..kernels.panel_step.ref import colnorms2
    lib = _build.load_library()
    for i, dtype in enumerate(DTYPES):
        gen = torch.Generator(device=dev)
        gen.manual_seed(500 + i)
        code = dtype_code(dtype)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for l, b, n in COEFF_SHAPES:
            c = randn(gen, (l, b), dtype, dev)
            z = randn(gen, (l, n), dtype, dev)
            r2in = colnorms2(z)
            r2in[::7] = -1.0
            r2in[3::101] = float("nan")
            qp, w, r2 = panel_coeff(c, z, r2in)
            w2, r22 = torch.empty_like(w), torch.empty_like(r2)

            def sweep():
                _build.check_status("panel_coeff_sweep",
                                    lib.repro_panel_coeff_sweep(
                                        code, qp.data_ptr(), z.data_ptr(),
                                        r2in.data_ptr(), w2.data_ptr(),
                                        r22.data_ptr(), l, b, n, stream))
            flops, nbytes = coeff_work(dtype, l, b, n)
            sweep_ms = _cuda_ms(sweep, 20)
            torch.cuda.synchronize()
            bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / PEAK_F64)
            out.append({
                "what": "coeff", "kernel": "panel_coeff",
                "dtype": str(dtype).removeprefix("torch."), "l": l, "b": b,
                "n": n, "ms": _cuda_ms(lambda: panel_coeff(c, z, r2in), 20),
                "sweep_ms": sweep_ms, "sweep_bound_ms": bound,
                "sweep_bound_share": bound / sweep_ms,
                "sweep_gbs": nbytes / sweep_ms / 1e6,
                "apart_same_bits": bool(torch.equal(w2, w) and torch.equal(
                    r22.nan_to_num(-2.0), r2.nan_to_num(-2.0))),
                "qp_sha256": _digest(qp), "w_sha256": _digest(w),
                "r2_sha256": _digest(r2)})
            del c, z, r2in, qp, w, r2, w2, r22
        torch.cuda.empty_cache()


def fwht_work(dtype: torch.dtype, m: int, n: int, sweeps: int) -> tuple:
    """(bytes of one read and one write of x, bytes the sweeps move)."""
    item = torch.empty((), dtype=dtype, device="meta").element_size()
    return 2.0 * m * n * item, 2.0 * m * n * item * sweeps


def _fwht_rows(dev, out: list) -> None:
    """``fwht`` at ``FWHT_SHAPES``; each shape draws from its own seed."""
    from ..kernels.srht import fwht
    from ..kernels.srht.kernel import LAUNCHES
    for i, (dtype, m, n) in enumerate(FWHT_SHAPES):
        gen = torch.Generator(device=dev)
        gen.manual_seed(800 + i)
        x = randn(gen, (m, n), dtype, dev)
        before = LAUNCHES.count
        y = fwht(x)
        sweeps = LAUNCHES.count - before
        ms = _cuda_ms(lambda: fwht(x), 5)
        one_pass, moved = fwht_work(dtype, m, n, sweeps)
        bound = 1e3 * one_pass / HBM_BYTES_PER_S
        out.append({"what": "fwht", "kernel": "fwht",
                    "dtype": str(dtype).removeprefix("torch."), "m": m,
                    "n": n, "launches": sweeps, "ms": ms,
                    "gbs": moved / ms / 1e6, "bound_ms": bound,
                    "bound_share": bound / ms, "y_sha256": _digest(y)})
        del x, y
        torch.cuda.empty_cache()


def _rid_rows(dev, out: list) -> None:
    """The main row's gaussian ``rid`` (13 ``panel_step`` panels): warm
    host seconds and digests of the pivots and P."""
    from ..core import rid
    gen = torch.Generator(device=dev)
    gen.manual_seed(1000)
    f64 = torch.float64
    A = randn(gen, (M, K), f64, dev) @ randn(gen, (K, N), f64, dev)
    dec = rid(0, A, K, sketch_kind="gaussian")
    out.append({"what": "rid", "kernel": "rid", "dtype": "float64", "m": M,
                "n": N, "k": K, "warm_median_s": time_fn(
                    lambda: rid(0, A, K, sketch_kind="gaussian")),
                "j_sha256": _digest(dec.J), "p_sha256": _digest(dec.P)})
    # The same matrix through the distributed panel (13 panel_coeff and
    # panel_apply launches) on a one-rank group.
    from ..core import rid_distributed
    from .bench_error import one_rank_group
    with one_rank_group(dev) as g:
        def dist_call():
            return rid_distributed(0, A, K, group=g, sketch_kind="gaussian",
                                   qr_impl="panel_parallel")
        dec = dist_call()
        out.append({"what": "rid", "kernel": "rid_distributed",
                    "dtype": "float64", "m": M, "n": N, "k": K,
                    "warm_median_s": time_fn(dist_call),
                    "j_sha256": _digest(dec.J), "p_sha256": _digest(dec.P)})
    del A, dec
    torch.cuda.empty_cache()


def _apply_rows(dev, out: list) -> None:
    """``panel_apply`` at ``APPLY_SHAPES`` in the four dtypes beside the
    library call; each dtype draws from its own seed."""
    from ..kernels.panel_step import panel_apply
    for i, dtype in enumerate(DTYPES):
        gen = torch.Generator(device=dev)
        gen.manual_seed(600 + i)
        for l, b, n in APPLY_SHAPES:
            qp = torch.linalg.qr(randn(gen, (l, b), dtype, dev)).Q.contiguous()
            w = randn(gen, (b, n), dtype, dev)
            z = randn(gen, (l, n), dtype, dev)

            def library():
                return torch.addmm(z, qp, w, alpha=-1)

            flops, nbytes = apply_work(dtype, l, b, n)
            o, r2 = panel_apply(qp, w, z, emit_norms=True)
            ms = _cuda_ms(lambda: panel_apply(qp, w, z), 20)
            out.append({
                "what": "apply", "kernel": "panel_apply",
                "dtype": str(dtype).removeprefix("torch."), "l": l, "b": b,
                "n": n, "ms": ms,
                "norms_ms": _cuda_ms(lambda: panel_apply(qp, w, z,
                                                         emit_norms=True), 20),
                "library_ms": _cuda_ms(library, 20), "gbs": nbytes / ms / 1e6,
                "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                      flops / PEAK_F64),
                "rel_err_vs_library": _rel_err(o, library()),
                "o_sha256": _digest(o), "r2_sha256": _digest(r2)})
            del qp, w, z, o, r2
        torch.cuda.empty_cache()


def _tsolve_rows(dev, out: list) -> None:
    """``tsolve`` at n = ``N`` and k in ``TSOLVE_KS`` in the four dtypes, on
    the R of a QR, beside ``torch.linalg.solve_triangular``."""
    from ..kernels.tsolve import tsolve
    from ..kernels.tsolve.ref import tsolve_ref
    for i, dtype in enumerate(DTYPES):
        gen = torch.Generator(device=dev)
        gen.manual_seed(700 + i)
        for k in TSOLVE_KS:
            r1 = torch.linalg.qr(randn(gen, (k + 20, k), dtype, dev)).R
            r2 = randn(gen, (k, N), dtype, dev)

            def library():
                return torch.linalg.solve_triangular(r1, r2, upper=True)

            flops, nbytes = tsolve_work(dtype, k, N)
            ms = _cuda_ms(lambda: tsolve(r1, r2), 10)
            got = tsolve(r1, r2)
            bound = max(nbytes / HBM_BYTES_PER_S,
                        flops / (PEAK_F64 if dtype in (torch.float64,
                                                       torch.complex128)
                                 else PEAK_F32))
            out.append({
                "what": "tsolve", "kernel": "tsolve",
                "dtype": str(dtype).removeprefix("torch."), "k": k, "n": N,
                "ms": ms, "library_ms": _cuda_ms(library, 10),
                "tflops": flops / ms / 1e9, "bound_ms": 1e3 * bound,
                "rel_err_vs_plain": _rel_err(got, tsolve_ref(r1, r2)),
                "rel_err_vs_library": _rel_err(got, library())})
            del r1, r2, got
        torch.cuda.empty_cache()


def device_summary(rows, wall_s: float) -> dict:
    """A trace's device rows ``(kernel, us, launches)`` as busy ms, the
    idle share of ``wall_s`` and the kernels by device time, each name cut
    at its argument list."""
    kernels = {}
    for name, us, count in rows:
        key = name.replace("(anonymous namespace)::", "").split("(")[0]
        key = key.removeprefix("void ")
        ms, n = kernels.get(key, (0.0, 0))
        kernels[key] = (ms + us / 1e3, n + count)
    busy = sum(ms for ms, _ in kernels.values())
    return {"busy_ms": busy, "idle_share": 1 - busy / (1e3 * wall_s),
            "kernels": [{"name": k, "ms": ms, "launches": n} for k, (ms, n)
                        in sorted(kernels.items(), key=lambda kv: -kv[1][0])]}


def _traced(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler`` (``device_summary``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return {"wall_s": wall, **device_summary(rows, wall)}


def _split_rows(dev, out: list) -> None:
    """``bench_qr``'s fused and split panel loops, host clock and traced."""
    from ..core import blocked_pivoted_qr
    from .bench_qr import (ACCEPT_K, ACCEPT_L, ACCEPT_N, PANEL_SWEEP,
                           split_blocked_qr)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    l, n, k = ACCEPT_L, ACCEPT_N, ACCEPT_K
    y = randn(gen, (l, n), torch.float32, dev)
    for b in PANEL_SWEEP:
        paths = {"fused": lambda: blocked_pivoted_qr(y, k, panel=b,
                                                     panel_impl="fused"),
                 "split": lambda: split_blocked_qr(y, k, b)}
        host = {name: [] for name in paths}
        for _ in range(SPLIT_ROUNDS):
            for name, fn in paths.items():
                host[name].append(time_fn(fn))
        for name, fn in paths.items():
            ts = sorted(host[name])
            out.append({"what": "split", "path": name, "l": l, "n": n,
                        "k": k, "b": b, "host_s": ts,
                        "host_median_s": ts[len(ts) // 2],
                        "trace": _traced(fn)})


def _flash_rows(dev, out: list) -> None:
    """The flash kernel at ``FLASH_SHAPES`` beside SDPA in f32."""
    import torch.nn.functional as F
    from ..kernels.flash.kernel import flash_attention_kernel
    gen = torch.Generator(device=dev)
    gen.manual_seed(500)
    f32, bf16 = torch.float32, torch.bfloat16
    for case, bh, s, hd, window in FLASH_SHAPES:
        q = randn(gen, (bh, s, hd), f32, dev) * hd ** -0.5
        k = randn(gen, (bh, s, hd), f32, dev).to(bf16)
        v = randn(gen, (bh, s, hd), f32, dev).to(bf16)
        k4, v4 = k.float()[None], v.float()[None]
        mask = None
        if window is not None:
            i = torch.arange(s, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

        def sdpa():
            if mask is None:
                return F.scaled_dot_product_attention(q[None], k4, v4,
                                                      is_causal=True,
                                                      scale=1.0)
            return F.scaled_dot_product_attention(q[None], k4, v4,
                                                  attn_mask=mask, scale=1.0)

        pairs, flops, nbytes = flash_work(bh, s, s, hd, True, window, f32,
                                          bf16)
        ms = _cuda_ms(lambda: flash_attention_kernel(q, k, v, causal=True,
                                                     window=window), 10)
        got = flash_attention_kernel(q, k, v, causal=True, window=window)
        out.append({
            "what": "flash", "kernel": "flash", "case": case, "bh": bh,
            "s": s, "t": s, "hd": hd, "window": window, "q_dtype": "float32",
            "kv_dtype": "bfloat16", "live_pairs": pairs, "flops": flops,
            "bytes": nbytes, "ms": ms, "library_ms": _cuda_ms(sdpa, 10),
            "tflops": flops / ms / 1e9,
            "ffma_bound_ms": 1e3 * max(flops / PEAK_F32,
                                       nbytes / HBM_BYTES_PER_S),
            "tf32_2pass_bound_ms": 1e3 * max(2 * flops / PEAK_TF32,
                                             nbytes / HBM_BYTES_PER_S),
            "rel_err_vs_library": _rel_err(got, sdpa()[0])})
        del q, k, v, k4, v4, mask, got
        torch.cuda.empty_cache()


# Row kinds whose digests --against holds to an earlier run's.
PARITY_KINDS = ("gram", "sweep", "coeff", "apply", "fwht", "rid")
_PARITY_KEY = ("what", "kernel", "dtype", "m", "l", "b", "n")


def parity(rows: list, earlier: list) -> list[dict]:
    """One ``parity`` row per ``PARITY_KINDS`` row of ``rows``: whether the
    row of ``earlier`` with the same (kind, kernel, dtype, m, l, b, n) has
    the same digests (every ``*sha256`` field)."""
    def key(r):
        return tuple(r.get(f) for f in _PARITY_KEY)

    def digests(r):
        return {f: r[f] for f in r if f.endswith("sha256")}
    before = {key(r): r for r in earlier if r.get("what") in PARITY_KINDS}
    out = []
    for r in rows:
        if r.get("what") not in PARITY_KINDS:
            continue
        o = before.get(key(r))
        out.append({"what": "parity", **{f: r[f] for f in _PARITY_KEY[1:]
                                         if f in r},
                    "bit_equal": o is not None
                    and bool(digests(r)) and digests(o) == digests(r)})
    return out


def run(device="cuda", parts=PARTS, emit=None) -> list[dict]:
    """The measurements of ``parts`` on ``device`` (a card), as dicts,
    each also handed to ``emit`` as soon as it is taken."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("bench_dmma: needs a CUDA device")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    unknown = set(parts) - set(PARTS)
    if unknown:
        raise ValueError(f"bench_dmma: unknown parts {sorted(unknown)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    out = _Rows(emit)
    if "probe" in parts:
        _probe(dev, gen, out)
    if "kernels" in parts:
        _sketch_rows("sketch_accum", dev, gen, DTYPES, (L,), out)
        _sketch_rows("sketch_matmul", dev, gen, DTYPES, (L,), out)
        _project_out_rows(dev, gen, DTYPES, (K,), out)
    if "shapes" in parts:
        _sketch_rows("sketch_accum", dev, gen, (torch.float64,), (768, 1024),
                     out)
        _sketch_rows("sketch_matmul", dev, gen, (torch.float64,),
                     (768, L, 1024), out)
        _project_out_rows(dev, gen, (torch.float64,), (384, 512), out)
    if "gram" in parts:
        _gram_rows(dev, out)
    if "deflate" in parts:
        _deflate_rows(dev, out)
    if "coeff" in parts:
        _coeff_rows(dev, out)
    if "split" in parts:
        _split_rows(dev, out)
    if "apply" in parts:
        _apply_rows(dev, out)
    if "tsolve" in parts:
        _tsolve_rows(dev, out)
    if "flash" in parts:
        _flash_rows(dev, out)
    if "fwht" in parts:
        _fwht_rows(dev, out)
    if "rid" in parts:
        _rid_rows(dev, out)
    out.append({"what": "device", "name": torch.cuda.get_device_name(dev)})
    return list(out)


class _Rows(list):
    """A list of rows that hands each row to ``emit`` as it is added."""

    def __init__(self, emit):
        super().__init__()
        self._emit = emit

    def append(self, row: dict) -> None:
        super().append(row)
        if self._emit is not None:
            self._emit(row)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None,
                    help="append the rows to the JSON list at this path")
    ap.add_argument("--parts", nargs="*", default=list(PARTS), choices=PARTS)
    ap.add_argument("--against", default=None,
                    help="an earlier run's --json file: exit 1 unless every "
                         "gram, sweep, coeff, apply, fwht and rid row has "
                         "its digests")
    args = ap.parse_args(argv)
    rows = run("cuda", tuple(args.parts),
               emit=lambda row: print(json.dumps(row), flush=True))
    ok = True
    if args.against:
        with open(args.against) as f:
            checked = parity(rows, json.load(f))
        for row in checked:
            print(json.dumps(row), flush=True)
        ok = bool(checked) and all(r["bit_equal"] for r in checked)
        rows += checked
    if args.json:
        append_json_rows(args.json, rows)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
