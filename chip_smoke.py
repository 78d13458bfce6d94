#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``src/repro_torch/csrc`` and runs,
in order, printing one JSON line per phase:

  1. device   -- the card, its power limit, the build time and the
                 ``-Xptxas -v`` report of every kernel;
  2. kernels  -- each kernel against its plain PyTorch version on the card,
                 at the main path's shapes, for f32, f64, c64 and c128, with
                 the tolerance stated; sketch_accum's chunk invariance
                 (bit-exact); a duplicate-column panel;
  3. main     -- ``rid(seed, A, 400, sketch_kind="gaussian")`` on a real
                 f64 ``A = B0 @ P0`` of 2^16 x 2^14 (the paper's Table row
                 k=400, m=2^16, n=2^14), with the launch counts of both
                 kernels and the paper's eq. (3) bound;
  4. default  -- ``rid(seed, A, 100)`` (srft) on a complex128 ``A`` of
                 2^14 x 2^14 (the paper's row k=100, m=n=2^14);
  5. times    -- each kernel's time at the main path's shapes beside its
                 bound, its plain version's time and the library call's;
  6. trace    -- the main path once more: the sketch and the rest timed
                 apart, then one ``rid`` under ``torch.profiler`` (device
                 time by kernel, device idle share).

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` name and power
limit, and as the last line ``{"ok": true, "device": {...}}``.  Any failed
phase exits non-zero before that line.  Without a CUDA device, or without
the rest of the repository beside it, the script exits non-zero at once.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

SEED = 0
# The paper's Table rows (src/repro/configs/paper_rid.py, PAPER_GRID[2] and
# PAPER_GRID[0]); l = 2k.
MAIN_K, MAIN_M, MAIN_N = 400, 2 ** 16, 2 ** 14
DEFAULT_K, DEFAULT_M, DEFAULT_N = 100, 2 ** 14, 2 ** 14
PANEL = 32
# c128 sketch_accum runs at a quarter of the main path's m, so that phase 2
# stays within a few seconds (4x the flops of f64 per element).
C128_ACCUM_M = 2 ** 14

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W) for the bounds of the
# f64 timings: HBM3 bytes/s, and the FP64 tensor-core rate, the least time
# the card could take for f64 work (the kernels run DFMA, whose peak is
# half of it).
HBM_BYTES_PER_S = 3.35e12
PEAK_F64_FLOPS = 67e12
PEAK_NAME = "FP64 tensor 67 TFLOP/s"
# Kernel-vs-plain tolerances, relative to the largest entry of the plain
# output: the two sum in different orders (the kernel in its own tiles, the
# plain version through the library's GEMMs), so they agree to rounding
# that grows with the reduction length, far inside these bounds.
REL_TOL = {"float32": 1e-4, "complex64": 1e-4,
           "float64": 1e-10, "complex128": 1e-10}


class PhaseError(RuntimeError):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch.core import (error_bound, expected_sigma_kp1, rid,
                                      rid_from_sketch, sketch,
                                      spectral_error)
        from repro_torch.kernels import _build
        from repro_torch.kernels.panel_step import panel_step
        from repro_torch.kernels.panel_step.kernel import (
            LAUNCHES as PANEL_LAUNCHES)
        from repro_torch.kernels.panel_step.ref import panel_step_ref
        from repro_torch.kernels.sketch_accum import sketch_accum
        from repro_torch.kernels.sketch_accum.kernel import (
            LAUNCHES as ACCUM_LAUNCHES)
        from repro_torch.kernels.sketch_accum.ref import sketch_accum_ref
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def randn(shape, dtype):
        if dtype.is_complex:
            rdt = dtype.to_real()
            return torch.complex(
                torch.randn(shape, generator=gen, dtype=rdt, device=dev),
                torch.randn(shape, generator=gen, dtype=rdt, device=dev))
        return torch.randn(shape, generator=gen, dtype=dtype, device=dev)

    def rel_err(got, want) -> float:
        scale = max(float(want.abs().max()), 1e-300)
        return float((got - want).abs().max()) / scale

    def cuda_ms(fn, reps: int) -> float:
        fn()                                    # warm-up
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps

    def dname(dtype) -> str:
        return str(dtype).replace("torch.", "")

    # ---------------------------------------------------------- 1. device
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    emit({"phase": "device", "ok": True,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_seconds": round(build_s, 3),
          "ptxas": _build.build_info["ptxas"]})

    # --------------------------------------- 2. kernels vs plain versions
    accum_err_f64 = panel_err_f64 = None
    for dtype in (torch.float32, torch.float64, torch.complex64,
                  torch.complex128):
        name, tol = dname(dtype), REL_TOL[dname(dtype)]
        l, n = 2 * MAIN_K, MAIN_N
        m = C128_ACCUM_M if dtype == torch.complex128 else MAIN_M
        x, a, acc = randn((l, m), dtype), randn((m, n), dtype), randn((l, n), dtype)
        got = sketch_accum(x, a, acc)
        want = sketch_accum_ref(x, a, acc)
        err = rel_err(got, want)
        # chunk invariance: four calls over row ranges at block multiples
        chunk = m // 4
        acc_c = acc
        for r0 in range(0, m, chunk):
            acc_c = sketch_accum(x[:, r0:r0 + chunk].contiguous(),
                                 a[r0:r0 + chunk], acc_c)
        torch.cuda.synchronize()
        chunk_exact = bool(torch.equal(acc_c, got))
        emit({"phase": "kernels", "kernel": "sketch_accum", "dtype": name,
              "l": l, "m": m, "n": n,
              "reduced": (f"m cut from {MAIN_M} to {m} (phase time)"
                          if m != MAIN_M else None),
              "max_abs_err": float((got - want).abs().max()),
              "rel_err": err, "rel_tol": tol, "chunks": 4,
              "chunk_invariant_bit_exact": chunk_exact})
        check(err <= tol, f"sketch_accum {name}: rel err {err} > {tol}")
        check(chunk_exact, f"sketch_accum {name}: chunked != one call")
        if dtype == torch.float64:
            accum_err_f64 = float((got - want).abs().max())
        del x, a, acc, got, want, acc_c
        torch.cuda.empty_cache()

        z = randn((l, n), dtype)
        for b in (PANEL, MAIN_K % PANEL):
            c = randn((l, b), dtype)
            qp, o, w, r2 = panel_step(c, z, emit_w=True)
            qp2, o2, w2, r22 = panel_step(c, z, emit_w=False)
            ref = panel_step_ref(c, z)
            errs = {k: rel_err(u, v) for k, u, v in
                    zip(("qp", "o", "w", "r2"), (qp, o, w, r2), ref)}
            torch.cuda.synchronize()
            same = bool(torch.equal(o2, o) and torch.equal(r22, r2)
                        and w2 is None)
            emit({"phase": "kernels", "kernel": "panel_step", "dtype": name,
                  "l": l, "b": b, "n": n, "rel_err": errs, "rel_tol": tol,
                  "max_abs_err": max(float((u - v).abs().max()) for u, v in
                                     zip((qp, o, w, r2), ref)),
                  "emit_w_false_same_bits": same})
            check(max(errs.values()) <= tol,
                  f"panel_step {name} b={b}: rel errs {errs} > {tol}")
            check(same, f"panel_step {name} b={b}: emit_w=False differs")
            if dtype == torch.float64 and b == PANEL:
                panel_err_f64 = max(float((u - v).abs().max()) for u, v in
                                    zip((qp, o, w, r2), ref))
        # duplicate-column panel: finite, and not orthonormal
        c16 = randn((l, PANEL // 2), dtype)
        cdup = torch.cat([c16, c16], dim=1)
        qp, o, _, r2 = panel_step(cdup, z, emit_w=False)
        eye = torch.eye(PANEL, dtype=dtype, device=dev)
        orth = float((qp.mH @ qp - eye).abs().max())
        finite = bool(torch.isfinite(qp).all() and torch.isfinite(o).all()
                      and torch.isfinite(r2).all())
        emit({"phase": "kernels", "kernel": "panel_step",
              "case": "duplicate columns", "dtype": name, "finite": finite,
              "orth_err": orth})
        check(finite and orth > math.sqrt(torch.finfo(dtype.to_real()
                                                       if dtype.is_complex
                                                       else dtype).eps),
              f"panel_step {name}: duplicate panel finite={finite} "
              f"orth={orth}")
        del z, c, qp, o, w, r2, qp2, o2, r22, ref
        torch.cuda.empty_cache()

    # ----------------------------------------- 3. main path, f64 gaussian
    def lowrank(m, n, k, dtype):
        return randn((m, k), dtype) @ randn((k, n), dtype)

    def run_rid(m, n, k, dtype, **kw):
        A = lowrank(m, n, k, dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ACCUM_LAUNCHES.reset()
        PANEL_LAUNCHES.reset()
        t0 = time.perf_counter()
        dec = rid(SEED, A, k, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"sketch_accum": ACCUM_LAUNCHES.count,
                  "panel_step": PANEL_LAUNCHES.count}
        peak = torch.cuda.max_memory_allocated()
        J = dec.J
        distinct = int(torch.unique(J).numel()) == k
        in_range = bool(((J >= 0) & (J < n)).all())
        eye = torch.eye(k, dtype=dec.P.dtype, device=dev)
        identity = bool(torch.equal(dec.P[:, J], eye))
        err = float(spectral_error(SEED + 1, A, dec.B, dec.P))
        bound = error_bound(m, n, k) * expected_sigma_kp1(m, n)
        out = {"m": m, "n": n, "k": k, "l": 2 * k, "dtype": dname(dtype),
               "launches": counts, "wall_s": wall,
               "max_memory_allocated": peak, "J_distinct": distinct,
               "J_in_range": in_range, "P_J_identity": identity,
               "spectral_error": err, "eq3_bound": bound,
               "error_over_bound": err / bound,
               "finite": bool(torch.isfinite(dec.P).all())}
        del A, dec
        torch.cuda.empty_cache()
        return out

    res = run_rid(MAIN_M, MAIN_N, MAIN_K, torch.float64,
                  sketch_kind="gaussian")
    emit({"phase": "main", "call": "rid(seed, A, 400, sketch_kind='gaussian')",
          **res})
    n_panels = math.ceil(MAIN_K / PANEL)
    check(res["launches"]["sketch_accum"] >= 1, "main: sketch_accum unused")
    check(res["launches"]["panel_step"] == n_panels,
          f"main: panel_step launched {res['launches']['panel_step']} "
          f"times, expected {n_panels}")
    check(res["J_distinct"] and res["J_in_range"] and res["P_J_identity"]
          and res["finite"], "main: J or P malformed")
    check(res["spectral_error"] <= res["eq3_bound"], "main: eq.(3) violated")
    main_launches = res["launches"]

    # ----------------------------------------- 4. default path, c128 srft
    res = run_rid(DEFAULT_M, DEFAULT_N, DEFAULT_K, torch.complex128)
    emit({"phase": "default", "call": "rid(seed, A, 100)", **res})
    n_panels = math.ceil(DEFAULT_K / PANEL)
    check(res["launches"]["panel_step"] == n_panels,
          f"default: panel_step launched {res['launches']['panel_step']} "
          f"times, expected {n_panels}")
    check(res["J_distinct"] and res["J_in_range"] and res["P_J_identity"]
          and res["finite"], "default: J or P malformed")
    check(res["spectral_error"] <= res["eq3_bound"],
          "default: eq.(3) violated")

    # ------------------------------------ 5. times at the main path shapes
    dtype, esize = torch.float64, 8
    l, m, n, b = 2 * MAIN_K, MAIN_M, MAIN_N, PANEL
    x, a = randn((l, m), dtype), randn((m, n), dtype)
    acc = torch.zeros((l, n), dtype=dtype, device=dev)
    flops = 2.0 * l * m * n
    nbytes = esize * (l * m + m * n + 2 * l * n)
    t_flop, t_byte = flops / PEAK_F64_FLOPS, nbytes / HBM_BYTES_PER_S
    accum = {"name": "sketch_accum", "route": "cuda",
             "source": "src/repro_torch/csrc/sketch_accum.cu",
             "replaces": "src/repro/kernels/sketch_accum/kernel.py:52",
             "launches": main_launches["sketch_accum"],
             "max_abs_err": accum_err_f64,
             "ms": cuda_ms(lambda: sketch_accum(x, a, acc), 3),
             "plain_ms": cuda_ms(lambda: sketch_accum_ref(x, a, acc), 3),
             "bound_ms": 1e3 * max(t_flop, t_byte),
             "bound_by": "operations" if t_flop >= t_byte else "bytes",
             "library_ms": cuda_ms(lambda: torch.addmm(acc, x, a), 3)}
    emit({"phase": "times", "kernel": "sketch_accum", "dtype": "float64",
          "l": l, "m": m, "n": n, "flops": flops, "bytes": nbytes,
          "peak": PEAK_NAME, "ms": accum["ms"],
          "plain_ms": accum["plain_ms"], "library_ms": accum["library_ms"],
          "bound_ms": accum["bound_ms"], "bound_by": accum["bound_by"]})
    del x, a, acc
    torch.cuda.empty_cache()

    c, z = randn((l, b), dtype), randn((l, n), dtype)
    # factor: 2 rounds of Gram (2 l b^2), Cholesky (b^3 / 3), solve (l b^2);
    # sweep: W and O (2 l b n each), norms (2 l n)
    flops = 2 * (3.0 * l * b * b + b ** 3 / 3) + 4.0 * l * b * n + 2.0 * l * n
    nbytes = esize * (2 * l * b + 2 * l * n) + esize * n
    t_flop, t_byte = flops / PEAK_F64_FLOPS, nbytes / HBM_BYTES_PER_S
    pstep = {"name": "panel_step", "route": "cuda",
             "source": "src/repro_torch/csrc/panel_step.cu",
             "replaces": "src/repro/kernels/panel_step/kernel.py:147",
             "launches": main_launches["panel_step"],
             "max_abs_err": panel_err_f64,
             "ms": cuda_ms(lambda: panel_step(c, z, emit_w=False), 20),
             "plain_ms": cuda_ms(lambda: panel_step_ref(c, z), 5),
             "bound_ms": 1e3 * max(t_flop, t_byte),
             "bound_by": "operations" if t_flop >= t_byte else "bytes",
             "library_ms": None}
    emit({"phase": "times", "kernel": "panel_step", "dtype": "float64",
          "l": l, "b": b, "n": n, "flops": flops, "bytes": nbytes,
          "peak": PEAK_NAME, "ms": pstep["ms"],
          "plain_ms": pstep["plain_ms"], "library_ms": None,
          "bound_ms": pstep["bound_ms"], "bound_by": pstep["bound_by"]})

    del c, z
    torch.cuda.empty_cache()

    # ------------------- 6. where the main path's time goes (one more run)
    A = lowrank(MAIN_M, MAIN_N, MAIN_K, dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Y = sketch(SEED, A, 2 * MAIN_K, kind="gaussian").Y
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rid_from_sketch(A, Y, MAIN_K)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t3 = time.perf_counter()
        rid(SEED, A, MAIN_K, sketch_kind="gaussian")
        torch.cuda.synchronize()
        t4 = time.perf_counter()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    emit({"phase": "trace", "call": "rid(seed, A, 400, sketch_kind='gaussian')",
          "sketch_s": t1 - t0, "qr_interp_gather_s": t2 - t1,
          "traced_wall_s": t4 - t3, "device_busy_ms": busy_ms,
          "device_idle_share": 1 - busy_ms / (1e3 * (t4 - t3)),
          "top_kernels": [{"name": k[:80], "ms": ms, "count": n}
                          for k, ms, n in rows[:12]]})
    check(busy_ms > 0, "trace: no device time recorded")
    del A, Y
    torch.cuda.empty_cache()

    emit({"kernels": [accum, pstep]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as exc:
        emit({"ok": False, "error": str(exc)})
        sys.exit(1)
