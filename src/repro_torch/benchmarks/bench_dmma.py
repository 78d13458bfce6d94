"""The FP64 tensor-core tile of ``csrc/dmma_tile.cuh`` and the two kernels
on it, on the card.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_dmma \
        [--parts probe kernels shapes] [--json PATH]

Prints one JSON line per measurement (and appends them to ``--json``):

  probe    -- ``frag``: each ``mma.sync`` f64 shape (m8n8k4, m16n8k4,
              m16n8k8, m16n8k16) on one warp against a known product, its
              operands loaded by the fragment maps of the tile; ``rate``:
              each shape's rate on registers alone, 132 and 264 CTAs of 8
              warps, 16 independent tiles a warp;
  kernels  -- ``sketch_accum`` (l=800, m=2^16, n=2^14) and ``project_out``
              (l=800, k=400, n=2^14) through their wrappers in f32, f64,
              c64 and c128, beside ``torch.addmm`` and the ``q.mH @ z`` /
              ``addmm`` pair on the same inputs;
  shapes   -- the f64 kernels at other l (sketch_accum) and k
              (project_out): how the time follows the number of 128-row
              tiles.

Needs a card (and nvcc).  The ``kernels`` part uses only the wrappers'
public signatures, so the same file times an older checkout's kernels when
copied into its ``repro_torch/benchmarks/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from .common import append_json_rows, randn

__all__ = ["PARTS", "run"]

PARTS = ("probe", "kernels", "shapes")
DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128)
L, M, N, K = 800, 2 ** 16, 2 ** 14, 400

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


def _sketch_accum_rows(dev, gen, dtypes, rows_list, out: list) -> None:
    from ..kernels.sketch_accum import sketch_accum
    for dtype in dtypes:
        x = randn(gen, (max(rows_list), M), dtype, dev)
        a = randn(gen, (M, N), dtype, dev)
        for rows in rows_list:
            xr = x[:rows]
            acc = randn(gen, (rows, N), dtype, dev)
            ms = _cuda_ms(lambda: sketch_accum(xr, a, acc), 3)
            want = torch.addmm(acc, xr, a)
            row = {"what": "kernel", "kernel": "sketch_accum",
                   "dtype": str(dtype).removeprefix("torch."), "l": rows,
                   "m": M, "n": N, "ms": ms,
                   "tflops": _real_flops(dtype, rows * M * N) / ms / 1e9,
                   "rel_err_vs_library": _rel_err(sketch_accum(xr, a, acc),
                                                  want)}
            if rows == L:
                row["library_ms"] = _cuda_ms(
                    lambda: torch.addmm(acc, xr, a), 3)
            out.append(row)
            del acc, want
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


def run(device="cuda", parts=PARTS, emit=None) -> list[dict]:
    """The measurements of ``parts`` on ``device`` (a card), as dicts,
    each also handed to ``emit`` as soon as it is taken."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("bench_dmma: needs a CUDA device")
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
        _sketch_accum_rows(dev, gen, DTYPES, (L,), out)
        _project_out_rows(dev, gen, DTYPES, (K,), out)
    if "shapes" in parts:
        _sketch_accum_rows(dev, gen, (torch.float64,), (768, 1024), out)
        _project_out_rows(dev, gen, (torch.float64,), (384, 512), out)
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
    args = ap.parse_args(argv)
    rows = run("cuda", tuple(args.parts),
               emit=lambda row: print(json.dumps(row), flush=True))
    if args.json:
        append_json_rows(args.json, rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
