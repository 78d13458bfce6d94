"""The FP64 tensor-core tile of ``csrc/dmma_tile.cuh``, the three kernels
on it, and the panel Gram, on the card.

    PYTHONPATH=src python -m repro_torch.benchmarks.bench_dmma \
        [--parts probe kernels shapes gram] [--json PATH] [--against PATH]

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
              2^14 sketch, one-rank group), warm host seconds.

``--against PATH`` compares the ``gram`` rows' digests with those of an
earlier run's ``--json`` file (same inputs: each dtype draws from its own
seed) and exits 1 unless every row is bit-equal.

Needs a card (and nvcc).  The ``kernels``, ``shapes`` and ``gram`` parts
use only the wrappers' public signatures, so the same file times an older
checkout's kernels when copied into its ``repro_torch/benchmarks/``.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import sys
from pathlib import Path

import torch

from .common import append_json_rows, randn, time_fn

__all__ = ["PARTS", "run"]

PARTS = ("probe", "kernels", "shapes", "gram")
DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128)
L, M, N, K = 800, 2 ** 16, 2 ** 14, 400
GRAM_BS = (16, 32, 64)

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


def parity(rows: list, earlier: list) -> list[dict]:
    """One ``parity`` row per ``gram`` row of ``rows``: whether the row of
    ``earlier`` at the same (dtype, l, b, n) has the same G and V digests."""
    def key(r):
        return (r["dtype"], r["l"], r["b"], r["n"])
    before = {key(r): r for r in earlier if r.get("what") == "gram"}
    out = []
    for r in rows:
        if r.get("what") != "gram":
            continue
        o = before.get(key(r))
        out.append({"what": "parity", "kernel": r["kernel"],
                    "dtype": r["dtype"], "l": r["l"], "b": r["b"],
                    "n": r["n"], "bit_equal": o is not None and all(
                        o[d] == r[d] for d in ("g_sha256", "v_sha256"))})
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
                         "gram row has its G and V digests")
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
