"""Build and load the port's CUDA kernels: ``csrc/*.cu`` -> one shared
library with a plain C interface, bound with ``ctypes``.

At the first kernel launch in a process, ``load_library`` compiles every
source with its own ``nvcc`` (all started together), links the objects
into ``build/repro_torch/<hash>/libkernels.so`` under the checkout, and
loads it.  ``<hash>`` covers the sources and the flags, so an edited
source builds anew and an unchanged one is reused.  A failed build raises;
nothing falls back to the plain versions.

Each C entry point takes a dtype code (``common.dtype_code``), raw device
pointers, int64 sizes and the CUDA stream, launches on that stream without
synchronizing, and returns the launch's status (a refused shared-memory
request's included; ``csrc/common.cuh``, ``launch``).

A kernel kept out of the production library (the analysis fixture
``big_copy``) is built the same way into a library of its own by
``load_extra``.  ``query_launches`` asks a library what one call of an
entry point would launch, without launching: the geometry the analysis
pass holds the kernel contracts to.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from ..obs.clock import now

__all__ = ["load_library", "load_extra", "query_launches", "build_info",
           "check_status", "tensor_core_ops", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc"
_BUILD = _PKG.parents[1] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# name -> argtypes; every entry point returns a cudaError_t as int.
_SIGNATURES = {
    # dtype, x, a, acc, out, l, m, n, stream
    "repro_sketch_accum": [_I, _P, _P, _P, _P, _I64, _I64, _I64, _P],
    # dtype, c, qp, l, b, stream
    "repro_panel_factor": [_I, _P, _P, _I64, _I64, _P],
    # dtype, qp, z, o, w (nullable), r2, l, b, n, stream
    "repro_panel_sweep": [_I, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P],
    # dtype, qp, z, r2_in, w, r2, l, b, n, stream
    "repro_panel_coeff_sweep": [_I, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P],
    # dtype, qp, w, z, o, r2 (nullable), l, b, n, stream
    "repro_panel_apply": [_I, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P],
    # dtype, c, z, g, v, l, b, n, stream
    "repro_panel_gram": [_I, _P, _P, _P, _P, _I64, _I64, _I64, _P],
    # dtype, omega, a, out, l, m, n, stream
    "repro_sketch_matmul": [_I, _P, _P, _P, _I64, _I64, _I64, _P],
    # dtype, x, y, m, n, stride, f_log2, scale, stream
    "repro_fwht_pass": [_I, _P, _P, _I64, _I64, _I64, _I, ctypes.c_double,
                        _P],
    # dtype, r1, r2, t, k, n, stream
    "repro_tsolve": [_I, _P, _P, _P, _I64, _I64, _P],
    # dtype, q, z, w (workspace), o, l, k, n, stream
    "repro_project_out": [_I, _P, _P, _P, _P, _I64, _I64, _I64, _P],
    # dtype, qp, z, o, w, l, b, n, stream
    "repro_panel_deflate": [_I, _P, _P, _P, _P, _I64, _I64, _I64, _P],
    # q dtype, k/v dtype, q, k, v, o, lse (nullable), bh, s, t, hd, causal,
    # window, stream
    "repro_flash_attention": [_I, _I, _P, _P, _P, _P, _P, _I64, _I64, _I64,
                              _I64, _I, _I64, _P],
}

_lock = threading.Lock()
_libs: dict = {}
# Filled by load_library: library path, build seconds (0.0 when reused)
# and the per-kernel ``-Xptxas -v`` report; ``libraries`` holds the same
# three for every library built (production and extra), by name.
build_info: dict = {"libraries": {}}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _digest(sources: list[Path]) -> str:
    """Hash of the flags, the sources and every ``csrc`` header."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(set(sources) | set(_SRC.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


_TYPE_CODES = {"f": "float32", "d": "float64",
               "N5repro4cplxIfEE": "complex64",
               "N5repro4cplxIdEE": "complex128",
               "13__nv_bfloat16": "bfloat16"}
_TYPE_RE = r"N5repro4cplxI[fd]EE|13__nv_bfloat16|f|d"


def _short_name(mangled: str) -> str:
    """``panel_sweep_kernel<float64,true,false>`` from the mangled entry
    name (any element types, then any bool or int template arguments).  A
    type repeated in the arguments is mangled as a substitution
    (``S1_``): it stands for the type before it."""
    m = re.search(rf"\d([a-z_]+_kernel)I((?:{_TYPE_RE}|S\d*_)*)"
                  r"((?:Lb[01]E|Li\d+E)*)E", mangled)
    if not m:
        return mangled
    types = []
    for t in re.findall(rf"{_TYPE_RE}|S\d*_", m.group(2)):
        types.append(types[-1] if t.startswith("S") else _TYPE_CODES[t])
    args = [{"b0": "false", "b1": "true"}.get(a, a[1:])
            for a in re.findall(r"L(b[01]|i\d+)E", m.group(3))]
    return f"{m.group(1)}<{','.join(types + args)}>"


def parse_ptxas(log: str) -> list[dict]:
    """Registers, shared memory and spills per kernel from ``-Xptxas -v``."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": _short_name(m.group(1))}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(s.group(1)) if s else 0
    return out


def tensor_core_ops(lib_path: str) -> dict:
    """The tensor-core instructions (SASS opcodes ending in ``MMA``:
    ``DMMA``, ``HMMA``, ``HGMMA``, ...) of every kernel in the built
    library ``lib_path``, by the kernel's short name, from ``cuobjdump
    -sass`` (beside nvcc).  A kernel without any maps to ``[]``."""
    cuobjdump = str(Path(_nvcc()).with_name("cuobjdump"))
    sass = subprocess.run([cuobjdump, "-sass", lib_path], check=True,
                          stdout=subprocess.PIPE, text=True).stdout
    ops: dict = {}
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = ops.setdefault(_short_name(m.group(1)), set())
            continue
        # /*0a30*/  @!P0 DMMA.8x8x4 R24, R136, R120, R24 ;  /* 0x... */
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P[0-9T]\s+)?([A-Z][A-Z0-9]*)",
                     line)
        if cur is not None and m and m.group(1).endswith("MMA"):
            cur.add(m.group(1))
    return {name: sorted(found) for name, found in ops.items()}


def _compile(dest: Path, sources: list[Path]) -> str:
    nvcc = _nvcc()
    dest.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=dest.parent) as tmp:
        procs = []
        for src in sources:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(_SRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {src.name}\n{text}")
            if p.returncode:
                failed.append(src.name)
        log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        lib = Path(tmp) / dest.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(lib), *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        log_path = dest.with_suffix(".log")
        (Path(tmp) / "build.log").write_text(log)
        os.replace(Path(tmp) / "build.log", log_path)
        os.replace(lib, dest)
    return log


def _load(name: str, sources, signatures: dict) -> ctypes.CDLL:
    """The library ``lib<name>.so`` of ``sources()``, built on first use in
    this process (reused from the build directory when its hash matches).
    Once loaded it is returned at once: every launch calls this."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name in _libs:
            return _libs[name]
        sources = sources()
        dest = _BUILD / _digest(sources) / f"lib{name}.so"
        t0 = now()
        if dest.exists():
            log = dest.with_suffix(".log").read_text()
            seconds = 0.0
        else:
            log = _compile(dest, sources)
            seconds = now() - t0
        lib = ctypes.CDLL(str(dest))
        for entry, argtypes in signatures.items():
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [_I]
        lib.repro_error_string.restype = ctypes.c_char_p
        lib.repro_query_begin.argtypes = [_P, _I]
        lib.repro_query_begin.restype = None
        lib.repro_query_end.argtypes = []
        lib.repro_query_end.restype = _I
        info = {"path": str(dest), "seconds": seconds,
                "ptxas": parse_ptxas(log)}
        build_info["libraries"][name] = info
        if name == "kernels":
            build_info.update(info)
        _libs[name] = lib
        return lib


def load_library() -> ctypes.CDLL:
    """The production kernels' shared library (every ``csrc/*.cu``)."""
    return _load("kernels", lambda: sorted(_SRC.glob("*.cu")), _SIGNATURES)


def load_extra(name: str, sources: list[Path],
               signatures: dict) -> ctypes.CDLL:
    """A library of kernels kept out of the production one, from
    ``sources`` (each may include the ``csrc`` headers and must expand
    ``REPRO_QUERY_ENTRIES`` and define ``repro_error_string`` once)."""
    return _load(name, lambda: [Path(p) for p in sources], signatures)


# Fields of one record of the geometry query (csrc/common.cuh, launch), and
# the most records one query keeps (a C entry point launches one or two
# kernels).
QUERY_FIELDS = ("gx", "gy", "gz", "bx", "by", "bz", "smem", "static_smem",
                "registers", "local_bytes", "max_threads")
_QUERY_CAP = 8


def query_launches(lib: ctypes.CDLL, entry: str,
                   args: tuple) -> tuple[int, list[dict]]:
    """What one call ``entry(*args)`` would launch, without launching:
    ``(status, [record, ...])``, a record per launch with ``QUERY_FIELDS``.
    Pointer arguments may be any value (nothing is dereferenced)."""
    cap = _QUERY_CAP
    buf = (ctypes.c_int64 * (cap * len(QUERY_FIELDS)))()
    lib.repro_query_begin(ctypes.cast(buf, _P), cap)
    try:
        rc = getattr(lib, entry)(*args)
    finally:
        n = lib.repro_query_end()
    k = len(QUERY_FIELDS)
    recs = [dict(zip(QUERY_FIELDS, buf[i * k:(i + 1) * k]))
            for i in range(min(n, cap))]
    return rc, recs


def check_status(name: str, rc: int, lib: ctypes.CDLL | None = None) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if rc:
        what = (lib or load_library()).repro_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc} ({what})")
