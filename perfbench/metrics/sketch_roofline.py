"""``sketch_roofline``: the least time the sketch stage could take on the
chip over its measured device time (``sketch_ms``), in %.

The least time is ``max(ops / f64 peak, bytes / HBM peak)`` with the
published H100 SXM peaks of ``peaks.json`` (67e12 f64 operations a second,
the tensor-core rate and the chip's best in f64, and 3.35e12 bytes a
second), counted from the shapes of the algorithm, not of the kernels that
run it:

* gaussian: ``8 l m n`` real operations for complex data (``2 l m n`` for
  real); ``A``, ``Omega`` and ``Y`` each moved once;
* srft: ``5 m log2(m) n`` (a complex FFT down each column); ``A`` read once
  and ``Y`` (complex) written once.

A sketch kind without a count reads nothing.
"""
import math

ITEMSIZE = {"complex128": 16, "complex64": 8, "float64": 8, "float32": 4}
COMPLEX_OF = {"complex128": "complex128", "complex64": "complex64",
              "float64": "complex128", "float32": "complex64"}


def ops(config, traffic):
    m, n, k = config["m"], config["n"], config["k"]
    l = config["l_over_k"] * k
    kind = traffic["sketch_kind"]
    if kind == "gaussian":
        per_mac = 8 if config["dtype"].startswith("complex") else 2
        return per_mac * l * m * n
    if kind == "srft":
        return 5 * m * math.log2(m) * n
    return None


def bytes_moved(config, traffic):
    m, n, k = config["m"], config["n"], config["k"]
    l = config["l_over_k"] * k
    size = ITEMSIZE[config["dtype"]]
    kind = traffic["sketch_kind"]
    if kind == "gaussian":
        return (m * n + l * m + l * n) * size
    if kind == "srft":
        return m * n * size + l * n * ITEMSIZE[COMPLEX_OF[config["dtype"]]]
    return None


def least_seconds(config, traffic, peaks):
    f, b = ops(config, traffic), bytes_moved(config, traffic)
    if f is None or b is None:
        return None
    return max(f / peaks["f64_flops_per_s"], b / peaks["hbm_bytes_per_s"])


def read(run):
    t = run.trace
    least = least_seconds(run.config, run.traffic, run.peaks)
    if t is None or least is None or not t.ids:
        return None
    measured = t.ranges["bench.sketch"]["device_s"] / t.ids
    if measured <= 0:
        return None
    return 100.0 * least / measured
