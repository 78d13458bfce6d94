"""``sketch_ms``: device time of the operations launched inside the range
``bench.sketch`` (``core/sketch.py``: the operator's draw, ``sketch_accum``
or ``torch.fft``, the scale), per traced ID (profiler trace)."""


def read(run):
    t = run.trace
    if t is None or not t.ids or t.busy_s <= 0:
        return None
    return 1e3 * t.ranges["bench.sketch"]["device_s"] / t.ids
