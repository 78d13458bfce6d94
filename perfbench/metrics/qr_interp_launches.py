"""``qr_interp_launches``: kernels launched inside the range
``bench.qr_interp`` per traced ID (copies and sets not counted; profiler
trace)."""


def read(run):
    t = run.trace
    if t is None or not t.ids or t.busy_s <= 0:
        return None
    return t.ranges["bench.qr_interp"]["launches"] / t.ids
