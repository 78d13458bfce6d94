"""``qr_interp_ms``: device time of the operations launched inside the
range ``bench.qr_interp`` (``core/qr.py`` with ``panel_step``, the
interpolation solve, the gather ``B = A[:, J]``), per traced ID (profiler
trace)."""


def read(run):
    t = run.trace
    if t is None or not t.ids or t.busy_s <= 0:
        return None
    return 1e3 * t.ranges["bench.qr_interp"]["device_s"] / t.ids
