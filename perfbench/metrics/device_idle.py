"""``device_idle``: the share of the traced IDs' wall time (first ID's start
to last ID's end, waits included) in which no operation ran on the device:
the union of the operations' intervals, so overlaps count once (%)."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * t.idle_share
