"""``id_p95_s``: the 95th percentile of the per-ID wall time, from the call
to the device's completion, over every ID of the window (host clock;
``statistics.quantiles``, inclusive method)."""
import statistics


def read(run):
    if len(run.walls) < 20:
        return None
    return statistics.quantiles(run.walls, n=20, method="inclusive")[18]
