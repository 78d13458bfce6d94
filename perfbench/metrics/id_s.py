"""``id_s``: the window's seconds over the IDs completed in it, the time to
a decomposition under a closed loop with one caller (host clock)."""


def read(run):
    done = run.attempted - run.failed
    return run.window_s / done if done else None
