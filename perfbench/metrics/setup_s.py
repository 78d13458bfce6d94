"""``setup_s``: from the start of the harness's process to the window's
start: torch, the CUDA context, the program's kernel library (built in the
checkout on a first run), the matrix made on the device and the warm-up
IDs (host clock)."""


def read(run):
    return run.setup_s
