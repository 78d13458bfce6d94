"""``peak_gb``: ``torch.cuda.max_memory_allocated()`` over the window, the
matrix included, after a reset at the window's start (1e9 bytes)."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
