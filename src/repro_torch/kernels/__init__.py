"""Hand-written Hopper kernels of the port, one package per TPU kernel:
``kernel.py`` (ctypes wrapper and launch count), ``ref.py`` (the plain
PyTorch version) and ``ops.py`` (checks and dispatch: CPU tensors take the
plain version, CUDA tensors the kernel)."""
from .cgs import panel_deflate, project_out

__all__ = ["project_out", "panel_deflate"]
