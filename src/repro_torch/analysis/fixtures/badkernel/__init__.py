"""Deliberately hostile kernel package (counterpart of
``repro.analysis.fixtures.badkernel``): its contract example declares a
launch whose shared memory (the whole 64 MiB operand per block) is far
over one Hopper block's 232448 B.  The contract checker must flag it
(``kernels.smem-overflow``): the runner's kernel-side positive control.
Its CUDA kernel (``big_copy.cu``) is built into a library of its own."""
