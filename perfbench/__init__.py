"""The benchmark of the PyTorch and CUDA port (``repro_torch``): the
paper's randomized ID at its Table rows, timed on the chip, each run's
answers held to a plain reference.  ``run.py`` runs one cell; see
``README.md``."""
