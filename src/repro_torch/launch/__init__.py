"""Entry points of the port (counterpart of ``repro.launch``): so far the
serving driver."""
