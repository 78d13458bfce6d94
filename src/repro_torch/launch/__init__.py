"""Entry points of the port (counterpart of ``repro.launch``): serving,
and the training step and loop."""
