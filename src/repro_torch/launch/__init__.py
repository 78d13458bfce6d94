"""Entry points of the port (counterpart of ``repro.launch``): serving,
the training step and loop, and sharding over a device mesh (meshes, the
layout rules, the sharded steps, the input-shape grid and the dry-run)."""
