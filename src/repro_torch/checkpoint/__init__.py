"""Checkpoints of the port (counterpart of ``repro.checkpoint``)."""
from .store import (CheckpointManager, latest_step, restore_pytree,
                    save_pytree)

__all__ = ["save_pytree", "restore_pytree", "latest_step",
           "CheckpointManager"]
