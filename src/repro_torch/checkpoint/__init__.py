"""Atomic keep-N checkpoints of the training state, in the reference
package's on-disk layout."""
from .manager import CheckpointManager, load_flat, save_flat

__all__ = ["CheckpointManager", "save_flat", "load_flat"]
