"""Atomic async checkpointing of the PyTorch port (save / restore)."""

from .manager import CheckpointManager, load_pytree, save_pytree

__all__ = ["CheckpointManager", "save_pytree", "load_pytree"]
