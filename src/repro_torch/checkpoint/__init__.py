"""Checkpointing with elastic restore (the port's counterpart of
``repro.checkpoint``), in the reference's on-disk format."""
from .checkpoint import CheckpointManager, latest_step, restore, save

__all__ = ["CheckpointManager", "save", "restore", "latest_step"]
