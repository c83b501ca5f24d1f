"""Optimizers and the cross-pod gradient compression (the port's
counterpart of ``repro.optim``)."""
from . import adamw
from .adamw import AdamWConfig

__all__ = ["adamw", "AdamWConfig"]
