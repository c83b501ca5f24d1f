"""Deterministic, restartable synthetic-token data pipeline (the port's
counterpart of ``repro.data``)."""
from .pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]
