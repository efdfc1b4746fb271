"""Synthetic token data (numpy), the port's copy of `repro.data`."""
from .pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]
