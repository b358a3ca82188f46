"""The training data pipeline: step-keyed synthetic or memory-mapped
token batches (numpy)."""
from .pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]
