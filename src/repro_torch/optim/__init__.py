"""Optimizer of the port's training path: AdamW as the reference forms
it."""
from .adam import AdamState, AdamW, clip_by_global_norm, global_norm

__all__ = ["AdamW", "AdamState", "global_norm", "clip_by_global_norm"]
