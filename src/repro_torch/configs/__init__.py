"""Architecture registry of the port: ``--arch <id>`` selectable configs.

Ported families: hymba-1.5b, mamba2-130m and gemma3-1b (their serving
paths need nothing beyond the port's LM slice).  The other families of
the reference registry raise ``NotImplementedError``; ROADMAP.md lists
what they wait for (MoE, vision cross-attention, the audio frontend).
"""
from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig
from . import gemma3_1b, hymba_1_5b, mamba2_130m
from .shapes import SHAPE_NAMES, SHAPES, ShapeSpec, shape_applicable

_MODULES = {
    "hymba-1.5b": hymba_1_5b,
    "gemma3-1b": gemma3_1b,
    "mamba2-130m": mamba2_130m,
}

# families of the reference registry whose paths are not ported yet
NOT_PORTED = ("llama4-scout-17b-a16e", "mixtral-8x22b", "chatglm3-6b",
              "stablelm-12b", "qwen3-32b", "llama-3.2-vision-11b",
              "musicgen-large")

ARCH_NAMES = list(_MODULES)


def _module(arch: str):
    if arch in _MODULES:
        return _MODULES[arch]
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported to repro_torch yet (see "
            f"ROADMAP.md, Queue A); ported: {ARCH_NAMES}")
    raise KeyError(f"unknown arch {arch!r}; ported: {ARCH_NAMES}")


def get_config(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).FULL
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def smoke_config(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).SMOKE
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


__all__ = ["ARCH_NAMES", "NOT_PORTED", "get_config", "smoke_config",
           "SHAPES", "SHAPE_NAMES", "ShapeSpec", "shape_applicable"]
