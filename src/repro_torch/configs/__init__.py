"""Architecture registry of the port: ``--arch <id>`` selectable configs,
the ten families of the reference registry (each config a copy of the
reference's), and ``input_specs``: the batch of an (arch x shape) cell."""
from __future__ import annotations

import dataclasses

import torch

from ..models.config import ModelConfig
from . import (chatglm3_6b, gemma3_1b, hymba_1_5b, llama32_vision_11b,
               llama4_scout_17b_a16e, mamba2_130m, mixtral_8x22b,
               musicgen_large, qwen3_32b, stablelm_12b)
from .shapes import SHAPE_NAMES, SHAPES, ShapeSpec, shape_applicable

_MODULES = {
    "hymba-1.5b": hymba_1_5b,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e,
    "mixtral-8x22b": mixtral_8x22b,
    "gemma3-1b": gemma3_1b,
    "chatglm3-6b": chatglm3_6b,
    "stablelm-12b": stablelm_12b,
    "qwen3-32b": qwen3_32b,
    "llama-3.2-vision-11b": llama32_vision_11b,
    "mamba2-130m": mamba2_130m,
    "musicgen-large": musicgen_large,
}

# families of the reference registry whose paths are not ported: none
NOT_PORTED = ()

ARCH_NAMES = list(_MODULES)


def _module(arch: str):
    if arch in _MODULES:
        return _MODULES[arch]
    raise KeyError(f"unknown arch {arch!r}; ported: {ARCH_NAMES}")


def get_config(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).FULL
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def smoke_config(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).SMOKE
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def input_specs(cfg: ModelConfig, shape: ShapeSpec, device="meta"):
    """The inputs of the step of this (arch, shape) as tensors on
    ``device`` (default the meta device: shapes and types, no memory):
    ``tokens`` int32 ``[B, S]`` (audio ``[B, S, K]``; decode ``S = 1``)
    and, to train or prefill a vision model, the stub's encoder states
    ``vision [B, cross_tokens, d]`` in the activation type.  Values are
    left unset."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind not in ("train", "prefill", "decode"):
        raise ValueError(shape.kind)

    def tokens(b, s):
        extra = (cfg.codebooks,) if cfg.frontend == "audio" else ()
        return torch.empty(b, s, *extra, dtype=torch.int32, device=device)

    if shape.kind == "decode":
        return {"tokens": tokens(B, 1)}
    batch = {"tokens": tokens(B, S)}
    if cfg.frontend == "vision":
        batch["vision"] = torch.empty(B, cfg.cross_tokens, cfg.d_model,
                                      dtype=cfg.activation_dtype,
                                      device=device)
    return batch


__all__ = ["ARCH_NAMES", "NOT_PORTED", "get_config", "smoke_config",
           "input_specs",
           "SHAPES", "SHAPE_NAMES", "ShapeSpec", "shape_applicable"]
