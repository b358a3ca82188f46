"""Assigned input shapes (one set, shared by every LM arch).

``train_4k``   -> train step;  ``prefill_32k`` -> prefill step;
``decode_32k`` / ``long_500k`` -> serve step (one token, KV cache of
seq_len).  ``long_500k`` requires sub-quadratic attention.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

SHAPE_NAMES = list(SHAPES)


def shape_applicable(cfg, shape: ShapeSpec) -> bool:
    """long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k":
        return cfg.sub_quadratic
    return True
