"""Assigned input-shape set (LM transformer shapes: seq_len x global_batch).

``decode_*`` / ``long_*`` lower ``serve_step`` (one new token against a KV
cache of seq_len); the others lower ``train_step``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_is_runnable(arch_family: str, shape: ShapeConfig,
                     sub_quadratic: bool) -> tuple[bool, str]:
    """Spec-mandated skips. Returns (runnable, reason_if_not)."""
    if arch_family == "encoder" and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not sub_quadratic:
        return False, "long_500k requires sub-quadratic attention (spec skip)"
    return True, ""
