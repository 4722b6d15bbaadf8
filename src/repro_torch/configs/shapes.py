"""Assigned input shapes and the (arch x shape) applicability matrix.

LM transformer shapes are seq_len x global_batch. ``decode_*``/``long_*``
lower ``serve_step`` (one token against a seq_len KV cache), not
``train_step``. Skip rules (recorded per cell in EXPERIMENTS.md):
  - encoder-only archs have no decode step  -> skip decode_32k, long_500k
  - long_500k needs sub-quadratic attention -> runs only for SSM/hybrid
    (xlstm: pure recurrence; jamba: windowed attention), skipped for pure
    full-attention archs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.models.config import ModelConfig

__all__ = ["ShapeConfig", "SHAPES", "applicability", "cell_window"]


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def applicability(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """None if the cell runs; otherwise the skip reason."""
    if cfg.encoder_only and shape.kind == "decode":
        return "encoder-only: no autoregressive decode step"
    if shape.name == "long_500k":
        if cfg.is_recurrent_only:
            return None  # O(1) state
        if "mamba" in "".join(cfg.pattern):
            return None  # hybrid: windowed attention + recurrent state
        return "pure full-attention arch: long_500k needs sub-quadratic attention"
    return None


def cell_window(cfg: ModelConfig, shape: ShapeConfig) -> Optional[int]:
    """Sliding window used for a cell (jamba long-context mode)."""
    if shape.name == "long_500k" and cfg.has_attn:
        return 4096
    return cfg.window
