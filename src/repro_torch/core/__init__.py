"""Numeric core: flexible formats, the R2F2 multiplier, and the precision policy."""

from .flexformat import FlexFormat, quantize_em, quantize_em_with_flags, unbiased_exponent
from .policy import (
    KNOWN_MODES,
    PRESETS,
    PrecisionConfig,
    RangeTracker,
    adjust_step,
    evidence_k_need,
    tracker_init,
    tracker_k,
    tracker_observe,
    tracker_update,
)
from .r2f2 import op_bounds, product_guard_bits, r2f2_multiply, select_k, select_k_op, select_k_operand

__all__ = [
    "FlexFormat",
    "quantize_em",
    "quantize_em_with_flags",
    "unbiased_exponent",
    "product_guard_bits",
    "op_bounds",
    "select_k",
    "select_k_op",
    "select_k_operand",
    "r2f2_multiply",
    "PrecisionConfig",
    "PRESETS",
    "KNOWN_MODES",
    "RangeTracker",
    "tracker_init",
    "adjust_step",
    "evidence_k_need",
    "tracker_observe",
    "tracker_update",
    "tracker_k",
]
