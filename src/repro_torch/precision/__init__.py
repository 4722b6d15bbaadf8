"""repro_torch.precision: the single integration point for precision math.

    from repro_torch.precision import PRESETS, multiply, divide

    prec = PRESETS["r2f2_16"]
    p = multiply(alpha, lap, prec, site="heat.flux")

Tracked modes thread a :class:`SiteTracker` through the same calls and get
``(out, tracker)`` back; with ``tracker=None`` the functions return the
array alone.
"""

from __future__ import annotations

from repro_torch.core.flexformat import FlexFormat
from repro_torch.core.policy import PRESETS, PrecisionConfig, RangeTracker, adjust_step, tracker_init

from . import engines as _engines  # noqa: F401 (registers the six builtins)
from .engine import PrecisionEngine
from .fusion import FUSED_FAMILIES, fold_evidence, fused_eligible, fused_family
from .registry import get_engine, is_known_mode, known_modes, register_engine
from .sites import SiteTracker, resolve_site, site_tracker_init

__all__ = [
    "PrecisionEngine",
    "register_engine",
    "get_engine",
    "known_modes",
    "is_known_mode",
    "SiteTracker",
    "site_tracker_init",
    "resolve_site",
    "FUSED_FAMILIES",
    "fused_family",
    "fused_eligible",
    "fold_evidence",
    "prepare_operand",
    "multiply",
    "add",
    "divide",
    "rsqrt",
    "store",
    "contract",
    "FlexFormat",
    "PrecisionConfig",
    "PRESETS",
    "RangeTracker",
    "adjust_step",
    "tracker_init",
]


def _ret(out, tracker_out, tracker):
    return (out, tracker_out) if tracker is not None else out


def prepare_operand(x, cfg, *, k=None):
    """Policy-round one operand (LM path; raises until it is ported)."""
    return get_engine(cfg).prepare_operand(x, cfg, k=k)


def multiply(a, b, cfg, *, tracker=None, site=None):
    """Elementwise product on the policy's multiplier."""
    return _ret(*get_engine(cfg).multiply(a, b, cfg, tracker=tracker, site=site), tracker)


def add(a, b, cfg, *, tracker=None, site=None):
    """Elementwise sum on the policy's adder."""
    return _ret(*get_engine(cfg).add(a, b, cfg, tracker=tracker, site=site), tracker)


def divide(a, b, cfg, *, tracker=None, site=None):
    """Elementwise quotient on the policy's divider."""
    return _ret(*get_engine(cfg).divide(a, b, cfg, tracker=tracker, site=site), tracker)


def rsqrt(x, cfg, *, tracker=None, site=None):
    """Elementwise reciprocal square root on the policy's datapath."""
    return _ret(*get_engine(cfg).rsqrt(x, cfg, tracker=tracker, site=site), tracker)


def store(x, cfg):
    """Round state to the policy's storage format."""
    return get_engine(cfg).store(x, cfg)


def contract(spec, a, b, cfg, *, tracker=None, site=None, shared_k=False):
    """Einsum with policy operands (LM path; raises until it is ported)."""
    return get_engine(cfg).contract(spec, a, b, cfg, tracker=tracker, site=site, shared_k=shared_k)
