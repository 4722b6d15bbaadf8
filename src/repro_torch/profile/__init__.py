"""repro_torch.profile: range-distribution capture, offline analysis, and
the precision-policy autotuner (the port of ``repro.profile``).

1. capture (:mod:`.capture`): per-site exponent histograms and the site
   evidence stream of ``Simulation.run(..., capture=True)`` on every plane;
2. analysis (:mod:`.analysis`): :class:`RangeProfile` and
   :class:`RangeReport`, the paper's Fig. 3/4 views;
3. autotune (:mod:`.autotune`): the evidence replayed through the adjust
   law into a :class:`PrecisionPolicy`, validated against the f32 oracle;
4. artifacts and the CLI (:mod:`.artifact`, ``python -m
   repro_torch.profile <stepper>``), consumed by ``Simulation.run(...,
   policy=...)`` and ``repro_torch.serve.generate(..., policy=...)``.
"""

from __future__ import annotations

from .capture import CaptureResult, CaptureSpec, exp_hist, pair_exp_hist, site_evidence
from .artifact import SCHEMA, SCHEMA_VERSION, PrecisionPolicy, resolve_policy
from .analysis import RangeProfile, RangeReport
from .autotune import synthesize_policy, tune_policy, validate_policy
from .pipeline import capture_profile

__all__ = [
    "CaptureSpec",
    "CaptureResult",
    "exp_hist",
    "pair_exp_hist",
    "site_evidence",
    "SCHEMA",
    "SCHEMA_VERSION",
    "PrecisionPolicy",
    "resolve_policy",
    "RangeProfile",
    "RangeReport",
    "synthesize_policy",
    "validate_policy",
    "tune_policy",
    "capture_profile",
]
