"""PrecisionPolicy artifacts (the port of ``repro/profile/artifact.py``):
per-site flexible splits derived from a range profile, as schema-versioned
JSON. The schema is ``repro``'s, so a policy saved by either package loads
in the other.

Consumers: ``Simulation.run(..., policy=...)`` (tracked runs start their
tracker at the artifact's per-site ``k`` and clamp re-picks to its
``[k_lo, k_hi]`` hints; with ``prec.pinned`` the static profiled
deployment) and ``repro_torch.serve.generate(..., policy=...)``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.flexformat import FlexFormat
from repro_torch.core.policy import PrecisionConfig

__all__ = ["SCHEMA", "SCHEMA_VERSION", "PrecisionPolicy", "resolve_policy"]

SCHEMA = "repro.profile/policy"
SCHEMA_VERSION = 1


@dataclasses.dataclass
class PrecisionPolicy:
    """Per-site static precision derived from a range profile: ``sites``
    maps a site name to ``{"k", "k_lo", "k_hi"}`` (the converged split, and
    the least and most instantaneous need over the run)."""

    stepper: str
    fmt: FlexFormat
    sites: Dict[str, Dict[str, int]]
    ema: float = 0.95
    headroom: int = 1
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    validation: Optional[Dict[str, Any]] = None

    @property
    def accepted(self) -> bool:
        """Did the closed-loop validation replay stamp this artifact?"""
        return bool(self.validation and self.validation.get("accepted"))

    @property
    def site_names(self) -> Tuple[str, ...]:
        return tuple(self.sites)

    def _site(self, name: str) -> Dict[str, int]:
        try:
            return self.sites[name]
        except KeyError:
            raise KeyError(f"policy for {self.stepper!r} has no site {name!r}; covered sites: {list(self.sites)}") from None

    def k_array(self, sites: Optional[Sequence[str]] = None) -> np.ndarray:
        """Per-site tuned splits ordered like ``sites`` (default: the
        artifact's own order): a tracker's ``k0``."""
        names = self.site_names if sites is None else tuple(sites)
        return np.asarray([self._site(n)["k"] for n in names], np.int32)

    def bounds(self, sites: Optional[Sequence[str]] = None) -> Tuple[Tuple[int, int], ...]:
        """Per-site ``(k_lo, k_hi)`` hints for ``PrecisionConfig.k_bounds``."""
        names = self.site_names if sites is None else tuple(sites)
        return tuple((self._site(n)["k_lo"], self._site(n)["k_hi"]) for n in names)

    def apply(self, prec: PrecisionConfig, sites: Optional[Sequence[str]] = None) -> PrecisionConfig:
        """Config with this policy's hints installed (ordered by ``sites``);
        refuses a format mismatch."""
        if prec.fmt != self.fmt:
            raise ValueError(
                f"policy was profiled for fmt {self.fmt} but the run uses {prec.fmt}; re-profile or match the format"
            )
        return dataclasses.replace(prec, k_bounds=self.bounds(sites))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema": SCHEMA,
            "schema_version": SCHEMA_VERSION,
            "stepper": self.stepper,
            "fmt": {"eb": self.fmt.eb, "mb": self.fmt.mb, "fx": self.fmt.fx},
            "ema": self.ema,
            "headroom": self.headroom,
            "sites": {n: {k: int(v) for k, v in d.items()} for n, d in self.sites.items()},
            "meta": self.meta,
            "validation": self.validation,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "PrecisionPolicy":
        if d.get("schema") != SCHEMA:
            raise ValueError(f"not a {SCHEMA} artifact: schema={d.get('schema')!r}")
        ver = d.get("schema_version")
        if not isinstance(ver, int) or ver < 1 or ver > SCHEMA_VERSION:
            raise ValueError(f"unsupported {SCHEMA} schema_version {ver!r} (this build reads <= {SCHEMA_VERSION})")
        fmt = d["fmt"]
        return cls(
            stepper=d["stepper"],
            fmt=FlexFormat(int(fmt["eb"]), int(fmt["mb"]), int(fmt["fx"])),
            sites={n: {k: int(v) for k, v in s.items()} for n, s in d["sites"].items()},
            ema=float(d.get("ema", 0.95)),
            headroom=int(d.get("headroom", 1)),
            meta=dict(d.get("meta") or {}),
            validation=d.get("validation"),
        )

    def save(self, path: str) -> str:
        """Write the artifact (parent directories created); returns ``path``."""
        payload = self.to_dict()
        payload.setdefault("meta", {}).setdefault("created_unix", time.time())
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        return path

    @classmethod
    def load(cls, path: str) -> "PrecisionPolicy":
        with open(path) as f:
            return cls.from_dict(json.load(f))


def resolve_policy(prec: PrecisionConfig, policy, require_accepted: bool = True) -> Tuple[PrecisionConfig, PrecisionPolicy]:
    """A consumer's precision from a PrecisionPolicy artifact (or a path to
    its JSON): refuses an artifact no validation accepted (unless
    ``require_accepted=False``) and re-bases ``prec`` on its format. The
    per-site hints stay on the returned artifact: they apply only where a
    consumer threads a tracker with the producer's site names."""
    if isinstance(policy, (str, os.PathLike)):
        policy = PrecisionPolicy.load(os.fspath(policy))
    if require_accepted and not policy.accepted:
        raise ValueError(
            f"policy artifact for {policy.stepper!r} was never accepted by a validation replay; "
            "re-run `python -m repro_torch.profile` or pass require_accepted=False"
        )
    return dataclasses.replace(prec, fmt=policy.fmt), policy
