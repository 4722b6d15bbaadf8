"""Precision telemetry: per-site carried-k time series, §5.3 counters,
evidence-coverage fractions, drained from trackers at chunk boundaries.

The adjust unit's state (the flexible split ``k``, the exponent EMAs, the
§5.3 grow/shrink counters) exists on every plane; :class:`PrecisionTelemetry`
watches it, per ``(scope, site)``:

* the **k time series**: ``(step, k)`` samples at chunk boundaries;
* the **adjustment counters**: cumulative ``grew``/``shrank`` at each
  sample (the paper's §5.3 adjustment statistics as a trajectory);
* optionally a **coverage fraction**: how many of the run's multiply/op
  issues the final carried split covers without an adjust event, computed
  from the capture plane's evidence stream.

Two feeding paths, both passive (DESIGN.md §15):

* the **service plane** drains each member's carried tracker right after a
  bucket chunk returns (:meth:`record_tracker`: one copy to the host per
  drain);
* the **solver planes** record the final tracker after ``Simulation.run``
  and, when the run captured range evidence, reconstruct the series at
  every chunk boundary by replaying the captured evidence through the
  adjust law itself (:func:`replay_k_series` drives
  ``repro_torch.precision.fold_evidence``, the same §5.3 law every plane
  applies): no new kernel outputs.

The artifact's schema is ``repro.obs``'s, so either package loads the
other's. Module-level imports are numpy-only; the replay imports the port's
precision modules when it runs, so the reporter loads exported telemetry on
a machine without PyTorch.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "PrecisionTelemetry",
    "SiteSeries",
    "replay_k_series",
    "coverage_fraction",
    "load_telemetry",
]

SCHEMA = "repro.obs/telemetry@1"


class SiteSeries:
    """One (scope, site) trajectory: parallel step/k/grew/shrank lists."""

    __slots__ = ("scope", "site", "steps", "k", "grew", "shrank", "coverage")

    def __init__(self, scope: str, site: str):
        self.scope = scope
        self.site = site
        self.steps: List[int] = []
        self.k: List[int] = []
        self.grew: List[int] = []
        self.shrank: List[int] = []
        self.coverage: Optional[float] = None  # at the final carried k

    def append(self, step: int, k: int, grew: int, shrank: int) -> None:
        self.steps.append(int(step))
        self.k.append(int(k))
        self.grew.append(int(grew))
        self.shrank.append(int(shrank))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "scope": self.scope,
            "site": self.site,
            "steps": self.steps,
            "k": self.k,
            "grew": self.grew,
            "shrank": self.shrank,
            "coverage": self.coverage,
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SiteSeries":
        s = cls(d["scope"], d["site"])
        s.steps = [int(x) for x in d["steps"]]
        s.k = [int(x) for x in d["k"]]
        s.grew = [int(x) for x in d["grew"]]
        s.shrank = [int(x) for x in d["shrank"]]
        s.coverage = d.get("coverage")
        return s

    def __repr__(self) -> str:
        ks = "->".join(str(k) for k in self.k) or "?"
        return f"SiteSeries({self.scope}:{self.site}, k {ks})"


class PrecisionTelemetry:
    """The accumulator (see module docstring). Keyed by (scope, site)."""

    def __init__(self):
        self._series: Dict[Tuple[str, str], SiteSeries] = {}
        self._scope_seq: Dict[str, int] = {}

    # -- recording -----------------------------------------------------------

    def series(self, scope: str, site: str) -> SiteSeries:
        key = (scope, site)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = SiteSeries(scope, site)
        return s

    def unique_scope(self, prefix: str) -> str:
        """A fresh scope name under ``prefix`` (``sim:heat1d``,
        ``sim:heat1d#2``, ...) so repeated solo runs never interleave."""
        n = self._scope_seq.get(prefix, 0) + 1
        self._scope_seq[prefix] = n
        return prefix if n == 1 else f"{prefix}#{n}"

    def record_tracker(self, scope: str, tracker, step: int) -> None:
        """Drain one SiteTracker snapshot at ``step``: its rows come to the
        host in one copy. Safe to call with ``tracker=None`` (no-op)."""
        if tracker is None:
            return
        st = tracker.state
        k, grew, shrank = (_host(x) for x in (st.k, st.overflow_steps, st.shrink_steps))
        for i, name in enumerate(tracker.names):
            self.series(scope, name).append(step, k[i], grew[i], shrank[i])

    def record_series(
        self,
        scope: str,
        sites: Sequence[str],
        steps: Sequence[int],
        k: np.ndarray,
        grew: np.ndarray,
        shrank: np.ndarray,
        coverage: Optional[Dict[str, float]] = None,
    ) -> None:
        """Install a whole reconstructed trajectory (``k``/``grew``/
        ``shrank`` are ``(n_boundaries, n_sites)``)."""
        for j, name in enumerate(sites):
            s = self.series(scope, name)
            for b, step in enumerate(steps):
                s.append(step, k[b, j], grew[b, j], shrank[b, j])
            if coverage is not None and name in coverage:
                s.coverage = float(coverage[name])

    # -- views / export ------------------------------------------------------

    def scopes(self) -> List[str]:
        return sorted({scope for scope, _ in self._series})

    def all_series(self) -> List[SiteSeries]:
        return [self._series[k] for k in sorted(self._series)]

    def k_series(self, scope: str, site: str) -> Tuple[np.ndarray, np.ndarray]:
        s = self._series[(scope, site)]
        return np.asarray(s.steps, np.int64), np.asarray(s.k, np.int64)

    def final_k(self, scope: str) -> Dict[str, int]:
        return {
            site: s.k[-1]
            for (sc, site), s in sorted(self._series.items())
            if sc == scope and s.k
        }

    def to_dict(self) -> Dict[str, Any]:
        return {"schema": SCHEMA, "series": [s.to_dict() for s in self.all_series()]}

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)
        return path

    def __len__(self) -> int:
        return len(self._series)


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def load_telemetry(path: str) -> PrecisionTelemetry:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != SCHEMA:
        raise ValueError(
            f"{path}: unknown telemetry schema {doc.get('schema')!r} "
            f"(expected {SCHEMA})"
        )
    t = PrecisionTelemetry()
    for d in doc["series"]:
        t._series[(d["scope"], d["site"])] = SiteSeries.from_dict(d)
    return t


# ---------------------------------------------------------------------------
# evidence replay: the chunk-boundary k series, from the capture stream
# ---------------------------------------------------------------------------

def replay_k_series(
    evidence,
    prec,
    sites: Sequence[str],
    site_ops: Optional[Sequence[str]] = None,
    every: int = 1,
    k0=None,
    tracker0=None,
):
    """Replay a captured per-substep evidence stream through the §5.3
    adjust law, sampling tracker state at every chunk boundary.

    ``evidence`` is the capture plane's ``(steps, n_sites, 2)`` stream (a
    tensor on any device, or an array); ``every`` is the run's snapshot
    cadence (the chunk length: the boundaries the fused and megakernel
    planes fold at; a trailing remainder chunk is sampled too). ``k0``
    seeds the tracker as the run did (None = start wide); ``tracker0``
    instead resumes from a full carried SiteTracker (EMAs and §5.3 counters
    included).

    Returns ``(boundary_steps, k, grew, shrank)`` with the arrays shaped
    ``(n_boundaries, n_sites)``. :func:`repro_torch.precision.fold_evidence`
    replays each substep through the adjust law every plane applies, so
    the sampled k equals the run's carried tracker at every boundary, and
    ``repro``'s replay of the same evidence, bit for bit.
    """
    import torch

    from repro_torch.precision import site_tracker_init
    from repro_torch.precision.fusion import fold_evidence

    ev = _host(evidence).astype(np.float32)
    steps = ev.shape[0]
    if ev.ndim != 3 or ev.shape[1] != len(sites) or ev.shape[2] != 2:
        raise ValueError(
            f"evidence shape {ev.shape} does not match {len(sites)} sites"
        )
    every = max(1, int(every))
    ops = None if site_ops is None else tuple(site_ops)
    if tracker0 is not None:
        tr = tracker0.to("cpu")
    else:
        tr = site_tracker_init(
            tuple(sites), prec.fmt, k0=None if k0 is None else torch.as_tensor(_host(k0)), device="cpu"
        )
    out_steps, out_k, out_g, out_s = [], [], [], []
    for start in range(0, steps, every):
        chunk = torch.from_numpy(np.ascontiguousarray(ev[start : start + every]))
        tr = fold_evidence(tr, chunk, prec, ops=ops)
        out_steps.append(min(start + every, steps))
        out_k.append(_host(tr.state.k))
        out_g.append(_host(tr.state.overflow_steps))
        out_s.append(_host(tr.state.shrink_steps))
    return (
        out_steps,
        np.stack(out_k) if out_k else np.zeros((0, len(sites)), np.int32),
        np.stack(out_g) if out_g else np.zeros((0, len(sites)), np.int32),
        np.stack(out_s) if out_s else np.zeros((0, len(sites)), np.int32),
    )


def coverage_fraction(
    evidence,
    prec,
    sites: Sequence[str],
    k_final: Dict[str, int],
    site_ops: Optional[Sequence[str]] = None,
) -> Dict[str, float]:
    """Fraction of each site's issues its final carried split covers
    without an adjust event: ``mean(k_need <= k_final)`` over the captured
    evidence, each site judged under its own op envelope
    (:func:`repro_torch.core.policy.evidence_k_need`, the adjust unit's own
    per-issue statistic)."""
    import torch

    from repro_torch.core.policy import evidence_k_need

    ev = torch.from_numpy(np.ascontiguousarray(_host(evidence).astype(np.float32)))
    out = {}
    for j, name in enumerate(sites):
        if name not in k_final:
            continue
        op = "mul" if site_ops is None else site_ops[j]
        need = _host(evidence_k_need(ev[:, j, 0], ev[:, j, 1], prec, op))
        out[name] = float(np.mean(need <= int(k_final[name]))) if need.size else 1.0
    return out
