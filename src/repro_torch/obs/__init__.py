"""repro_torch.obs: the observability the service, solver and kernel planes
report into (DESIGN.md §15), as ``repro.obs`` has it.

* :mod:`repro_torch.obs.trace`: nestable spans and lifecycle instants with
  a process-wide sampled recorder; Chrome-trace/Perfetto JSON export.
* :mod:`repro_torch.obs.metrics`: named counters, gauges and histograms
  with label sets; Prometheus text and JSON export, strict parser.
* :mod:`repro_torch.obs.precision`: per-site carried-k time series, §5.3
  grow/shrink counters and evidence coverage, drained from trackers.
* :mod:`repro_torch.obs.timing`: the timing helper with a compile/execute
  split that synchronizes the card before it reads the clock.
* :mod:`repro_torch.obs.health`: the live numerics-health monitor the
  service reports into (DESIGN.md §16): anomaly detectors over the
  telemetry and the streamed frames, SLO rules, the shadow oracle, the
  flight recorder; ``python -m repro_torch.obs.health`` (report,
  ``--watch``, ``--smoke``).
* :mod:`repro_torch.obs.shadow`: deterministic shadow-oracle sampling, f32
  replays of served requests (``Simulation.oracle_replay``) and the rel-L2
  drift.
* :mod:`repro_torch.obs.flightrec`: the bounded flight recorder and its
  strict loader (``repro``'s schema, so dumps load in either package).
* :mod:`repro_torch.obs.server`: the stdlib HTTP scrape endpoint
  (``/metrics``, ``/health``, ``/telemetry``).
* ``python -m repro_torch.obs``: the headless reporter over exported
  artifacts, and the ``--smoke`` gate.

The passivity contract
----------------------

Instrumentation observes values the program already has and never feeds
anything back: spans and metrics are host-side Python, and a telemetry
drain copies a tracker to the host. A run is bit-identical with
observability on or off (``tests/test_torch_obs.py``, and ``chip_smoke.py``
on the card). ``repro``'s guard refuses jax tracers; the port traces
nothing, so its guard refuses only tensors on the ``meta`` device, which
hold no values. When observability is disabled (the default) every hook is
a no-op: :func:`span` returns a shared null context manager and the
counters return before any lookup.

Usage::

    import repro_torch.obs as obs

    obs.enable(sample=1.0)
    ... run / serve ...
    paths = obs.export("artifacts/obs")   # trace.json, metrics.prom, ...
    obs.disable()
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from .metrics import (  # noqa: F401  (re-exported)
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    parse_prometheus,
)
from .precision import PrecisionTelemetry, load_telemetry  # noqa: F401
from .timing import Timing, measure  # noqa: F401
from .trace import NULL_SPAN, Span, Tracer, load_trace  # noqa: F401

__all__ = [
    "Observability",
    "enable",
    "disable",
    "active",
    "enabled",
    "span",
    "instant",
    "inc",
    "observe",
    "set_gauge",
    "record_tracker",
    "export",
    # re-exports
    "Tracer",
    "Span",
    "NULL_SPAN",
    "load_trace",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "parse_prometheus",
    "PrecisionTelemetry",
    "load_telemetry",
    "Timing",
    "measure",
]


class Observability:
    """One enabled observability scope: a tracer, a metrics registry and a
    precision-telemetry accumulator."""

    def __init__(
        self,
        trace: bool = True,
        telemetry: bool = True,
        sample: float = 1.0,
        capacity: int = 65536,
        registry: Optional[MetricsRegistry] = None,
    ):
        self.tracer: Optional[Tracer] = (
            Tracer(sample=sample, capacity=capacity) if trace else None
        )
        self.registry: MetricsRegistry = registry or MetricsRegistry()
        self.telemetry: Optional[PrecisionTelemetry] = (
            PrecisionTelemetry() if telemetry else None
        )

    def export(self, out_dir: str) -> Dict[str, str]:
        """Write every artifact under ``out_dir``; returns name -> path."""
        os.makedirs(out_dir, exist_ok=True)
        paths: Dict[str, str] = {}
        if self.tracer is not None:
            paths["trace"] = self.tracer.save(os.path.join(out_dir, "trace.json"))
        prom = os.path.join(out_dir, "metrics.prom")
        mjson = os.path.join(out_dir, "metrics.json")
        self.registry.save(prom_path=prom, json_path=mjson)
        paths["prometheus"] = prom
        paths["metrics_json"] = mjson
        if self.telemetry is not None:
            paths["telemetry"] = self.telemetry.save(
                os.path.join(out_dir, "telemetry.json")
            )
        return paths


_OBS: Optional[Observability] = None


def enable(
    trace: bool = True,
    telemetry: bool = True,
    sample: float = 1.0,
    capacity: int = 65536,
    registry: Optional[MetricsRegistry] = None,
) -> Observability:
    """Turn on process-wide observability (idempotent: replaces any prior
    scope). ``sample`` thins top-level spans deterministically."""
    global _OBS
    _OBS = Observability(
        trace=trace,
        telemetry=telemetry,
        sample=sample,
        capacity=capacity,
        registry=registry,
    )
    return _OBS


def disable() -> None:
    """Turn observability off; every hook reverts to its no-op fast path."""
    global _OBS
    _OBS = None


def active() -> Optional[Observability]:
    """The enabled scope, or None."""
    return _OBS


def enabled() -> bool:
    return _OBS is not None


# ---------------------------------------------------------------------------
# instrumentation hooks — no-ops unless enable() was called
# ---------------------------------------------------------------------------

def span(name: str, **args):
    """A tracing span context manager (NULL_SPAN when disabled)."""
    o = _OBS
    if o is None or o.tracer is None:
        return NULL_SPAN
    return o.tracer.span(name, **args)


def instant(name: str, **args) -> None:
    """A zero-duration lifecycle event."""
    o = _OBS
    if o is not None and o.tracer is not None:
        o.tracer.instant(name, **args)


def inc(name: str, amount: float = 1, help: str = "", **labels) -> None:
    """Bump a counter on the active registry."""
    o = _OBS
    if o is not None:
        o.registry.counter(name, help).inc(amount, **labels)


def observe(name: str, value: float, help: str = "", **labels) -> None:
    """Record a histogram observation on the active registry."""
    o = _OBS
    if o is not None:
        o.registry.histogram(name, help).observe(value, **labels)


def set_gauge(name: str, value: float, help: str = "", **labels) -> None:
    """Set a gauge on the active registry."""
    o = _OBS
    if o is not None:
        o.registry.gauge(name, help).set(value, **labels)


def _concrete(tree) -> bool:
    """True iff no leaf of ``tree`` is a tensor on the ``meta`` device (a
    shape without values, as a checkpoint template holds)."""
    from repro_torch import _tree

    return not any(getattr(leaf, "is_meta", False) for _, leaf in _tree.flatten(tree))


def record_tracker(scope: str, tracker, step: int) -> None:
    """Drain a carried SiteTracker's (k, grow, shrink) into the telemetry
    series at ``step``, one copy to the host. No-op when disabled, when
    ``tracker`` is None, or when its rows hold no values (``meta``)."""
    o = _OBS
    if o is None or o.telemetry is None or tracker is None:
        return
    if not _concrete(tracker):
        return
    o.telemetry.record_tracker(scope, tracker, step)


def export(out_dir: str) -> Dict[str, str]:
    """Export the active scope's artifacts (raises if disabled)."""
    if _OBS is None:
        raise RuntimeError("repro_torch.obs is not enabled; call repro_torch.obs.enable() first")
    return _OBS.export(out_dir)
