"""repro_torch.obs.health: live numerics-health monitoring over the obs
registry, as ``repro.obs.health`` does it.

One :class:`HealthMonitor` rides a :class:`repro_torch.obs.Observability`
scope and layers four things on top of the recording substrate (DESIGN.md
§16):

* **anomaly detectors** over the precision-telemetry stream: pure,
  step-indexed functions of the per-(scope, site) series (no wall clock,
  no RNG): overflow-storm detection on §5.3 grow-counter rates *and* on
  non-finite fractions in streamed snapshot frames (a starved pinned
  deployment overflows without ever touching its grow counters: the
  adjust unit is out of the loop, so the state itself is the only
  witness); k-thrash detection on grow/shrink oscillation; evidence-
  coverage-drop alarms. The same telemetry stream always produces the
  same alert sequence (:func:`run_detectors` is the offline replay of the
  exact per-series law the live monitor applies incrementally).
* **shadow-oracle sampling** (:mod:`repro_torch.obs.shadow`): a
  deterministic low-rate sampler replays completed service requests at f32
  on the request's own device and books the rel-L2 drift into the
  error-budget metrics.
* a **declarative SLO rule set** (:class:`SLORule`) over rolling windows:
  p99 chunk latency (from the registry histogram via
  :func:`repro_torch.obs.metrics.histogram_quantile`, not the raw sample
  window), error-budget burn, thrash rate, queue depth, evaluated at
  chunk boundaries; breaches fire on the rising edge.
* a bounded **flight recorder** (:mod:`repro_torch.obs.flightrec`) dumped
  on any alert or request failure.

Alerts go four places at once: the monitor's ``alerts`` list, a
``health.alert`` instant in the trace, the ``repro_health_alerts_total``
counter, and a flight-recorder dump. ``python -m repro_torch.obs.health`` is
the operator surface: offline detector replay over exported artifacts,
``--watch`` (scrape server over an artifact directory), and ``--smoke``
(the gate: a clean burst must exit 0, ``--burst storm`` must exit
nonzero), on the CUDA card unless ``--device cpu`` is given.

Everything here is passive (DESIGN.md §15): the hooks observe host-side
values the service already holds (the batcher's frames are host numpy; a
tracker's splits come to the host in one ``.tolist()``, not one sync a
site); served states, snapshots and tracker bits are bit-identical with the
monitor on or off (``tests/test_torch_health.py``, and ``chip_smoke.py`` on
the card). A hook that fails raises into the service, as ``repro``'s do:
nothing is swallowed.

Cost: :meth:`HealthMonitor.sweep` recomputes every telemetry series'
detectors at every chunk (:func:`detect_series` is O(length) a series), as
``repro`` does; ``chip_smoke.py`` measures its share of chunk time on the
card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import repro_torch.obs as obs

from .flightrec import FlightRecorder, load_flightrec
from .precision import PrecisionTelemetry, SiteSeries
from .shadow import ShadowJob, ShadowSampler, nonfinite_fraction

__all__ = [
    "Alert",
    "SLORule",
    "DEFAULT_SLOS",
    "HealthConfig",
    "HealthMonitor",
    "detect_series",
    "run_detectors",
    "enable",
    "disable",
    "active",
]

VERDICT_SCHEMA = "repro.obs/health@1"


# ---------------------------------------------------------------------------
# alerts
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Alert:
    """One detector/SLO firing. ``step`` is the telemetry boundary step (or
    the chunk sequence number for SLO breaches) — never a wall-clock time,
    so alert sequences are comparable across runs."""

    kind: str  # overflow_storm | k_thrash | coverage_drop | slo_breach
    scope: str  # telemetry scope, request scope, or SLO rule name
    site: str  # site name ("" when not site-scoped)
    step: int
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def key(self) -> Tuple[str, str, str, int]:
        return (self.kind, self.scope, self.site, self.step)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        at = f"{self.scope}:{self.site}" if self.site else self.scope
        brief = ", ".join(f"{k}={v}" for k, v in sorted(self.detail.items()))
        return f"[{self.kind}] {at} @ step {self.step}" + (
            f" ({brief})" if brief else ""
        )


# ---------------------------------------------------------------------------
# declarative SLO rules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SLORule:
    """One service-level objective: ``metric op threshold`` over a rolling
    window. ``metric`` names a monitor-computed value:

    * ``chunk_latency_p<NN>_us`` — bucket-estimated latency percentile of
      the ``repro_service_chunk_latency_seconds`` histogram (µs);
    * ``error_budget_burn`` — fraction of recently shadowed requests whose
      rel-L2 drift exceeded ``HealthConfig.err_budget``;
    * ``thrash_rate`` — k-thrash alerts per chunk over the last ``window``
      chunks;
    * ``queue_depth`` — the scheduler's admission queue length.

    ``op`` is ``"<="`` or ``">="`` (the healthy direction). A NaN metric
    value (no data yet) never breaches.
    """

    name: str
    metric: str
    op: str
    threshold: float
    window: int = 32

    def __post_init__(self):
        if self.op not in ("<=", ">="):
            raise ValueError(f"SLO op must be '<=' or '>=', got {self.op!r}")
        if self.window <= 0:
            raise ValueError(f"SLO window must be positive: {self.window}")

    def ok(self, value: float) -> bool:
        if value != value:  # NaN: no data, no breach
            return True
        return value <= self.threshold if self.op == "<=" else value >= self.threshold

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SLORule":
        return cls(
            name=d["name"],
            metric=d["metric"],
            op=d["op"],
            threshold=float(d["threshold"]),
            window=int(d.get("window", 32)),
        )


#: default rule set — generous enough that a healthy smoke burst is silent,
#: tight enough that an overflowing one is not
DEFAULT_SLOS: Tuple[SLORule, ...] = (
    SLORule("chunk_latency", "chunk_latency_p99_us", "<=", 10e6),
    SLORule("error_budget", "error_budget_burn", "<=", 0.5),
    SLORule("thrash", "thrash_rate", "<=", 0.5),
    SLORule("queue", "queue_depth", "<=", 256.0),
)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Knobs of the monitoring plane (thresholds are per-window, windows
    are in telemetry boundary samples / chunks — never seconds)."""

    window: int = 8  # boundary samples per detector window
    grow_rate: float = 0.25  # §5.3 grow events per step that call a storm
    grow_min_events: int = 4  # ... with at least this many events in-window
    thrash_reversals: int = 3  # k direction reversals in-window
    coverage_min: float = 0.9  # evidence-coverage floor
    nonfinite_frac: float = 0.0  # frame non-finite fraction above this alerts
    shadow_rate: float = 0.0  # fraction of requests shadow-replayed at f32
    err_budget: float = 1e-2  # rel-L2 budget per shadowed request
    shadow_window: int = 64  # shadowed requests in the burn window
    slos: Tuple[SLORule, ...] = DEFAULT_SLOS
    flight_capacity: int = 512
    flight_dir: str = "artifacts/flightrec"
    max_dumps: int = 16


# ---------------------------------------------------------------------------
# detectors — pure functions of one telemetry series
# ---------------------------------------------------------------------------

def _reversals(ks: Sequence[int]) -> int:
    """Direction reversals in a k trajectory: the number of sign flips in
    the sequence of non-zero first differences (grow->shrink or
    shrink->grow counts one each)."""
    dirs = []
    for a, b in zip(ks, ks[1:]):
        d = (b > a) - (b < a)
        if d != 0:
            dirs.append(d)
    return sum(1 for a, b in zip(dirs, dirs[1:]) if a != b)


def detect_series(series: SiteSeries, config: HealthConfig) -> List[Alert]:
    """Every alert one (scope, site) series has earned, in boundary order.

    Pure and deterministic: depends only on the series' step-indexed
    samples and the config — no wall clock, no monitor state. Each kind
    fires at most once per series (at its first qualifying boundary), so
    the returned list only ever *grows* as the series grows; the live
    monitor exploits exactly that to emit incrementally
    (``offline[len(already_emitted):]`` is always the fresh suffix).
    """
    alerts: List[Alert] = []
    n = len(series.steps)
    W = max(1, config.window)
    fired_storm = fired_thrash = False
    for i in range(n):
        if fired_storm and fired_thrash:
            break
        lo = max(0, i - W + 1)
        base_g = series.grew[lo - 1] if lo > 0 else 0
        base_s = series.steps[lo - 1] if lo > 0 else 0
        dg = series.grew[i] - base_g
        ds = series.steps[i] - base_s
        if (
            not fired_storm
            and dg >= config.grow_min_events
            and ds > 0
            and dg / ds >= config.grow_rate
        ):
            fired_storm = True
            alerts.append(Alert(
                "overflow_storm", series.scope, series.site, series.steps[i],
                {"signal": "grow_rate", "grew": int(dg), "steps": int(ds),
                 "rate": dg / ds},
            ))
        if not fired_thrash:
            rev = _reversals(series.k[lo : i + 1])
            if rev >= config.thrash_reversals:
                fired_thrash = True
                alerts.append(Alert(
                    "k_thrash", series.scope, series.site, series.steps[i],
                    {"reversals": int(rev), "window": W,
                     "k": [int(k) for k in series.k[lo : i + 1]]},
                ))
    if (
        series.coverage is not None
        and series.coverage < config.coverage_min
        and series.steps
    ):
        alerts.append(Alert(
            "coverage_drop", series.scope, series.site, series.steps[-1],
            {"coverage": float(series.coverage),
             "floor": config.coverage_min},
        ))
    return alerts


def run_detectors(
    telemetry: PrecisionTelemetry, config: Optional[HealthConfig] = None
) -> List[Alert]:
    """Offline detector replay over a whole telemetry stream — series in
    sorted (scope, site) order, each through :func:`detect_series`. Used by
    the CLI report mode and the determinism tests: same stream in, same
    alert sequence out, always."""
    config = config or HealthConfig()
    out: List[Alert] = []
    for s in telemetry.all_series():
        out.extend(detect_series(s, config))
    return out


# ---------------------------------------------------------------------------
# the live monitor
# ---------------------------------------------------------------------------

class HealthMonitor:
    """The monitoring plane over one obs scope (see module docstring).

    Construct it after :func:`repro_torch.obs.enable` (or let
    :func:`enable` below do both) and **before** the
    :class:`~repro_torch.service.scheduler.SimService`, so the service's
    metrics land in the registry the SLO rules read.
    """

    def __init__(
        self,
        config: Optional[HealthConfig] = None,
        scope: Optional[obs.Observability] = None,
    ):
        self.config = config or HealthConfig()
        if scope is None:
            scope = obs.active() or obs.enable()
        self.obs = scope
        self.flight = FlightRecorder(capacity=self.config.flight_capacity)
        self.alerts: List[Alert] = []
        self.dump_paths: List[str] = []
        self._emitted: Dict[Tuple[str, str], int] = {}  # per-series alert count
        self._frame_alerted: set = set()  # request ids already frame-stormed
        self._slo_breached: Dict[str, bool] = {}
        self._slo_last: Dict[str, float] = {}
        self._chunk_seq = 0
        self._queue_depth = 0
        self._active_members = 0
        self._sampler = ShadowSampler(self.config.shadow_rate)
        self._pending: Dict[int, ShadowJob] = {}
        #: request id -> shadow rel-L2, for every completed shadow replay
        #: (the per-request view behind the rolling burn window; the bench
        #: suite attributes error budget to cells from it)
        self.shadow_rel: Dict[int, float] = {}
        self._shadow_window: Deque[Tuple[int, float]] = deque(
            maxlen=max(1, self.config.shadow_window)
        )
        self._thrash_seqs: Deque[int] = deque(maxlen=4096)
        reg = self.obs.registry
        self._alert_counter = reg.counter(
            "repro_health_alerts_total", "health alerts fired, by kind"
        )
        self._shadow_sampled = reg.counter(
            "repro_health_shadow_sampled_total", "requests shadow-replayed at f32"
        )
        self._shadow_breaches = reg.counter(
            "repro_health_shadow_breach_total",
            "shadow replays whose rel-L2 drift exceeded the error budget",
        )
        self._shadow_seconds = reg.counter(
            "repro_health_shadow_seconds_total", "wall seconds in shadow replays"
        )
        self._burn_gauge = reg.gauge(
            "repro_health_error_budget_burn",
            "breaching fraction of the recent shadow window",
        )
        self._rel_gauge = reg.gauge(
            "repro_health_shadow_rel_l2", "rel-L2 drift of the last shadow replay"
        )
        self._queue_gauge = reg.gauge(
            "repro_health_queue_depth", "admission queue length at last chunk"
        )
        self._latency_hist = reg.histogram(
            "repro_service_chunk_latency_seconds",
            "steady-state chunk wall time (compile calls excluded)",
        )

    # -- service hooks (all passive: they read host-side values only) --------

    def on_submit(self, rec) -> None:
        """Admission: record the lifecycle event and, when the deterministic
        sampler picks this request, capture its shadow job (host copies)."""
        self.flight.record(
            "submit", request=rec.id, bucket=rec.key.short(), steps=rec.steps
        )
        if self._sampler.pick():
            self._pending[rec.id] = ShadowJob.capture(rec)
            self.flight.record("shadow_pick", request=rec.id)

    def note_occupancy(self, queued: int, active: int) -> None:
        self._queue_depth = int(queued)
        self._active_members = int(active)
        self._queue_gauge.set(queued)

    def on_chunk(
        self, key, n_members: int, steps: int, seconds: float, compiled: bool
    ) -> None:
        """Chunk boundary: the evaluation point. Records the chunk (its
        number as ``chunk``: repro's ``seq=`` overwrites the recorder's own
        sequence number), sweeps the telemetry detectors, evaluates the SLO
        rules."""
        self._chunk_seq += 1
        self.flight.record(
            "chunk", chunk=self._chunk_seq, bucket=key.short(), members=n_members,
            steps=steps, seconds=seconds, compiled=compiled,
        )
        self.sweep()
        self._eval_slos()

    def observe_frame(self, rec, frame) -> None:
        """A streamed snapshot frame (already host numpy in the batcher).
        Non-finite content is the direct overflow signal — the
        one a starved *pinned* deployment gives, since its adjust unit
        never bumps a grow counter."""
        frac = nonfinite_fraction(frame)
        if frac > self.config.nonfinite_frac and rec.id not in self._frame_alerted:
            self._frame_alerted.add(rec.id)
            self._fire(Alert(
                "overflow_storm", f"req{rec.id}:{rec.key.stepper}", "",
                rec.elapsed,
                {"signal": "nonfinite", "fraction": frac},
            ))

    def on_tracker(self, rec, chunk_steps: int) -> None:
        """Carried-k sample for the flight recorder (telemetry itself is
        drained by the batcher's existing ``obs.record_tracker``). The
        splits come to the host in one ``.tolist()``: one sync, not one a
        site."""
        self.flight.record(
            "tracker", request=rec.id, step=rec.elapsed + chunk_steps,
            k=rec.tracker.state.k.tolist(),
        )

    def on_request_done(self, rec) -> None:
        self.flight.record(
            "done", request=rec.id, steps=rec.elapsed, chunks=rec.chunks
        )
        job = self._pending.pop(rec.id, None)
        if job is None or rec.result is None:
            return
        t0 = time.perf_counter()
        rel = job.replay(rec.result.state)
        dt = time.perf_counter() - t0
        self._shadow_sampled.inc()
        self._shadow_seconds.inc(dt)
        self._rel_gauge.set(rel)
        breach = not (rel <= self.config.err_budget)  # NaN/inf breach too
        if breach:
            self._shadow_breaches.inc()
        self._shadow_window.append((rec.id, rel))
        self.shadow_rel[rec.id] = rel
        self._burn_gauge.set(self.error_budget_burn())
        self.flight.record(
            "shadow", request=rec.id, rel_l2=rel, budget=self.config.err_budget,
            breach=breach, seconds=dt,
        )

    def on_request_failed(self, rec, error: str) -> None:
        self.flight.record(
            "failed", request=rec.id, steps=rec.elapsed, error=str(error)
        )
        self._pending.pop(rec.id, None)
        self.dump(f"request_failed_req{rec.id}")

    # -- detector sweep ------------------------------------------------------

    def sweep(self) -> None:
        """Incremental detector pass over every telemetry series: emit the
        suffix of :func:`detect_series` beyond what this monitor already
        fired (per-series fire-once makes the suffix well-defined)."""
        tel = self.obs.telemetry
        if tel is None:
            return
        for s in tel.all_series():
            key = (s.scope, s.site)
            seen = self._emitted.get(key, 0)
            fresh = detect_series(s, self.config)[seen:]
            if fresh:
                self._emitted[key] = seen + len(fresh)
                for a in fresh:
                    self._fire(a)

    def _fire(self, alert: Alert) -> None:
        self.alerts.append(alert)
        if alert.kind == "k_thrash":
            self._thrash_seqs.append(self._chunk_seq)
        self._alert_counter.inc(kind=alert.kind)
        if self.obs.tracer is not None:
            self.obs.tracer.instant(
                "health.alert", kind=alert.kind, scope=alert.scope,
                site=alert.site, step=alert.step,
            )
        self.flight.record("alert", alert=alert.to_dict())
        self.dump(alert.kind)

    # -- SLO evaluation ------------------------------------------------------

    def error_budget_burn(self) -> float:
        """Breaching fraction of the rolling shadow window (NaN with no
        shadowed requests yet)."""
        if not self._shadow_window:
            return float("nan")
        bad = sum(
            1 for _, rel in self._shadow_window
            if not (rel <= self.config.err_budget)
        )
        return bad / len(self._shadow_window)

    def _metric_value(self, rule: SLORule) -> float:
        m = rule.metric
        if m.startswith("chunk_latency_p") and m.endswith("_us"):
            pct = float(m[len("chunk_latency_p") : -len("_us")])
            return self._latency_hist.quantile(pct / 100.0) * 1e6
        if m == "error_budget_burn":
            return self.error_budget_burn()
        if m == "thrash_rate":
            if self._chunk_seq == 0:
                return float("nan")
            floor_seq = self._chunk_seq - rule.window
            recent = sum(1 for s in self._thrash_seqs if s > floor_seq)
            return recent / min(rule.window, self._chunk_seq)
        if m == "queue_depth":
            return float(self._queue_depth)
        return float("nan")  # unknown metric: no data, never breaches

    def _eval_slos(self) -> None:
        for rule in self.config.slos:
            value = self._metric_value(rule)
            self._slo_last[rule.name] = value
            ok = rule.ok(value)
            was_breached = self._slo_breached.get(rule.name, False)
            if not ok and not was_breached:
                self._fire(Alert(
                    "slo_breach", rule.name, "", self._chunk_seq,
                    {"metric": rule.metric, "op": rule.op, "value": value,
                     "threshold": rule.threshold, "window": rule.window},
                ))
            self._slo_breached[rule.name] = not ok

    # -- verdict / dumps -----------------------------------------------------

    def alerting(self) -> bool:
        return bool(self.alerts)

    def verdict(self) -> Dict[str, Any]:
        """The JSON health verdict (the ``/health`` endpoint body)."""
        by_kind: Dict[str, int] = {}
        for a in self.alerts:
            by_kind[a.kind] = by_kind.get(a.kind, 0) + 1
        return {
            "schema": VERDICT_SCHEMA,
            "status": "alerting" if self.alerts else "ok",
            "alerts": {"total": len(self.alerts), "by_kind": by_kind},
            "slo": {
                rule.name: {
                    "metric": rule.metric,
                    "op": rule.op,
                    "threshold": rule.threshold,
                    "window": rule.window,
                    "value": self._slo_last.get(rule.name, float("nan")),
                    "ok": not self._slo_breached.get(rule.name, False),
                }
                for rule in self.config.slos
            },
            "shadow": {
                "rate": self.config.shadow_rate,
                "sampled": int(self._shadow_sampled.total()),
                "breaches": int(self._shadow_breaches.total()),
                "budget": self.config.err_budget,
                "burn": self.error_budget_burn(),
                "seconds": self._shadow_seconds.total(),
            },
            "chunks": self._chunk_seq,
            "queue_depth": self._queue_depth,
            "active_members": self._active_members,
            "flight_dumps": list(self.dump_paths),
        }

    def dump(self, reason: str) -> Optional[str]:
        """Flight-recorder dump (bounded by ``max_dumps``); returns the
        path, or None once the budget is spent."""
        if len(self.dump_paths) >= self.config.max_dumps:
            return None
        path = self.flight.dump(
            self.config.flight_dir, reason,
            metrics=self.obs.registry.export_json(),
            verdict=self.verdict(),
        )
        self.dump_paths.append(path)
        return path


# ---------------------------------------------------------------------------
# process-wide install (mirrors repro_torch.obs.enable/disable/active)
# ---------------------------------------------------------------------------

_MONITOR: Optional[HealthMonitor] = None


def enable(config: Optional[HealthConfig] = None, **overrides) -> HealthMonitor:
    """Install the process-wide health monitor (enabling ``repro_torch.obs``
    first if needed). Keyword overrides are :class:`HealthConfig` fields:
    ``enable(shadow_rate=0.25, flight_dir=...)``. Idempotent in the same
    sense as ``obs.enable``: a second call replaces the monitor."""
    global _MONITOR
    if config is None:
        config = HealthConfig(**overrides)
    elif overrides:
        config = dataclasses.replace(config, **overrides)
    _MONITOR = HealthMonitor(config)
    return _MONITOR


def disable() -> None:
    """Remove the monitor; every service hook reverts to a no-op. (Leaves
    ``repro_torch.obs`` itself as-is.)"""
    global _MONITOR
    _MONITOR = None


def active() -> Optional[HealthMonitor]:
    return _MONITOR


# ---------------------------------------------------------------------------
# CLI: offline report / --watch / --smoke
# ---------------------------------------------------------------------------

def offline_verdict(
    art_dir: str, config: Optional[HealthConfig] = None
) -> Dict[str, Any]:
    """Detector replay over an exported artifact directory (telemetry.json
    if present), shaped like :meth:`HealthMonitor.verdict`."""
    config = config or HealthConfig()
    alerts: List[Alert] = []
    tel_path = os.path.join(art_dir, "telemetry.json")
    source = None
    if os.path.exists(tel_path):
        from .precision import load_telemetry

        alerts = run_detectors(load_telemetry(tel_path), config)
        source = tel_path
    by_kind: Dict[str, int] = {}
    for a in alerts:
        by_kind[a.kind] = by_kind.get(a.kind, 0) + 1
    return {
        "schema": VERDICT_SCHEMA,
        "status": "alerting" if alerts else "ok",
        "alerts": {"total": len(alerts), "by_kind": by_kind},
        "alert_list": [a.to_dict() for a in alerts],
        "telemetry": source,
        "mode": "offline",
    }


def run_report(art_dir: str) -> int:
    v = offline_verdict(art_dir)
    if v["telemetry"] is None:
        print(f"(telemetry.json: not found in {art_dir} — nothing to detect on)")
    print(f"health: {v['status']} ({v['alerts']['total']} alert(s))")
    for a in v["alert_list"]:
        print("  " + str(Alert(**{k: a[k] for k in
                                  ("kind", "scope", "site", "step", "detail")})))
    return 1 if v["alerts"]["total"] else 0


def run_watch(art_dir: str, port: int, interval: float) -> int:
    """Serve ``/metrics``, ``/health`` and ``/telemetry`` over an artifact
    directory, recomputing the offline verdict on demand."""
    from .server import HealthServer

    def metrics_text() -> str:
        p = os.path.join(art_dir, "metrics.prom")
        if not os.path.exists(p):
            return "# no metrics.prom in " + art_dir + "\n"
        with open(p) as f:
            return f.read()

    def telemetry_doc() -> Dict[str, Any]:
        p = os.path.join(art_dir, "telemetry.json")
        if not os.path.exists(p):
            return {"error": f"no telemetry.json in {art_dir}"}
        with open(p) as f:
            return json.load(f)

    server = HealthServer(
        metrics_fn=metrics_text,
        health_fn=lambda: offline_verdict(art_dir),
        telemetry_fn=telemetry_doc,
        port=port,
    )
    server.start()
    print(f"watching {art_dir} at {server.url} "
          f"(/metrics /health /telemetry; ctrl-c to stop)")
    try:
        while True:
            time.sleep(interval)
    except KeyboardInterrupt:
        return 0
    finally:
        server.stop()


# -- smoke: the CI gate ------------------------------------------------------

def _starved_policy(stepper_name: str):
    """A validation-stamped PrecisionPolicy pinning every site at the
    starved split k=0 — the 'stale artifact' that induces the storm burst
    (tuned against a workload whose dynamic range the live traffic no
    longer matches)."""
    from repro_torch.core.policy import PRESETS
    from repro_torch.pde.registry import get_stepper
    from repro_torch.profile.artifact import PrecisionPolicy

    fmt = PRESETS["r2f2_16"].fmt
    sites = {name: {"k": 0, "k_lo": 0, "k_hi": 0}
             for name in get_stepper(stepper_name).sites}
    return PrecisionPolicy(
        stepper=stepper_name,
        fmt=fmt,
        sites=sites,
        validation={"accepted": True, "note": "synthetic starved policy (smoke)"},
    )


def _storm_burst(svc, members: int = 3):
    """Submit the storm traffic: pinned rr_tracked advection members whose
    initial pulses (amplitude 1e5) overflow the starved k=0 split, on the
    service's device."""
    import dataclasses as _dc

    from repro_torch.core.policy import PRESETS
    from repro_torch.pde.advection1d import AdvectionConfig
    from repro_torch.service import SimRequest
    from repro_torch.service.request import scaled_state0

    cfg = AdvectionConfig(nx=64, amplitude=1.0)
    prec = _dc.replace(PRESETS["r2f2_16"], mode="rr_tracked", pinned=True)
    policy = _starved_policy("advection1d")
    handles = []
    for m in range(members):
        handles.append(svc.submit(SimRequest(
            "advection1d", steps=32, precision=prec, cfg=cfg, policy=policy,
            snapshot_every=8,
            state0=scaled_state0(
                "advection1d", scale=(1.0 + 0.1 * m) * 1e5,
                overrides={"nx": 64, "amplitude": 1.0}, device=svc.device,
            ),
        )))
    return handles


def run_smoke(out_dir: str, burst: str = "clean", device=None) -> int:
    """The exit-code-gated self-check, on ``device`` (None: the CUDA card,
    raising without one; nothing falls back to the CPU).

    ``clean``: serve a healthy burst under the monitor; the scrape server
    must round-trip, a synthetic telemetry stream must fire a detector and
    produce a loadable flight dump, and the real burst must stay silent.
    Exit 0 on pass, 2 on any failure.

    ``storm``: serve the starved-pinned advection burst; exits 3 (nonzero,
    by design — this is the alarm working) when an ``overflow_storm``
    alert fired AND its flight dump reloads, else 0 so a negated
    invocation catches a dead detector.
    """
    failures: List[str] = []

    def check(ok: bool, what: str) -> None:
        print(("  ok   " if ok else "  FAIL ") + what)
        if not ok:
            failures.append(what)

    from repro_torch.service import SimRequest, SimService

    flight_dir = os.path.join(out_dir, "flightrec")

    if burst == "storm":
        print("health smoke: storm burst (starved pinned policy, hot traffic)")
        obs.enable(sample=1.0)
        try:
            monitor = enable(shadow_rate=1.0, flight_dir=flight_dir)
            svc = SimService(device=device)
            _storm_burst(svc)
            svc.run_until_idle()
            obs.export(out_dir)
        finally:
            disable()
            obs.disable()
        storm_alerts = [a for a in monitor.alerts if a.kind == "overflow_storm"]
        print(f"  {len(monitor.alerts)} alert(s), "
              f"{len(storm_alerts)} overflow_storm, "
              f"{len(monitor.dump_paths)} flight dump(s)")
        for a in monitor.alerts:
            print("    " + str(a))
        dump_ok = False
        if monitor.dump_paths:
            try:
                load_flightrec(monitor.dump_paths[0])
                dump_ok = True
            except (ValueError, OSError) as e:
                print(f"  flight dump failed to reload: {e}")
        if storm_alerts and dump_ok:
            print("storm burst alerted (exit 3 — the alarm works)")
            return 3
        print("SMOKE FAIL: storm burst did not alert (or dump unreadable)")
        return 0  # callers negate this invocation; silence here must read as failure

    print("health smoke: clean burst with the monitor enabled")
    obs.enable(sample=1.0)
    try:
        monitor = enable(shadow_rate=1.0, flight_dir=flight_dir)
        svc = SimService(device=device)
        handles = [
            svc.submit(SimRequest("heat1d", steps=64, precision="f32",
                                  snapshot_every=16)),
            svc.submit(SimRequest("heat1d", steps=64, precision="rr_tracked",
                                  snapshot_every=16)),
        ]
        svc.run_until_idle()
        for h in handles:
            h.result()

        # 1. scrape round-trip against the live monitor
        from urllib.request import urlopen

        from .metrics import parse_prometheus
        from .server import HealthServer

        server = HealthServer.for_monitor(monitor)
        server.start()
        try:
            with urlopen(server.url + "/metrics", timeout=10) as r:
                families = parse_prometheus(r.read().decode())
            check("repro_health_alerts_total" in families
                  and "repro_service_chunk_latency_seconds" in families,
                  f"/metrics round-trips the strict parser "
                  f"({len(families)} families)")
            with urlopen(server.url + "/health", timeout=10) as r:
                verdict = json.loads(r.read().decode())
            check(verdict.get("schema") == VERDICT_SCHEMA
                  and verdict.get("status") == "ok",
                  f"/health verdict is ok ({verdict.get('status')})")
            with urlopen(server.url + "/telemetry", timeout=10) as r:
                tel_doc = json.loads(r.read().decode())
            check(tel_doc.get("schema") == "repro.obs/telemetry@1",
                  "/telemetry serves the telemetry schema")
        finally:
            server.stop()

        # 2. the clean burst stayed silent, and shadowing actually ran
        check(not monitor.alerts,
              f"clean burst fired no alerts ({len(monitor.alerts)})")
        sampled = int(monitor._shadow_sampled.total())
        burn = monitor.error_budget_burn()
        check(sampled >= 1 and burn == 0.0,
              f"shadow oracle sampled {sampled} request(s), burn {burn}")
        obs.export(out_dir)
    finally:
        disable()
        obs.disable()

    # 3. a synthetic overflow storm fires the detector and dumps a loadable
    #    flight recording (a private scope — nothing touches the real burst)
    synth_scope = obs.Observability(trace=True, telemetry=True)
    synth = HealthMonitor(
        HealthConfig(flight_dir=os.path.join(flight_dir, "synthetic")),
        scope=synth_scope,
    )
    series = synth_scope.telemetry.series("synthetic", "site0")
    for b in range(8):
        series.append(step=(b + 1) * 4, k=3, grew=(b + 1) * 4, shrank=0)
    synth.sweep()
    kinds = [a.kind for a in synth.alerts]
    check(kinds == ["overflow_storm"],
          f"synthetic storm stream fires exactly one overflow_storm ({kinds})")
    dump_ok = False
    if synth.dump_paths:
        try:
            doc = load_flightrec(synth.dump_paths[0])
            dump_ok = doc["verdict"]["status"] == "alerting"
        except (ValueError, OSError) as e:
            print(f"  flight dump reload: {e}")
    check(dump_ok, "synthetic alert's flight-recorder dump reloads and validates")

    if failures:
        print(f"SMOKE FAIL: {len(failures)} check(s) failed")
        return 2
    print(f"health smoke passed; artifacts in {out_dir}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.health",
        description="Numerics-health monitor: offline detector replay, "
                    "artifact watcher, CI smoke gate.",
    )
    ap.add_argument("--dir", default="artifacts/obs",
                    help="artifact directory to report on (default: %(default)s)")
    ap.add_argument("--watch", action="store_true",
                    help="serve /metrics /health /telemetry over --dir")
    ap.add_argument("--port", type=int, default=0,
                    help="watch-mode port (default: ephemeral)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="watch-mode poll interval in seconds")
    ap.add_argument("--smoke", action="store_true",
                    help="serve an instrumented burst and gate the health "
                         "contract (exit 2 on failure)")
    ap.add_argument("--burst", choices=("clean", "storm"), default="clean",
                    help="smoke burst flavour: 'clean' must exit 0, 'storm' "
                         "must exit nonzero (the alarm firing)")
    ap.add_argument("--out", default=None,
                    help="smoke-mode export directory (default: --dir)")
    ap.add_argument("--device", default=None,
                    help="smoke-mode torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.smoke:
        return run_smoke(args.out or args.dir, burst=args.burst, device=args.device)
    if args.watch:
        return run_watch(args.dir, args.port, args.interval)
    return run_report(args.dir)


if __name__ == "__main__":
    # ``python -m repro_torch.obs.health`` executes this file as ``__main__``:
    # a SECOND module object. enable() must install the monitor on the
    # canonical ``repro_torch.obs.health`` module (the one the service hooks
    # import), so delegate to that copy's main().
    from repro_torch.obs.health import main as _canonical_main

    sys.exit(_canonical_main())
