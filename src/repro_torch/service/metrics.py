"""The service's observability surface: counters, latency, occupancy.

One :class:`ServiceMetrics` per :class:`~repro_torch.service.scheduler.SimService`
accumulates what the serving plane is judged by:

* **throughput** — member-steps advanced per second of busy (chunk) time:
  the saturation measure of the kernel planes under heterogeneous traffic;
* **chunk latency** — wall seconds per bucket chunk call (p50/p99 over the
  service lifetime, and per bucket key for the benchmark suite), with a
  **compile/execute split**: the first call of each cached chunk callable
  (on the card: a kernel's library load, its launch plan and occupancy
  queries) lands in ``compile_seconds``/``compiles`` instead of polluting
  the latency percentiles, throughput denominator, or busy time;
* **bucket occupancy** — members per chunk call: how well the bucketing
  scheduler packs the ensembles (1.0 = no batching win at all);
* **per-site adjust counters** — the §5.3 grow/shrink totals drained from
  completed tracked requests, aggregated by site name: the fleet-level view
  of how hard the precision-adjust unit worked;
* lifecycle counters — submitted / rejected (backpressure) / completed /
  evicted / resumed / snapshots streamed.

This class is a thin consumer of a
:class:`repro_torch.obs.MetricsRegistry` — every counter/histogram lives in the
registry (and is therefore Prometheus/JSON-exportable), while the public
attribute API (``metrics.submitted += 1``, ``metrics.busy_seconds``, ...)
is preserved via properties over the registry cells. When
``repro_torch.obs.enable()`` is active at construction, the service reports into
the process-wide registry so one export captures the whole fleet;
otherwise it gets a private registry and behaves exactly as before.

Derived views guard their denominators: throughput with zero busy time and
latency/occupancy over an empty window return NaN (never raise, never
inf). Everything is plain Python floats/ints on the host — metrics never
touch the chunk's tensors. The metric names and help texts are
``repro.service``'s.
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["ServiceMetrics"]

#: lifecycle counter attribute -> registry counter (name, help)
_LIFECYCLE = {
    "submitted": ("repro_service_submitted_total", "requests admitted"),
    "rejected": ("repro_service_rejected_total", "requests refused (backpressure)"),
    "completed": ("repro_service_completed_total", "requests finished"),
    "failed": ("repro_service_failed_total", "requests failed"),
    "evicted": ("repro_service_evicted_total", "members parked under pressure"),
    "resumed": ("repro_service_resumed_total", "parked members re-admitted"),
    "snapshots_emitted": ("repro_service_snapshots_total", "snapshot frames streamed"),
    "chunks": ("repro_service_chunks_total", "bucket chunk calls"),
    "member_steps": ("repro_service_member_steps_total",
                     "member-steps advanced (all chunk calls)"),
    "compiles": ("repro_service_compiles_total",
                 "chunk calls that traced+compiled a fresh program"),
}

_FLOAT_COUNTERS = {
    "busy_seconds": ("repro_service_busy_seconds_total",
                     "wall seconds in steady-state chunk execution"),
    "compile_seconds": ("repro_service_compile_seconds_total",
                        "wall seconds in first-call trace+compile"),
}


def _counter_property(attr: str, name: str, as_int: bool):
    def getter(self):
        v = self._reg.counter(name).total()
        return int(v) if as_int else v

    def setter(self, value):
        # preserves the historical `metrics.submitted += 1` call sites:
        # assignment becomes a delta-increment on the registry counter
        delta = value - getter(self)
        if delta:
            self._reg.counter(name).inc(delta)

    return property(getter, setter)


def _key_labels(key) -> Dict[str, str]:
    """Low-cardinality labels from a BucketKey (display classes only — the
    full key still keys the sample window)."""
    prec = getattr(key, "prec", None)
    return {
        "stepper": str(getattr(key, "stepper", key)),
        "mode": str(getattr(prec, "mode", prec if prec is not None else "?")),
        "execution": str(getattr(key, "execution", "?")),
    }


class ServiceMetrics:
    def __init__(self, window: int = 65536, registry: Optional[MetricsRegistry] = None):
        if registry is None:
            import repro_torch.obs as obs

            o = obs.active()
            registry = o.registry if o is not None else MetricsRegistry()
        self._reg = registry
        for name, help in list(_LIFECYCLE.values()) + list(_FLOAT_COUNTERS.values()):
            registry.counter(name, help)
        self._latency_hist = registry.histogram(
            "repro_service_chunk_latency_seconds",
            "steady-state chunk wall time (compile calls excluded)",
        )
        self._adjust_counter = registry.counter(
            "repro_service_site_adjust_total",
            "per-site precision adjustments from completed tracked requests",
        )
        #: cumulative member-steps over execute-only (non-compile) chunk
        #: calls — the throughput numerator matching ``busy_seconds``
        self._exec_member_steps = 0
        #: recent per-chunk samples (full BucketKey, n_members, steps, secs,
        #: compiled) — a bounded window, so a long-lived service never grows
        #: unbounded host state; percentiles/occupancy/per-key stats are over
        #: this window while the counters stay cumulative. Samples key on the
        #: FULL bucket key, so buckets that differ only in format/config/
        #: shape never merge in per-key statistics (``BucketKey.short()`` is
        #: display only).
        self.chunk_samples: Deque[Tuple[Any, int, int, float, bool]] = deque(
            maxlen=window
        )
        #: site name -> [grew, shrank] totals from completed tracked requests
        self.site_adjustments: Dict[str, List[int]] = defaultdict(lambda: [0, 0])

    @property
    def registry(self) -> MetricsRegistry:
        """The backing obs registry (for export)."""
        return self._reg

    # -- recording -----------------------------------------------------------

    def observe_chunk(
        self, key, n_members: int, steps: int, seconds: float, compiled: bool = False
    ):
        """Record one bucket chunk call. ``compiled=True`` marks the first
        call of a freshly cached chunk callable: its wall time is booked as
        ``compile_seconds`` and kept out of the latency window and the
        throughput denominator."""
        self.chunks += 1
        self.member_steps += n_members * steps
        if compiled:
            self.compiles += 1
            self.compile_seconds += seconds
        else:
            self.busy_seconds += seconds
            self._exec_member_steps += n_members * steps
            self._latency_hist.observe(seconds, **_key_labels(key))
        self.chunk_samples.append((key, n_members, steps, seconds, compiled))

    def observe_completion(self, adjustments: Optional[Dict[str, Tuple[int, int]]]):
        self.completed += 1
        for site, (grew, shrank) in (adjustments or {}).items():
            self.site_adjustments[site][0] += grew
            self.site_adjustments[site][1] += shrank
            if grew:
                self._adjust_counter.inc(grew, site=site, dir="grow")
            if shrank:
                self._adjust_counter.inc(shrank, site=site, dir="shrink")

    # -- derived views -------------------------------------------------------

    def _latencies(self, key=None) -> np.ndarray:
        xs = [
            s
            for k, _, _, s, compiled in self.chunk_samples
            if not compiled and (key is None or k == key)
        ]
        return np.asarray(xs, np.float64)

    def latency_us(self, pct: float, key=None) -> float:
        """Execute-only chunk-latency percentile in microseconds (NaN with
        no samples). ``key``: a full BucketKey to restrict to one bucket
        class. Compile calls never enter this distribution."""
        xs = self._latencies(key)
        return float(np.percentile(xs, pct) * 1e6) if xs.size else float("nan")

    def throughput(self, key=None) -> float:
        """Member-steps per second of busy (execute-only) time (NaN with no
        busy time yet).

        Service-wide throughput uses the cumulative counters; per-key
        throughput is over the recent sample window."""
        if key is None:
            busy = self.busy_seconds
            return self._exec_member_steps / busy if busy > 0 else float("nan")
        rows = [
            (n * st, s)
            for k, n, st, s, compiled in self.chunk_samples
            if not compiled and k == key
        ]
        secs = sum(r[1] for r in rows)
        return sum(r[0] for r in rows) / secs if secs > 0 else float("nan")

    def occupancy(self, key=None) -> Tuple[float, int]:
        """(mean, max) members per chunk call ((NaN, 0) with no samples).
        Occupancy is a packing measure, so compile calls count too."""
        ns = [n for k, n, _, _, _ in self.chunk_samples if key is None or k == key]
        return (float(np.mean(ns)), int(max(ns))) if ns else (float("nan"), 0)

    def summary(self) -> Dict:
        occ_mean, occ_max = self.occupancy()
        return {
            "submitted": self.submitted,
            "rejected": self.rejected,
            "completed": self.completed,
            "failed": self.failed,
            "evicted": self.evicted,
            "resumed": self.resumed,
            "snapshots_emitted": self.snapshots_emitted,
            "chunks": self.chunks,
            "member_steps": self.member_steps,
            "busy_seconds": self.busy_seconds,
            "compiles": self.compiles,
            "compile_seconds": self.compile_seconds,
            "throughput_steps_per_s": self.throughput(),
            "chunk_latency_p50_us": self.latency_us(50),
            "chunk_latency_p99_us": self.latency_us(99),
            "occupancy_mean": occ_mean,
            "occupancy_max": occ_max,
            "site_adjustments": {
                s: tuple(v) for s, v in sorted(self.site_adjustments.items())
            },
        }

    def report(self) -> str:
        s = self.summary()
        lines = [
            "service metrics:",
            f"  requests    submitted={s['submitted']} completed={s['completed']} "
            f"rejected={s['rejected']} failed={s['failed']} "
            f"evicted={s['evicted']} resumed={s['resumed']}",
            f"  chunks      n={s['chunks']} p50={s['chunk_latency_p50_us']:.0f}us "
            f"p99={s['chunk_latency_p99_us']:.0f}us busy={s['busy_seconds']:.2f}s",
            f"  compile     n={s['compiles']} {s['compile_seconds']:.2f}s "
            f"(excluded from latency/throughput)",
            f"  throughput  {s['throughput_steps_per_s']:.0f} member-steps/s "
            f"({s['member_steps']} steps, {s['snapshots_emitted']} snapshots streamed)",
            f"  occupancy   mean={s['occupancy_mean']:.2f} max={s['occupancy_max']} "
            f"members/chunk",
        ]
        if s["site_adjustments"]:
            adj = ", ".join(
                f"{site}:+{g}/-{h}" for site, (g, h) in s["site_adjustments"].items()
            )
            lines.append(f"  adjust unit {adj}")
        return "\n".join(lines)


for _attr, (_name, _help) in _LIFECYCLE.items():
    setattr(ServiceMetrics, _attr, _counter_property(_attr, _name, as_int=True))
for _attr, (_name, _help) in _FLOAT_COUNTERS.items():
    setattr(ServiceMetrics, _attr, _counter_property(_attr, _name, as_int=False))
del _attr, _name, _help
