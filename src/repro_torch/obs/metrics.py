"""Metrics registry: named counters/gauges/histograms with label sets.

One :class:`MetricsRegistry` per scope (the process-wide one installed by
``repro_torch.obs.enable``, or a private one per ``ServiceMetrics``) owns every
metric by name. Metrics are the standard three:

* :class:`Counter` — monotone float, ``inc(amount, **labels)``;
* :class:`Gauge` — settable float, ``set(value, **labels)``;
* :class:`Histogram` — cumulative buckets + sum + count,
  ``observe(value, **labels)``.

Every series is addressed by a **label set** (sorted kwargs), and every
metric carries a hard **cardinality bound** (``max_series``): a label set
beyond the bound is dropped and counted in ``registry.dropped_series``
instead of growing host memory without limit — unbounded label cardinality
is the classic way a metrics layer becomes the outage. Declaring the same
name twice returns the same metric object (idempotent); re-declaring under
a different type raises.

Export is Prometheus text exposition format (``# HELP``/``# TYPE`` +
samples; histograms as ``_bucket``/``_sum``/``_count`` with cumulative
``le`` buckets) and a JSON mirror. :func:`parse_prometheus` is a *strict*
parser of the same format — name/label grammar, TYPE-before-samples,
cumulative-bucket monotonicity, ``+Inf`` terminal bucket, count/sum
consistency — used by the round-trip tests and the ``repro_torch.obs`` reporter,
so an export that drifts from the spec fails loudly in CI rather than in
someone's scrape pipeline.

Pure stdlib on the hot path; recording never touches a tensor (the
passivity contract, DESIGN.md §15). The text and the JSON schema are
``repro.obs``'s: the same calls export the same bytes in either package.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "histogram_quantile",
    "parse_prometheus",
    "DEFAULT_BUCKETS",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: default histogram buckets (seconds): µs-scale kernel launches through
#: multi-second compiles
DEFAULT_BUCKETS = (
    1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 1e-2, 5e-2, 0.1, 0.5, 1.0, 5.0, 10.0,
)


def _labelkey(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    for name in labels:
        if not _LABEL_RE.match(name):
            raise ValueError(f"invalid label name {name!r}")
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _fmt_labels(key: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(float(v))


class _Metric:
    kind = "untyped"

    def __init__(self, registry: "MetricsRegistry", name: str, help: str):
        self.registry = registry
        self.name = name
        self.help = help
        self._series: Dict[Tuple, Any] = {}
        self._lock = threading.Lock()

    def _get_series(self, labels: Dict[str, Any], default):
        """The state cell of one label set, or None past the cardinality
        bound (the drop is counted on the registry)."""
        key = _labelkey(labels)
        with self._lock:
            cell = self._series.get(key)
            if cell is None:
                if len(self._series) >= self.registry.max_series:
                    self.registry._dropped += 1
                    return None
                cell = self._series[key] = default()
            return cell

    def labelsets(self) -> List[Dict[str, str]]:
        with self._lock:
            return [dict(k) for k in self._series]

    def __len__(self) -> int:
        return len(self._series)


class _Cell:
    __slots__ = ("value",)

    def __init__(self, value: float = 0.0):
        self.value = value


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({amount})")
        cell = self._get_series(labels, _Cell)
        if cell is not None:
            cell.value += amount

    def value(self, **labels) -> float:
        cell = self._series.get(_labelkey(labels))
        return 0.0 if cell is None else cell.value

    def total(self) -> float:
        """Sum over every label set."""
        with self._lock:
            return sum(c.value for c in self._series.values())

    def samples(self):
        with self._lock:
            return [(self.name, key, cell.value) for key, cell in self._series.items()]


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        cell = self._get_series(labels, _Cell)
        if cell is not None:
            cell.value = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        cell = self._get_series(labels, _Cell)
        if cell is not None:
            cell.value += amount

    def value(self, **labels) -> float:
        cell = self._series.get(_labelkey(labels))
        return float("nan") if cell is None else cell.value

    def samples(self):
        with self._lock:
            return [(self.name, key, cell.value) for key, cell in self._series.items()]


class _HistCell:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (non-cumulative) counts
        self.sum = 0.0
        self.count = 0


def histogram_quantile(q: float, buckets, count: float) -> float:
    """Prometheus-style quantile estimate from cumulative ``le`` buckets.

    ``buckets`` is a sequence of ``(le, cumulative_count)`` pairs over the
    *finite* bucket bounds, ascending (exactly what
    :meth:`Histogram.snapshot` returns); ``count`` is the total observation
    count (the implicit ``+Inf`` bucket). Estimation is linear interpolation
    inside the bucket holding rank ``q * count``, with 0 as the lower bound
    of the first bucket; a rank past the last finite bucket returns that
    bucket's bound (the standard `histogram_quantile` convention — the
    estimate never invents mass above the largest finite bound). Returns
    NaN with no observations or a ``q`` outside ``[0, 1]``.
    """
    count = float(count)
    if not (0.0 <= q <= 1.0) or count <= 0 or not buckets:
        return float("nan")
    rank = q * count
    lower = 0.0
    prev_cum = 0.0
    for le, cum in buckets:
        if cum >= rank:
            width = float(le) - lower
            in_bucket = cum - prev_cum
            if in_bucket <= 0 or width <= 0:
                return float(le)
            return lower + width * (rank - prev_cum) / in_bucket
        lower = float(le)
        prev_cum = float(cum)
    return float(buckets[-1][0])


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, registry, name, help, buckets=DEFAULT_BUCKETS):
        super().__init__(registry, name, help)
        bs = tuple(float(b) for b in buckets)
        if list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"histogram buckets must be strictly increasing: {bs}")
        if bs and math.isinf(bs[-1]):
            bs = bs[:-1]  # +Inf is implicit
        self.buckets = bs

    def observe(self, value: float, **labels) -> None:
        cell = self._get_series(labels, lambda: _HistCell(len(self.buckets) + 1))
        if cell is None:
            return
        i = len(self.buckets)  # the +Inf bucket
        for j, b in enumerate(self.buckets):
            if value <= b:
                i = j
                break
        cell.counts[i] += 1
        cell.sum += value
        cell.count += 1

    def snapshot(self, **labels) -> Optional[Dict[str, Any]]:
        """(cumulative bucket counts, sum, count) of one label set."""
        cell = self._series.get(_labelkey(labels))
        if cell is None:
            return None
        cum, acc = [], 0
        for c in cell.counts:
            acc += c
            cum.append(acc)
        return {"buckets": list(zip(self.buckets, cum[:-1])), "sum": cell.sum,
                "count": cell.count}

    def quantile(self, q: float, **labels) -> float:
        """Bucket-estimated quantile (seconds for latency histograms) of one
        label set — or, with no labels, of the distribution aggregated over
        every label set (all series share this histogram's bucket layout, so
        cumulative counts sum exactly). NaN with no observations."""
        if labels:
            snap = self.snapshot(**labels)
            if snap is None:
                return float("nan")
            return histogram_quantile(q, snap["buckets"], snap["count"])
        with self._lock:
            cells = list(self._series.values())
        counts = [0] * (len(self.buckets) + 1)
        total = 0
        for cell in cells:
            for i, c in enumerate(cell.counts):
                counts[i] += c
            total += cell.count
        cum, acc = [], 0
        for c in counts[:-1]:
            acc += c
            cum.append(acc)
        return histogram_quantile(q, list(zip(self.buckets, cum)), total)

    def samples(self):
        out = []
        with self._lock:
            for key, cell in self._series.items():
                acc = 0
                for b, c in zip(self.buckets, cell.counts):
                    acc += c
                    out.append((f"{self.name}_bucket", key + (("le", _fmt_value(b)),), acc))
                out.append(
                    (f"{self.name}_bucket", key + (("le", "+Inf"),), cell.count)
                )
                out.append((f"{self.name}_sum", key, cell.sum))
                out.append((f"{self.name}_count", key, cell.count))
        return out


class MetricsRegistry:
    """Name -> metric map with idempotent declaration and a per-metric
    series-cardinality bound (see module docstring)."""

    def __init__(self, max_series: int = 256):
        self.max_series = int(max_series)
        self._metrics: Dict[str, _Metric] = {}
        self._dropped = 0
        self._lock = threading.Lock()

    @property
    def dropped_series(self) -> int:
        """Label sets refused by the cardinality bound (process lifetime)."""
        return self._dropped

    def _declare(self, cls, name: str, help: str, **kw) -> _Metric:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(self, name, help, **kw)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already declared as {m.kind}, not {cls.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._declare(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._declare(Gauge, name, help)

    def histogram(self, name: str, help: str = "", buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._declare(Histogram, name, help, buckets=buckets)

    def metrics(self) -> List[_Metric]:
        with self._lock:
            return [self._metrics[n] for n in sorted(self._metrics)]

    # -- export --------------------------------------------------------------

    def export_prometheus(self) -> str:
        """Prometheus text exposition format, strict-parser clean."""
        lines = []
        for m in self.metrics():
            lines.append(f"# HELP {m.name} {m.help or m.name}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for name, key, value in m.samples():
                lines.append(f"{name}{_fmt_labels(key)} {_fmt_value(value)}")
        return "\n".join(lines) + "\n"

    def export_json(self) -> Dict[str, Any]:
        out = {}
        for m in self.metrics():
            out[m.name] = {
                "type": m.kind,
                "help": m.help,
                "samples": [
                    {"name": name, "labels": dict(key), "value": value}
                    for name, key, value in m.samples()
                ],
            }
        return {"schema": "repro.obs/metrics@1", "dropped_series": self._dropped,
                "metrics": out}

    def save(self, prom_path: Optional[str] = None, json_path: Optional[str] = None):
        for path, text in (
            (prom_path, lambda: self.export_prometheus()),
            (json_path, lambda: json.dumps(self.export_json(), indent=2, sort_keys=True)),
        ):
            if path:
                os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
                with open(path, "w") as f:
                    f.write(text())


# ---------------------------------------------------------------------------
# strict text-format parser (round-trip tests + the repro_torch.obs reporter)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>\S+)\s*$"
)
_LABEL_PAIR_RE = re.compile(
    r'\s*(?P<k>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<v>(?:[^"\\]|\\.)*)"\s*(?:,|$)'
)


def _parse_value(tok: str) -> float:
    if tok == "+Inf":
        return float("inf")
    if tok == "-Inf":
        return float("-inf")
    if tok == "NaN":
        return float("nan")
    return float(tok)  # raises ValueError on garbage


def _parse_labels(body: str) -> Dict[str, str]:
    out, pos = {}, 0
    while pos < len(body):
        m = _LABEL_PAIR_RE.match(body, pos)
        if m is None:
            raise ValueError(f"malformed label body {body!r}")
        v = m.group("v").replace(r"\n", "\n").replace(r"\"", '"').replace(r"\\", "\\")
        out[m.group("k")] = v
        pos = m.end()
    return out


def parse_prometheus(text: str) -> Dict[str, Dict[str, Any]]:
    """Strictly parse Prometheus text format.

    Returns ``{family: {"type", "help", "samples": [(name, labels, value)]}}``.
    Raises ``ValueError`` on grammar violations, samples without a ``TYPE``
    declaration, non-cumulative histogram buckets, a histogram missing its
    ``+Inf`` bucket, or ``_count`` disagreeing with the terminal bucket.
    """
    families: Dict[str, Dict[str, Any]] = {}

    def family_of(sample_name: str) -> Optional[str]:
        for fam in families:
            if families[fam]["type"] == "histogram" and sample_name in (
                f"{fam}_bucket", f"{fam}_sum", f"{fam}_count"
            ):
                return fam
            if sample_name == fam:
                return fam
        return None

    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) < 3 or not _NAME_RE.match(parts[2]):
                raise ValueError(f"line {lineno}: malformed HELP: {raw!r}")
            families.setdefault(
                parts[2], {"type": None, "help": "", "samples": []}
            )["help"] = parts[3] if len(parts) > 3 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or not _NAME_RE.match(parts[2]):
                raise ValueError(f"line {lineno}: malformed TYPE: {raw!r}")
            if parts[3] not in ("counter", "gauge", "histogram", "summary", "untyped"):
                raise ValueError(f"line {lineno}: unknown metric type {parts[3]!r}")
            fam = families.setdefault(parts[2], {"type": None, "help": "", "samples": []})
            if fam["type"] is not None:
                raise ValueError(f"line {lineno}: duplicate TYPE for {parts[2]!r}")
            fam["type"] = parts[3]
            continue
        if line.startswith("#"):
            continue  # comment
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {lineno}: malformed sample: {raw!r}")
        name = m.group("name")
        labels = _parse_labels(m.group("labels")) if m.group("labels") else {}
        try:
            value = _parse_value(m.group("value"))
        except ValueError:
            raise ValueError(
                f"line {lineno}: malformed value {m.group('value')!r}"
            ) from None
        fam = family_of(name)
        if fam is None or families[fam]["type"] is None:
            raise ValueError(f"line {lineno}: sample {name!r} has no TYPE declaration")
        families[fam]["samples"].append((name, labels, value))

    # histogram structural checks
    for fam, rec in families.items():
        if rec["type"] != "histogram":
            continue
        by_series: Dict[Tuple, Dict[str, Any]] = {}
        for name, labels, value in rec["samples"]:
            base = {k: v for k, v in labels.items() if k != "le"}
            key = tuple(sorted(base.items()))
            s = by_series.setdefault(key, {"buckets": [], "sum": None, "count": None})
            if name == f"{fam}_bucket":
                if "le" not in labels:
                    raise ValueError(f"{fam}: bucket sample without le label")
                s["buckets"].append((_parse_value(labels["le"]), value))
            elif name == f"{fam}_sum":
                s["sum"] = value
            elif name == f"{fam}_count":
                s["count"] = value
        for key, s in by_series.items():
            bs = sorted(s["buckets"], key=lambda t: t[0])
            if not bs or not math.isinf(bs[-1][0]):
                raise ValueError(f"{fam}{dict(key)}: histogram missing +Inf bucket")
            counts = [c for _, c in bs]
            if any(b > a for a, b in zip(counts[1:], counts)):
                raise ValueError(f"{fam}{dict(key)}: bucket counts not cumulative")
            if s["count"] is None or s["sum"] is None:
                raise ValueError(f"{fam}{dict(key)}: missing _sum/_count")
            if s["count"] != counts[-1]:
                raise ValueError(
                    f"{fam}{dict(key)}: _count {s['count']} != +Inf bucket {counts[-1]}"
                )
    return families
