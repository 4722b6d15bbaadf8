"""Flight recorder: a bounded ring of recent health and lifecycle events, as
``repro.obs.flightrec`` keeps it (the same schema, so a dump written by either
package loads in the other).

The postmortem story of the health plane (DESIGN.md §16): while the service
runs, :class:`FlightRecorder` keeps the last ``capacity`` events — request
lifecycle transitions, chunk records, carried-k samples, shadow-replay
results, alerts — in a plain ``deque``. Nothing is written until something
goes wrong; on any alert or request failure the monitor calls :meth:`dump`,
which freezes the ring plus the current metric summary and health verdict
into one schema-versioned JSON file under ``artifacts/flightrec/``.

Design constraints, in order:

* **bounded** — the ring never grows past ``capacity`` events and dumps
  are capped by the monitor (``HealthConfig.max_dumps``), so a pathological
  alert storm cannot fill the disk the way it filled the logs;
* **deterministic** — events carry a monotone ``seq`` (and whatever step /
  chunk indices the caller supplies), never wall-clock timestamps, so two
  runs of the same burst dump byte-identical recordings;
* **loadable** — :func:`load_flightrec` is a strict loader (schema tag,
  required keys, monotone ``seq``) used by the ``--smoke`` gate: a dump that
  cannot be reloaded is a bug today, not during the real postmortem.

Pure stdlib; recording is O(1) dict appends on the host (passivity,
DESIGN.md §15).
"""

from __future__ import annotations

import json
import os
import re
from collections import deque
from typing import Any, Deque, Dict, List, Optional

__all__ = ["FlightRecorder", "load_flightrec", "SCHEMA"]

SCHEMA = "repro.obs/flightrec@1"

_SLUG_RE = re.compile(r"[^a-zA-Z0-9_.-]+")


def _slug(text: str) -> str:
    return _SLUG_RE.sub("-", str(text)).strip("-") or "event"


class FlightRecorder:
    """The ring buffer (see module docstring)."""

    def __init__(self, capacity: int = 512):
        if capacity <= 0:
            raise ValueError(f"flight-recorder capacity must be positive: {capacity}")
        self.capacity = int(capacity)
        self._events: Deque[Dict[str, Any]] = deque(maxlen=self.capacity)
        self._seq = 0  # events ever recorded (dumps report truncation)
        self._dump_seq = 0

    def record(self, kind: str, **fields) -> None:
        """Append one event. ``fields`` must be JSON-serialisable scalars /
        small structures — the recorder stores them verbatim. ``seq`` is
        the recorder's own key: a field of that name would overwrite it
        (``repro``'s chunk events do, with the chunk number, so its dumps
        taken after a chunk fail its own loader; the port's monitor records
        the chunk number as ``chunk``)."""
        if "seq" in fields:
            raise ValueError("a flight-recorder field may not be named 'seq': it is the event's sequence number")
        self._seq += 1
        self._events.append({"seq": self._seq, "kind": kind, **fields})

    @property
    def recorded(self) -> int:
        """Events ever recorded (>= len(self) once the ring wraps)."""
        return self._seq

    def events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    def __len__(self) -> int:
        return len(self._events)

    def dump(
        self,
        out_dir: str,
        reason: str,
        metrics: Optional[Dict[str, Any]] = None,
        verdict: Optional[Dict[str, Any]] = None,
    ) -> str:
        """Freeze the ring to ``out_dir/flightrec-NNNN-<reason>.json``.

        The write is atomic (tmp + rename) so a crash mid-dump never leaves
        a half-written recording for the loader to choke on. Returns the
        path."""
        self._dump_seq += 1
        os.makedirs(out_dir, exist_ok=True)
        name = f"flightrec-{self._dump_seq:04d}-{_slug(reason)}.json"
        path = os.path.join(out_dir, name)
        doc = {
            "schema": SCHEMA,
            "reason": str(reason),
            "dump_seq": self._dump_seq,
            "capacity": self.capacity,
            "recorded": self._seq,
            "events": self.events(),
            "metrics": metrics or {},
            "verdict": verdict or {},
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
        return path


def load_flightrec(path: str) -> Dict[str, Any]:
    """Strictly load one dump: schema tag, required keys, every event a
    dict with ``seq``/``kind``, ``seq`` strictly increasing. Raises
    ``ValueError`` on any violation."""
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != SCHEMA:
        raise ValueError(
            f"{path}: unknown flightrec schema {doc.get('schema')!r} "
            f"(expected {SCHEMA})"
        )
    for key in ("reason", "capacity", "recorded", "events", "metrics", "verdict"):
        if key not in doc:
            raise ValueError(f"{path}: flightrec dump missing key {key!r}")
    prev = 0
    for e in doc["events"]:
        if not isinstance(e, dict) or "seq" not in e or "kind" not in e:
            raise ValueError(f"{path}: malformed flightrec event {e!r}")
        if e["seq"] <= prev:
            raise ValueError(
                f"{path}: event seq not strictly increasing at {e['seq']}"
            )
        prev = e["seq"]
    if len(doc["events"]) > doc["capacity"]:
        raise ValueError(
            f"{path}: {len(doc['events'])} events exceed capacity {doc['capacity']}"
        )
    return doc
