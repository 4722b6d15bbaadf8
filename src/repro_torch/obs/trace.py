"""Structured tracing: nestable spans, one process-wide sampled recorder.

A :class:`Tracer` records *complete* spans (``ph: "X"`` in Chrome-trace
terms: a name, a start timestamp and a duration) and *instant* lifecycle
events (``ph: "i"``), both carrying free-form JSON ``args``. Spans nest by
plain dynamic scoping — a thread-local stack — so a served burst renders as
a real timeline in Perfetto: ``service.pump`` containing ``service.chunk``
containing ``sim.run_ensemble`` and its ``cuda.*`` dispatch spans.

The recorder is deliberately dumb and host-only (DESIGN.md §15):

* **passive** — entering/leaving a span reads ``time.perf_counter`` and
  appends to a Python list; nothing here ever touches a tensor, so an
  instrumented program is bit-identical to an uninstrumented one;
* **sampled** — ``sample=r`` keeps a deterministic ``r`` fraction of
  *top-level* spans (the n-th top-level span is kept iff
  ``floor((n+1)·r) > floor(n·r)`` — no RNG, so two identical runs record
  identical span sets); nested spans and instants inherit the enclosing
  top-level decision;
* **bounded** — at most ``capacity`` events are retained; further kept
  events only bump ``dropped`` (a long-lived service cannot leak host
  memory through its own observability);
* **self-measuring** — the recorder accumulates the wall time spent inside
  its own bookkeeping (``self_seconds``), which is what the <5% overhead
  gate in ``python -m repro_torch.obs --smoke`` measures.

The events and their envelope are ``repro.obs``'s, so either package's
reporter reads the other's trace.

Export is Chrome-trace JSON (the ``{"traceEvents": [...]}`` envelope),
loadable by Perfetto (https://ui.perfetto.dev) and ``chrome://tracing``.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, NamedTuple, Optional

__all__ = ["Span", "Tracer", "NULL_SPAN", "load_trace"]


class Span(NamedTuple):
    """One recorded event. ``dur_us`` is None for instant events."""

    name: str
    ts_us: float  # microseconds since the tracer's epoch
    dur_us: Optional[float]
    tid: int
    depth: int  # nesting depth at record time (0 = top-level)
    args: Dict[str, Any]


class _Frame:
    __slots__ = ("name", "args", "keep", "depth", "t0")

    def __init__(self, name, args, keep, depth, t0):
        self.name = name
        self.args = args
        self.keep = keep
        self.depth = depth
        self.t0 = t0


class _NullSpan:
    """Reentrant no-op context manager — the disabled-path span."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    """The process-wide span recorder (see module docstring)."""

    def __init__(self, sample: float = 1.0, capacity: int = 65536):
        if not 0.0 <= sample <= 1.0:
            raise ValueError(f"sample must be in [0, 1], got {sample}")
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.sample = float(sample)
        self.capacity = int(capacity)
        self.spans: List[Span] = []
        self.dropped = 0  # kept-by-sampling events beyond capacity
        self.self_seconds = 0.0  # recorder bookkeeping wall time
        self._top_seen = 0  # top-level spans offered (sampling counter)
        self._epoch = time.perf_counter()
        self._tls = threading.local()
        self._lock = threading.Lock()

    # -- internals -----------------------------------------------------------

    def _stack(self) -> List[_Frame]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _keep_top(self) -> bool:
        """Deterministic proportional sampling over top-level spans."""
        with self._lock:
            n = self._top_seen
            self._top_seen += 1
        return math.floor((n + 1) * self.sample) > math.floor(n * self.sample)

    def _record(self, span: Span) -> None:
        with self._lock:
            if len(self.spans) < self.capacity:
                self.spans.append(span)
            else:
                self.dropped += 1

    # -- recording API -------------------------------------------------------

    @contextmanager
    def span(self, name: str, **args):
        """A complete span around the ``with`` body. Yields the mutable
        ``args`` dict, so the body can attach late attributes (e.g. a chunk
        size computed inside)."""
        t_in = time.perf_counter()
        stack = self._stack()
        keep = stack[-1].keep if stack else self._keep_top()
        frame = _Frame(name, dict(args), keep, len(stack), time.perf_counter())
        stack.append(frame)
        self.self_seconds += time.perf_counter() - t_in
        try:
            yield frame.args
        finally:
            t_out = time.perf_counter()
            stack.pop()
            if keep:
                self._record(
                    Span(
                        name=frame.name,
                        ts_us=(frame.t0 - self._epoch) * 1e6,
                        dur_us=(t_out - frame.t0) * 1e6,
                        tid=threading.get_ident(),
                        depth=frame.depth,
                        args=frame.args,
                    )
                )
            self.self_seconds += time.perf_counter() - t_out

    def instant(self, name: str, **args) -> None:
        """A zero-duration lifecycle event (request submitted / joined a
        bucket / evicted / done ...). Inside a span it inherits that span's
        sampling decision; outside one it is always kept (lifecycle events
        are rare and cheap)."""
        t_in = time.perf_counter()
        stack = self._stack()
        keep = stack[-1].keep if stack else True
        if keep:
            self._record(
                Span(
                    name=name,
                    ts_us=(t_in - self._epoch) * 1e6,
                    dur_us=None,
                    tid=threading.get_ident(),
                    depth=len(stack),
                    args=dict(args),
                )
            )
        self.self_seconds += time.perf_counter() - t_in

    # -- export --------------------------------------------------------------

    def chrome_trace(self) -> Dict[str, Any]:
        """The Chrome-trace/Perfetto JSON object (``traceEvents`` envelope)."""
        pid = os.getpid()
        events = []
        for s in self.spans:
            ev = {
                "name": s.name,
                "cat": "repro",
                "ph": "X" if s.dur_us is not None else "i",
                "ts": round(s.ts_us, 3),
                "pid": pid,
                "tid": s.tid,
                "args": {**s.args, "depth": s.depth},
            }
            if s.dur_us is not None:
                ev["dur"] = round(s.dur_us, 3)
            else:
                ev["s"] = "t"  # instant scope: thread
            events.append(ev)
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "recorder": "repro_torch.obs",
                "sample": self.sample,
                "dropped": self.dropped,
            },
        }

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


def load_trace(path: str) -> Dict[str, Any]:
    """Load an exported Chrome trace, validating the envelope the reporter
    (and Perfetto) depends on."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError(f"{path}: not a Chrome trace (no traceEvents list)")
    for ev in events:
        if "name" not in ev or "ph" not in ev or "ts" not in ev:
            raise ValueError(f"{path}: malformed trace event {ev!r}")
    return doc
