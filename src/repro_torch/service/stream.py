"""Streaming result delivery: per-request event streams + client handles.

A served simulation does not return once at the end — snapshots become
available at every chunk boundary the request's cadence hits, and a
production client wants them as they land (progress bars, live dashboards,
early-exit on divergence). Each :class:`~repro_torch.service.request.SimRequest`
admitted by the service gets a :class:`ResultStream`: an ordered,
thread-safe event queue the batcher pushes into between chunks.

Event kinds (``StreamEvent.kind``):

* ``"snapshot"`` — one observable frame; ``step`` is the request's own
  elapsed step count, ``payload`` the host-side numpy array;
* ``"evicted"`` — the request was checkpointed out to ``repro_torch.ckpt``;
  ``payload`` is the checkpoint directory;
* ``"resumed"`` — the request re-joined a bucket from its checkpoint;
* ``"done"`` — terminal; ``payload`` is the final
  :class:`~repro_torch.service.request.RequestResult`;
* ``"failed"`` — terminal; ``payload`` is the stringified error.

The service is cooperatively pumped (``SimService.pump`` /
``run_until_idle``), so single-threaded clients drain with the
non-blocking :meth:`ResultStream.drain`; a client on another thread can
block in :meth:`ResultStream.next_event`.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, List, NamedTuple, Optional

__all__ = ["StreamEvent", "ResultStream", "RequestHandle"]


class StreamEvent(NamedTuple):
    kind: str  # "snapshot" | "evicted" | "resumed" | "done" | "failed"
    step: int  # the request's elapsed steps when the event fired
    payload: Any = None


class ResultStream:
    """Ordered event stream for one request (producer: the batcher)."""

    def __init__(self):
        self._events: deque = deque()
        self._cv = threading.Condition()
        self._closed = False

    # -- producer side (service internals) ----------------------------------

    def emit(self, kind: str, step: int, payload=None) -> None:
        with self._cv:
            if self._closed:
                raise RuntimeError(f"stream already closed; cannot emit {kind!r}")
            self._events.append(StreamEvent(kind, int(step), payload))
            if kind in ("done", "failed"):
                self._closed = True
            self._cv.notify_all()

    # -- consumer side -------------------------------------------------------

    @property
    def closed(self) -> bool:
        """True once a terminal event (``done``/``failed``) was emitted."""
        with self._cv:
            return self._closed

    def drain(self) -> List[StreamEvent]:
        """Pop every event currently available (non-blocking)."""
        with self._cv:
            out = list(self._events)
            self._events.clear()
        return out

    def next_event(self, timeout: Optional[float] = None) -> Optional[StreamEvent]:
        """Blocking pop for threaded clients; None on timeout or when the
        stream is closed and fully drained."""
        with self._cv:
            while not self._events:
                if self._closed or not self._cv.wait(timeout=timeout):
                    return None
            return self._events.popleft()

    def __iter__(self):
        """Drain currently-available events (non-blocking iteration)."""
        return iter(self.drain())


class RequestHandle:
    """What ``SimService.submit`` returns: the client's view of one request.

    Wraps the live request record, so ``status``/``snapshots``/``result``
    reflect service progress as the caller pumps. Snapshot arrays are also
    accumulated here (in arrival order, with their step stamps) so a client
    that ignores the event stream still gets the full trajectory.
    """

    def __init__(self, record):
        self._record = record

    @property
    def id(self) -> int:
        return self._record.id

    @property
    def tag(self) -> str:
        return self._record.req.tag

    @property
    def status(self) -> str:
        return self._record.status

    @property
    def stream(self) -> ResultStream:
        return self._record.stream

    @property
    def bucket_key(self):
        """The scheduler's compatibility key this request packs under."""
        return self._record.key

    @property
    def snapshot_steps(self) -> List[int]:
        return [s for s, _ in self._record.snapshots]

    @property
    def snapshots(self) -> List[Any]:
        """Host-side observable frames delivered so far (arrival order)."""
        return [a for _, a in self._record.snapshots]

    @property
    def done(self) -> bool:
        return self._record.status in ("done", "failed")

    def result(self):
        """The final :class:`RequestResult`; raises unless ``status=='done'``."""
        if self._record.status == "failed":
            raise RuntimeError(
                f"request {self.id} failed: {self._record.error}"
            )
        if self._record.status != "done":
            raise RuntimeError(
                f"request {self.id} is {self._record.status!r}, not done — "
                "pump the service (SimService.run_until_idle) first"
            )
        return self._record.result

    def __repr__(self) -> str:
        r = self._record
        return (
            f"RequestHandle(id={r.id}, stepper={r.req.stepper!r}, "
            f"status={r.status!r}, elapsed={r.elapsed}/{r.steps})"
        )
