"""Admission, bucketing and the `SimService` facade.

The scheduler — not the user — decides how requests pack onto hardware
(the RAPTOR/Siklósi shape: every request carries its own stepper, horizon
and validated precision artifact; the service owns the packing):

* **admission control** — a bounded FIFO queue; ``submit`` resolves the
  request eagerly (bad steppers/modes/artifacts are rejected before they
  cost anything) and raises :class:`ServiceOverloaded` once the queue is
  full — backpressure the client can see.
* **bucketing** — queued requests join the first
  :class:`~repro_torch.service.batcher.Bucket` of their
  :class:`~repro_torch.service.request.BucketKey` with room (``max_bucket``
  caps the members of one chunk call; further compatible requests open
  sibling buckets), up to
  ``max_active_members`` total running members — the service's hardware
  occupancy budget. Joins happen only at chunk boundaries, which is when
  ``pump`` runs the fill pass.
* **eviction / resume** — ``evict`` checkpoints a running member's
  ``(state, tracker)`` through :mod:`repro_torch.ckpt` (atomic, bit-exact
  arrays) and frees its slot; ``resume`` restores it onto the service's
  device and re-queues it, and the fill
  pass auto-resumes evicted members whenever slots are free and no fresh
  work is queued. With ``auto_evict=True`` the fill pass itself evicts the
  longest-remaining member to admit shorter queued work — the
  long-horizon-spill policy. Resumed members rejoin at a chunk boundary
  with their carried tracker intact, so an evicted+resumed request's
  trajectory is bit-identical to an uninterrupted one (tested).

``pump()`` is one cooperative scheduling iteration (fill → advance one
bucket one chunk → fill); ``run_until_idle()`` drives it to completion.
Single-process and synchronous by design — the batching/scheduling
semantics are the subject here, not an async runtime; a server front-end
can pump this loop from any thread.

A service runs its requests on one device: ``SimService(device=None)``
means the CUDA card, and raises without one, as ``Simulation`` does; pass
``device="cpu"`` for the plain PyTorch versions. A chunk that fails fails
its members and re-raises: nothing falls back to another plane or device.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from collections import deque
from typing import Deque, Dict, List, Optional

import torch

import repro_torch.obs as obs
import repro_torch.obs.health as health
from repro_torch import _tree
from repro_torch._device import resolve_device
from repro_torch.ckpt import checkpoint as ckpt

from .batcher import Bucket, ChunkCompiler
from .metrics import ServiceMetrics
from .request import RequestRecord, SimRequest, resolve_request
from .stream import RequestHandle

__all__ = ["ServiceConfig", "ServiceOverloaded", "SimService"]


class ServiceOverloaded(RuntimeError):
    """Admission queue is full — backpressure; retry later."""


@dataclasses.dataclass
class ServiceConfig:
    """Knobs of the serving plane (all host-side scheduling policy)."""

    max_queue: int = 64  # admission bound; submit raises beyond it
    max_bucket: int = 8  # members of one chunk call, at most
    max_active_members: int = 16  # total running members (occupancy budget)
    ckpt_dir: str = "artifacts/service_ckpt"  # eviction checkpoint root
    auto_evict: bool = False  # spill longest-remaining members under pressure
    evict_min_remaining: int = 64  # only members with more left are spillable
    auto_resume: bool = True  # restore evicted members when slots free up
    #: None = auto: shard bucket members on the logical ``batch`` axis iff a
    #: ``dist.sharding.axis_rules`` mesh context is active at chunk time.
    #: The context stack is THREAD-LOCAL — pump from the thread that entered
    #: ``axis_rules`` (or pass an explicit True and enter the context around
    #: the pumping thread's loop); a different thread sees no mesh and would
    #: silently run unsharded.
    sharded: Optional[bool] = None
    #: how many terminal (done/failed) RequestRecords the service itself
    #: retains for ``handle(id)`` lookups; older ones are released so a
    #: long-lived service never grows unbounded host state (clients holding
    #: a RequestHandle keep their record alive regardless)
    retain_terminal: int = 1024


class SimService:
    """The batched simulation-serving plane (see module docstring)."""

    def __init__(self, config: Optional[ServiceConfig] = None, *, device=None):
        self.config = config or ServiceConfig()
        self.device = resolve_device(device)
        self.metrics = ServiceMetrics()
        self._queue: Deque[RequestRecord] = deque()
        self._buckets: Dict[object, List[Bucket]] = {}
        self._requests: Dict[int, RequestRecord] = {}
        self._terminal: Deque[int] = deque()  # retention FIFO of finished ids
        self._evicted: Deque[RequestRecord] = deque()
        self._ids = itertools.count(1)
        self._compiler = ChunkCompiler()
        self._rr = 0  # round-robin bucket cursor

    # -- client surface ------------------------------------------------------

    def submit(self, req: SimRequest) -> RequestHandle:
        """Admit one request (resolved eagerly; may raise, see
        ``resolve_request``) or raise :class:`ServiceOverloaded`."""
        if len(self._queue) >= self.config.max_queue:
            self.metrics.rejected += 1
            raise ServiceOverloaded(
                f"admission queue is full ({self.config.max_queue} requests); "
                "pump the service or retry later"
            )
        try:
            rec = resolve_request(next(self._ids), req, device=self.device)
        except Exception:
            self.metrics.rejected += 1
            raise
        self._queue.append(rec)
        self._requests[rec.id] = rec
        self.metrics.submitted += 1
        mon = health.active()
        if mon is not None:
            mon.on_submit(rec)  # deterministic shadow-sampling decision
        obs.instant(
            "request.submit",
            request=rec.id,
            stepper=rec.key.stepper,
            mode=rec.key.prec.mode,
            steps=rec.steps,
        )
        return RequestHandle(rec)

    def handle(self, request_id: int) -> RequestHandle:
        return RequestHandle(self._requests[request_id])

    def pump(self) -> bool:
        """One scheduling iteration: fill buckets, advance ONE bucket by one
        chunk, fill again (joins/drains happen at the boundary). Returns
        False when there is nothing left to do."""
        with obs.span("service.pump") as sp:
            self._fill()
            buckets = self._live_buckets()
            if not buckets:
                return False
            bucket = buckets[self._rr % len(buckets)]
            self._rr += 1
            if sp is not None:
                sp["bucket"] = bucket.key.short()
                sp["members"] = len(bucket)
            mon = health.active()
            if mon is not None:
                mon.note_occupancy(self.queued, self.active_members)
            try:
                drained = bucket.advance(
                    self._compiler, self.metrics, sharded=self.config.sharded
                )
            except Exception as e:  # compile/runtime failure: fail the members
                for m in list(bucket.members):
                    bucket.members.remove(m)
                    m.status = "failed"
                    m.error = repr(e)
                    m.stream.emit("failed", m.elapsed, repr(e))
                    self.metrics.failed += 1
                    self._retire(m)
                    if mon is not None:
                        mon.on_request_failed(m, repr(e))
                raise
            for m in drained:
                self._retire(m)
            self._gc_buckets()
            self._fill()
        return True

    def _retire(self, rec: RequestRecord) -> None:
        """Bound service-side retention of terminal records: keep the most
        recent ``retain_terminal`` for ``handle(id)`` lookups, release the
        rest (outstanding RequestHandles keep their record alive)."""
        self._terminal.append(rec.id)
        while len(self._terminal) > self.config.retain_terminal:
            self._requests.pop(self._terminal.popleft(), None)

    def run_until_idle(self, max_chunks: int = 100_000) -> ServiceMetrics:
        """Pump until no bucket has members and the queue is empty (evicted
        members auto-resume along the way unless ``auto_resume=False``)."""
        for _ in range(max_chunks):
            if not self.pump():
                break
        return self.metrics

    # -- occupancy -----------------------------------------------------------

    @property
    def active_members(self) -> int:
        return sum(len(b) for bs in self._buckets.values() for b in bs)

    @property
    def queued(self) -> int:
        return len(self._queue)

    @property
    def evicted_ids(self) -> List[int]:
        return [m.id for m in self._evicted]

    def _live_buckets(self) -> List[Bucket]:
        return [b for bs in self._buckets.values() for b in bs if b.members]

    def _gc_buckets(self) -> None:
        for key in list(self._buckets):
            self._buckets[key] = [b for b in self._buckets[key] if b.members]
            if not self._buckets[key]:
                del self._buckets[key]

    # -- bucketing -----------------------------------------------------------

    def _bucket_for(self, rec: RequestRecord) -> Bucket:
        buckets = self._buckets.setdefault(rec.key, [])
        for b in buckets:
            if len(b) < self.config.max_bucket:
                return b
        b = Bucket(rec.key)
        buckets.append(b)
        return b

    def _fill(self) -> None:
        cfg = self.config
        while self._queue and self.active_members < cfg.max_active_members:
            rec = self._queue.popleft()
            self._bucket_for(rec).add(rec)
        # pressure: spill the longest-remaining member to admit queued work
        while self._queue and cfg.auto_evict:
            victim = self._evictable()
            if victim is None or victim.remaining <= self._queue[0].remaining:
                break
            self.evict(victim.id)
            rec = self._queue.popleft()
            self._bucket_for(rec).add(rec)
        # free slots + no fresh work: transparently restore evicted members
        while (
            cfg.auto_resume
            and self._evicted
            and not self._queue
            and self.active_members < cfg.max_active_members
        ):
            self.resume(self._evicted[0].id)
            rec = self._queue.popleft()  # resume() re-queues; admit it now
            self._bucket_for(rec).add(rec)

    def _evictable(self) -> Optional[RequestRecord]:
        members = [m for b in self._live_buckets() for m in b.members]
        members = [m for m in members if m.remaining > self.config.evict_min_remaining]
        return max(members, key=lambda m: m.remaining) if members else None

    # -- eviction / resume ---------------------------------------------------

    def _ckpt_dir(self, rec: RequestRecord) -> str:
        return os.path.join(self.config.ckpt_dir, f"req_{rec.id:06d}")

    def evict(self, request_id: int) -> str:
        """Checkpoint a running (or still-queued) request out of the service.

        The member's carried ``(state, tracker)`` goes through
        ``repro_torch.ckpt`` (atomic directory rename; the arrays round-trip
        bit-exactly, in ``repro``'s layout) stamped with its elapsed step;
        the slot frees immediately. Returns the checkpoint directory."""
        rec = self._requests[request_id]
        if rec.status not in ("running", "queued"):
            raise ValueError(
                f"request {request_id} is {rec.status!r}; only running or "
                "queued requests can be evicted"
            )
        tree = {"state": rec.state, "tracker": rec.tracker}
        rec.ckpt_dir = self._ckpt_dir(rec)
        ckpt.save(tree, rec.ckpt_dir, step=rec.elapsed)
        # the tree's structure, shapes and dtypes on ``meta``, for the restore
        rec.like = _tree.tree_map(
            lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), tree
        )
        if rec.status == "running":
            for b in self._buckets.get(rec.key, []):
                if rec in b.members:
                    b.members.remove(rec)
                    break
            self._gc_buckets()
        else:
            self._queue.remove(rec)
        rec.state = None
        rec.tracker = None
        rec.status = "evicted"
        self._evicted.append(rec)
        rec.stream.emit("evicted", rec.elapsed, rec.ckpt_dir)
        obs.instant("request.evict", request=rec.id, step=rec.elapsed)
        self.metrics.evicted += 1
        return rec.ckpt_dir

    def resume(self, request_id: int) -> RequestHandle:
        """Restore an evicted request from its checkpoint and re-queue it;
        it rejoins a bucket at the next fill pass with its adjust-unit state
        (split ``k``, EMAs, §5.3 counters) exactly as checkpointed, on the
        service's device."""
        rec = self._requests[request_id]
        if rec.status != "evicted":
            raise ValueError(f"request {request_id} is {rec.status!r}, not evicted")
        step = ckpt.latest_step(rec.ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {rec.ckpt_dir}")
        tree = ckpt.restore(rec.like, rec.ckpt_dir, step, device=self.device)
        rec.state, rec.tracker = tree["state"], tree["tracker"]
        rec.elapsed = step
        rec.status = "queued"
        self._evicted.remove(rec)
        self._queue.append(rec)
        rec.stream.emit("resumed", rec.elapsed)
        obs.instant("request.resume", request=rec.id, step=rec.elapsed)
        self.metrics.resumed += 1
        return RequestHandle(rec)
