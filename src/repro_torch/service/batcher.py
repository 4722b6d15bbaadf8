"""Continuous batching onto ``Simulation.run_ensemble``, at chunk boundaries.

A :class:`Bucket` is one group of compatible requests (same
:class:`~repro_torch.service.request.BucketKey`) advancing together through
ONE ``run_ensemble`` call per chunk. On the kernel planes that call is one
launch a chunk for every member (the kernels take a member axis); on the
reference plane it runs member by member.

* **chunk size is event-driven**: the min over members of steps to the
  next event (own snapshot point or horizon), so no member is stepped past
  a point where a solo run would have paused. Members with heterogeneous
  cadences and horizons coexist; the bucket just pauses more often.
* **join/drain between chunks**: the member list is plain host state
  between chunks: finished requests drain out, queued compatible requests
  pack in, and the next chunk call restacks ``(state, tracker)``. Each
  member's :class:`~repro_torch.precision.SiteTracker` rows (split ``k``,
  EMAs, §5.3 counters) ride the stack and come back sliced, so repacking
  is invisible: a member's trajectory is bit-identical to its solo
  ``Simulation.run`` (``tests/test_torch_service.py``).
* **chunk-program cache**: one chunk callable per ``(bucket key, chunk
  steps, member count, sharded, mesh)``, LRU-bounded, as ``repro`` caches
  its jitted programs. The first call of a fresh entry books as compile
  time: on the card it is where a kernel's library loads and its launch
  plan and occupancy queries are first computed.

Why invisibility holds: a chunk of ``c1 + c2`` steps computes the same op
sequence as two chunks of ``c1`` then ``c2``, each member's lane computes
its solo bits, and snapshots are recorded only when a member's own
``elapsed`` hits its own cadence. The one deliberate relaxation, as in
``repro``: ``rr_tracked`` on the fused and megakernel planes latches its
floor and folds evidence at *bucket* chunk boundaries, which are finer than
a solo run's snapshot intervals when cadences mix; final splits and §5.3
counters still match.

Each chunk runs eagerly with ``run_ensemble(..., _drain=False)``: the
batcher drains every tracked member's tracker under its request's scope
``req<id>:<stepper>``, so the telemetry holds ``repro``'s scopes (whose
chunk runs inside ``jax.jit``, where the solver's drains skip).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Callable, List, Optional, Tuple

import repro_torch.obs as obs
import repro_torch.obs.health as health
from repro_torch.dist.sharding import active_mesh
from repro_torch.obs.timing import sync
from repro_torch.pack import member_of, stack_members
from repro_torch.precision.sites import SiteTracker, stack_site_trackers

from .metrics import ServiceMetrics
from .request import BucketKey, RequestRecord, RequestResult, host

__all__ = ["Bucket", "ChunkCompiler", "tree_stack", "tree_slice"]


def tree_stack(trees):
    """Stack congruent trees along a new leading member dim: state trees
    (PackedArrays by their payload and splits) or SiteTrackers (rows)."""
    if isinstance(trees[0], SiteTracker):
        return stack_site_trackers(trees)
    return stack_members(list(trees))


def tree_slice(tree, i: int):
    """Member ``i``'s slice of a stacked tree (drops the member dim)."""
    if isinstance(tree, SiteTracker):
        return tree.member(i)
    return member_of(tree, i)


class ChunkCompiler:
    """Chunk callables, cached per (key, chunk, n_members, sharded, mesh).

    The callable is ``run_ensemble(state_b, chunk, snapshot_every=chunk,
    tracker0_batch=tracker_b)``: one snapshot interval for the bucket,
    trackers threaded through and returned stacked for repacking. ``mesh``
    is the active ``axis_rules`` mesh (or None), so a callable made under
    one mesh never serves another.

    The cache is LRU-bounded (``maxsize``): event-driven chunking produces
    one chunk length per distinct member-event spacing, so a long-lived
    service with heterogeneous traffic would otherwise grow without limit.
    """

    def __init__(self, maxsize: int = 256):
        self.maxsize = maxsize
        self._cache: "OrderedDict[Tuple, Callable]" = OrderedDict()

    def get(
        self, sim, key: BucketKey, chunk: int, n: int, sharded: bool, mesh=None
    ) -> Tuple[Callable, bool]:
        """Returns ``(chunk_fn, fresh)``: ``fresh`` marks a cache miss, whose
        first call the batcher books as compile time, not a chunk-latency
        sample."""
        cache_key = (key, chunk, n, sharded, mesh)
        fn = self._cache.get(cache_key)
        fresh = fn is None
        if fresh:

            def chunk_fn(state_b, tracker_b):
                res = sim.run_ensemble(
                    state_b,
                    chunk,
                    snapshot_every=chunk,
                    tracker0_batch=tracker_b,
                    execution=key.execution,
                    sharded=sharded,
                    storage=key.storage,
                    _drain=False,
                )
                return res.state, res.snapshots, res.tracker

            fn = self._cache[cache_key] = chunk_fn
            if len(self._cache) > self.maxsize:
                self._cache.popitem(last=False)
        else:
            self._cache.move_to_end(cache_key)
        return fn, fresh

    def __len__(self) -> int:
        return len(self._cache)


class Bucket:
    """One packing of compatible requests; advances one chunk at a time."""

    def __init__(self, key: BucketKey):
        self.key = key
        self.members: List[RequestRecord] = []

    def __len__(self) -> int:
        return len(self.members)

    def add(self, rec: RequestRecord) -> None:
        if rec.key != self.key:
            raise ValueError(
                f"request {rec.id} (key {rec.key.short()}) is not compatible "
                f"with bucket {self.key.short()}"
            )
        self.members.append(rec)
        rec.status = "running"
        obs.instant("request.join", request=rec.id, bucket=self.key.short())

    def next_chunk(self) -> int:
        """Steps until the earliest member event: the next chunk's length."""
        return min(m.steps_to_next_event() for m in self.members)

    def advance(
        self,
        compiler: ChunkCompiler,
        metrics: ServiceMetrics,
        sharded: Optional[bool] = None,
    ) -> List[RequestRecord]:
        """Run one chunk for every member; returns the members that drained.

        ``sharded=None`` auto-detects: bucket members ride the logical
        ``batch`` axis whenever a ``dist.sharding.axis_rules`` mesh context
        is active (``repro_torch.dist.sharding.active_mesh``).

        The chunk clock stops after the device has finished the chunk's
        work (``obs.timing.sync``), as ``repro`` blocks until ready.
        """
        if not self.members:
            return []
        mesh = active_mesh()
        if sharded is None:
            sharded = mesh is not None
        chunk = self.next_chunk()
        n = len(self.members)
        sim = self.members[0].sim  # identical (stepper, cfg, prec) by key

        state_b = tree_stack([m.state for m in self.members])
        tracked = self.members[0].tracked
        tracker_b = (
            tree_stack([m.tracker for m in self.members]) if tracked else None
        )

        fn, fresh = compiler.get(
            sim, self.key, chunk, n, sharded, mesh=mesh if sharded else None
        )
        with obs.span(
            "service.chunk",
            bucket=self.key.short(),
            members=n,
            steps=chunk,
            compile=fresh,
        ):
            t0 = time.perf_counter()
            out_state, out_snaps, out_tracker = sync(fn(state_b, tracker_b), sim.device)
            dt = time.perf_counter() - t0
        metrics.observe_chunk(self.key, n, chunk, dt, compiled=fresh)
        mon = health.active()

        # the snapshots lead with (member, n_out=1, ...): one copy to the host for the chunk
        due = any((m.elapsed + chunk) % m.every == 0 for m in self.members)
        frames = out_snaps[:, 0].cpu().numpy() if due else None
        drained: List[RequestRecord] = []
        for i, m in enumerate(self.members):
            m.state = tree_slice(out_state, i)
            if tracked:
                m.tracker = tree_slice(out_tracker, i)
                obs.record_tracker(
                    f"req{m.id}:{m.key.stepper}", m.tracker, m.elapsed + chunk
                )
                if mon is not None:
                    mon.on_tracker(m, chunk)
            m.elapsed += chunk
            m.chunks += 1
            if m.snapshot_due():
                snap = frames[i]
                m.snapshots.append((m.elapsed, snap))
                m.stream.emit("snapshot", m.elapsed, snap)
                metrics.snapshots_emitted += 1
                if mon is not None:
                    mon.observe_frame(m, snap)
            if m.remaining == 0:
                drained.append(m)

        # chunk-boundary health evaluation after the member updates, so the
        # detectors see the telemetry this chunk just drained
        if mon is not None:
            mon.on_chunk(self.key, n, chunk, dt, compiled=fresh)

        for m in drained:
            self.members.remove(m)
            self._finalize(m, metrics)
            if mon is not None:
                mon.on_request_done(m)
        return drained

    @staticmethod
    def _finalize(m: RequestRecord, metrics: ServiceMetrics) -> None:
        final_k, adjustments = m.site_summary()
        m.status = "done"
        m.result = RequestResult(
            state=host(m.state),
            snapshots=[a for _, a in m.snapshots],
            snapshot_steps=[s for s, _ in m.snapshots],
            tracker=m.tracker,
            final_k=final_k,
            adjustments=adjustments,
            elapsed=m.elapsed,
            chunks=m.chunks,
        )
        m.stream.emit("done", m.elapsed, m.result)
        obs.instant(
            "request.done", request=m.id, steps=m.elapsed, chunks=m.chunks
        )
        metrics.observe_completion(adjustments)
