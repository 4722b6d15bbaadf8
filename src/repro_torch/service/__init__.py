"""repro_torch.service: the batched simulation-serving plane (DESIGN.md §12),
as ``repro.service`` has it, on the port's kernels.

Concurrent, heterogeneous simulation requests (each with its own stepper,
horizon, snapshot cadence and precision policy artifact) are batched at
chunk boundaries onto ``Simulation.run_ensemble``, whose kernel planes run
every member of a bucket in one launch a chunk, while every request's
numerics stay bit-identical to a solo run.

    from repro_torch.service import SimRequest, SimService

    svc = SimService()          # the CUDA card; SimService(device="cpu") on the CPU
    h = svc.submit(SimRequest("heat2d", steps=1500, precision="rr_tracked"))
    svc.run_until_idle()
    res = h.result()            # snapshots streamed; final splits in res.final_k
    print(svc.metrics.report()) # throughput, p50/p99 chunk latency, occupancy

Layers: :mod:`~repro_torch.service.request` (job model and admission-time
resolution), :mod:`~repro_torch.service.scheduler` (bounded-queue
admission, bucketing, eviction/resume policy, the :class:`SimService`
facade), :mod:`~repro_torch.service.batcher` (continuous batching at chunk
boundaries onto ``Simulation.run_ensemble``), :mod:`~repro_torch.service.stream`
(per-request event streams), :mod:`~repro_torch.service.metrics` (the
observability surface).
"""

from __future__ import annotations

from .batcher import Bucket, ChunkCompiler
from .metrics import ServiceMetrics
from .request import (
    BucketKey,
    RequestRecord,
    RequestResult,
    SimRequest,
    resolve_request,
    scaled_state0,
)
from .scheduler import ServiceConfig, ServiceOverloaded, SimService
from .stream import RequestHandle, ResultStream, StreamEvent

__all__ = [
    "SimRequest",
    "SimService",
    "ServiceConfig",
    "ServiceOverloaded",
    "RequestHandle",
    "RequestRecord",
    "RequestResult",
    "ResultStream",
    "StreamEvent",
    "ServiceMetrics",
    "Bucket",
    "BucketKey",
    "ChunkCompiler",
    "resolve_request",
    "scaled_state0",
]
