"""The service's job model: what one simulation request is, resolved once.

A :class:`SimRequest` is the wire-level ask: stepper name, config
overrides, precision mode, an optional validated
:class:`~repro_torch.profile.PrecisionPolicy` artifact, horizon and
snapshot cadence. Admission resolves it into a :class:`RequestRecord`, the
mutable runtime record the scheduler buckets and the batcher advances:

* the precision string or preset becomes an **effective**
  :class:`~repro_torch.core.policy.PrecisionConfig`: policy artifacts are
  resolved through the shared :func:`repro_torch.profile.resolve_policy`
  gate (validated only, format re-based) and their ``[k_lo, k_hi]`` hints
  installed through ``PrecisionPolicy.apply`` (the site names are the
  stepper's own);
* tracked modes get a per-request
  :class:`~repro_torch.precision.SiteTracker` on the service's device,
  seeded at the artifact's tuned splits (or the wide default): the
  per-member adjust-unit state that survives bucket repacking;
* ``execution="auto"`` is resolved **at admission** on the service's
  device, so the bucket key is concrete and an ineligible explicit
  ``"fused"`` fails at submit instead of mid-flight;
* the initial state (a numpy array or a tensor, or the stepper's own) moves
  to the service's device; under ``storage="packed"`` it is packed there,
  as a solo run packs its entry state, so a member that joins a running
  bucket stacks with the payloads already in it.

The :class:`BucketKey` is the scheduler's compatibility contract: requests
sharing ``(stepper, cfg, effective precision, execution plane, state-shape
signature, storage)`` step through identical per-member programs and may
share one ``run_ensemble`` call a chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import _tree
from repro_torch._device import resolve_device
from repro_torch.core.ftz import card_flush
from repro_torch.core.policy import PRESETS, PrecisionConfig
from repro_torch.pack import PackedArray, is_packed
from repro_torch.pde.solver import Simulation
from repro_torch.profile.artifact import PrecisionPolicy, resolve_policy

from .stream import ResultStream

__all__ = [
    "SimRequest",
    "RequestRecord",
    "RequestResult",
    "BucketKey",
    "resolve_request",
    "scaled_state0",
]


@dataclasses.dataclass
class SimRequest:
    """One client ask. Everything beyond ``stepper``/``steps`` is optional.

    ``precision`` may be a preset name (``"r2f2_16"``, ``"e5m10"``, ...), a
    bare mode name (``"rr_tracked"``, ``"deploy"``), or a full
    :class:`PrecisionConfig`. ``overrides`` are ``dataclasses.replace``
    fields on the stepper's default config (or on ``cfg`` when given).
    ``policy`` is a PrecisionPolicy artifact (object or JSON path): it must
    be validated-accepted and profiled for this stepper. ``state0`` replaces
    the stepper's initial condition (a numpy array or a tensor on any
    device). ``storage`` selects the carried-state format between chunks
    (:data:`repro_torch.pde.solver.STORAGE_MODES`: ``"packed"`` members
    carry R2F2 payloads through the whole bucket lifecycle, eviction
    included). ``tag`` is a free-form client label echoed in reports.
    """

    stepper: str
    steps: int
    precision: Union[str, PrecisionConfig] = "f32"
    overrides: Optional[Dict[str, Any]] = None
    cfg: Any = None
    policy: Union[str, PrecisionPolicy, None] = None
    snapshot_every: Optional[int] = None
    execution: str = "auto"
    state0: Any = None
    storage: str = "f32"
    tag: str = ""


class RequestResult(NamedTuple):
    """Terminal payload of a completed request."""

    state: Any  # final solver state on the host (numpy; a PackedArray of numpy payload and splits when packed)
    snapshots: List[Any]  # observable frames (numpy), arrival order
    snapshot_steps: List[int]
    tracker: Optional[Any]  # final SiteTracker (tracked modes), on the service's device
    final_k: Optional[Dict[str, int]]  # per-site converged splits
    adjustments: Optional[Dict[str, Tuple[int, int]]]  # site -> (grew, shrank)
    elapsed: int
    chunks: int  # how many bucket chunks this request rode


class BucketKey(NamedTuple):
    """Scheduler compatibility key (see the module docstring). ``storage``
    is part of the key: packed members carry PackedArrays and never share a
    stack with f32 members."""

    stepper: str
    cfg: Any
    prec: PrecisionConfig
    execution: str
    shape_sig: Any
    storage: str = "f32"

    def short(self) -> str:
        s = f"{self.stepper}/{self.prec.mode}/{self.execution}"
        return s if self.storage == "f32" else f"{s}/{self.storage}"


def _shape_sig(state) -> Tuple:
    """Each leaf's path, shape and dtype (a PackedArray's payload and splits)."""
    return tuple((path, tuple(x.shape), str(x.dtype)) for path, x in _tree.flatten(state))


def _resolve_precision(precision: Union[str, PrecisionConfig]) -> PrecisionConfig:
    if isinstance(precision, PrecisionConfig):
        return precision
    if precision in PRESETS:
        return PRESETS[precision]
    # a bare mode name ("rr_tracked", "deploy", a registered mode);
    # PrecisionConfig validates it against the registry's known modes
    return PrecisionConfig(mode=precision)


def _on_device(state0, device):
    """A client's initial state on the service's device: f32 tensors, and a
    PackedArray's payload and splits as they are."""
    if isinstance(state0, PackedArray):
        return state0.to(device)

    def leaf(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=torch.float32)
        return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)

    return _tree.tree_map(leaf, state0)


class RequestRecord:
    """The live, mutable runtime record of one admitted request.

    ``state``/``tracker`` are the member's carried simulation state between
    chunks, on the service's device: the batcher stacks them into a
    bucket's ``run_ensemble`` call and hands the sliced results back, so
    the adjust unit's ``k`` and §5.3 counters survive repacking, eviction
    and resume.

    Lifecycle (``status``): ``queued`` -> ``running`` -> (``evicted`` <->
    ``running``) -> ``done`` | ``failed``.
    """

    def __init__(self, rid: int, req: SimRequest, sim: Simulation, key: BucketKey,
                 state, tracker, steps: int, every: int):
        self.id = rid
        self.req = req
        self.sim = sim
        self.key = key
        self.state = state
        self.tracker = tracker
        self.tracked = tracker is not None
        self.steps = steps
        self.every = every
        self.elapsed = 0
        self.chunks = 0
        self.status = "queued"
        self.stream = ResultStream()
        self.snapshots: List[Tuple[int, Any]] = []
        self.result: Optional[RequestResult] = None
        self.error: Optional[str] = None  # set when status == "failed"
        self.ckpt_dir: Optional[str] = None
        self.like = None  # the (state, tracker) tree on ``meta`` that restores the checkpoint

    # -- scheduling queries --------------------------------------------------

    @property
    def remaining(self) -> int:
        return self.steps - self.elapsed

    def steps_to_next_event(self) -> int:
        """Steps until this member next needs the bucket to pause: its own
        snapshot point or its horizon, whichever is sooner. The bucket chunk
        is the min of this over members (continuous batching never steps a
        member past one of its events)."""
        return min(self.remaining, self.every - (self.elapsed % self.every))

    def snapshot_due(self) -> bool:
        """Does the current ``elapsed`` coincide with one of the snapshot
        points a solo ``Simulation.run(steps, snapshot_every=every)`` would
        record? Exactly the positive multiples of the cadence: chunking
        never advances past the horizon, so every such multiple is one the
        solo run snapshots (remainder steps never land on one)."""
        return self.elapsed > 0 and self.elapsed % self.every == 0

    def site_summary(self):
        """(final_k, adjustments) dicts from the carried tracker, or Nones."""
        if self.tracker is None:
            return None, None
        st = self.tracker.state
        names = self.tracker.names
        k, grew, shrank = st.k.tolist(), st.overflow_steps.tolist(), st.shrink_steps.tolist()
        final_k = dict(zip(names, k))
        adjustments = {n: (g, s) for n, g, s in zip(names, grew, shrank)}
        return final_k, adjustments

    def __repr__(self) -> str:
        return (
            f"RequestRecord(id={self.id}, {self.key.short()}, "
            f"{self.elapsed}/{self.steps}, {self.status})"
        )


def resolve_request(rid: int, req: SimRequest, *, device=None) -> RequestRecord:
    """Admission-time resolution on ``device`` (None: the card): validate
    and freeze everything static.

    Raises (rejecting the request before it enters the queue) on: unknown
    stepper/mode, invalid horizon, unvalidated or foreign policy artifacts,
    format-mismatched artifacts, and explicitly-requested-but-ineligible
    fused execution.
    """
    if req.steps <= 0:
        raise ValueError(f"request horizon must be positive, got {req.steps}")
    if req.snapshot_every is not None and req.snapshot_every <= 0:
        raise ValueError(
            f"snapshot_every must be positive, got {req.snapshot_every}: a "
            "non-positive cadence would drive bucket chunking backwards"
        )
    device = resolve_device(device)
    prec = _resolve_precision(req.precision)
    sim0 = Simulation(req.stepper, req.cfg, prec, device=device)  # resolves stepper + default cfg
    stepper, cfg = sim0.stepper, sim0.cfg
    if req.overrides:
        cfg = dataclasses.replace(cfg, **req.overrides)

    policy = None
    if req.policy is not None:
        prec, policy = resolve_policy(prec, req.policy)  # accepted gate + fmt re-base
        if policy.stepper != stepper.name:
            raise ValueError(
                f"policy artifact was profiled for stepper {policy.stepper!r} "
                f"but the request targets {stepper.name!r}; per-site splits "
                "do not transfer across steppers"
            )
        prec = policy.apply(prec, stepper.sites)  # [k_lo, k_hi] -> prec.k_bounds

    sim = Simulation(stepper, cfg, prec, device=device)
    execution = sim._resolve_execution(req.execution)  # "auto" -> concrete plane
    storage = sim._resolve_storage(req.storage)  # reject unknown formats at admission

    if req.state0 is None:
        with card_flush(device):
            state0 = stepper.init_state(cfg, device=device)
    else:
        state0 = _on_device(req.state0, device)
    if storage == "packed" and not is_packed(state0):
        # a packed member carries payloads from admission on, packed as a solo
        # run packs its entry state, so members that join a running bucket
        # stack with the payloads already there
        with card_flush(device):
            state0 = sim._storage_in(sim._entry(state0, req.steps), storage)
    tracker = sim.init_tracker(k0=None if policy is None else policy.k_array(stepper.sites))
    every = req.snapshot_every or max(1, req.steps // stepper.snapshots_default)

    key = BucketKey(stepper.name, cfg, prec, execution, _shape_sig(state0), storage)
    return RequestRecord(rid, req, sim, key, state0, tracker, req.steps, every)


def scaled_state0(stepper_name: str, scale: float = 1.0, overrides=None, *, device=None):
    """A stepper's default initial condition scaled by ``scale`` (with
    optional config-override fields), on ``device`` (None: the card): the
    bursts' way of submitting members that differ while staying
    bucket-compatible."""
    from repro_torch.pde.registry import get_stepper

    device = resolve_device(device)
    stepper = get_stepper(stepper_name)
    cfg = stepper.default_config()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    with card_flush(device):
        return _tree.tree_map(lambda x: (scale * x).to(x.dtype), stepper.init_state(cfg, device=device))


def host(tree):
    """A state tree on the host as numpy arrays (a PackedArray's payload and
    splits too)."""
    return _tree.tree_map(lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x), tree)
