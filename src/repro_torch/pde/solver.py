"""PDE solver framework: Stepper protocol and the Simulation driver.

* a :class:`Stepper` is the workload: ``init_state / step / observables``
  plus its named policy sites;
* :class:`StepOps` is the per-step arithmetic context: ``mul/div/add/rsqrt``
  route through the precision engine and thread the tracker;
* :class:`Simulation` drives the snapshot loop on two planes:
  ``"reference"`` steps the ``StepOps`` path one update at a time, and
  ``"fused"`` runs whole snapshot intervals through the stepper's
  ``fused_step`` hook (the CUDA kernels) and folds the kernels' per-site
  evidence into the carried tracker between chunks.

The loops issue no host synchronisation per step: trackers stay on the
state's device, and the fused plane copies one chunk's evidence to the host
to fold it.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.core.policy import PrecisionConfig
from repro_torch.kernels.fused import CAPTURE_PENDING, STORAGE_PENDING
from repro_torch.pde.registry import get_stepper
from repro_torch.precision import fold_evidence, fused_eligible, get_engine, site_tracker_init

__all__ = ["Stepper", "StepOps", "Simulation", "SimResult", "EXECUTIONS"]

EXECUTIONS = ("reference", "fused", "megakernel", "auto")
MEGAKERNEL_PENDING = (
    "the megakernel plane is not ported to repro_torch yet: ROADMAP.md queue 1 item 5 "
    "(execution='auto' resolves to it in repro, so it is refused here too)"
)
ENSEMBLE_PENDING = "run_ensemble is not ported to repro_torch yet: ROADMAP.md queue 1 item 9"


class StepOps:
    """Per-step policy arithmetic for stepper code: ``ops.mul(a, b, site)``
    calls the engine and carries the updated tracker in ``self.tracker``."""

    __slots__ = ("prec", "tracker", "_engine")

    def __init__(self, prec: PrecisionConfig, tracker=None):
        self.prec = prec
        self.tracker = tracker
        self._engine = get_engine(prec)

    def mul(self, a, b, site: str):
        out, self.tracker = self._engine.multiply(a, b, self.prec, tracker=self.tracker, site=site)
        return out

    def mul_add(self, a, b, c, site: str):
        """``a * b + c`` with the product on the policy's multiplier at a
        named site (one rounding where the compiled reference fuses it)."""
        out, self.tracker = self._engine.multiply_add(a, b, c, self.prec, tracker=self.tracker, site=site)
        return out

    def add(self, a, b, site: str):
        out, self.tracker = self._engine.add(a, b, self.prec, tracker=self.tracker, site=site)
        return out

    def div(self, a, b, site: Optional[str] = None):
        """Quotient; with a named site this is the tracked flexible divider."""
        if site is None:
            return self._engine.divide(a, b, self.prec)[0]
        out, self.tracker = self._engine.divide(a, b, self.prec, tracker=self.tracker, site=site)
        return out

    def rsqrt(self, x, site: Optional[str] = None):
        if site is None:
            return self._engine.rsqrt(x, self.prec)[0]
        out, self.tracker = self._engine.rsqrt(x, self.prec, tracker=self.tracker, site=site)
        return out

    def store(self, x):
        return self._engine.store(x, self.prec)


class Stepper:
    """One PDE workload. Subclasses implement ``init_state`` and ``step``
    and declare their named sites; ``fused_step`` is the optional fused-plane
    hook ``fused_step(state, cfg, prec, steps, *, k_floor=None,
    collect_evidence=False) -> (state, evidence)``."""

    name: str = "?"
    sites: Tuple[str, ...] = ()
    site_ops: Tuple[str, ...] = ()
    failure_mode: str = "?"
    story: str = ""
    snapshots_default: int = 8
    fused_step = None

    def fused_supported(self, cfg, prec: PrecisionConfig) -> bool:
        return True

    def default_config(self):
        raise NotImplementedError

    def init_state(self, cfg, *, device):
        raise NotImplementedError

    def step(self, state, cfg, ops: StepOps):
        raise NotImplementedError

    def observables(self, state, cfg):
        return state

    def metric_offset(self, cfg) -> float:
        return 0.0


class SimResult(NamedTuple):
    """What a run returns; ``tracker`` is None for untracked modes."""

    state: Any
    snapshots: Any
    tracker: Optional[Any]
    profile: Optional[Any] = None


class Simulation:
    """The snapshot loop, owned once for every stepper.

    ``stepper`` is a registered name or a Stepper; ``cfg`` None means the
    stepper's default. ``device`` None means CUDA (raising without a card).
    """

    def __init__(self, stepper, cfg, prec: PrecisionConfig, *, device=None):
        self.stepper = get_stepper(stepper) if isinstance(stepper, str) else stepper
        self.cfg = self.stepper.default_config() if cfg is None else cfg
        self.prec = prec
        self.device = resolve_device(device)

    def init_tracker(self, k0: Optional[int] = None):
        """Fresh SiteTracker over the stepper's sites (tracked modes only)."""
        if not (get_engine(self.prec).tracks and self.stepper.sites):
            return None
        return site_tracker_init(self.stepper.sites, self.prec.fmt, k0=k0, device=self.device)

    def fused_eligible(self) -> bool:
        return fused_eligible(self.prec, self.stepper, self.cfg)

    def _resolve_execution(self, execution: str) -> str:
        if execution not in EXECUTIONS:
            raise ValueError(f"unknown execution mode {execution!r}; expected one of {EXECUTIONS}")
        if execution in ("megakernel", "auto"):
            raise NotImplementedError(MEGAKERNEL_PENDING)
        if execution == "fused" and not self.fused_eligible():
            raise ValueError(
                f"stepper {self.stepper.name!r} is not fused-eligible under mode {self.prec.mode!r}"
            )
        return execution

    def run(
        self,
        steps: int,
        *,
        snapshot_every: Optional[int] = None,
        state0=None,
        tracker=None,
        execution: str = "reference",
        capture=None,
        policy=None,
        storage: str = "f32",
    ) -> SimResult:
        """Advance ``steps`` updates, snapshotting observables every
        ``snapshot_every`` steps (default ``steps // snapshots_default``).
        A trailing remainder of steps runs after the last snapshot.

        ``execution`` is ``"reference"`` or ``"fused"``. Pass ``tracker`` to
        resume tracked modes from saved adjust-unit state.
        """
        execution = self._resolve_execution(execution)
        if storage != "f32":
            raise NotImplementedError(STORAGE_PENDING)
        if capture is not None or policy is not None:
            raise NotImplementedError(CAPTURE_PENDING)
        stepper, cfg = self.stepper, self.cfg
        if state0 is None:
            state = stepper.init_state(cfg, device=self.device)
        else:
            state = torch.as_tensor(state0).to(device=self.device, dtype=torch.float32)
        if tracker is None:
            tracker = self.init_tracker()
        else:
            tracker = tracker.to(self.device)
        every = snapshot_every or max(1, steps // stepper.snapshots_default)
        n_out, rem = divmod(steps, every)
        advance = self._chunk_fused if execution == "fused" else self._chunk_reference

        snaps = []
        for _ in range(n_out):
            state, tracker = advance(state, tracker, every)
            snaps.append(stepper.observables(state, cfg))
        if rem:
            state, tracker = advance(state, tracker, rem)
        if snaps:
            snapshots = torch.stack(snaps)
        else:
            obs = stepper.observables(state, cfg)
            snapshots = obs.new_empty((0,) + tuple(obs.shape))
        return SimResult(state, snapshots, tracker)

    def _chunk_reference(self, state, tracker, n: int):
        for _ in range(n):
            ops = StepOps(self.prec, tracker)
            state = self.stepper.step(state, self.cfg, ops)
            tracker = ops.tracker
        return state, tracker

    def _chunk_fused(self, state, tracker, n: int):
        """One fused chunk: the carried splits enter as the rr family's
        floor, and the chunk's evidence replays through the adjust law."""
        prec = self.prec
        state, ev = self.stepper.fused_step(
            state, self.cfg, prec, n,
            k_floor=None if tracker is None else tracker.state.k,
            collect_evidence=tracker is not None and not prec.pinned,
        )
        if tracker is not None:
            tracker = fold_evidence(tracker, ev, prec, ops=self.stepper.site_ops or None)
        return state, tracker

    def run_ensemble(self, *args, **kwargs):
        raise NotImplementedError(ENSEMBLE_PENDING)
