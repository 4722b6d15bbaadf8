"""PDE solver framework: Stepper protocol and the Simulation driver.

* a :class:`Stepper` is the workload: ``init_state / step / observables``
  plus its named policy sites;
* :class:`StepOps` is the per-step arithmetic context: ``mul/div/add/rsqrt``
  route through the precision engine and thread the tracker;
* :class:`Simulation` drives the snapshot loop on three planes:
  ``"reference"`` steps the ``StepOps`` path one update at a time;
  ``"fused"`` runs whole snapshot intervals through the stepper's
  ``fused_step`` hook (the CUDA kernels) and folds the kernels' per-site
  evidence into the carried tracker between chunks; ``"megakernel"`` runs
  the whole horizon, snapshots and adjust unit included, in one launch of
  the stepper's ``mega_step`` hook. ``"auto"`` picks the megakernel where
  it is eligible, else the fused plane, else the reference.

``storage`` selects the carried state between chunk boundaries (snapshot
intervals): ``"f32"``; ``"quantized"``, rounded through the packed format
at every boundary but carried f32; or ``"packed"``, carried as
:class:`repro_torch.pack.PackedArray` payloads, the same values as
``"quantized"`` bit for bit at ``fmt.total_bits`` an element. Steppers with
``fused_packed`` take the packed carry into their fused kernel, which
decodes and re-encodes it; the others are packed around their f32 chunk.
The megakernels round at the boundaries inside their one launch.

The loops issue no host synchronisation per step: trackers stay on the
state's device, and the fused plane copies one chunk's evidence to the host
to fold it. On a CUDA device a run flushes f32 subnormals, as the reference
does: the kernels build with ``-ftz=true``, and the PyTorch arithmetic of
the initial state, the reference plane and the observables runs under
``core/ftz.py::card_flush``.

:meth:`Simulation.run_ensemble` runs the same run for a batch of initial
states, each member with its own tracker rows, splits, profile and storage
splits, as ``repro`` vmaps ``run``: the kernel planes hand the whole batch
to one launch a chunk (the kernels take a member axis), the reference plane
runs member by member.

``capture`` (True or a :class:`repro_torch.profile.CaptureSpec`) records
the run's range profile on every plane: per-step site evidence and
per-site operand exponent histograms, per snapshot interval and in total
(``SimResult.profile``). ``policy`` loads a
:class:`repro_torch.profile.PrecisionPolicy`: a tracked run starts at its
per-site splits and clamps re-picks to its hints.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

import repro_torch.obs as _obs
from repro_torch._device import resolve_device
from repro_torch._tree import tree_map
from repro_torch.core import ftz
from repro_torch.core.ftz import card_flush
from repro_torch.core.policy import PrecisionConfig
from repro_torch.dist.sharding import constrain
from repro_torch.pack import (
    PackedArray, is_packed, member_of, pack_members, pack_state, stack_members, storage_quantize, unpack_members,
    unpack_state,
)
from repro_torch.pde.registry import get_stepper
from repro_torch.precision import fold_evidence, fused_eligible, get_engine, mega_eligible, site_tracker_init
from repro_torch.precision.sites import rewrap, stack_site_trackers
from repro_torch.profile.capture import CaptureResult, CaptureSpec, pair_exp_hist, site_evidence

__all__ = ["Stepper", "StepOps", "Simulation", "SimResult", "EXECUTIONS", "STORAGE_MODES"]

EXECUTIONS = ("reference", "fused", "megakernel", "auto")
#: carried-state storage formats: f32; "quantized", rounded through the
#: packed format at every chunk boundary but carried f32; "packed", carried
#: as PackedArray payloads (the same values as "quantized", bit for bit)
STORAGE_MODES = ("f32", "quantized", "packed")


class StepOps:
    """Per-step policy arithmetic for stepper code: ``ops.mul(a, b, site)``
    calls the engine and carries the updated tracker in ``self.tracker``.
    With ``capture`` (a ``(CaptureSpec, sites, counts)`` triple) every named
    operation also bins its broadcast operands into ``cap_counts`` and
    records the step's site evidence in ``cap_evidence``."""

    __slots__ = ("prec", "tracker", "_engine", "_cap_spec", "_cap_sites", "cap_counts", "cap_evidence")

    def __init__(self, prec: PrecisionConfig, tracker=None, capture=None):
        self.prec = prec
        self.tracker = tracker
        self._engine = get_engine(prec)
        self._cap_spec = None
        if capture is not None:
            self._cap_spec, self._cap_sites, self.cap_counts = capture
            # per-step site evidence; -127 is the zero-operand floor
            self.cap_evidence = torch.full((len(self._cap_sites), 2), -127.0, device=self.cap_counts.device)

    def _capture(self, a, b, site: str):
        """Bin the broadcast operands' exponents and take the site evidence
        (``repro_torch.profile.capture``), as the fused plane's FusedOps does."""
        j = self._cap_sites.index(site)
        dev = self.cap_counts.device
        a, b = torch.broadcast_tensors(torch.as_tensor(a, device=dev).to(torch.float32),
                                       torch.as_tensor(b, device=dev).to(torch.float32))
        self.cap_counts[j] += pair_exp_hist(a, b, self._cap_spec)
        self.cap_evidence[j] = torch.maximum(self.cap_evidence[j], site_evidence(a, b))

    def mul(self, a, b, site: str):
        if self._cap_spec is not None:
            self._capture(a, b, site)
        out, self.tracker = self._engine.multiply(a, b, self.prec, tracker=self.tracker, site=site)
        return out

    def mul_add(self, a, b, c, site: str):
        """``a * b + c`` with the product on the policy's multiplier at a
        named site (one rounding where the compiled reference fuses it)."""
        if self._cap_spec is not None:
            self._capture(a, b, site)
        out, self.tracker = self._engine.multiply_add(a, b, c, self.prec, tracker=self.tracker, site=site)
        return out

    def add(self, a, b, site: str):
        if self._cap_spec is not None:
            self._capture(a, b, site)
        out, self.tracker = self._engine.add(a, b, self.prec, tracker=self.tracker, site=site)
        return out

    def div(self, a, b, site: Optional[str] = None):
        """Quotient; with a named site this is the tracked flexible divider."""
        if site is None:
            return self._engine.divide(a, b, self.prec)[0]
        if self._cap_spec is not None:
            self._capture(a, b, site)
        out, self.tracker = self._engine.divide(a, b, self.prec, tracker=self.tracker, site=site)
        return out

    def rsqrt(self, x, site: Optional[str] = None):
        if site is None:
            return self._engine.rsqrt(x, self.prec)[0]
        if self._cap_spec is not None:
            self._capture(x, x, site)
        out, self.tracker = self._engine.rsqrt(x, self.prec, tracker=self.tracker, site=site)
        return out

    def store(self, x):
        return self._engine.store(x, self.prec)


class Stepper:
    """One PDE workload. Subclasses implement ``init_state`` and ``step``
    and declare their named sites; ``fused_step`` is the optional fused-plane
    hook ``fused_step(state, cfg, prec, steps, *, k_floor=None,
    collect_evidence=False) -> (state, evidence)``, and ``mega_step`` the
    optional megakernel hook ``mega_step(state, cfg, prec, steps, every, *,
    tracker=None) -> repro_torch.kernels.mega.MegaResult``, which takes
    ``storage=`` too for runs with storage other than f32. Both take
    ``capture=`` (a CaptureSpec): ``fused_step`` then returns ``(state,
    evidence, counts)`` with the chunk's ``(n_sites, 2, n_bins)`` counts, and
    ``mega_step``'s result carries ``exp_time`` and ``exp_total``. A stepper with
    ``fused_packed`` also takes ``storage="packed"`` on ``fused_step``, and
    then a PackedArray state that its kernel decodes and re-encodes; the
    Simulation packs around the others' f32 chunks.

    ``kernels_hold(cfg)`` says whether the hooks' CUDA kernels hold the
    config's field; on a CUDA device ``auto`` takes a kernel plane only
    where it does. A stepper has no kernel by default: its fused body runs
    the plain version, and on the card it runs the reference plane
    (ROADMAP.md queue 2). The shape gates ``fused_supported`` and
    ``mega_supported`` are the planes' own limits, on every device. A hook
    that does PyTorch arithmetic of the policy on the card enters
    ``core/ftz.py::card_flush`` itself (swe2d's fused step).

    ``ensemble_hooks`` says that both hooks also take ``members=True``: a
    state whose leaves lead with a member dim, ``(members, n_sites)``
    floors and tracker rows, and results that lead with the member, all
    members in one launch. An ensemble of a stepper without them runs
    member by member."""

    name: str = "?"
    sites: Tuple[str, ...] = ()
    site_ops: Tuple[str, ...] = ()
    failure_mode: str = "?"
    story: str = ""
    snapshots_default: int = 8
    fused_step = None
    fused_packed = False
    mega_step = None
    ensemble_hooks = False

    def fused_supported(self, cfg, prec: PrecisionConfig) -> bool:
        return True

    def mega_supported(self, cfg, prec: PrecisionConfig) -> bool:
        return True

    def kernels_hold(self, cfg) -> bool:
        """Whether the hooks launch CUDA kernels that hold the config's field."""
        return False

    def raw_cells(self, cfg, device):
        """A bool mask over one state of the cells whose bits a step uses as
        they are, or None for no cell: cells it only copies (a pinned
        boundary, whose bits ``repro`` keeps) and cells that capture bins as
        operands before any arithmetic (``repro`` counts a subnormal there
        in the low edge bin). On the card a caller's f32 subnormals there
        keep their bits, and every other one enters as a zero of its sign,
        as XLA's DAZ reads it (``core/ftz.py::zero_subnormal_inputs``)."""
        return None

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
    """What a run returns; ``tracker`` is None for untracked modes and
    ``profile`` (a CaptureResult) None unless the run captured."""

    state: Any
    snapshots: Any
    tracker: Optional[Any]
    profile: Optional[Any] = None


class _Profile:
    """A captured chunked run's accumulators: the per-step evidence, each
    whole interval's counts (the time axis) and the total, the remainder's
    included (the fused and reference planes' shared epilogue). ``lead``
    is ``(members,)`` for an ensemble, whose every array leads with the
    member."""

    def __init__(self, spec: CaptureSpec, n_sites: int, device, lead=()):
        self.spec, self.n_sites, self.lead = spec, n_sites, tuple(lead)
        self.evidence, self.exp_time = [], []
        self.total = torch.zeros(self.lead + (n_sites, 2, spec.n_bins), dtype=torch.int32, device=device)

    def add(self, evidence, counts, *, whole: bool):
        self.evidence.append(evidence.to(self.total.device))
        counts = counts.to(self.total.device)
        self.total = self.total + counts
        if whole:
            self.exp_time.append(counts)

    def result(self) -> CaptureResult:
        dev, axis = self.total.device, len(self.lead)
        ev = (torch.cat(self.evidence, dim=axis) if self.evidence else
              torch.zeros(self.lead + (0, self.n_sites, 2), device=dev))
        exp_time = (torch.stack(self.exp_time, dim=axis) if self.exp_time else
                    torch.zeros(self.lead + (0, self.n_sites, 2, self.spec.n_bins), dtype=torch.int32, device=dev))
        return CaptureResult(ev, exp_time, self.total)


def _constrain_ensemble(tree):
    """Every tensor's leading (member) dim as the logical ``batch`` axis: the
    identity outside a ``dist.sharding.axis_rules`` context."""
    return tree_map(lambda x: constrain(x, "batch", *([None] * (len(x.shape) - 1))), tree)


def _stack_runs(results) -> SimResult:
    """Members' results as one result whose every array leads with the member."""
    first = results[0]
    tracker = None if first.tracker is None else stack_site_trackers([r.tracker for r in results])
    profile = None
    if first.profile is not None:
        profile = CaptureResult(*(torch.stack(list(col)) for col in zip(*(r.profile for r in results))))
    return SimResult(stack_members([r.state for r in results]), torch.stack([r.snapshots for r in results]),
                     tracker, profile)


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
        return fused_eligible(self.prec, self.stepper, self.cfg, self.device)

    def mega_eligible(self) -> bool:
        return mega_eligible(self.prec, self.stepper, self.cfg, self.device)

    def _resolve_execution(self, execution: str) -> str:
        if execution not in EXECUTIONS:
            raise ValueError(f"unknown execution mode {execution!r}; expected one of {EXECUTIONS}")
        if execution == "auto":
            if self.mega_eligible():
                return "megakernel"
            return "fused" if self.fused_eligible() else "reference"
        for plane, eligible in (("fused", self.fused_eligible), ("megakernel", self.mega_eligible)):
            if execution == plane and not eligible():
                raise ValueError(
                    f"stepper {self.stepper.name!r} is not {plane}-eligible under mode {self.prec.mode!r} "
                    "(no hook, no fused arithmetic family, no kernel on this device, or an unsupported shape); "
                    "use execution='auto' to fall back"
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

        ``execution`` is ``"reference"``, ``"fused"``, ``"megakernel"`` or
        ``"auto"``. Pass ``tracker`` to resume tracked modes from saved
        adjust-unit state. ``storage`` is one of :data:`STORAGE_MODES`;
        under ``"packed"`` the result's state is a PackedArray, and a
        packed ``state0`` (a resumed carry) is taken as it is. ``capture``
        (True or a CaptureSpec) fills ``SimResult.profile`` with a
        :class:`repro_torch.profile.CaptureResult`; ``policy`` (a
        PrecisionPolicy) installs its hints and seeds a fresh tracker at its
        splits. Neither changes the run's arithmetic.

        With :mod:`repro_torch.obs` enabled the run is wrapped in a
        ``sim.run`` span, counted in ``repro_sim_runs_total``, and a tracked
        run's final tracker (or, for a captured run, the k series at every
        chunk boundary replayed from its evidence) is drained into the
        precision telemetry: passive, the bits are the same with it on or off.
        """
        resolved = self._resolve_execution(execution)
        with _obs.span("sim.run", stepper=self.stepper.name, mode=self.prec.mode, steps=steps, execution=resolved,
                       storage=storage):
            _obs.inc("repro_sim_runs_total", help="Simulation.run calls by plane", stepper=self.stepper.name,
                     mode=self.prec.mode, execution=resolved)
            res = self._run(steps, snapshot_every=snapshot_every, state0=state0, tracker=tracker, execution=resolved,
                            capture=capture, policy=policy, storage=storage)
        self._drain_telemetry(res, steps, snapshot_every, tracker, policy)
        return res

    def _run(self, steps, *, snapshot_every, state0, tracker, execution, capture, policy, storage) -> SimResult:
        execution = self._resolve_execution(execution)
        storage = self._resolve_storage(storage)
        spec = self._resolve_capture(capture)
        stepper, prec = self.stepper, self.prec
        if state0 is not None and not isinstance(state0, PackedArray):
            # moved before the flush mode, which would flush the copy's subnormals, the kept cells' too
            state0 = torch.as_tensor(state0).to(device=self.device, dtype=torch.float32)
        with card_flush(self.device):
            if state0 is None:
                state = stepper.init_state(self.cfg, device=self.device)
            elif isinstance(state0, PackedArray):
                state = state0.to(self.device)
            else:
                state = self._entry(state0, steps)
            state = self._storage_in(state, storage)
        if tracker is not None:
            tracker = tracker.to(self.device)
        if policy is not None:
            prec, tracker = self._apply_policy(prec, tracker, policy)
        if tracker is None:
            tracker = self.init_tracker()
        every = snapshot_every or max(1, steps // stepper.snapshots_default)
        if execution == "megakernel":
            return self._run_mega(state, tracker, steps, every, storage, prec, spec)
        n_out, rem = divmod(steps, every)
        advance = self._chunk_fused if execution == "fused" else self._chunk_reference
        profile = None if spec is None else _Profile(spec, len(stepper.sites), self.device)

        snaps = []
        for _ in range(n_out):
            state, tracker, cap = advance(state, tracker, every, storage, prec, spec)
            snaps.append(self._observe(state))
            if profile is not None:
                profile.add(*cap, whole=True)
        if rem:
            state, tracker, cap = advance(state, tracker, rem, storage, prec, spec)
            if profile is not None:
                profile.add(*cap, whole=False)
        if snaps:
            snapshots = torch.stack(snaps)
        else:
            obs = self._observe(state)
            snapshots = obs.new_empty((0,) + tuple(obs.shape))
        return SimResult(state, snapshots, tracker, None if profile is None else profile.result())

    # -- precision-telemetry drains (passive; repro_torch.obs) ---------------

    def _drain_telemetry(self, res, steps, snapshot_every, tracker_arg, policy):
        """Feed a finished tracked run into :mod:`repro_torch.obs`'s telemetry
        under a fresh ``sim:<stepper>`` scope: its final tracker or, for a
        captured run, the k series replayed from its evidence at every chunk
        boundary, with each site's coverage of the final split."""
        o = _obs.active()
        if o is None or o.telemetry is None or res.tracker is None:
            return
        scope = o.telemetry.unique_scope(f"sim:{self.stepper.name}")
        if res.profile is None:
            o.telemetry.record_tracker(scope, res.tracker, steps)
            return
        from repro_torch.obs.precision import coverage_fraction, replay_k_series

        prec, tr0 = self.prec, tracker_arg
        if policy is not None:
            prec, tr0 = self._apply_policy(prec, tr0, policy)
        if tr0 is None:
            tr0 = self.init_tracker()
        every = snapshot_every or max(1, steps // self.stepper.snapshots_default)
        sites, ops = list(self.stepper.sites), self.stepper.site_ops or None
        bsteps, k, grew, shrank = replay_k_series(res.profile.evidence, prec, sites, site_ops=ops, every=every,
                                                  tracker0=tr0)
        final_k = dict(zip(res.tracker.names, res.tracker.state.k.tolist()))
        cov = coverage_fraction(res.profile.evidence, prec, sites, final_k, site_ops=ops)
        o.telemetry.record_series(scope, sites, bsteps, k, grew, shrank, coverage=cov)

    def _drain_ensemble_telemetry(self, res, steps):
        """Each member's final tracker under ``ens:<stepper>/m<i>``."""
        o = _obs.active()
        if o is None or o.telemetry is None or res.tracker is None:
            return
        base = o.telemetry.unique_scope(f"ens:{self.stepper.name}")
        for i in range(res.tracker.state.k.shape[0]):
            o.telemetry.record_tracker(f"{base}/m{i}", res.tracker.member(i), steps)

    def _entry(self, state, steps: int):
        """A caller's f32 state as a run on the card reads it: its subnormals
        zeroes of their sign, as XLA's DAZ reads them, but in the cells
        whose bits the stepper uses as they are (``Stepper.raw_cells``).
        The CPU's own flags do this there; a run of no steps computes
        nothing."""
        if steps == 0 or not ftz.on_card(self.device):
            return state
        return ftz.zero_subnormal_inputs(state, self.stepper.raw_cells(self.cfg, self.device))

    def _resolve_capture(self, capture) -> Optional[CaptureSpec]:
        """``capture`` may be None, a bool (True: the default spec) or a CaptureSpec."""
        if capture is None or capture is False:
            return None
        if capture is True:
            capture = CaptureSpec()
        if not isinstance(capture, CaptureSpec):
            raise TypeError(f"capture must be bool or CaptureSpec, got {capture!r}")
        if not self.stepper.sites:
            raise ValueError(f"stepper {self.stepper.name!r} declares no multiplication sites; nothing to capture")
        return capture

    def _apply_policy(self, prec, tracker, policy):
        """A PrecisionPolicy's floor and ceiling hints as ``prec.k_bounds``
        and, for a tracked mode without a tracker, one seeded at its splits
        (both ordered by the stepper's sites)."""
        sites = self.stepper.sites
        prec = policy.apply(prec, sites)
        if tracker is None and get_engine(prec).tracks and sites:
            tracker = site_tracker_init(sites, prec.fmt, k0=torch.from_numpy(policy.k_array(sites)), device=self.device)
        return prec, tracker

    @staticmethod
    def _resolve_storage(storage: str) -> str:
        if storage not in STORAGE_MODES:
            raise ValueError(f"unknown storage mode {storage!r}; expected one of {STORAGE_MODES}")
        return storage

    def _storage_in(self, state0, storage: str):
        """The initial state in the run's storage format: a packed run packs
        f32 leaves (the boundary's one pack) and takes a packed carry as it
        is; the others decode a packed carry, and ``"quantized"`` rounds."""
        fmt = self.prec.fmt
        if storage == "packed":
            return state0 if is_packed(state0) else pack_state(state0, fmt)
        if is_packed(state0):
            state0 = unpack_state(state0)
        return storage_quantize(state0, fmt) if storage == "quantized" else state0

    def _storage_out(self, state, storage: str):
        """A chunk's f32 result in the run's storage format."""
        if storage == "f32":
            return state
        with card_flush(self.device):
            if storage == "quantized":
                return storage_quantize(state, self.prec.fmt)
            return pack_state(state, self.prec.fmt)

    def _unpacked(self, state):
        if not is_packed(state):
            return state
        with card_flush(self.device):
            return unpack_state(state)

    def _observe(self, state):
        state = self._unpacked(state)
        with card_flush(self.device):
            return self.stepper.observables(state, self.cfg)

    def _chunk_reference(self, state, tracker, n: int, storage: str, prec, spec=None):
        """``n`` reference steps; with ``spec`` also the chunk's per-step
        evidence and operand counts."""
        state = self._unpacked(state)
        sites = self.stepper.sites
        counts = None if spec is None else torch.zeros((len(sites), 2, spec.n_bins), dtype=torch.int32,
                                                       device=self.device)
        evs = []
        with card_flush(self.device):
            for _ in range(n):
                ops = StepOps(prec, tracker, None if spec is None else (spec, sites, counts))
                state = self.stepper.step(state, self.cfg, ops)
                tracker = ops.tracker
                if spec is not None:
                    counts = ops.cap_counts
                    evs.append(ops.cap_evidence)
        cap = None if spec is None else (torch.stack(evs), counts)
        return self._storage_out(state, storage), tracker, cap

    def _chunk_fused(self, state, tracker, n: int, storage: str, prec, spec=None):
        """One fused chunk: the carried splits enter as the rr family's
        floor, and the chunk's evidence replays through the adjust law. A
        ``fused_packed`` stepper takes a packed carry into its kernel. With
        ``spec`` the chunk's evidence and counts come back too."""
        in_kernel = storage == "packed" and self.stepper.fused_packed
        if not in_kernel:
            state = self._unpacked(state)
        res = self.stepper.fused_step(
            state, self.cfg, prec, n,
            k_floor=None if tracker is None else tracker.state.k,
            collect_evidence=spec is not None or (tracker is not None and not prec.pinned),
            **({"storage": "packed"} if in_kernel else {}),
            **({"capture": spec} if spec is not None else {}),
        )
        state, ev = res[:2]
        if not in_kernel:
            state = self._storage_out(state, storage)
        if tracker is not None:
            tracker = fold_evidence(tracker, ev, prec, ops=self.stepper.site_ops or None)
        return state, tracker, (None if spec is None else (ev, res[2]))

    def _run_mega(self, state, tracker, steps: int, every: int, storage: str, prec, spec=None) -> SimResult:
        """The whole horizon in one launch: tracker rows tick every substep
        in the kernel, the datapath floor latches at the snapshot boundaries,
        the state rounds to storage there, and the observables are taken
        from the kernel's state snapshots. With ``spec`` the kernel bins
        every interval's operands and emits the evidence."""
        res = self.stepper.mega_step(
            state, self.cfg, prec, steps, every, tracker=None if tracker is None else tracker.state,
            **({"storage": storage} if storage != "f32" else {}),
            **({"capture": spec} if spec is not None else {}),
        )
        if res.snaps.shape[0]:
            snapshots = torch.stack([self._observe(s) for s in res.snaps])
        else:
            obs = self._observe(res.state)
            snapshots = obs.new_empty((0,) + tuple(obs.shape))
        profile = None if spec is None else CaptureResult(res.evidence, res.exp_time, res.exp_total)
        return SimResult(res.state, snapshots, rewrap(tracker, res.tracker), profile)

    # -- ensembles ----------------------------------------------------------

    def run_ensemble(
        self,
        state0_batch,
        steps: int,
        *,
        snapshot_every: Optional[int] = None,
        sharded: bool = False,
        execution: str = "reference",
        capture=None,
        policy=None,
        tracker0_batch=None,
        storage: str = "f32",
        _drain: bool = True,
    ) -> SimResult:
        """Run :meth:`run` for a batch of initial states at once.

        ``state0_batch`` is the stepper's state with a leading member dim
        (a numpy array or a tensor; under packed storage also a PackedArray
        whose payload and splits lead with the member). Each member carries
        its own tracker rows, its own splits, capture and storage split, and
        equals that member run alone; every array of the result leads with
        the member (the tracker is a stacked SiteTracker, ``tracker.state.k``
        ``(members, n_sites)``). ``capture``, ``policy`` and ``storage``
        behave as in :meth:`run`, per member; a packed ensemble's state comes
        back as a PackedArray whose children lead with the member.

        ``tracker0_batch`` resumes tracked modes from a stacked tracker, such
        as the ``tracker`` an earlier ``run_ensemble`` returned: each
        member's carried split and adjust counters continue from there.

        The kernel planes hand the whole batch to one launch a chunk (one
        a horizon on the megakernel plane), the kernels taking a member
        axis; the reference plane, and a stepper whose hooks take no member
        dim (``Stepper.ensemble_hooks``), run member by member. ``execution``
        and ``storage`` are resolved once, before any member runs.

        With ``sharded=True`` every leaf's member dim is annotated as the
        logical ``batch`` axis (``dist.sharding.constrain``), on the way in
        and on the way out: the identity outside an ``axis_rules`` context,
        and passive on one device.

        With :mod:`repro_torch.obs` enabled the call is wrapped in a
        ``sim.run_ensemble`` span, counted once in ``repro_sim_runs_total``
        (as ``repro``'s vmapped ``run`` counts once), and each member's final
        tracker is drained under ``ens:<stepper>/m<i>``. ``_drain=False``
        says that the caller drains the members' trackers itself (the
        service's batcher, under its requests' scopes), so this call records
        no telemetry, as ``repro``'s records none inside the service's
        jitted chunk.
        """
        if sharded:
            state0_batch = _constrain_ensemble(state0_batch)
            if tracker0_batch is not None:
                tracker0_batch = _constrain_ensemble(tracker0_batch)
        resolved = self._resolve_execution(execution)
        storage = self._resolve_storage(storage)
        with _obs.span("sim.run_ensemble", stepper=self.stepper.name, mode=self.prec.mode, steps=steps,
                       execution=execution, sharded=bool(sharded)):
            _obs.inc("repro_sim_runs_total", help="Simulation.run calls by plane", stepper=self.stepper.name,
                     mode=self.prec.mode, execution=resolved)
            res = self._run_ensemble(state0_batch, steps, snapshot_every=snapshot_every, execution=resolved,
                                     capture=capture, policy=policy, tracker0_batch=tracker0_batch, storage=storage)
        if sharded:
            res = _constrain_ensemble(res)
        if _drain:
            self._drain_ensemble_telemetry(res, steps)
        return res

    def _run_ensemble(self, state0_batch, steps, *, snapshot_every, execution, capture, policy, tracker0_batch,
                      storage) -> SimResult:
        stepper = self.stepper
        if not isinstance(state0_batch, PackedArray):
            state0_batch = self._entry(torch.as_tensor(state0_batch).to(device=self.device, dtype=torch.float32), steps)
        members = (state0_batch.payload if isinstance(state0_batch, PackedArray) else state0_batch).shape[0]
        if tracker0_batch is not None and tracker0_batch.state.k.shape[0] != members:
            raise ValueError(f"tracker0_batch has {tracker0_batch.state.k.shape[0]} members for {members} states")
        if execution == "reference" or not stepper.ensemble_hooks:
            return _stack_runs([
                self._run(steps, snapshot_every=snapshot_every, state0=member_of(state0_batch, m),
                         tracker=None if tracker0_batch is None else tracker0_batch.member(m), execution=execution,
                         capture=capture, policy=policy, storage=storage)
                for m in range(members)
            ])
        spec = self._resolve_capture(capture)
        with card_flush(self.device):
            state = self._storage_in_members(state0_batch.to(self.device), storage)
        tracker = None if tracker0_batch is None else tracker0_batch.to(self.device)
        prec, one = self.prec, None
        if policy is not None:
            prec, one = self._apply_policy(prec, None, policy)
        if one is None:
            one = self.init_tracker()
        if tracker is None and one is not None:
            tracker = stack_site_trackers([one] * members)
        every = snapshot_every or max(1, steps // stepper.snapshots_default)
        if execution == "megakernel":
            return self._ensemble_mega(state, tracker, steps, every, storage, prec, spec)
        n_out, rem = divmod(steps, every)
        profile = None if spec is None else _Profile(spec, len(stepper.sites), self.device, (members,))
        snaps = []
        for _ in range(n_out):
            state, tracker, cap = self._chunk_fused_members(state, tracker, every, storage, prec, spec)
            snaps.append(self._observe_members(state))
            if profile is not None:
                profile.add(*cap, whole=True)
        if rem:
            state, tracker, cap = self._chunk_fused_members(state, tracker, rem, storage, prec, spec)
            if profile is not None:
                profile.add(*cap, whole=False)
        if snaps:
            snapshots = torch.stack(snaps, dim=1)
        else:
            obs = self._observe_members(state)
            snapshots = obs.new_empty((members, 0) + tuple(obs.shape[1:]))
        return SimResult(state, snapshots, tracker, None if profile is None else profile.result())

    def _storage_in_members(self, state, storage: str):
        """:meth:`_storage_in` for an ensemble's state: each member packed as
        one storage block (kernel K1 once for all members on the card)."""
        fmt = self.prec.fmt
        if storage == "packed":
            return state if is_packed(state) else pack_members(state, fmt)
        if is_packed(state):
            state = unpack_members(state)
        return unpack_members(pack_members(state, fmt)) if storage == "quantized" else state

    def _storage_out_members(self, state, storage: str):
        if storage == "f32":
            return state
        with card_flush(self.device):
            packed = pack_members(state, self.prec.fmt)
            return unpack_members(packed) if storage == "quantized" else packed

    def _unpacked_members(self, state):
        if not is_packed(state):
            return state
        with card_flush(self.device):
            return unpack_members(state)

    def _observe_members(self, state):
        state = self._unpacked_members(state)
        with card_flush(self.device):
            return torch.stack([self.stepper.observables(s, self.cfg) for s in state])

    def _chunk_fused_members(self, state, tracker, n: int, storage: str, prec, spec=None):
        """:meth:`_chunk_fused` for an ensemble: one launch for every member,
        each member's floor its own tracker row and its evidence folded into
        its own rows."""
        in_kernel = storage == "packed" and self.stepper.fused_packed
        if not in_kernel:
            state = self._unpacked_members(state)
        res = self.stepper.fused_step(
            state, self.cfg, prec, n,
            k_floor=None if tracker is None else tracker.state.k,
            collect_evidence=spec is not None or (tracker is not None and not prec.pinned),
            members=True,
            **({"storage": "packed"} if in_kernel else {}),
            **({"capture": spec} if spec is not None else {}),
        )
        state, ev = res[:2]
        if not in_kernel:
            state = self._storage_out_members(state, storage)
        if tracker is not None:
            tracker = fold_evidence(tracker, ev, prec, ops=self.stepper.site_ops or None)
        return state, tracker, (None if spec is None else (ev, res[2]))

    def _ensemble_mega(self, state, tracker, steps: int, every: int, storage: str, prec, spec=None) -> SimResult:
        """:meth:`_run_mega` for an ensemble: one launch for every member."""
        res = self.stepper.mega_step(
            state, self.cfg, prec, steps, every, tracker=None if tracker is None else tracker.state, members=True,
            **({"storage": storage} if storage != "f32" else {}),
            **({"capture": spec} if spec is not None else {}),
        )
        members = res.snaps.shape[0]
        if res.snaps.shape[1]:
            with card_flush(self.device):
                snapshots = torch.stack([torch.stack([self.stepper.observables(s, self.cfg) for s in member])
                                         for member in res.snaps])
        else:
            obs = self._observe_members(res.state)
            snapshots = obs.new_empty((members, 0) + tuple(obs.shape[1:]))
        profile = None if spec is None else CaptureResult(res.evidence, res.exp_time, res.exp_total)
        return SimResult(res.state, snapshots, rewrap(tracker, res.tracker), profile)
