"""Shadow-oracle sampling: replay a deterministic slice of traffic at f32, as
``repro.obs.shadow`` does.

Siklósi et al. (arXiv 2505.20911) document the failure mode this exists
for: reduced-precision runs that stay plausible while drifting from the
full-precision answer. The only way to *see* that drift live is to pay for
a full-precision replay of some traffic, so the health plane samples a
deterministic low-rate subset of completed service requests, reruns each
one at f32 through :meth:`repro_torch.pde.solver.Simulation.oracle_replay`
(on the request's own device), and books the relative L2 distance between
the served final state and the oracle's into the error-budget metrics.

Passivity: the sampler decides at admission from the *submission count*
alone (the same ``floor((n+1)r) > floor(nr)`` law the tracer uses: no RNG,
no wall clock), the job keeps a **copy** of the request's initial state,
and the replay is a separate f32 run that shares nothing with the primary
one. The primary path is bit-identical with shadowing on or off
(``tests/test_torch_health.py``, and ``chip_smoke.py`` on the card).

Subnormal bits: the copy of a state on the card comes to the host with
``.cpu()`` and is copied there as numpy bytes (a PackedArray's payload and
splits are cloned), never through arithmetic and never inside
``core/ftz.py::card_flush``, whose mode would flush the f32 subnormals a
pinned boundary keeps as they are. The replay's ``Simulation.run`` moves
the copy to the device before it enters that mode.

Trees are walked with :mod:`repro_torch._tree`. Leaves may be numpy arrays,
CPU tensors or tensors on the card; a tensor on the card comes to the host
once, with ``.cpu()``. A packed tree is decoded with
:func:`repro_torch.pack.unpack_state` before any distance is taken.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import _tree

__all__ = ["ShadowSampler", "ShadowJob", "rel_l2", "nonfinite_fraction"]


def _host_leaves(tree):
    """The leaves of ``tree`` as host numpy arrays, a packed tree decoded."""
    from repro_torch.pack import is_packed, unpack_state

    if is_packed(tree):
        tree = unpack_state(_tree.tree_map(lambda x: torch.as_tensor(x).cpu(), tree))
    return [x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for _, x in _tree.flatten(tree)]


def rel_l2(state, oracle_state, offset: float = 0.0) -> float:
    """Relative L2 distance between two state trees, after removing the
    stepper's additive baseline (``Stepper.metric_offset``: e.g. the SWE
    resting depth, so drift is measured on the dynamic field). Any
    non-finite value in either tree makes the distance ``inf``: an
    overflowed primary is *maximally* wrong, not NaN-silently fine."""
    a = np.concatenate([np.ravel(np.asarray(x, np.float64)) - offset for x in _host_leaves(state)])
    b = np.concatenate([np.ravel(np.asarray(x, np.float64)) - offset for x in _host_leaves(oracle_state)])
    if a.shape != b.shape:
        raise ValueError(f"state shapes differ: {a.shape} vs {b.shape}")
    if not (np.all(np.isfinite(a)) and np.all(np.isfinite(b))):
        return float("inf")
    ref = float(np.linalg.norm(b))
    err = float(np.linalg.norm(a - b))
    if ref == 0.0:
        return 0.0 if err == 0.0 else float("inf")
    return err / ref


def nonfinite_fraction(tree) -> float:
    """Fraction of non-finite elements across a tree (the batcher's frames
    are host numpy already): the frame statistic behind the overflow-storm
    detector's direct signal."""
    total = 0
    bad = 0
    for x in _host_leaves(tree):
        if not np.issubdtype(x.dtype, np.floating):
            continue
        total += x.size
        bad += int(np.count_nonzero(~np.isfinite(x)))
    return bad / total if total else 0.0


class ShadowSampler:
    """Deterministic rate sampler over a monotone admission counter.

    Keeps request ``n`` iff ``floor((n+1) * rate) > floor(n * rate)``:
    exactly ``rate`` of traffic in the long run, the *same* requests every
    run, and no state beyond the counter (so two services fed the same
    burst shadow the same members)."""

    def __init__(self, rate: float):
        if not (0.0 <= rate <= 1.0):
            raise ValueError(f"shadow rate must be in [0, 1], got {rate}")
        self.rate = float(rate)
        self._n = 0

    def pick(self) -> bool:
        n = self._n
        self._n += 1
        if self.rate <= 0.0:
            return False
        return math.floor((n + 1) * self.rate) > math.floor(n * self.rate)


def _copy_leaf(x):
    """A bit-exact copy of one leaf: a tensor's bytes on the host (``.cpu()``
    moves a card tensor; ``.copy()`` detaches a CPU tensor's memory), a numpy
    array's bytes. No arithmetic, so no flush mode can touch a subnormal."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.array(x, copy=True)


def _copy_state(state):
    """A state's copy that the primary run cannot reach: f32 leaves as host
    numpy bytes; a packed tree's payloads and splits cloned where they lie,
    so the replay's ``Simulation.run`` takes it as a packed carry
    (``Tensor.clone`` is a copy the flush mode leaves alone)."""
    from repro_torch.pack import is_packed

    if is_packed(state):
        return _tree.tree_map(lambda x: x.detach().clone() if isinstance(x, torch.Tensor) else np.array(x, copy=True),
                              state)
    return _tree.tree_map(_copy_leaf, state)


class ShadowJob:
    """One sampled request's replayable workload, captured at admission.

    ``state0`` is a copy taken before the request ever enters a bucket;
    ``sim`` is the request's own Simulation (static config and device), from
    which :meth:`replay` derives the f32 oracle twin.
    """

    def __init__(self, request_id: int, sim, state0, steps: int, offset: float):
        self.request_id = int(request_id)
        self.sim = sim
        self.state0 = _copy_state(state0)
        self.steps = int(steps)
        self.offset = float(offset)

    @classmethod
    def capture(cls, rec) -> "ShadowJob":
        """Snapshot a just-admitted RequestRecord: its initial state as
        admitted, which for a request with packed storage is the f32 state
        before its admission pack (``RequestRecord.initial``), as ``repro``
        replays the f32 state its record holds until the first chunk."""
        stepper, cfg = rec.sim.stepper, rec.sim.cfg
        return cls(rec.id, rec.sim, rec.initial, rec.steps, stepper.metric_offset(cfg))

    def replay(self, primary_state) -> float:
        """Run the f32 oracle over the captured workload and return the
        rel-L2 drift of ``primary_state`` (the served final state) from it.
        Packed served states are decoded first: the comparison is always
        between decoded values."""
        res = self.sim.oracle_replay(self.steps, state0=self.state0)
        return rel_l2(primary_state, res.state, offset=self.offset)
