"""repro_torch's Simulation.run_ensemble against repro's at small sizes: the
same numpy batch through both packages, every builtin stepper on the
reference, fused and megakernel planes and auto, in r2f2_16 and rr_tracked;
per-member capture in f32, packed storage and sharded=True under
axis_rules on one device. The kernels' member axis runs its plain versions
here (CPU tensors).

The batch holds the members of repro's TestEnsembles (scales 0.001, 1.0
and 2.0 of repro's initial state) and a member with f32 subnormals made
from bits in interior and pinned boundary cells: XLA:CPU flushes subnormal
inputs and results of its arithmetic and copies a pinned cell's bits, and
the port, under the CPU's flush mode, must do the same at its entry.
States compare as raw f32 bits (NaNs canonical), trackers and counts
exactly. repro's runs are jitted and cached per module."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import policy as jpol
from repro.pde import Simulation as JSim
from repro.pde.advection1d import AdvectionConfig as JAdv
from repro.pde.burgers1d import BurgersConfig as JBur
from repro.pde.heat1d import HeatConfig as JHeat
from repro.pde.heat2d import Heat2DConfig as JH2
from repro.pde.swe2d import SWEConfig as JSWE
from repro_torch import convert
from repro_torch.core import policy as tpol
from repro_torch.dist import LocalMesh, axis_rules
from repro_torch.pack import PackedArray, member_of
from repro_torch.pde import AdvectionConfig, BurgersConfig, Heat2DConfig, HeatConfig, Simulation, SWEConfig

BUILTINS = ("advection1d", "burgers1d", "heat1d", "heat2d", "swe2d")
PLANES = ("reference", "fused", "megakernel", "auto")
MODES = ("r2f2_16", "rr_tracked")
STEPS, EVERY = 12, 5  # a remainder chunk after the last snapshot
SCALES = (0.001, 1.0, 2.0)
SMALL = {
    "heat1d": (JHeat(nx=32), HeatConfig(nx=32)),
    "heat2d": (JH2(nx=12, ny=12), Heat2DConfig(nx=12, ny=12)),
    "advection1d": (JAdv(nx=64), AdvectionConfig(nx=64)),
    "burgers1d": (JBur(nx=64), BurgersConfig(nx=64)),
    "swe2d": (JSWE(nx=16, ny=16), SWEConfig(nx=16, ny=16)),
}
#: f32 subnormals as bits: 1e-40, -3e-39, the smallest, the largest
SUBNORMALS = np.array([0x000116C2, 0x8020AB1B, 0x00000001, 0x007FFFFF], np.uint32)


@pytest.fixture(scope="module", autouse=True)
def torch_env():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(prev)


def preset(P, mode):
    if mode == "rr_tracked":
        return dataclasses.replace(P["r2f2_16"], mode="rr_tracked")
    return P[mode]


def canon(x):
    x = np.ascontiguousarray(np.asarray(x, np.float32))
    b = x.view(np.uint32).copy()
    b[np.isnan(x)] = 0x7FC00000
    return b


def with_subnormals(name, s0):
    """The scale-1.0 state with subnormals set from bits (a float assignment
    would flush under the CPU's flush mode): interior cells and pinned
    boundary cells (the periodic rods have none; swe2d's in the momenta)."""
    s = np.array(s0, np.float32, copy=True)
    bits = s.view(np.uint32)
    if name == "swe2d":
        bits[1, 0, 3], bits[1, 5, 5], bits[2, 7, 0], bits[2, 6, 9] = SUBNORMALS
    elif name == "heat2d":
        bits[0, 4], bits[5, 5], bits[11, 7], bits[3, 8] = SUBNORMALS
    elif name == "heat1d":
        bits[0], bits[5], bits[-1], bits[17] = SUBNORMALS
    else:
        bits[3], bits[20], bits[21], bits[40] = SUBNORMALS
    return s


@pytest.fixture(scope="module")
def batches():
    out = {}
    for name, (jc, _) in SMALL.items():
        s0 = np.asarray(JSim(name, jc, jpol.PRESETS["f32"]).stepper.init_state(jc))
        members = [s0 * np.float32(c) for c in SCALES] + [with_subnormals(name, s0)]
        out[name] = np.stack(members).astype(np.float32)
    return out


def jensemble(name, mode, batch, **kw):
    """repro's run_ensemble, jitted: the state, snapshots, the stacked
    tracker's state and the profile, as numpy."""
    jc = SMALL[name][0]
    prec = preset(jpol.PRESETS, mode)

    def run(b):
        res = JSim(name, jc, prec).run_ensemble(b, STEPS, snapshot_every=EVERY, **kw)
        return res.state, res.snapshots, None if res.tracker is None else res.tracker.state, res.profile

    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(batch))


@pytest.fixture(scope="module")
def repro_runs(batches):
    cache = {}

    def get(name, mode, plane):
        plane = "megakernel" if plane == "auto" else plane  # repro's auto resolves to it for every builtin
        if (name, mode, plane) not in cache:
            cache[name, mode, plane] = jensemble(name, mode, batches[name], execution=plane)
        return cache[name, mode, plane]

    return get


def port_sim(name, mode):
    return Simulation(name, SMALL[name][1], preset(tpol.PRESETS, mode), device="cpu")


def assert_tracker_equal(want, got):
    for field in ("k", "hi_ema", "lo_ema", "overflow_steps", "shrink_steps"):
        np.testing.assert_array_equal(canon(getattr(want, field)) if field.endswith("ema") else getattr(want, field),
                                      canon(getattr(got.state, field).numpy()) if field.endswith("ema")
                                      else getattr(got.state, field).numpy())


@pytest.mark.parametrize("execution", PLANES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", BUILTINS)
def test_ensemble_equals_repro(name, mode, execution, batches, repro_runs):
    """The four members (0.001, 1.0, 2.0 and the subnormal member) on one
    plane: state and snapshots bit for bit and every tracker row exactly,
    against repro's run_ensemble on that plane (auto: its megakernel)."""
    state, snaps, trk, _ = repro_runs(name, mode, execution)
    res = port_sim(name, mode).run_ensemble(convert.state_from_numpy(batches[name]), STEPS, snapshot_every=EVERY,
                                            execution=execution)
    assert res.state.shape == batches[name].shape
    np.testing.assert_array_equal(canon(state), canon(res.state.numpy()))
    np.testing.assert_array_equal(canon(snaps), canon(res.snapshots.numpy()))
    if mode == "rr_tracked":
        assert res.tracker.state.k.shape == (len(SCALES) + 1, len(res.tracker.names))
        assert_tracker_equal(trk, res.tracker)
    else:
        assert trk is None and res.tracker is None


@pytest.mark.parametrize("execution", ("reference", "fused", "megakernel"))
def test_members_carry_their_own_trackers(execution, batches):
    """repro's TestEnsembles: burgers1d's 0.001 member settles on a smaller
    split at burgers.uu than the 1.0 member after 30 steps, on every plane;
    the stacked tracker's ``k(name)`` gives one split a member."""
    res = port_sim("burgers1d", "rr_tracked").run_ensemble(convert.state_from_numpy(batches["burgers1d"]), 30,
                                                            execution=execution)
    assert res.tracker.members == len(SCALES) + 1
    k = res.tracker.k("burgers.uu")
    assert k.shape == (len(SCALES) + 1,) and k[0] < k[1]


def test_subnormal_member_keeps_pinned_bits_as_repro(batches, repro_runs):
    """What repro does with the subnormal member on its reference plane: the
    pinned boundary cells keep their bits (XLA copies them), the interior
    ones are gone after the first step; the port's ensemble gives the same
    bits on every plane (the member is held in test_ensemble_equals_repro
    too)."""
    state, _, _, _ = repro_runs("heat1d", "r2f2_16", "reference")
    member = canon(state[-1])
    assert member[0] == SUBNORMALS[0] and member[-1] == SUBNORMALS[2]
    assert member[5] != SUBNORMALS[1] and member[17] != SUBNORMALS[3]


@pytest.mark.parametrize("name,execution", [("heat1d", "megakernel"), ("swe2d", "fused"), ("burgers1d", "reference")])
def test_ensemble_capture_is_per_member(name, execution, batches):
    """Capture in f32: each member's evidence bits and counts, per interval
    and in total, exactly as repro's run_ensemble(capture=True) gives them
    (repro's test_ensemble_capture_has_per_member_profiles)."""
    _, _, _, want = jensemble(name, "f32", batches[name], execution=execution, capture=True)
    got = port_sim(name, "f32").run_ensemble(convert.state_from_numpy(batches[name]), STEPS, snapshot_every=EVERY,
                                             execution=execution, capture=True).profile
    assert got.evidence.shape == (len(SCALES) + 1, STEPS) + got.evidence.shape[2:]
    np.testing.assert_array_equal(canon(want.evidence), canon(got.evidence.numpy()))
    np.testing.assert_array_equal(np.asarray(want.exp_time), got.exp_time.numpy())
    np.testing.assert_array_equal(np.asarray(want.exp_total), got.exp_total.numpy())
    totals = got.exp_total.sum(dim=(1, 2, 3))
    assert bool((totals > 0).all()) and len(set(totals.tolist())) >= 1


@pytest.mark.parametrize("name,execution", [("heat1d", "fused"), ("swe2d", "megakernel"), ("heat2d", "reference")])
def test_packed_ensemble_carries_packed_state(name, execution, batches):
    """Packed storage, r2f2_16: the state comes back as a PackedArray whose
    payload and splits lead with the member, payload bits, splits and
    snapshots as repro's packed run_ensemble gives them; a packed batch is
    taken back in as it is, each member as it would be alone (repro's
    test_packed_ensemble_carries_packed_state)."""
    jc = SMALL[name][0]

    def run(b):
        res = JSim(name, jc, jpol.PRESETS["r2f2_16"]).run_ensemble(b, STEPS, snapshot_every=EVERY, execution=execution,
                                                                   storage="packed")
        return res.state.payload, res.state.k, res.snapshots

    pay, k, snaps = jax.tree_util.tree_map(np.asarray, jax.jit(run)(batches[name]))
    sim = port_sim(name, "r2f2_16")
    first = sim.run_ensemble(convert.state_from_numpy(batches[name]), STEPS, snapshot_every=EVERY,
                             execution=execution, storage="packed")
    assert isinstance(first.state, PackedArray) and first.state.payload.shape[0] == len(SCALES) + 1
    assert first.state.shape == batches[name].shape[1:]
    np.testing.assert_array_equal(pay.astype(np.int64), first.state.payload.numpy().astype(np.int64))
    np.testing.assert_array_equal(k, first.state.k.numpy())
    np.testing.assert_array_equal(canon(snaps), canon(first.snapshots.numpy()))
    again = sim.run_ensemble(first.state, EVERY, snapshot_every=EVERY, execution=execution, storage="packed")
    for m in (0, len(SCALES)):
        one = sim.run(EVERY, snapshot_every=EVERY, state0=member_of(first.state, m), execution=execution,
                      storage="packed")
        np.testing.assert_array_equal(member_of(again.state, m).payload.numpy(), one.state.payload.numpy())
        np.testing.assert_array_equal(member_of(again.state, m).k.numpy(), one.state.k.numpy())


@pytest.mark.parametrize("execution", ("reference", "fused", "megakernel"))
def test_sharded_ensemble_under_axis_rules(execution, batches, repro_runs):
    """sharded=True under axis_rules on a one-device mesh (repro's
    test_sharded_ensemble_runs_under_mesh): the port's constrain is passive
    there, so the run equals repro's run_ensemble bit for bit; a mesh axis
    of several devices that would split the members is refused."""
    sim = port_sim("burgers1d", "r2f2_16")
    batch = convert.state_from_numpy(batches["burgers1d"])
    with axis_rules(LocalMesh(("data",))):
        got = sim.run_ensemble(batch, STEPS, snapshot_every=EVERY, sharded=True, execution=execution)
    np.testing.assert_array_equal(canon(repro_runs("burgers1d", "r2f2_16", execution)[0]), canon(got.state.numpy()))
    assert got.snapshots.shape[0] == len(SCALES) + 1

    class TwoDevices:
        axis_names, shape = ("data",), {"data": 2}

    with axis_rules(TwoDevices()), pytest.raises(NotImplementedError, match="one device"):
        sim.run_ensemble(batch, STEPS, sharded=True, execution=execution)


@pytest.mark.parametrize("name,execution", [("heat1d", "fused"), ("swe2d", "megakernel")])
def test_tracker0_batch_resumes_repros_ensemble(name, execution, repro_runs):
    """repro's rr_tracked ensemble after one run of STEPS steps, carried into
    the port as numpy (``convert.state_from_numpy`` and the stacked rows
    through ``convert.tracker_from_numpy``), resumed with tracker0_batch:
    the port's second chunk equals repro's, state and every tracker row."""
    state, _, trk, _ = repro_runs(name, "rr_tracked", execution)
    jc = SMALL[name][0]

    def second(s, t):
        sim = JSim(name, jc, preset(jpol.PRESETS, "rr_tracked"))
        first = sim.run_ensemble(s, 1, execution=execution)  # a stacked tracker of the right structure
        res = sim.run_ensemble(s, STEPS, snapshot_every=EVERY, execution=execution,
                               tracker0_batch=first.tracker.with_state(t))
        return res.state, res.tracker.state

    want_state, want_trk = jax.tree_util.tree_map(np.asarray, jax.jit(second)(state, trk))
    names = port_sim(name, "rr_tracked").stepper.sites
    t0 = convert.tracker_from_numpy(names, trk.k, trk.hi_ema, trk.lo_ema, trk.overflow_steps, trk.shrink_steps)
    assert t0.members == len(SCALES) + 1
    got = port_sim(name, "rr_tracked").run_ensemble(convert.state_from_numpy(state), STEPS, snapshot_every=EVERY,
                                                    execution=execution, tracker0_batch=t0)
    np.testing.assert_array_equal(canon(want_state), canon(got.state.numpy()))
    assert_tracker_equal(want_trk, got.tracker)


@pytest.mark.parametrize("execution", ("reference", "fused", "megakernel"))
def test_policy_applies_to_every_member(execution, batches):
    """run_ensemble(policy=) as run(policy=), member by member: the policy's
    hints installed and every member's tracker seeded at its splits."""
    from repro_torch.profile import PrecisionPolicy

    sim = port_sim("heat1d", "rr_tracked")
    policy = PrecisionPolicy("heat1d", sim.prec.fmt, {s: {"k": 1, "k_lo": 1, "k_hi": 2} for s in sim.stepper.sites})
    batch = convert.state_from_numpy(batches["heat1d"])
    ens = sim.run_ensemble(batch, STEPS, snapshot_every=EVERY, execution=execution, policy=policy)
    for m in (0, len(SCALES)):
        one = sim.run(STEPS, snapshot_every=EVERY, state0=batch[m], execution=execution, policy=policy)
        np.testing.assert_array_equal(canon(one.state.numpy()), canon(ens.state[m].numpy()))
        np.testing.assert_array_equal(one.tracker.state.k.numpy(), ens.tracker.state.k[m].numpy())
    assert int(ens.tracker.state.k.max()) <= 2


def test_ensemble_resolves_execution_before_any_member_runs():
    """An ineligible explicit plane raises before a member runs, as repro's
    ``_resolve_execution`` does outside its vmap; an unknown storage too."""
    sim = Simulation("heat1d", HeatConfig(nx=16), tpol.PRESETS["r2f2_16"], device="cpu")
    batch = torch.zeros((2, 16))
    with pytest.raises(ValueError, match="unknown execution mode"):
        sim.run_ensemble(batch, 2, execution="warp")
    with pytest.raises(ValueError, match="unknown storage mode"):
        sim.run_ensemble(batch, 2, storage="bf16")
