"""Kernel K4 and the megakernel plane of repro_torch against repro's, on the
CPU: the port's plain version (``mega_sweep_plain``, which a CPU tensor
takes) against repro's Pallas megakernel in interpret mode, and the port's
megakernel plane against its own fused plane.

heat1d at nx=64 and swe2d at 32x32 run 20 steps with a snapshot every 6, so
each run has a two-substep remainder after its last snapshot. States,
snapshots and every tracker field compare as raw bits; swe2d under e5m10
compares with NaNs made canonical (see test_torch_pde.py). PyTorch flushes
subnormals here, as XLA:CPU does."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import policy as jpol
from repro.kernels import mega as jmega
from repro.pde import Simulation as JSim
from repro.pde.heat1d import HeatConfig as JHeat
from repro.pde.swe2d import SWEConfig as JSWE
from repro_torch.convert import state_from_numpy, tracker_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.kernels import mega as tmega
from repro_torch.pde import HeatConfig, Simulation, SWEConfig

MODES = ("f32", "bf16", "e5m10", "r2f2_16", "rr_tracked", "deploy")
STEPS, EVERY = 20, 6
SMALL = {"heat1d": (JHeat(nx=64), HeatConfig(nx=64)), "swe2d": (JSWE(nx=32, ny=32), SWEConfig(nx=32, ny=32))}
SITES = {"heat1d": ("heat.flux", "heat.update"), "swe2d": ("swe.q1q1", "swe.q3q3", "swe.gq3", "swe.div")}


@pytest.fixture(scope="module", autouse=True)
def torch_env():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(prev)


def preset(P, mode, **kw):
    if mode == "rr_tracked":
        return dataclasses.replace(P["r2f2_16"], mode="rr_tracked", **kw)
    return dataclasses.replace(P[mode], **kw)


def raw(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(np.uint32)


def canon(x):
    b = raw(x).copy()
    b[np.isnan(np.asarray(x, np.float32))] = 0x7FC00000
    return b


def assert_tracker_equal(want, got):
    """Two RangeTrackers (numpy-convertible fields), every field as bits."""
    assert (want is None) == (got is None)
    if want is None:
        return
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), np.asarray(getattr(got, f))
        if w.dtype == np.float32:
            np.testing.assert_array_equal(raw(w), raw(g), err_msg=f)
        else:
            np.testing.assert_array_equal(w, g, err_msg=f)


def assert_run_equal(want, got, nan_canonical=False):
    view = canon if nan_canonical else raw
    np.testing.assert_array_equal(view(want.state), view(np.asarray(got.state)))
    np.testing.assert_array_equal(view(want.snapshots), view(np.asarray(got.snapshots)))
    assert_tracker_equal(
        None if want.tracker is None else want.tracker.state,
        None if got.tracker is None else RangeTrackerView(got.tracker.state),
    )


class RangeTrackerView:
    """A port tracker's fields as numpy arrays, in the reference's field order."""

    _fields = ("hi_ema", "lo_ema", "k", "overflow_steps", "shrink_steps")

    def __init__(self, t):
        for f in self._fields:
            setattr(self, f, getattr(t, f).numpy())


@pytest.fixture(scope="module")
def state0s():
    return {name: np.asarray(JSim(name, jc, jpol.PRESETS["f32"]).stepper.init_state(jc)) for name, (jc, _) in SMALL.items()}


@pytest.fixture(scope="module")
def reference_mega(state0s):
    cache = {}

    def get(name, mode):
        if (name, mode) not in cache:
            jc, _ = SMALL[name]
            cache[name, mode] = JSim(name, jc, preset(jpol.PRESETS, mode)).run(
                STEPS, snapshot_every=EVERY, state0=state0s[name], execution="megakernel"
            )
        return cache[name, mode]

    return get


def port_run(name, mode, state0, execution, **kw):
    _, tc = SMALL[name]
    return Simulation(name, tc, preset(tpol.PRESETS, mode, **kw), device="cpu").run(
        STEPS, snapshot_every=EVERY, state0=state_from_numpy(state0), execution=execution
    )


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["heat1d", "swe2d"])
def test_megakernel_bit_exact_against_reference(name, mode, state0s, reference_mega):
    tres = port_run(name, mode, state0s[name], "megakernel")
    assert tres.snapshots.shape[0] == STEPS // EVERY
    assert_run_equal(reference_mega(name, mode), tres, nan_canonical=(name, mode) == ("swe2d", "e5m10"))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["heat1d", "swe2d"])
def test_megakernel_plane_equals_fused_plane(name, mode, state0s):
    """The latch keeps the two planes bit-identical: the fused plane folds
    at the snapshot cadence, the megakernel latches its floor there."""
    meg = port_run(name, mode, state0s[name], "megakernel")
    fus = port_run(name, mode, state0s[name], "fused")
    nan = (name, mode) == ("swe2d", "e5m10")
    view = canon if nan else raw
    np.testing.assert_array_equal(view(fus.state.numpy()), view(meg.state.numpy()))
    np.testing.assert_array_equal(view(fus.snapshots.numpy()), view(meg.snapshots.numpy()))
    assert (fus.tracker is None) == (meg.tracker is None)
    if fus.tracker is not None:
        assert_tracker_equal(RangeTrackerView(fus.tracker.state), RangeTrackerView(meg.tracker.state))


def _evidence_pair(name, mode, state0):
    """(repro, port) results of the stepper's mega entry with evidence, from
    the same state and tracker."""
    jc, tc = SMALL[name]
    jprec, tprec = preset(jpol.PRESETS, mode), preset(tpol.PRESETS, mode)
    sites = SITES[name]
    jtrk = ttrk = None
    if mode in ("rr_tracked", "deploy"):
        jtrk = jpol.tracker_init(len(sites), jprec.fmt)
        ttrk = tpol.tracker_init(len(sites), tprec.fmt, device="cpu")
    common = dict(steps=STEPS, every=EVERY, sites=sites, collect_evidence=True)
    x = state_from_numpy(state0)
    if name == "heat1d":
        want = jmega.heat1d_mega(state0, alpha=jc.alpha, dtodx2=jc.dtodx2, prec=jprec, tracker=jtrk, **common)
        got = tmega.heat1d_mega(x, alpha=tc.alpha, dtodx2=tc.dtodx2, prec=tprec, tracker=ttrk, **common)
    else:
        ops = ("mul", "mul", "mul", "div")
        want = jmega.swe2d_mega(state0, cfg=jc, prec=jprec, site_ops=ops, tracker=jtrk, **common)
        got = tmega.swe2d_mega(x, cfg=tc, prec=tprec, site_ops=ops, tracker=ttrk, **common)
    return want, got


@pytest.mark.parametrize("mode", ["r2f2_16", "rr_tracked"])
@pytest.mark.parametrize("name", ["heat1d", "swe2d"])
def test_mega_sweep_evidence_matches_reference(name, mode, state0s):
    want, got = _evidence_pair(name, mode, state0s[name])
    assert tuple(got.evidence.shape) == (STEPS, len(SITES[name]), 2)
    np.testing.assert_array_equal(raw(want.evidence), raw(got.evidence.numpy()))
    np.testing.assert_array_equal(raw(want.state), raw(got.state.numpy()))
    np.testing.assert_array_equal(raw(want.snaps), raw(got.snaps.numpy()))
    assert_tracker_equal(
        None if mode == "r2f2_16" else want.tracker,
        None if mode == "r2f2_16" else RangeTrackerView(got.tracker),
    )


@pytest.mark.parametrize("name", ["heat1d", "swe2d"])
def test_chained_tracked_runs_equal_one_long_run(name, state0s):
    """The tracker rows the megakernel hands back are resumable: two runs of
    18 steps (snapshot every 6) equal one of 36, from k0=0 so the tracker
    moves."""
    _, tc = SMALL[name]
    sim = Simulation(name, tc, preset(tpol.PRESETS, "rr_tracked"), device="cpu")
    s0 = state_from_numpy(state0s[name])
    a = sim.run(18, snapshot_every=6, state0=s0, tracker=sim.init_tracker(k0=0), execution="megakernel")
    b = sim.run(18, snapshot_every=6, state0=a.state, tracker=a.tracker, execution="megakernel")
    long = sim.run(36, snapshot_every=6, state0=s0, tracker=sim.init_tracker(k0=0), execution="megakernel")
    assert int(a.tracker.state.overflow_steps.sum()) > 0
    np.testing.assert_array_equal(raw(long.state.numpy()), raw(b.state.numpy()))
    np.testing.assert_array_equal(raw(long.snapshots[3:].numpy()), raw(b.snapshots.numpy()))
    assert_tracker_equal(RangeTrackerView(long.tracker.state), RangeTrackerView(b.tracker.state))


@pytest.mark.parametrize("variant", ["pinned", "k_bounds"])
@pytest.mark.parametrize("name", ["heat1d", "swe2d"])
def test_pinned_and_bounded_policies_against_reference(name, variant, state0s):
    """A pinned policy runs at the tracker's fixed splits and leaves the
    tracker alone (k=2 for heat1d; swe2d's h*h needs k=3, and a starved
    split would only compare NaNs); a k_bounds policy clamps every tick."""
    jc, tc = SMALL[name]
    n = len(SITES[name])
    kw = dict(pinned=True) if variant == "pinned" else dict(k_bounds=((1, 2),) * n)
    k0 = {"heat1d": 2, "swe2d": 3}[name] if variant == "pinned" else None
    jsim = JSim(name, jc, preset(jpol.PRESETS, "rr_tracked", **kw))
    tsim = Simulation(name, tc, preset(tpol.PRESETS, "rr_tracked", **kw), device="cpu")
    jres = jsim.run(STEPS, snapshot_every=EVERY, state0=state0s[name], tracker=jsim.init_tracker(k0=k0), execution="megakernel")
    tres = tsim.run(
        STEPS, snapshot_every=EVERY, state0=state_from_numpy(state0s[name]), tracker=tsim.init_tracker(k0=k0),
        execution="megakernel",
    )
    assert_run_equal(jres, tres)
    if variant == "pinned":
        assert tres.tracker.state.k.tolist() == [k0] * n
    else:
        assert int(tres.tracker.state.shrink_steps.sum()) > 0


def test_auto_resolves_as_reference_does():
    cases = [
        ("heat1d", JHeat(nx=64), HeatConfig(nx=64), "megakernel"),
        ("swe2d", JSWE(nx=32, ny=32), SWEConfig(nx=32, ny=32), "megakernel"),
        ("swe2d", JSWE(), SWEConfig(), "megakernel"),
        ("swe2d", JSWE(nx=144, ny=144), SWEConfig(nx=144, ny=144), "fused"),
    ]
    for name, jc, tc, plane in cases:
        for mode in ("r2f2_16", "rr_tracked"):
            jsim = JSim(name, jc, preset(jpol.PRESETS, mode))
            tsim = Simulation(name, tc, preset(tpol.PRESETS, mode), device="cpu")
            assert tsim._resolve_execution("auto") == jsim._resolve_execution("auto") == plane
    big = Simulation("swe2d", SWEConfig(nx=144, ny=144), tpol.PRESETS["r2f2_16"], device="cpu")
    assert not big.mega_eligible()
    with pytest.raises(ValueError, match="megakernel-eligible"):
        big.run(2, execution="megakernel")


def test_one_plain_call_per_horizon(state0s):
    """On the CPU a run is one call of the plain version and no launch,
    snapshots or not, tracker or not."""
    counters = {"heat1d": tmega.HEAT1D_MEGA, "swe2d": tmega.SWE2D_MEGA}
    for name, mode, steps in (("heat1d", "r2f2_16", 20), ("heat1d", "rr_tracked", 5), ("swe2d", "deploy", 4)):
        _, tc = SMALL[name]
        before = {k: (c.launches, c.plain_calls) for k, c in counters.items()}
        Simulation(name, tc, preset(tpol.PRESETS, mode), device="cpu").run(
            steps, snapshot_every=6, state0=state_from_numpy(state0s[name]), execution="auto"
        )
        delta = {k: (c.launches - before[k][0], c.plain_calls - before[k][1]) for k, c in counters.items()}
        assert delta == {k: (0, int(k == name)) for k in counters}


def test_resumed_reference_tracker_runs_on_the_megakernel(state0s):
    """A tracker saved by repro (numpy arrays) resumes on the port's
    megakernel as it does on repro's."""
    jc, tc = SMALL["heat1d"]
    jsim = JSim("heat1d", jc, preset(jpol.PRESETS, "rr_tracked"))
    first = jsim.run(12, snapshot_every=6, state0=state0s["heat1d"], tracker=jsim.init_tracker(k0=0), execution="megakernel")
    st = first.tracker.state
    resumed = tracker_from_numpy(first.tracker.names, st.k, st.hi_ema, st.lo_ema, st.overflow_steps, st.shrink_steps)
    jres = jsim.run(STEPS, snapshot_every=EVERY, state0=first.state, tracker=first.tracker, execution="megakernel")
    tres = Simulation("heat1d", tc, preset(tpol.PRESETS, "rr_tracked"), device="cpu").run(
        STEPS, snapshot_every=EVERY, state0=state_from_numpy(np.asarray(first.state)), tracker=resumed,
        execution="megakernel",
    )
    assert_run_equal(jres, tres)


def test_storage_host_pack_and_refusals(state0s):
    """K4 swe2d's host-pack shape against repro's swe2d_mega: f32 leaves
    under "packed" come back packed at the kernel's carried split kst (the
    boundary's and the remainder's rounding), "quantized" f32 at the same
    values; the megakernel refuses what the reference refuses."""
    from repro.kernels.mega import swe2d_mega as j_swe2d_mega
    from repro_torch.pack import pack_array, unpack_state

    jc, tc = SMALL["swe2d"]
    jp, tp = preset(jpol.PRESETS, "r2f2_16"), preset(tpol.PRESETS, "r2f2_16")
    sites, ops = SITES["swe2d"], ("mul", "mul", "mul", "div")
    U0 = state0s["swe2d"]
    kw = dict(steps=STEPS, every=EVERY, sites=sites, site_ops=ops)
    want = j_swe2d_mega(U0, cfg=jc, prec=jp, interpret=True, storage="packed", **kw)
    got = tmega.swe2d_mega(state_from_numpy(U0), cfg=tc, prec=tp, storage="packed", **kw)
    np.testing.assert_array_equal(np.asarray(want.state.payload), got.state.payload.numpy())
    np.testing.assert_array_equal(np.asarray(want.state.k), got.state.k.numpy())
    assert (got.state.shape, got.state.block) == (want.state.shape, want.state.block)
    np.testing.assert_array_equal(raw(want.snaps), raw(got.snaps))
    quant = tmega.swe2d_mega(state_from_numpy(U0), cfg=tc, prec=tp, storage="quantized", **kw)
    np.testing.assert_array_equal(raw(unpack_state(got.state)), raw(quant.state))
    assert int(quant.kst[0]) == int(np.asarray(want.state.k).reshape(-1)[0])
    u = torch.ones(1, 16)
    packed = pack_array(u, tp.fmt)
    body = tmega._heat1d_body(1.0, 0.1, SITES["heat1d"])
    with pytest.raises(ValueError, match="require storage='packed'"):
        tmega.mega_sweep(body, (packed,), prec=tp, sites=SITES["heat1d"], steps=2, every=1, storage="quantized")
    with pytest.raises(TypeError, match="mixed"):
        tmega.mega_sweep(body, (packed, u), prec=tp, sites=SITES["heat1d"], steps=2, every=1, storage="packed")
    with pytest.raises(ValueError, match="unknown mega storage"):
        tmega.mega_sweep(body, (u,), prec=tp, sites=SITES["heat1d"], steps=2, every=1, storage="bf16")
