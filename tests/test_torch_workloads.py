"""heat2d, advection1d and burgers1d in repro_torch against repro, on the CPU:
the three steppers on all three planes in the six modes, kernel K5's plain
versions (the fused sweeps and the megakernels) against repro's Pallas
kernels in interpret mode, and the places where the compiled reference
fuses a product into an add.

heat2d runs at 24x24, advection1d and burgers1d at nx=128, 20 steps with a
snapshot every 6 (three snapshots and a two-step remainder). States,
snapshots and every tracker field compare as raw f32 bits; advection1d and
burgers1d under e5m10 turn to NaN, and compare with NaNs made canonical
(the sign XLA gives a NaN depends on the operand order it picks). Both
packages start from repro's initial state. PyTorch flushes subnormals here,
as XLA:CPU does."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jpol
from repro.kernels import mega as jmega
from repro.kernels import pde_steps as jsteps
from repro.pde import Simulation as JSim
from repro.pde.advection1d import AdvectionConfig as JAdv
from repro.pde.burgers1d import BurgersConfig as JBurg
from repro.pde.heat1d import HeatConfig as JHeat
from repro.pde.heat2d import Heat2DConfig as JHeat2D
from repro_torch.convert import state_from_numpy, tracker_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.core.fma import fma
from repro_torch.kernels import mega as tmega
from repro_torch.kernels import pde_steps as tsteps
from repro_torch.kernels.rod import rod_plan
from repro_torch.pde import AdvectionConfig, BurgersConfig, Heat2DConfig, HeatConfig, Simulation, get_stepper

MODES = ("f32", "bf16", "e5m10", "r2f2_16", "rr_tracked", "deploy")
PLANES = ("reference", "fused", "megakernel")
NAMES = ("heat2d", "advection1d", "burgers1d")
STEPS, EVERY = 20, 6
SMALL = {
    "heat2d": (JHeat2D(nx=24, ny=24), Heat2DConfig(nx=24, ny=24)),
    "advection1d": (JAdv(nx=128), AdvectionConfig(nx=128)),
    "burgers1d": (JBurg(nx=128), BurgersConfig(nx=128)),
}
SITES = {"heat2d": jsteps.HEAT2D_SITES, "advection1d": jsteps.ADVECTION1D_SITES, "burgers1d": jsteps.BURGERS1D_SITES}
#: the split each workload pins at without starving a product
PINNED_K = {"heat2d": 2, "advection1d": 3, "burgers1d": 3}


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


def assert_bits(want, got, nan_canonical=False):
    view = canon if nan_canonical else raw
    np.testing.assert_array_equal(view(want), view(np.asarray(got)))


def assert_tracker_equal(want, got):
    """Two RangeTrackers (repro's, the port's), every field as bits."""
    assert (want is None) == (got is None)
    if want is None:
        return
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if w.dtype == np.float32:
            np.testing.assert_array_equal(raw(w), raw(g), err_msg=f)
        else:
            np.testing.assert_array_equal(w, g, err_msg=f)


def assert_run_equal(want, got, nan_canonical=False):
    assert_bits(want.state, got.state.numpy(), nan_canonical)
    assert_bits(want.snapshots, got.snapshots.numpy(), nan_canonical)
    assert_tracker_equal(
        None if want.tracker is None else want.tracker.state, None if got.tracker is None else got.tracker.state
    )


def nan_run(name, mode):
    return mode == "e5m10" and name in ("advection1d", "burgers1d")


@pytest.fixture(scope="module")
def state0s():
    return {name: np.asarray(JSim(name, jc, jpol.PRESETS["f32"]).stepper.init_state(jc)) for name, (jc, _) in SMALL.items()}


@pytest.fixture(scope="module")
def reference_runs(state0s):
    """repro's runs, one per (stepper, mode, plane)."""
    cache = {}

    def get(name, mode, plane):
        if (name, mode, plane) not in cache:
            jc, _ = SMALL[name]
            cache[name, mode, plane] = JSim(name, jc, preset(jpol.PRESETS, mode)).run(
                STEPS, snapshot_every=EVERY, state0=state0s[name], execution=plane
            )
        return cache[name, mode, plane]

    return get


def port_run(name, mode, state0, execution, cfg=None, **kw):
    tc = SMALL[name][1] if cfg is None else cfg
    return Simulation(name, tc, preset(tpol.PRESETS, mode, **kw), device="cpu").run(
        STEPS, snapshot_every=EVERY, state0=state_from_numpy(state0), execution=execution
    )


# ---------------------------------------------------------------------------
# the steppers, plane by plane
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("execution", PLANES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_simulation_bit_exact(name, mode, execution, state0s, reference_runs):
    """Each plane of the port against the same plane of repro: repro's own
    planes differ in rr_tracked (the fused plane latches its floor per
    chunk), so no plane stands in for another."""
    tres = port_run(name, mode, state0s[name], execution)
    assert tres.snapshots.shape[0] == STEPS // EVERY
    assert_run_equal(reference_runs(name, mode, execution), tres, nan_canonical=nan_run(name, mode))


@pytest.mark.parametrize("name", NAMES)
def test_auto_resolves_to_the_megakernel_with_one_plain_call(name, state0s):
    """execution="auto" resolves to the megakernel in every mode with a fused
    family, as in repro; on the CPU a run is one plain megakernel call and
    launches nothing."""
    jc, tc = SMALL[name]
    for mode in MODES:
        jsim = JSim(name, jc, preset(jpol.PRESETS, mode))
        tsim = Simulation(name, tc, preset(tpol.PRESETS, mode), device="cpu")
        assert tsim._resolve_execution("auto") == jsim._resolve_execution("auto") == "megakernel"
    ctr = {"heat2d": tmega.HEAT2D_MEGA, "advection1d": tmega.ADVECTION1D_MEGA, "burgers1d": tmega.BURGERS1D_MEGA}
    before = {k: (c.launches, c.plain_calls) for k, c in ctr.items()}
    Simulation(name, tc, preset(tpol.PRESETS, "rr_tracked"), device="cpu").run(
        8, snapshot_every=3, state0=state_from_numpy(state0s[name]), execution="auto"
    )
    delta = {k: (c.launches - before[k][0], c.plain_calls - before[k][1]) for k, c in ctr.items()}
    assert delta == {k: (0, int(k == name)) for k in ctr}


@pytest.mark.parametrize("name", NAMES)
def test_tracker_grows_from_narrow_start_and_resumes(name, state0s):
    """rr_tracked from k0=0 on the megakernel: the adjust unit grows the
    split as repro's does, and a tracker saved by repro (numpy arrays)
    resumes on the port as it does on repro."""
    jc, tc = SMALL[name]
    jsim = JSim(name, jc, preset(jpol.PRESETS, "rr_tracked"))
    tsim = Simulation(name, tc, preset(tpol.PRESETS, "rr_tracked"), device="cpu")
    s0 = state0s[name]
    jres = jsim.run(12, snapshot_every=5, state0=s0, tracker=jsim.init_tracker(k0=0), execution="megakernel")
    tres = tsim.run(12, snapshot_every=5, state0=state_from_numpy(s0), tracker=tsim.init_tracker(k0=0), execution="megakernel")
    assert int(tres.tracker.state.overflow_steps.sum()) > 0
    assert_run_equal(jres, tres)
    st = jres.tracker.state
    resumed = tracker_from_numpy(jres.tracker.names, st.k, st.hi_ema, st.lo_ema, st.overflow_steps, st.shrink_steps)
    j2 = jsim.run(STEPS, snapshot_every=EVERY, state0=jres.state, tracker=jres.tracker, execution="megakernel")
    t2 = tsim.run(STEPS, snapshot_every=EVERY, state0=state_from_numpy(np.asarray(jres.state)), tracker=resumed, execution="megakernel")
    assert_run_equal(j2, t2)


# ---------------------------------------------------------------------------
# kernel K5's plain versions against repro's kernels (interpret mode)
# ---------------------------------------------------------------------------


def kernel_args(name):
    jc, _ = SMALL[name]
    if name == "heat2d":
        return dict(alpha=jc.alpha, dtodx2=jc.dtodx2)
    if name == "advection1d":
        return dict(speed=jc.speed, dtodx=jc.dtodx)
    return dict(dt=jc.dt, dx=jc.dx)


SWEEP_CASES = [
    # (mode, k_floor, pinned, evidence); the f32, bf16 and deploy sweeps run
    # in test_simulation_bit_exact's fused rows, with evidence under deploy
    ("e5m10", None, False, True),
    ("r2f2_16", None, False, True),
    ("rr_tracked", (2, 1), False, True),
    ("rr_tracked", "pinned", True, False),
]


@pytest.mark.parametrize("case", SWEEP_CASES, ids=lambda c: f"{c[0]}-f{c[1]}-e{c[3]}")
@pytest.mark.parametrize("name", NAMES)
def test_sweep_plain_matches_interpret(name, case, state0s):
    """K5a-c: output and per-substep evidence of the plain sweep against
    repro's fused kernel, with carried floors and pinned splits."""
    mode, floor, pinned, ev = case
    if floor == "pinned":
        floor = (PINNED_K[name],) * 2
    jp, tp = preset(jpol.PRESETS, mode, pinned=pinned), preset(tpol.PRESETS, mode, pinned=pinned)
    kw = dict(kernel_args(name), steps=7, collect_evidence=ev)
    u = state0s[name]
    jout, jev = getattr(jsteps, f"{name}_sweep")(
        jnp.asarray(u), prec=jp, k_floor=None if floor is None else jnp.asarray(floor, jnp.int32), interpret=True, **kw
    )
    counter = getattr(tsteps, f"{name.upper()}_SWEEP")
    before = counter.plain_calls
    tout, tev = getattr(tsteps, f"{name}_sweep")(
        state_from_numpy(u), prec=tp, k_floor=None if floor is None else torch.tensor(floor, dtype=torch.int32), **kw
    )
    assert counter.plain_calls == before + 1  # CPU tensors take the plain version
    assert tout.shape == u.shape
    assert_bits(jout, tout.numpy(), nan_canonical=nan_run(name, mode))
    assert (jev is None) == (tev is None)
    if ev:
        assert tuple(tev.shape) == (7, 2, 2)
        assert_bits(jev, tev.numpy())


@pytest.mark.parametrize("variant", ["rr_tracked", "deploy", "pinned", "k_bounds"])
@pytest.mark.parametrize("name", NAMES)
def test_mega_plain_matches_interpret(name, variant, state0s):
    """K5d-f: state, snapshots, per-substep evidence and every tracker field
    of the plain megakernel against repro's, with an evolving tracker
    (rr_tracked, deploy), a pinned one (which stays as it is) and k_bounds
    clamping every tick."""
    mode = "deploy" if variant == "deploy" else "rr_tracked"
    kw = {"pinned": dict(pinned=True), "k_bounds": dict(k_bounds=((1, 2), (1, 2)))}.get(variant, {})
    jp, tp = preset(jpol.PRESETS, mode, **kw), preset(tpol.PRESETS, mode, **kw)
    k0 = PINNED_K[name] if variant == "pinned" else None
    common = dict(kernel_args(name), steps=STEPS, every=EVERY, sites=SITES[name], collect_evidence=True)
    u = state0s[name]
    want = getattr(jmega, f"{name}_mega")(u, prec=jp, tracker=jpol.tracker_init(2, jp.fmt, k0=k0), interpret=True, **common)
    got = getattr(tmega, f"{name}_mega")(
        state_from_numpy(u), prec=tp, tracker=tpol.tracker_init(2, tp.fmt, k0=k0, device="cpu"), **common
    )
    assert tuple(got.snaps.shape) == (STEPS // EVERY,) + u.shape
    assert_bits(want.state, got.state.numpy())
    assert_bits(want.snaps, got.snaps.numpy())
    assert_bits(want.evidence, got.evidence.numpy())
    assert_tracker_equal(want.tracker, got.tracker)
    if variant == "pinned":
        assert got.tracker.k.tolist() == [k0, k0]
    if variant == "k_bounds":
        assert set(got.tracker.k.tolist()) <= {1, 2}


def test_field_beyond_one_cta_is_refused():
    """A K5 kernel takes every field on the card, as repro does: heat2d in
    one thread-block cluster of up to 16 CTAs and beyond it on the rod's
    cooperative grid, a periodic rod on the rod's warp or grid shape. The
    old limits (heat2d past 358x358 or 258x514, a rod past one CTA's shared
    memory) are accepted; a field no body has (heat2d below nx, ny >= 3)
    is still refused, and nothing falls back to the plain version."""
    assert tsteps.heat2d_plan(64, 64) == (16, 4)
    assert tsteps.heat2d_plan(256, 256) == (16, 16)
    assert tsteps.heat2d_plan(358, 358) == (16, 23)
    for shape in ((359, 359), (258, 515), (400, 400)):
        assert tsteps.heat2d_plan(*shape).shape == "grid", shape
    for nx in (256, 4096, 25_601, 17_067, 20_000, 1 << 16):
        assert rod_plan(1, nx, periodic=True).shape == ("warp" if nx <= 2048 else "grid"), nx
    for name, cfg in (("advection1d", AdvectionConfig(nx=25_601)), ("burgers1d", BurgersConfig(nx=1 << 16)),
                      ("heat2d", Heat2DConfig(nx=359, ny=359))):
        assert get_stepper(name).kernels_hold(cfg), name
    with pytest.raises(ValueError, match="nx, ny >= 3"):
        tsteps.heat2d_plan(2, 64)


# ---------------------------------------------------------------------------
# where the compiled reference fuses (ROADMAP queue 3)
# ---------------------------------------------------------------------------


def _step_rounded_otherwise(name, u, cfg):
    """One f32 step rounded the other way from the port's: heat1d, heat2d
    and advection1d with every product rounded on its own, burgers1d with its
    update product fused into the subtraction."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32)  # noqa: E731
    if name == "heat2d":
        lap = u[:-2, 1:-1] + u[2:, 1:-1] + u[1:-1, :-2] + u[1:-1, 2:] - 4.0 * u[1:-1, 1:-1]
        out = u.clone()
        out[1:-1, 1:-1] = u[1:-1, 1:-1] + (f32(cfg.alpha) * lap) * f32(cfg.dtodx2)
        return out
    if name == "heat1d":
        lap = u[:-2] - 2.0 * u[1:-1] + u[2:]
        return torch.cat([u[:1], u[1:-1] + (f32(cfg.alpha) * lap) * f32(cfg.dtodx2), u[-1:]])
    if name == "advection1d":
        f = f32(cfg.speed) * u
        return u - f32(cfg.dtodx) * (f - torch.roll(f, 1))
    f = f32(0.5) * (u * u)
    u_avg = 0.5 * (torch.roll(u, -1) + torch.roll(u, 1))
    return fma(-f32(cfg.dt / (2.0 * cfg.dx)), torch.roll(f, -1) - torch.roll(f, 1), u_avg)


FMA_CASES = {
    # heat2d: an update the size of the field (the paper's config keeps it
    # ~1% of u, where the two roundings agree)
    "heat2d": dict(nx=20, ny=28, cfl=0.23, alpha=3e-5, init="exp"),
    # advection1d: cfl != 1, so dtodx*df is inexact
    "advection1d": dict(nx=128, cfl=0.7),
    # advection1d: speed != 1 as well, so the flux product is inexact
    "advection1d-speed": dict(nx=128, cfl=0.5, speed=0.7, amplitude=300.0),
    "burgers1d": dict(nx=128),
    # heat1d (slice 1) folds the same way as heat2d
    "heat1d": dict(nx=20, alpha=3e-5, cfl=0.45, init="exp"),
}


@pytest.mark.parametrize("case", list(FMA_CASES))
def test_fma_placement_matches_compiled_reference(case):
    """In the f32 mode the compiled reference computes heat2d's (and
    heat1d's) interior as fma(lap, alpha*dtodx2, u) (XLA folds the two
    constant products into one), advection1d's update as fma(-dtodx, df, u) and its difference as
    fma(speed, u, -f[i-1]), and burgers1d's update with two roundings. Each
    config tells the two roundings apart: the other rounding misses repro's
    run. The port matches repro over 20 steps on every plane, but
    for advection1d with speed != 1 on the reference plane, where XLA fuses
    the difference at some positions only (queue 3)."""
    name = case.split("-")[0]
    jcfg = {"heat1d": JHeat, "heat2d": JHeat2D, "advection1d": JAdv, "burgers1d": JBurg}[name](**FMA_CASES[case])
    tcfg = {"heat1d": HeatConfig, "heat2d": Heat2DConfig, "advection1d": AdvectionConfig, "burgers1d": BurgersConfig}[name](**FMA_CASES[case])
    f32 = jpol.PRESETS["f32"]
    s0 = np.asarray(JSim(name, jcfg, f32).stepper.init_state(jcfg))
    ref = np.asarray(JSim(name, jcfg, f32).run(STEPS, snapshot_every=STEPS, state0=s0).state)
    other = state_from_numpy(s0)
    for _ in range(STEPS):
        other = _step_rounded_otherwise(name, other, tcfg)
    assert (raw(other.numpy()) != raw(ref)).any(), "this config cannot tell the two roundings apart"
    planes = PLANES[1:] if case == "advection1d-speed" else PLANES
    for plane in planes:
        want = JSim(name, jcfg, f32).run(STEPS, snapshot_every=EVERY, state0=s0, execution=plane)
        got = port_run(name, "f32", s0, plane, cfg=tcfg)
        assert_run_equal(want, got)
