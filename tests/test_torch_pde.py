"""The slice end to end: repro_torch.pde.Simulation against repro.pde.Simulation
for heat1d and swe2d, six modes, reference and fused planes.

Both packages start from repro's initial state (the libraries' linspace/
sin/exp differ in the last ulp). States, snapshots and every tracker field
compare as raw bits, with one recorded exception: swe2d under e5m10 turns
to NaN, and the sign bit XLA gives a NaN depends on the operand order it
picks for commutative ops, so that run compares with NaNs made canonical
(their positions, and every other bit, still match).

PyTorch runs with subnormal flushing on here, as XLA:CPU does; the CUDA
kernels keep subnormals, as the plain versions do on the card."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import policy as jpol
from repro.pde import Simulation as JSim
from repro.pde.heat1d import HeatConfig as JHeat
from repro.pde.swe2d import SWEConfig as JSWE
from repro_torch.convert import state_from_numpy, tracker_from_numpy
from repro_torch.core import policy as tpol
from repro_torch.pde import HeatConfig, Simulation, SWEConfig, get_stepper

MODES = ("f32", "bf16", "e5m10", "r2f2_16", "rr_tracked", "deploy")
STEPS, EVERY = 28, 8  # three snapshots and a 4-step remainder chunk
SMALL = {"heat1d": (JHeat(nx=64), HeatConfig(nx=64)), "swe2d": (JSWE(nx=32, ny=32), SWEConfig(nx=32, ny=32))}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def raw(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(np.uint32)


def canon(x):
    b = raw(x).copy()
    b[np.isnan(np.asarray(x, np.float32))] = 0x7FC00000
    return b


def assert_run_equal(jres, tres, nan_canonical=False):
    view = canon if nan_canonical else raw
    np.testing.assert_array_equal(view(jres.state), view(tres.state.numpy()))
    np.testing.assert_array_equal(view(jres.snapshots), view(tres.snapshots.numpy()))
    assert (jres.tracker is None) == (tres.tracker is None)
    if jres.tracker is not None:
        assert tuple(jres.tracker.names) == tres.tracker.names
        for f in jres.tracker.state._fields:
            want, got = np.asarray(getattr(jres.tracker.state, f)), getattr(tres.tracker.state, f).numpy()
            if want.dtype == np.float32:
                np.testing.assert_array_equal(raw(want), raw(got))
            else:
                np.testing.assert_array_equal(want, got)


@pytest.fixture(scope="module")
def state0s():
    return {name: np.asarray(JSim(name, jc, jpol.PRESETS["f32"]).stepper.init_state(jc)) for name, (jc, _) in SMALL.items()}


@pytest.fixture(scope="module")
def reference_runs(state0s):
    """repro's runs, shared by both of the port's planes: repro's fused plane
    equals its reference plane bit for bit in every mode but rr_tracked
    (tests/test_fused.py), so only rr_tracked runs repro's fused plane."""
    cache = {}

    def get(name, mode, execution):
        plane = execution if mode == "rr_tracked" else "reference"
        if (name, mode, plane) not in cache:
            jc, _ = SMALL[name]
            cache[name, mode, plane] = JSim(name, jc, preset(jpol.PRESETS, mode)).run(
                STEPS, snapshot_every=EVERY, state0=state0s[name], execution=plane
            )
        return cache[name, mode, plane]

    return get


@pytest.mark.parametrize("execution", ["reference", "fused"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["heat1d", "swe2d"])
def test_simulation_bit_exact(name, mode, execution, state0s, reference_runs):
    _, tc = SMALL[name]
    s0 = state0s[name]
    jres = reference_runs(name, mode, execution)
    tres = Simulation(name, tc, preset(tpol.PRESETS, mode), device="cpu").run(
        STEPS, snapshot_every=EVERY, state0=state_from_numpy(s0), execution=execution
    )
    assert tres.snapshots.shape[0] == STEPS // EVERY
    assert_run_equal(jres, tres, nan_canonical=(name, mode) == ("swe2d", "e5m10"))


@pytest.mark.parametrize("execution", ["reference", "fused"])
def test_tracker_grows_from_narrow_start(execution, state0s):
    """heat1d rr_tracked from k0=0: the adjust unit must grow the carried
    split exactly as the reference does, counters included, and a resumed
    tracker carries across runs."""
    jc, tc = SMALL["heat1d"]
    s0 = state0s["heat1d"]
    jsim = JSim("heat1d", jc, preset(jpol.PRESETS, "rr_tracked"))
    jres = jsim.run(30, snapshot_every=10, state0=s0, tracker=jsim.init_tracker(k0=0), execution=execution)
    tsim = Simulation("heat1d", tc, preset(tpol.PRESETS, "rr_tracked"), device="cpu")
    tres = tsim.run(30, snapshot_every=10, state0=state_from_numpy(s0), tracker=tsim.init_tracker(k0=0), execution=execution)
    assert int(tres.tracker.state.overflow_steps.sum()) > 0
    assert_run_equal(jres, tres)
    st = jres.tracker.state
    resumed = tracker_from_numpy(jres.tracker.names, st.k, st.hi_ema, st.lo_ema, st.overflow_steps, st.shrink_steps)
    j2 = jsim.run(12, snapshot_every=6, state0=jres.state, tracker=jres.tracker, execution=execution)
    t2 = tsim.run(12, snapshot_every=6, state0=state_from_numpy(np.asarray(jres.state)), tracker=resumed, execution=execution)
    assert_run_equal(j2, t2)


def _bench_swe_rows():
    with open(os.path.join(ROOT, "artifacts", "bench", "BENCH_pde.json")) as f:
        rows = json.load(f)["rows"]
    out = {}
    for r in rows:
        parts = r["name"].split("/")
        if parts[1] == "swe2d" and parts[3] == "fused":
            fields = r["derived"].split(";")
            out[parts[2]] = (fields[0].split("=")[1], fields[2])
    return out


def _verdict(out, ref):
    if not np.isfinite(out).all():
        return "nan", "DESTROYED(NaN)"
    rel = float(np.linalg.norm(out - ref) / np.linalg.norm(ref))
    corr = float(np.corrcoef(out.reshape(-1), ref.reshape(-1))[0, 1])
    return f"{rel:.4f}", "CORRECT" if corr > 0.98 else "WRONG"


def test_paper_grid_swe2d_fused_60_steps():
    """swe2d at the paper's 128x128 for 60 steps on the port's fused plane:
    the verdicts and rel-L2 of BENCH_pde.json's rows (E5M10 destroyed,
    R2F2-16 correct at 0.0163, bf16 at 0.0608, rr_tracked adj=+2/-2), and
    the R2F2-16 final state bit-identical to repro's fused run."""
    cfg, jcfg = SWEConfig(), JSWE()
    s0 = np.asarray(JSim("swe2d", jcfg, jpol.PRESETS["f32"]).stepper.init_state(jcfg))
    depth = cfg.depth

    def port(mode):
        return Simulation("swe2d", cfg, preset(tpol.PRESETS, mode), device="cpu").run(
            60, state0=state_from_numpy(s0), execution="fused"
        )

    ref = port("f32").state[0].numpy() - depth
    want = _bench_swe_rows()
    for mode in ("e5m10", "r2f2_16", "bf16", "rr_tracked"):
        res = port(mode)
        assert _verdict(res.state[0].numpy() - depth, ref) == want[mode], mode
        if mode == "rr_tracked":
            st = res.tracker.state
            assert (int(st.overflow_steps.sum()), int(st.shrink_steps.sum())) == (2, 2)
        if mode == "r2f2_16":
            jres = JSim("swe2d", jcfg, preset(jpol.PRESETS, mode)).run(60, state0=s0, execution="fused")
            np.testing.assert_array_equal(raw(jres.state), raw(res.state.numpy()))


def test_port_initial_states_within_ulps():
    """The port's own initial conditions against repro's, within 16 ulps of
    each field's largest value: linspace, sin and exp differ in the last
    ulps between the libraries (31 ulps of a small value near a zero of the
    sin profile, and exp tails that XLA flushes to zero)."""
    from repro.configs import heat1d as jh, swe2d as js
    from repro_torch.configs import heat1d as th, swe2d as ts

    for jcfg, tcfg, stepper in ((jh.CONFIG, th.CONFIG, "heat1d"), (jh.CONFIG_EXP, th.CONFIG_EXP, "heat1d"), (js.CONFIG, ts.CONFIG, "swe2d")):
        want = np.asarray(JSim(stepper, jcfg, jpol.PRESETS["f32"]).stepper.init_state(jcfg), np.float32)
        got = get_stepper(stepper).init_state(tcfg, device="cpu").numpy()
        bound = 16 * np.spacing(np.abs(want).max())
        assert np.abs(got - want).max() <= bound, (stepper, float(np.abs(got - want).max()))


def test_snapshot_cadence_and_remainder():
    sim = Simulation("heat1d", HeatConfig(nx=32), tpol.PRESETS["r2f2_16"], device="cpu")
    res = sim.run(23, snapshot_every=5, execution="fused")
    assert tuple(res.snapshots.shape) == (4, 32)
    ref = sim.run(23, snapshot_every=5)
    np.testing.assert_array_equal(raw(ref.state.numpy()), raw(res.state.numpy()))
    empty = sim.run(3, snapshot_every=10)
    assert tuple(empty.snapshots.shape) == (0, 32)
    swe = Simulation("swe2d", SWEConfig(nx=8, ny=8), tpol.PRESETS["f32"], device="cpu").run(4)
    assert tuple(swe.snapshots.shape) == (4, 8, 8) and swe.tracker is None


def test_out_of_slice_paths_raise_with_roadmap_items():
    sim = Simulation("heat1d", HeatConfig(nx=16), tpol.PRESETS["r2f2_16"], device="cpu")
    for execution in ("megakernel", "auto"):
        with pytest.raises(NotImplementedError, match="queue 1 item 5"):
            sim.run(2, execution=execution)
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        sim.run(2, storage="packed")
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        sim.run(2, capture=True)
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        sim.run(2, policy=object())
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        sim.run_ensemble(None, 2)
    for name in ("heat2d", "advection1d", "burgers1d"):
        with pytest.raises(NotImplementedError, match="queue 1 item 8"):
            get_stepper(name)
    with pytest.raises(KeyError):
        get_stepper("wave1d")
    with pytest.raises(ValueError):
        sim.run(2, execution="warp")


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert Simulation("heat1d", None, tpol.PRESETS["f32"]).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Simulation("heat1d", None, tpol.PRESETS["f32"])


def test_port_imports_without_jax_or_repro():
    code = (
        "import sys, repro_torch, repro_torch.pde, repro_torch.kernels.heat_stencil, "
        "repro_torch.kernels.swe_flux, repro_torch.convert, repro_torch.configs.heat1d, repro_torch.configs.swe2d\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
