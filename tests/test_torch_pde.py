"""The slice end to end: repro_torch.pde.Simulation against repro.pde.Simulation
for heat1d and swe2d, six modes, reference and fused planes (the megakernel
plane is held in test_torch_mega.py), and every builtin stepper with packed
and quantized storage on all three planes against repro's packed runs.

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


@pytest.mark.parametrize("execution", ["reference", "fused", "megakernel"])
def test_tracker_grows_from_narrow_start(execution, state0s):
    """heat1d rr_tracked from k0=0: the adjust unit must grow the carried
    split exactly as the reference does, counters included, and a resumed
    tracker carries across runs. On the megakernel the split grows in the
    first substep but the datapath floor moves only at the first snapshot."""
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
    sin profile, and exp tails that XLA flushes to zero). Covers all five
    steppers' configs, and heat2d's exp profile."""
    from repro.configs import advection1d as ja, burgers1d as jb, heat1d as jh, heat2d as j2, swe2d as js
    from repro.pde.heat2d import Heat2DConfig as JHeat2D
    from repro_torch.configs import advection1d as ta, burgers1d as tb, heat1d as th, heat2d as t2, swe2d as ts
    from repro_torch.pde import Heat2DConfig

    cases = (
        (jh.CONFIG, th.CONFIG, "heat1d"), (jh.CONFIG_EXP, th.CONFIG_EXP, "heat1d"), (js.CONFIG, ts.CONFIG, "swe2d"),
        (j2.CONFIG, t2.CONFIG, "heat2d"), (JHeat2D(init="exp"), Heat2DConfig(init="exp"), "heat2d"),
        (ja.CONFIG, ta.CONFIG, "advection1d"), (jb.CONFIG, tb.CONFIG, "burgers1d"),
    )
    for jcfg, tcfg, stepper in cases:
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
    """Ensembles, storage, capture and policies, ported since this test
    held them as raising, run on every plane and refuse what the reference
    refuses."""
    from repro_torch.pack import PackedArray
    from repro_torch.profile import PrecisionPolicy

    sim = Simulation("heat1d", HeatConfig(nx=16), tpol.PRESETS["r2f2_16"], device="cpu")
    assert isinstance(sim.run(2, execution="megakernel", storage="packed").state, PackedArray)
    assert sim.run(2, execution="megakernel", capture=True).profile.exp_total.sum() > 0
    assert isinstance(sim.run(2, storage="packed").state, PackedArray)
    with pytest.raises(ValueError, match="unknown storage mode"):
        sim.run(2, storage="bf16")
    assert sim.run(2, capture=True).profile.evidence.shape == (2, 2, 2)
    with pytest.raises(TypeError, match="capture must be bool or CaptureSpec"):
        sim.run(2, capture="yes")
    policy = PrecisionPolicy("heat1d", tpol.PRESETS["r2f2_16"].fmt, {s: {"k": 2, "k_lo": 1, "k_hi": 3} for s in sim.stepper.sites})
    assert sim.run(2, policy=policy).tracker is None  # r2f2_16 tracks nothing: only the hints install
    with pytest.raises(AttributeError):
        sim.run(2, policy=object())
    ens = sim.run_ensemble(torch.stack([sim.stepper.init_state(sim.cfg, device="cpu")] * 2), 2)
    assert ens.state.shape == (2, 16) and ens.snapshots.shape[0] == 2  # ported: run_ensemble runs
    for name in ("heat2d", "advection1d", "burgers1d"):
        assert get_stepper(name).name == name
        small = Simulation(name, None, tpol.PRESETS["r2f2_16"], device="cpu")
        for execution in ("reference", "fused", "megakernel"):
            assert isinstance(small.run(2, execution=execution, storage="packed").state, PackedArray)
            assert small.run(2, execution=execution, capture=True).profile.exp_total.sum() > 0
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
        "repro_torch.kernels.swe_flux, repro_torch.kernels.mega, repro_torch.kernels.pde_steps, repro_torch.convert, "
        "repro_torch.configs.heat1d, repro_torch.configs.swe2d, repro_torch.configs.heat2d, "
        "repro_torch.configs.advection1d, repro_torch.configs.burgers1d, repro_torch.configs.llama4_scout_17b_a16e, "
        "repro_torch.kernels.ops, repro_torch.kernels.r2f2_quantize, repro_torch.kernels.r2f2_matmul, "
        "repro_torch.core.rr_dot, repro_torch.models, repro_torch.models.moe, repro_torch.train, repro_torch.serve, "
        "repro_torch.service, repro_torch.obs.health, repro_torch.obs.shadow, repro_torch.obs.flightrec, "
        "repro_torch.obs.server\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# carried storage: packed and quantized on every plane, every builtin stepper
# ---------------------------------------------------------------------------

#: the five builtin steppers at small sizes, 16 steps with a snapshot every 6
#: (two boundaries and a 4-step remainder)
STORAGE_CFGS = {
    "heat1d": ({"nx": 64}, {"nx": 64}), "swe2d": ({"nx": 24, "ny": 24}, {"nx": 24, "ny": 24}),
    "heat2d": ({"nx": 16, "ny": 12}, {"nx": 16, "ny": 12}), "advection1d": ({"nx": 96}, {"nx": 96}),
    "burgers1d": ({"nx": 96}, {"nx": 96}),
}
STORAGE_STEPS, STORAGE_EVERY = 16, 6
#: (stepper, mode, repro's plane): r2f2_16 on repro's reference plane (its
#: planes agree bit for bit); rr_tracked on repro's fused plane (the
#: megakernel's, which latches the floor per chunk) and, for heat1d, also on
#: its reference plane
STORAGE_RUNS = [(name, "r2f2_16", "reference") for name in STORAGE_CFGS] + [
    ("heat1d", "rr_tracked", "reference"), ("heat1d", "rr_tracked", "fused"), ("swe2d", "rr_tracked", "fused"),
]


#: the port's planes held to each of repro's (see STORAGE_RUNS)
STORAGE_CASES = [
    (run, execution)
    for run in STORAGE_RUNS
    for execution in (("reference", "fused", "megakernel") if run[1] == "r2f2_16" else
                      ("reference",) if run[2] == "reference" else ("fused", "megakernel"))
]
CONFIG_CLASS = {"heat1d": "HeatConfig", "swe2d": "SWEConfig", "heat2d": "Heat2DConfig", "advection1d": "AdvectionConfig",
                "burgers1d": "BurgersConfig"}


def _storage_cfgs(name):
    import importlib

    jcls = getattr(importlib.import_module(f"repro.pde.{name}"), CONFIG_CLASS[name])
    tcls = getattr(importlib.import_module(f"repro_torch.pde.{name}"), CONFIG_CLASS[name])
    jkw, tkw = STORAGE_CFGS[name]
    return jcls(**jkw), tcls(**tkw)


@pytest.fixture(scope="module")
def storage_reference():
    """repro's packed runs of :data:`STORAGE_RUNS` (its packed run equals its
    quantized run, tests/test_pack.py), from repro's initial states."""
    out = {}
    for name, mode, plane in STORAGE_RUNS:
        jc, _ = _storage_cfgs(name)
        jsim = JSim(name, jc, preset(jpol.PRESETS, mode))
        s0 = np.asarray(jsim.stepper.init_state(jc))
        out[name, mode, plane] = (s0, jsim.run(STORAGE_STEPS, snapshot_every=STORAGE_EVERY, state0=s0, execution=plane,
                                               storage="packed"))
    return out


def _payload_canon(payload, k, total_bits, values):
    p = np.asarray(payload).astype(np.int64)
    v = np.asarray(values, np.float32).reshape(p.shape)
    return np.where(np.isnan(v), p & ~(1 << (total_bits - 1)), p), np.asarray(k)


@pytest.mark.parametrize("run,execution", STORAGE_CASES, ids=["-".join(r) + f"-{e}" for r, e in STORAGE_CASES])
def test_storage_bit_exact(run, execution, storage_reference):
    """The port's packed and quantized runs on a plane against repro's
    packed run: the final state unpacked, the payload (NaN signs cleared)
    and splits, snapshots and every tracker field; packed = quantized."""
    from repro.pack import unpack_array as j_unpack
    from repro_torch.pack import PackedArray, unpack_state

    name, mode, _ = run
    _, tc = _storage_cfgs(name)
    s0, jres = storage_reference[run]
    jstate = np.asarray(j_unpack(jres.state))
    runs = {}
    for storage in ("packed", "quantized"):
        runs[storage] = Simulation(name, tc, preset(tpol.PRESETS, mode), device="cpu").run(
            STORAGE_STEPS, snapshot_every=STORAGE_EVERY, state0=state_from_numpy(s0), execution=execution, storage=storage
        )
    packed, quantized = runs["packed"], runs["quantized"]
    assert isinstance(packed.state, PackedArray) and packed.state.payload.dtype == torch.uint16
    bits_total = packed.state.fmt.total_bits
    want = _payload_canon(jres.state.payload, jres.state.k, bits_total, jstate)
    got = _payload_canon(packed.state.payload.numpy(), packed.state.k.numpy(), bits_total, jstate)
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[1], got[1])
    assert (packed.state.shape, packed.state.block, packed.state.nbytes) == (jres.state.shape, jres.state.block, jres.state.nbytes)
    for res in (packed, quantized):
        state = unpack_state(res.state)
        assert_run_equal(jres._replace(state=jstate), res._replace(state=state), nan_canonical=True)
    np.testing.assert_array_equal(canon(unpack_state(packed.state).numpy()), canon(quantized.state.numpy()))
