"""repro_torch.profile against repro.profile at tests/test_profile.py's small
sizes: range capture on every plane (Simulation.run(capture=)), its
passivity, policy synthesis and validation, policies on every plane
(Simulation.run(policy=)), policy artifacts across the two packages,
generate(policy=) and the python -m repro_torch.profile CLI.

Both packages start from repro's initial state. Evidence compares as raw
f32 bits, counts exactly. repro's runs are jitted and cached per module;
PyTorch runs with subnormal flushing on, as XLA:CPU does, and the port's
binning is decided from the f32 bits, so a subnormal operand counts in the
low edge bin as repro's compiled captured scans count it."""

import dataclasses
import json
import os
import subprocess
import sys

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
from repro.profile import PrecisionPolicy as JPolicy
from repro.profile import capture_profile as j_capture_profile
from repro.profile import synthesize_policy as j_synthesize_policy
from repro_torch.core import policy as tpol
from repro_torch.core.flexformat import FlexFormat
from repro_torch.pde import AdvectionConfig, BurgersConfig, Heat2DConfig, HeatConfig, Simulation, SWEConfig
from repro_torch.profile import (
    SCHEMA,
    CaptureSpec,
    PrecisionPolicy,
    capture_profile,
    exp_hist,
    synthesize_policy,
    tune_policy,
    validate_policy,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILTINS = ("advection1d", "burgers1d", "heat1d", "heat2d", "swe2d")
PLANES = ("reference", "fused", "megakernel", "auto")
SIX = ("f32", "bf16", "e5m10", "r2f2_16", "rr_tracked", "deploy")
STEPS = 38  # never divides the default snapshot cadence: a remainder chunk
SMALL = {
    "heat1d": (JHeat(nx=64), HeatConfig(nx=64)),
    "heat2d": (JH2(nx=24, ny=24), Heat2DConfig(nx=24, ny=24)),
    "advection1d": (JAdv(nx=128), AdvectionConfig(nx=128)),
    "burgers1d": (JBur(nx=128), BurgersConfig(nx=128)),
    "swe2d": (JSWE(nx=32, ny=32), SWEConfig(nx=32, ny=32)),
}


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


def jrun(jcfg, name, mode, steps, state0, **kw):
    """repro's run in ``mode`` (a name or a PrecisionConfig), jitted (its
    fused and megakernel planes in interpret mode): the final state, the
    tracker state and the captured profile."""
    prec = preset(jpol.PRESETS, mode) if isinstance(mode, str) else mode

    def run(s0):
        res = JSim(name, jcfg, prec).run(steps, state0=s0, **kw)
        return res.state, None if res.tracker is None else res.tracker.state, res.profile

    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(state0))


@pytest.fixture(scope="module")
def state0s():
    return {name: np.asarray(JSim(name, jc, jpol.PRESETS["f32"]).stepper.init_state(jc)) for name, (jc, _) in SMALL.items()}


@pytest.fixture(scope="module")
def repro_captures(state0s):
    cache = {}

    def get(name, mode, plane):
        plane = "megakernel" if plane == "auto" else plane  # repro's auto resolves to it for every builtin
        if (name, mode, plane) not in cache:
            cache[name, mode, plane] = jrun(SMALL[name][0], name, mode, STEPS, state0s[name], execution=plane, capture=True)
        return cache[name, mode, plane]

    return get


def assert_profile_equal(want, got):
    np.testing.assert_array_equal(raw(want.evidence), raw(got.evidence.numpy()))
    np.testing.assert_array_equal(np.asarray(want.exp_time), got.exp_time.numpy())
    np.testing.assert_array_equal(np.asarray(want.exp_total), got.exp_total.numpy())


PARITY = [(name, "f32") for name in BUILTINS] + [(name, "rr_tracked") for name in ("heat1d", "swe2d")]


@pytest.mark.parametrize("execution", PLANES)
@pytest.mark.parametrize("name,mode", PARITY)
def test_capture_matches_repro_on_every_plane(name, mode, execution, state0s, repro_captures):
    """Every builtin captured on each plane and auto, 38 steps, in f32 (the
    main path's heat1d and swe2d also in rr_tracked, the carried floor):
    evidence bits, exp_time and exp_total exactly, and the state and
    tracker, against repro's captured run on the same plane."""
    _, tc = SMALL[name]
    state, trk, prof = repro_captures(name, mode, execution)
    res = Simulation(name, tc, preset(tpol.PRESETS, mode), device="cpu").run(
        STEPS, state0=torch.from_numpy(state0s[name]), execution=execution, capture=True
    )
    assert_profile_equal(prof, res.profile)
    assert res.profile.exp_total.sum() > 0 and res.profile.evidence.shape[0] == STEPS
    np.testing.assert_array_equal(raw(state), raw(res.state.numpy()))
    if trk is not None:
        np.testing.assert_array_equal(np.asarray(trk.k), res.tracker.state.k.numpy())


def test_capture_masks_k3_pad_lanes():
    """swe2d at 140x32: K3's midpoint fields (139, 32) pad to a second tile
    whose q3 lanes hold 1.0; the fused plane's counts equal repro's."""
    jc, tc = JSWE(nx=140, ny=32), SWEConfig(nx=140, ny=32)
    s0 = np.asarray(JSim("swe2d", jc, jpol.PRESETS["f32"]).stepper.init_state(jc))
    for plane in ("reference", "fused"):
        _, _, want = jrun(jc, "swe2d", "f32", 2, s0, snapshot_every=1, execution=plane, capture=True)
        got = Simulation("swe2d", tc, tpol.PRESETS["f32"], device="cpu").run(
            2, snapshot_every=1, state0=torch.from_numpy(s0), execution=plane, capture=True
        )
        assert_profile_equal(want, got.profile)


def test_capture_fills_the_clamped_low_bin():
    """swe2d at 64x64 over 56 steps in f32: swe.q1q1 puts 3284 counts per
    operand into the clamped low bin (exponent <= -64) and swe.div's
    dividend 2804, on every plane, as in repro."""
    jc, tc = JSWE(nx=64, ny=64), SWEConfig(nx=64, ny=64)
    s0 = np.asarray(JSim("swe2d", jc, jpol.PRESETS["f32"]).stepper.init_state(jc))
    _, _, want = jrun(jc, "swe2d", "f32", 56, s0, snapshot_every=16, capture=True)
    np.testing.assert_array_equal(np.asarray(want.exp_total)[..., 0], [[3284, 3284], [0, 0], [0, 0], [2804, 0]])
    for plane in ("reference", "fused", "megakernel"):
        got = Simulation("swe2d", tc, tpol.PRESETS["f32"], device="cpu").run(
            56, snapshot_every=16, state0=torch.from_numpy(s0), execution=plane, capture=True
        )
        assert_profile_equal(want, got.profile)


def test_subnormal_operands_count_in_the_low_edge_bin():
    """f32 subnormals in advection1d's state are adv.flux operands of its
    first step: repro's compiled captured scan counts them in the low edge
    bin (the biased field 0 gives -127, clamped), and so does the port's
    binning from the bits, on every plane, under the CPU's flush."""
    jc, tc = JAdv(nx=128), AdvectionConfig(nx=128)
    base = np.asarray(JSim("advection1d", jc, jpol.PRESETS["f32"]).stepper.init_state(jc)).copy()
    zeroed, sub = base.copy(), base.copy()
    at = int(np.argmax(np.abs(base)))  # cells whose values are far from the low bin
    zeroed[at : at + 2] = 0.0
    # set from bits: a float assignment would flush under the CPU's flush mode
    sub.view(np.uint32)[at : at + 2] = (0x000116C2, 0x8020AB1B)  # 1e-40, -3e-39
    low = {}
    for label, s0 in (("zeroed", zeroed), ("subnormal", sub)):
        _, _, want = jrun(jc, "advection1d", "f32", 4, s0, snapshot_every=2, capture=True)
        low[label] = int(np.asarray(want.exp_total)[0, 1, 0])
        for plane in ("reference", "fused", "megakernel"):
            got = Simulation("advection1d", tc, tpol.PRESETS["f32"], device="cpu").run(
                4, snapshot_every=2, state0=torch.from_numpy(s0), execution=plane, capture=True
            )
            assert_profile_equal(want, got.profile)
    assert low["subnormal"] > low["zeroed"]


@pytest.mark.parametrize("mode", SIX)
def test_capture_is_passive(mode, state0s):
    """Capture changes no bit of the run: state, snapshots, splits and
    counters with capture equal those without, on every plane."""
    for name in ("heat1d", "swe2d"):
        _, tc = SMALL[name]
        kw = dict(state0=torch.from_numpy(state0s[name]), snapshot_every=5)
        for plane in ("reference", "fused", "megakernel"):
            sim = Simulation(name, tc, preset(tpol.PRESETS, mode), device="cpu")
            base = sim.run(12, execution=plane, **kw)
            cap = sim.run(12, execution=plane, capture=True, **kw)
            assert base.profile is None and cap.profile is not None
            np.testing.assert_array_equal(canon(base.state.numpy()), canon(cap.state.numpy()))
            np.testing.assert_array_equal(canon(base.snapshots.numpy()), canon(cap.snapshots.numpy()))
            if base.tracker is not None:
                for a, b in zip(base.tracker.state, cap.tracker.state):
                    np.testing.assert_array_equal(raw(a.float().numpy()), raw(b.float().numpy()))


@pytest.mark.parametrize("name,steps", [("heat1d", 200), ("burgers1d", 600)])
def test_autotuned_k_matches_rr_tracked_converged_k(name, steps, state0s):
    """Profiled under rr_tracked, the synthesized k equals the run's
    converged k (burgers grows to FX and shrinks back), and repro's
    synthesized k from its own evidence."""
    jc, tc = SMALL[name]
    tracked = preset(tpol.PRESETS, "rr_tracked")
    prof, res = capture_profile(name, tc, steps=steps, prec=tracked, state0=torch.from_numpy(state0s[name]), device="cpu")
    policy = synthesize_policy(prof, tracked)
    np.testing.assert_array_equal(policy.k_array(res.tracker.names), res.tracker.state.k.numpy())
    np.testing.assert_array_equal(policy.meta["adjust_counters"]["overflow_steps"], res.tracker.state.overflow_steps.numpy())
    if name == "burgers1d":
        assert int(res.tracker.state.shrink_steps.sum()) >= 1
    jtracked = preset(jpol.PRESETS, "rr_tracked")
    jprof, _ = j_capture_profile(name, jc, steps=steps, prec=jtracked, state0=state0s[name])
    np.testing.assert_array_equal(raw(jprof.evidence), raw(prof.evidence))
    want = j_synthesize_policy(jprof, jtracked)
    assert want.sites == policy.sites


def test_validation_accepts_and_rejects(tmp_path):
    """tune_policy stamps heat1d's policy accepted, and a pinned deploy run
    under the saved and reloaded artifact reproduces the recorded rel-L2; a
    starved policy (every split 0) on advection1d is rejected."""
    _, tc = SMALL["heat1d"]
    _, report, policy = tune_policy("heat1d", tc, steps=80, device="cpu")
    assert policy.accepted and policy.validation["rel_l2_tracked"] <= policy.validation["tol"]
    assert "heat.flux" in report.summary()
    loaded = PrecisionPolicy.load(policy.save(str(tmp_path / "p.json")))
    deploy = tpol.PrecisionConfig(mode="deploy", fmt=loaded.fmt, ema=loaded.ema, headroom=loaded.headroom, pinned=True)
    res = Simulation("heat1d", tc, deploy, device="cpu").run(80, policy=loaded)
    ref = Simulation("heat1d", tc, tpol.PRESETS["f32"], device="cpu").run(80)
    rel = np.linalg.norm(res.state.double().numpy() - ref.state.double().numpy()) / np.linalg.norm(ref.state.double().numpy())
    assert rel == pytest.approx(loaded.validation["rel_l2_deploy"], rel=0, abs=1e-15)

    _, ac = SMALL["advection1d"]
    prof, _ = capture_profile("advection1d", ac, steps=40, device="cpu")
    starved = synthesize_policy(prof)
    for d in starved.sites.values():
        d.update(k=0, k_lo=0, k_hi=0)
    stamp = validate_policy(starved, ac, steps=40, device="cpu")
    assert not stamp["accepted"] and not starved.accepted


def _policy(k, lo, hi):
    sites = {s: {"k": k, "k_lo": lo, "k_hi": hi} for s in ("heat.flux", "heat.update")}
    return PrecisionPolicy(stepper="heat1d", fmt=tpol.PRESETS["deploy"].fmt, sites=sites)


def _jpolicy(k, lo, hi):
    sites = {s: {"k": k, "k_lo": lo, "k_hi": hi} for s in ("heat.flux", "heat.update")}
    return JPolicy(stepper="heat1d", fmt=jpol.PRESETS["deploy"].fmt, sites=sites)


def test_policies_on_every_plane(state0s):
    """Pinned deploy keeps the policy's splits on every plane; k_bounds
    clamp rr_tracked's re-picks (a ceiling of 2 where heat1d needs 3); the
    fused plane's floor is seeded at the policy's splits. Each run equals
    repro's under the same policy on the same plane, bit for bit (repro's
    megakernel plane equals its fused plane: tests/test_mega.py)."""
    jc, tc = SMALL["heat1d"]
    s0 = state0s["heat1d"]
    tracked = preset(tpol.PRESETS, "rr_tracked")
    cases = [
        ("deploy", tpol.PrecisionConfig(mode="deploy", pinned=True), (1, 0, 3), [1, 1]),
        ("clamped", tracked, (2, 2, 2), [2, 2]),
        ("seeded", tracked, (3, 0, 3), None),
    ]
    for label, prec, kls, want_k in cases:
        jprec = tpol_to_j(prec)
        for plane in ("reference", "fused", "megakernel"):
            jplane = "fused" if plane == "megakernel" else plane
            state, trk, _ = jrun(jc, "heat1d", jprec, 40, s0, execution=jplane, policy=_jpolicy(*kls))
            res = Simulation("heat1d", tc, prec, device="cpu").run(
                40, state0=torch.from_numpy(s0), execution=plane, policy=_policy(*kls)
            )
            np.testing.assert_array_equal(raw(state), raw(res.state.numpy()), err_msg=f"{label} {plane}")
            np.testing.assert_array_equal(np.asarray(trk.k), res.tracker.state.k.numpy())
            if want_k is not None:
                assert res.tracker.state.k.tolist() == want_k, (label, plane)
            if prec.pinned:
                assert int(res.tracker.state.overflow_steps.sum()) == 0 and int(res.tracker.state.shrink_steps.sum()) == 0
    free = Simulation("heat1d", tc, tracked, device="cpu").run(40, state0=torch.from_numpy(s0))
    assert int(free.tracker.state.k.max()) == 3


def tpol_to_j(prec):
    """The same PrecisionConfig in repro."""
    fields = {f.name: getattr(prec, f.name) for f in dataclasses.fields(prec)}
    fields["fmt"] = type(jpol.PRESETS["f32"].fmt)(prec.fmt.eb, prec.fmt.mb, prec.fmt.fx)
    return jpol.PrecisionConfig(**fields)


def test_policy_artifacts_load_in_either_package(tmp_path):
    """A policy saved by repro loads in the port and the reverse; a newer
    schema version and a foreign schema are refused; a format mismatch is
    refused."""
    jc, tc = SMALL["heat1d"]
    jprof, _ = j_capture_profile("heat1d", jc, steps=60)
    jpolicy = j_synthesize_policy(jprof)
    jpolicy.validation = {"accepted": True, "tol": 0.1}
    ported = PrecisionPolicy.load(jpolicy.save(str(tmp_path / "from_repro.json")))
    assert ported.sites == jpolicy.sites and ported.stepper == "heat1d" and ported.accepted
    assert (ported.fmt.eb, ported.fmt.mb, ported.fmt.fx) == (jpolicy.fmt.eb, jpolicy.fmt.mb, jpolicy.fmt.fx)
    assert ported.to_dict()["sites"] == jpolicy.to_dict()["sites"]

    prof, _ = capture_profile("heat1d", tc, steps=60, device="cpu")
    policy = synthesize_policy(prof)
    assert policy.sites == jpolicy.sites
    back = JPolicy.load(policy.save(str(tmp_path / "from_port.json")))
    assert back.sites == policy.sites and back.ema == policy.ema and back.headroom == policy.headroom
    assert back.meta["profile"] == json.loads(json.dumps(policy.meta["profile"]))

    d = policy.to_dict()
    assert d["schema"] == SCHEMA == "repro.profile/policy"
    with pytest.raises(ValueError, match="schema_version"):
        PrecisionPolicy.from_dict(dict(d, schema_version=d["schema_version"] + 1))
    with pytest.raises(ValueError, match="schema"):
        PrecisionPolicy.from_dict(dict(d, schema="something/else"))
    other = tpol.PrecisionConfig(mode="deploy", fmt=FlexFormat(policy.fmt.eb, policy.fmt.mb - 1, policy.fmt.fx))
    with pytest.raises(ValueError, match="fmt"):
        policy.apply(other)
    with pytest.raises(ValueError, match="fmt"):
        Simulation("heat1d", tc, other, device="cpu").run(4, policy=policy)


def test_generate_with_policy_serves_at_its_format(tmp_path):
    """generate(policy=) on a 1-layer model of narrow widths equals generate
    at the policy's format, from an object or its JSON path; an artifact no
    validation accepted is refused."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model_init
    from repro_torch.serve import generate, resolve_policy

    cfg = dataclasses.replace(reduced(get_config("llama4-scout-17b-a16e")), n_layers=1)
    params = model_init(torch.Generator().manual_seed(0), cfg, "cpu")
    prompts = torch.randint(0, cfg.vocab, (2, 6), generator=torch.Generator().manual_seed(1))
    fmt = FlexFormat(3, 8, 4)
    policy = PrecisionPolicy(stepper="heat1d", fmt=fmt, sites={"heat.flux": {"k": 1, "k_lo": 0, "k_hi": 2}},
                             validation={"accepted": True})
    prec = tpol.PRESETS["r2f2_16"]
    want = generate(params, cfg, dataclasses.replace(prec, fmt=fmt), prompts, max_new_tokens=3, device="cpu")
    got = generate(params, cfg, prec, prompts, max_new_tokens=3, policy=policy, device="cpu")
    path = policy.save(str(tmp_path / "serve.json"))
    by_path = generate(params, cfg, prec, prompts, max_new_tokens=3, policy=path, device="cpu")
    assert torch.equal(want, got) and torch.equal(want, by_path)
    rprec, loaded = resolve_policy(prec, path)
    assert rprec.fmt == fmt and rprec.k_bounds is None and loaded.sites == policy.sites
    policy.validation = None
    with pytest.raises(ValueError, match="accepted"):
        generate(params, cfg, prec, prompts, max_new_tokens=3, policy=policy, device="cpu")
    assert resolve_policy(prec, policy, require_accepted=False)[0].fmt == fmt


def test_cli_runs_on_the_cpu(tmp_path):
    """python -m repro_torch.profile heat1d --device cpu --steps 40: the
    reference/fused parity, an accepted policy and a reproduced deploy."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.profile", "heat1d", "--device", "cpu", "--steps", "40", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "parity: EXACT" in res.stdout and "ACCEPTED" in res.stdout and "REPRODUCED" in res.stdout
    saved = json.loads((tmp_path / "heat1d_policy.json").read_text())
    assert saved["schema"] == "repro.profile/policy" and saved["validation"]["accepted"]


def test_binning_and_report():
    """exp_hist skips zeros of either sign and non-finite values; the
    report's coverage is monotone and complete at FX; bad capture
    arguments are refused as repro refuses them."""
    spec = CaptureSpec()
    # from bits: 0, -0, inf, nan, 1, 2, a subnormal (a float would flush here), 2**90
    bits = [0, 0x80000000, 0x7F800000, 0x7FC00000, 0x3F800000, 0x40000000, 0x00000400, 0x6C800000]
    h = exp_hist(torch.tensor(bits, dtype=torch.int64).to(torch.int32).view(torch.float32), spec)
    assert int(h.sum()) == 4 and h[0 - spec.e_lo] == 1 and h[1 - spec.e_lo] == 1
    assert h[0] == 1 and h[-1] == 1  # a subnormal and 2**90 in the edge bins
    _, tc = SMALL["heat1d"]
    prof, _ = capture_profile("heat1d", tc, steps=40, device="cpu")
    report = prof.report()
    for s in report.sites.values():
        cov = [s["coverage_at_k"][k] for k in range(prof.prec.fmt.fx + 1)]
        assert cov == sorted(cov) and cov[-1] == 1.0
        assert s["exp_span"] is not None and len(s["spread_over_time"]) == prof.exp_time.shape[0]
    sim = Simulation("heat1d", tc, tpol.PRESETS["f32"], device="cpu")
    with pytest.raises(TypeError):
        sim.run(8, capture="yes")
    with pytest.raises(ValueError):
        CaptureSpec(e_lo=5, e_hi=5)
