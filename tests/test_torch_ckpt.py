"""repro_torch.ckpt against repro.ckpt: the layout (step_%08d/, one .npy a
leaf named by its path, manifest.json, an atomic rename), a bit-exact round
trip, checkpoints of (state, tracker) that each package restores from the
other and resumes bit for bit (a single run and a stacked ensemble, f32
and packed), and an interrupted tracked ensemble that equals the
uninterrupted one. repro's runs are jitted, one function each."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.core import policy as jpol
from repro.pde import Simulation as JSim
from repro.pde.heat1d import HeatConfig as JHeat
from repro.pde.swe2d import SWEConfig as JSWE
from repro_torch import ckpt, convert
from repro_torch.core import policy as tpol
from repro_torch.pack import PackedArray, pack_array
from repro_torch.pde import HeatConfig, Simulation, SWEConfig
from repro_torch.precision import site_tracker_init

CHUNK, EVERY = 8, 4
SCALES = (0.5, 1.0, 2.0)


@pytest.fixture(scope="module", autouse=True)
def torch_env():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(prev)


def tracked(P):
    return dataclasses.replace(P["r2f2_16"], mode="rr_tracked")


def bits(x):
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.uint32) if x.dtype == np.float32 else x


def test_atomic_write_and_latest_step(tmp_path):
    """A write lands in step_%08d/ with its manifest; a leftover .tmp (a
    crash mid-write) is never a step, and a later write replaces it."""
    d = str(tmp_path)
    tree = {"u": torch.arange(4, dtype=torch.float32), "k": torch.tensor([1, 2], dtype=torch.int32)}
    assert ckpt.latest_step(d) is None and ckpt.available_steps(d) == []
    final = ckpt.save(tree, d, 3)
    assert final.endswith("step_00000003") and os.path.isdir(final)
    os.makedirs(os.path.join(d, "step_00000009.tmp"))  # an interrupted write
    assert ckpt.latest_step(d) == 3 and ckpt.available_steps(d) == [3]
    ckpt.save(tree, d, 9)
    assert ckpt.available_steps(d) == [3, 9] and not os.path.exists(os.path.join(d, "step_00000009.tmp"))
    with open(os.path.join(final, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 3 and manifest["leaves"]["u"] == {"shape": [4], "dtype": "float32"}


def test_round_trip_is_bit_exact(tmp_path):
    """Every leaf's bits come back: NaNs with payloads, subnormals, ints,
    a packed leaf and a stacked tracker, nested in tuples, dicts and None."""
    fmt = tpol.PRESETS["r2f2_16"].fmt
    u = torch.tensor([1.0, -0.0, float("inf"), 3.5], dtype=torch.float32)
    u.view(torch.int32)[1:3] = torch.tensor([0x00000123, 0x7FC01234], dtype=torch.int32)  # a subnormal, a NaN
    trk = site_tracker_init(("a", "b"), fmt, k0=2, device="cpu")
    stacked = trk.with_state(type(trk.state)(*(torch.stack([t, t + 1]) for t in trk.state)))
    tree = (u, {"packed": pack_array(torch.linspace(-3, 3, 12).reshape(3, 4), fmt), "none": None}, stacked)
    ckpt.save(tree, str(tmp_path), 0)
    back = ckpt.restore(tree, str(tmp_path), 0)
    np.testing.assert_array_equal(bits(back[0].numpy()), bits(u.numpy()))
    assert isinstance(back[1]["packed"], PackedArray) and back[1]["none"] is None
    np.testing.assert_array_equal(back[1]["packed"].payload.numpy(), tree[1]["packed"].payload.numpy())
    assert back[1]["packed"].payload.dtype == torch.uint16 and back[1]["packed"].shape == (3, 4)
    for a, b in zip(back[2].state, stacked.state):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b.numpy()))
    assert back[2].names == ("a", "b") and back[2].members == 2
    names = sorted(os.listdir(os.path.join(str(tmp_path), "step_00000000")))
    assert "idx1__packed__0.npy" in names and "idx2__0__k.npy" in names and "idx0.npy" in names


CASES = {
    "heat1d": (JHeat(nx=32), HeatConfig(nx=32), "fused"),
    "swe2d": (JSWE(nx=16, ny=16), SWEConfig(nx=16, ny=16), "megakernel"),
}


def jchunks(name, storage, ensemble):
    """repro's two-chunk resume as one jitted function: chunk one from the
    initial states, and a chunk from any (state, tracker)."""
    jc, _, execution = CASES[name]
    sim = JSim(name, jc, tracked(jpol.PRESETS))
    kw = dict(snapshot_every=EVERY, execution=execution, storage=storage)

    def first(s0):
        res = sim.run_ensemble(s0, CHUNK, **kw) if ensemble else sim.run(CHUNK, state0=s0, **kw)
        return res.state, res.tracker

    def second(state, tracker):
        if ensemble:
            res = sim.run_ensemble(state, CHUNK, tracker0_batch=tracker, **kw)
        else:
            res = sim.run(CHUNK, state0=state, tracker=tracker, **kw)
        return res.state, res.tracker, res.snapshots

    return jax.jit(first), jax.jit(second)


def port_chunks(name, storage, ensemble, s0, tracker=None):
    _, tc, execution = CASES[name]
    sim = Simulation(name, tc, tracked(tpol.PRESETS), device="cpu")
    kw = dict(snapshot_every=EVERY, execution=execution, storage=storage)
    if ensemble:
        return sim.run_ensemble(s0, CHUNK, tracker0_batch=tracker, **kw)
    return sim.run(CHUNK, state0=s0, tracker=tracker, **kw)


def leaves_equal(a, b):
    fa, fb = ckpt.checkpoint._flatten(a), [np.asarray(x) for x in jax.tree_util.tree_leaves(b)]
    assert [n for n, _ in fa] == list(jckpt._flatten_with_paths(b))
    for (_, x), y in zip(fa, fb):
        np.testing.assert_array_equal(bits(x.numpy()), bits(y))


@pytest.mark.parametrize("storage", ("f32", "packed"))
@pytest.mark.parametrize("name,ensemble", [("heat1d", True), ("swe2d", True), ("heat1d", False)])
def test_checkpoints_cross_the_packages(name, ensemble, storage, tmp_path):
    """rr_tracked: repro saves its (state, tracker) after one chunk, the
    port restores it and resumes, and the port's second chunk equals
    repro's bit for bit; then the port saves its own first chunk, repro
    restores and resumes it the same way. The leaf names of the two
    packages' trees are the same (SiteTracker, PackedArray, RangeTracker)."""
    jc = CASES[name][0]
    s0 = np.asarray(JSim(name, jc, jpol.PRESETS["f32"]).stepper.init_state(jc))
    batch = np.stack([s0 * np.float32(c) for c in SCALES]) if ensemble else s0
    jfirst, jsecond = jchunks(name, storage, ensemble)
    j1 = jfirst(jnp.asarray(batch))
    j2 = jsecond(*j1)
    t1 = port_chunks(name, storage, ensemble, convert.state_from_numpy(batch))
    leaves_equal((t1.state, t1.tracker), j1)  # the same first chunk, leaf by leaf, name by name

    d_repro, d_port = str(tmp_path / "repro"), str(tmp_path / "port")
    jckpt.save(j1, d_repro, CHUNK)
    state, tracker = ckpt.restore((t1.state, t1.tracker), d_repro, ckpt.latest_step(d_repro))
    t2 = port_chunks(name, storage, ensemble, state, tracker)
    leaves_equal((t2.state, t2.tracker, t2.snapshots), j2)

    ckpt.save((t1.state, t1.tracker), d_port, CHUNK)
    back = jckpt.restore(j1, d_port, jckpt.latest_step(d_port))
    leaves_equal((t2.state, t2.tracker, t2.snapshots), jsecond(*back))


@pytest.mark.parametrize("execution", ("fused", "megakernel"))
def test_interrupted_ensemble_equals_uninterrupted(execution, tmp_path):
    """A tracked heat1d ensemble run for 2 chunks in one call, and the same
    run stopped after one chunk, checkpointed, restored and resumed with
    tracker0_batch: the same state, snapshots and tracker, bit for bit."""
    sim = Simulation("heat1d", HeatConfig(nx=32), tracked(tpol.PRESETS), device="cpu")
    s0 = sim.stepper.init_state(sim.cfg, device="cpu")
    batch = torch.stack([s0 * c for c in SCALES])
    kw = dict(snapshot_every=EVERY, execution=execution)
    whole = sim.run_ensemble(batch, 2 * CHUNK, **kw)
    first = sim.run_ensemble(batch, CHUNK, **kw)
    ckpt.save((first.state, first.tracker), str(tmp_path), CHUNK)
    state, tracker = ckpt.restore((first.state, first.tracker), str(tmp_path), CHUNK)
    second = sim.run_ensemble(state, CHUNK, tracker0_batch=tracker, **kw)
    np.testing.assert_array_equal(bits(whole.state.numpy()), bits(second.state.numpy()))
    np.testing.assert_array_equal(bits(whole.snapshots.numpy()),
                                  bits(torch.cat([first.snapshots, second.snapshots], dim=1).numpy()))
    for a, b in zip(whole.tracker.state, second.tracker.state):
        np.testing.assert_array_equal(bits(a.numpy()), bits(b.numpy()))
