"""What repro_torch does differently on a CUDA device, checked on the CPU
without a launch: the plane gates that keep ``execution="auto"`` off a
kernel that cannot hold the field or does not exist, and the subnormal
flush of the port's PyTorch ops (``core/ftz.py``). The runs themselves on
the card are in ``tests/test_torch_cuda.py``.

The file imports neither JAX nor repro."""

import pytest
import torch

from repro_torch.core import ftz
from repro_torch.core.ftz import flush, flush_subnormals
from repro_torch.core.policy import PRESETS
from repro_torch.kernels.fused import fused_sweep
from repro_torch.kernels.heat_stencil import _heat1d_body
from repro_torch.kernels.mega import mega_sweep
from repro_torch.pde import (
    AdvectionConfig, BurgersConfig, Heat2DConfig, HeatConfig, Simulation, Stepper, SWEConfig, get_stepper,
    register_stepper,
)
from repro_torch.pde.heat1d import Heat1DStepper
from repro_torch.pde.registry import _STEPPERS
from repro_torch.precision import fused_eligible, mega_eligible

R2F2 = PRESETS["r2f2_16"]

# (stepper, config, the card's plane under auto): the field limits the
# kernels had before the rod's grid shape took the 1-D K5 bodies and heat2d
# beyond its cluster, and one past each: every builtin stepper's kernels now
# take any field, as repro does
LIMITS = [
    ("heat1d", HeatConfig(nx=25_600), "megakernel"),  # K2 and K4 take any length: a warp, then a cooperative grid
    ("heat1d", HeatConfig(nx=25_601), "megakernel"),
    ("heat1d", HeatConfig(nx=30_000), "megakernel"),
    ("heat1d", HeatConfig(nx=1_000_000), "megakernel"),
    ("advection1d", AdvectionConfig(nx=25_600), "megakernel"),  # K5b, K5e: the rod's grid shape
    ("advection1d", AdvectionConfig(nx=25_601), "megakernel"),
    ("burgers1d", BurgersConfig(nx=17_066), "megakernel"),  # K5c, K5f: the rod's grid shape
    ("burgers1d", BurgersConfig(nx=17_067), "megakernel"),
    ("burgers1d", BurgersConfig(nx=20_000), "megakernel"),
    ("heat2d", Heat2DConfig(nx=200, ny=200), "megakernel"),  # over one CTA's shared memory, in the cluster
    ("heat2d", Heat2DConfig(nx=358, ny=358), "megakernel"),  # 16 CTAs of 23 x 356 cells
    ("heat2d", Heat2DConfig(nx=359, ny=359), "megakernel"),  # beyond the cluster: the rod's grid shape
    ("heat2d", Heat2DConfig(nx=258, ny=514), "megakernel"),  # 16 CTAs of 16 x 512 cells, the most a CTA holds
    ("heat2d", Heat2DConfig(nx=258, ny=515), "megakernel"),
    ("swe2d", SWEConfig(), "megakernel"),
    ("swe2d", SWEConfig(nx=144, ny=144), "fused"),  # more than one K3 tile: the megakernel's own gate
]


@pytest.mark.parametrize("name,cfg,plane", LIMITS, ids=[f"{n}-{c.nx}x{getattr(c, 'ny', 1)}" for n, c, _ in LIMITS])
def test_auto_on_the_card_falls_back_at_the_field_limits(name, cfg, plane):
    """``auto`` resolves on a CUDA device to the plane whose kernel holds the
    field, on the CPU (the plain versions, no limit) to the megakernel or,
    for swe2d, where repro goes."""
    card = Simulation(name, cfg, R2F2, device="cuda")
    cpu = Simulation(name, cfg, R2F2, device="cpu")
    assert card._resolve_execution("auto") == plane
    assert cpu._resolve_execution("auto") == ("fused" if plane == "fused" else "megakernel")
    st = get_stepper(name)
    assert fused_eligible(R2F2, st, cfg, "cuda") == (plane != "reference")
    assert fused_eligible(R2F2, st, cfg, "cpu") and fused_eligible(R2F2, st, cfg)
    assert mega_eligible(R2F2, st, cfg, "cuda") == (plane == "megakernel")


@pytest.mark.parametrize("execution", ["fused", "megakernel"])
def test_explicit_plane_over_the_limit_raises(execution):
    """An explicit kernel plane past the old one-CTA limit (burgers1d at
    20,000 cells, beyond the 17,066 one CTA's shared memory held) no longer
    raises on the card: both planes are eligible there and resolve to
    themselves, as on the CPU (ROADMAP.md queue 3, handled)."""
    card = Simulation("burgers1d", BurgersConfig(nx=20_000), R2F2, device="cuda")
    cpu = Simulation("burgers1d", BurgersConfig(nx=20_000), R2F2, device="cpu")
    assert card._resolve_execution(execution) == execution == cpu._resolve_execution(execution)
    assert card.fused_eligible() and card.mega_eligible()


def test_builtin_steppers_declare_their_kernels():
    for name in ("heat1d", "swe2d", "heat2d", "advection1d", "burgers1d"):
        st = get_stepper(name)
        assert st.kernels_hold(st.default_config()), name


class _GenericHeat(Heat1DStepper):
    """heat1d with its fused and megakernel hooks on the generic drivers, as
    a stepper added with register_stepper writes them: the body has no CUDA
    kernel and the stepper declares none."""

    def kernels_hold(self, cfg):
        return False

    def fused_step(self, u, cfg, prec, steps, *, k_floor=None, collect_evidence=False):
        (out,), ev = fused_sweep(
            _heat1d_body(cfg.alpha, cfg.dtodx2, self.sites), (u[None, :],), prec=prec, sites=self.sites,
            steps=steps, block=(1, cfg.nx), k_floor=k_floor, collect_evidence=collect_evidence,
        )
        return out[0], ev

    def mega_step(self, u, cfg, prec, steps, every, *, tracker=None):
        res = mega_sweep(
            _heat1d_body(cfg.alpha, cfg.dtodx2, self.sites), (u[None, :],), prec=prec, sites=self.sites,
            steps=steps, every=every, tracker=tracker,
        )
        (out,), (snaps,) = res.state, res.snaps
        return res._replace(state=out[0], snaps=snaps[:, 0])


@pytest.fixture
def generic_heat():
    register_stepper("generic_heat", _GenericHeat)
    yield "generic_heat"
    _STEPPERS.pop("generic_heat", None)


def test_registered_body_without_kernel(generic_heat):
    """A registered stepper's hooks declare no kernel: its card gates are
    closed (auto gives the reference plane), its CPU gates open, and on the
    CPU its planes equal heat1d's bit for bit."""
    st, cfg = get_stepper(generic_heat), HeatConfig(nx=64)
    assert not st.kernels_hold(cfg) and Stepper().kernels_hold(cfg) is False
    for mode in ("r2f2_16", "e5m10"):
        prec = PRESETS[mode]
        assert not fused_eligible(prec, st, cfg, "cuda") and not mega_eligible(prec, st, cfg, "cuda")
        assert fused_eligible(prec, st, cfg, "cpu") and mega_eligible(prec, st, cfg, "cpu")
        assert Simulation(generic_heat, cfg, prec, device="cuda")._resolve_execution("auto") == "reference"
        assert Simulation(generic_heat, cfg, prec, device="cpu")._resolve_execution("auto") == "megakernel"
        want = Simulation("heat1d", cfg, prec, device="cpu").run(40, snapshot_every=16)
        for execution in ("fused", "megakernel", "auto"):
            got = Simulation(generic_heat, cfg, prec, device="cpu").run(40, snapshot_every=16, execution=execution)
            assert torch.equal(got.state.view(torch.int32), want.state.view(torch.int32)), execution
            assert torch.equal(got.snapshots.view(torch.int32), want.snapshots.view(torch.int32)), execution


def _bits(t):
    b = t.float().contiguous().view(torch.int32).clone()
    b[torch.isnan(t.float())] = 0x7FC00000
    return b


@pytest.fixture
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)  # torch.set_flush_denormal sets the calling thread's flags
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(prev)


@pytest.mark.parametrize("execution", ["reference", "fused", "megakernel"])
@pytest.mark.parametrize("mode", ["bf16", "r2f2_16", "deploy"])
def test_flush_mode_is_the_hardware_flush(mode, execution, one_thread):
    """swe2d at 64x64 reaches f32 subnormals in its momentum within 48 steps.
    Under flush_subnormals on the CPU's tensors (the mode Simulation.run
    takes on a CUDA device) a run equals the run with the CPU's own
    flush-to-zero and denormals-are-zero flags, bit for bit, and differs
    from the run that keeps subnormals."""
    cfg, prec = SWEConfig(nx=64, ny=64), PRESETS[mode]

    def run():
        return Simulation("swe2d", cfg, prec, device="cpu").run(48, snapshot_every=16, execution=execution)

    torch.set_flush_denormal(True)
    want = run()
    torch.set_flush_denormal(False)
    with flush_subnormals("cpu"):
        got = run()
    kept = run()
    for a, b in ((got.state, want.state), (got.snapshots, want.snapshots)):
        assert torch.equal(_bits(a), _bits(b))
    assert not torch.equal(_bits(kept.state), _bits(want.state))
    if want.tracker is not None:
        for a, b in zip(got.tracker.state, want.tracker.state):
            assert torch.equal(_bits(a.float()), _bits(b.float()))


def test_flush_keeps_signs_and_specials():
    tiny = 2.0**-126
    x = torch.tensor([tiny, -tiny, tiny / 2, -tiny / 2, 1e-45, -1e-45, 0.0, -0.0, float("inf"), float("-inf"),
                      float("nan"), 3.0, -tiny * 1.5])
    got = flush(x)
    want = torch.tensor([tiny, -tiny, 0.0, -0.0, 0.0, -0.0, 0.0, -0.0, float("inf"), float("-inf"), float("nan"),
                         3.0, -tiny * 1.5])
    assert torch.equal(_bits(got), _bits(want))


def test_flush_mode_leaves_bit_views_and_other_devices():
    """A subnormal built from bits stays (the port builds such patterns on
    purpose); a mode for one device type leaves another's tensors alone; an
    in-place op flushes in place."""
    torch.set_flush_denormal(False)
    sub = torch.tensor([1, -2**31 | 5], dtype=torch.int32)
    with flush_subnormals("cpu"):
        v = sub.view(torch.float32)
        half = torch.full((2,), 2.0**-126) * 0.5
        acc = torch.full((2,), 2.0**-125)
        acc.mul_(0.25)
    assert torch.equal(v.view(torch.int32), sub)
    assert torch.equal(_bits(half), torch.zeros(2, dtype=torch.int32))
    assert torch.equal(_bits(acc), torch.zeros(2, dtype=torch.int32))
    with flush_subnormals("cuda"):
        half = torch.full((2,), 2.0**-126) * 0.5
    assert bool((half > 0).all())


@pytest.mark.parametrize("execution", ["reference", "fused"])
@pytest.mark.parametrize("mode", ["bf16", "r2f2_16", "deploy"])
def test_card_flush_covers_the_pytorch_arithmetic(mode, execution, one_thread, monkeypatch):
    """On the card Simulation.run flushes only where PyTorch does the
    arithmetic (``card_flush``: the initial state, the reference steps, the
    observables, swe2d's Lax-Wendroff step around K3); the kernels flush
    themselves. With that scope taken on the CPU's tensors, swe2d's
    reference and fused planes equal the runs under the CPU's own flags."""
    cfg, prec = SWEConfig(nx=64, ny=64), PRESETS[mode]

    def run():
        return Simulation("swe2d", cfg, prec, device="cpu").run(48, snapshot_every=16, execution=execution)

    torch.set_flush_denormal(True)
    want = run()
    torch.set_flush_denormal(False)
    monkeypatch.setattr(ftz, "on_card", lambda device: True)
    got = run()
    for a, b in ((got.state, want.state), (got.snapshots, want.snapshots)):
        assert torch.equal(_bits(a), _bits(b))
    if want.tracker is not None:
        for a, b in zip(got.tracker.state, want.tracker.state):
            assert torch.equal(_bits(a.float()), _bits(b.float()))


_SUB = torch.tensor([5, -2**31 | 7, 0x3F800000, -2**31 | 0x007FFFFF], dtype=torch.int32)  # subnormals and 1.0


@pytest.mark.parametrize("op", [
    lambda x: torch.where(torch.tensor([True, True, False, True]), x, torch.zeros(4)),
    lambda x: x.where(torch.tensor([True, False, True, True]), 2.0),
    lambda x: -x,
    lambda x: torch.neg(x),
    lambda x: x.abs(),
    lambda x: x * 1.0,
    lambda x: torch.add(torch.ones(4), x, out=torch.empty(4)) - 1.0,
], ids=["where", "Tensor.where", "__neg__", "neg", "abs", "mul", "out"])
def test_flush_mode_moves_and_flushes_as_the_hardware(op, one_thread):
    """Ops that only select or move values (``where``, ``neg``, ``abs``)
    keep a subnormal under the CPU's flush flags and under the mode; an
    arithmetic result, ``out=`` targets included, is flushed by both (a
    subnormal input that only the flags would zero, as in ``x * 1.0``,
    gives the same zero here)."""
    torch.set_flush_denormal(True)
    want = op(_SUB.view(torch.float32))
    torch.set_flush_denormal(False)
    with flush_subnormals("cpu"):
        got = op(_SUB.view(torch.float32))
    assert torch.equal(_bits(got), _bits(want))


def test_flush_mode_does_not_zero_inputs(one_thread):
    """The documented limit (``core/ftz.py``): the mode flushes results, not
    inputs. A negative subnormal made from bits plus 0.0 is +0 under the
    flags (the input read as -0) and -0 under the mode (the result -s
    flushed to a zero of its sign)."""
    torch.set_flush_denormal(True)
    want = _SUB.view(torch.float32) + 0.0
    torch.set_flush_denormal(False)
    with flush_subnormals("cpu"):
        got = _SUB.view(torch.float32) + 0.0
    assert _bits(want)[1] == 0 and _bits(got)[1] == -2**31
    assert torch.equal(got.abs(), want.abs())


def test_flush_mode_flushes_out_targets(one_thread):
    torch.set_flush_denormal(False)
    dst = torch.empty(2)
    with flush_subnormals("cpu"):
        torch.mul(torch.full((2,), 2.0**-126), torch.tensor([0.5, -0.25]), out=dst)
    assert torch.equal(_bits(dst), torch.tensor([0, -2**31], dtype=torch.int32))


def _with_subnormals(x, cells):
    """``x`` with f32 subnormals set from bits at ``cells`` (a float
    assignment would flush under the CPU's flush flags)."""
    x = x.clone()
    for at, b in zip(cells, (0x000116C2, -2**31 | 0x0020AB1B, 0x00000001, 0x007FFFFF)):
        x.view(torch.int32)[at] = b
    return x


@pytest.mark.parametrize("name,execution", [("swe2d", "reference"), ("swe2d", "fused"), ("heat1d", "reference"),
                                            ("heat2d", "reference"), ("advection1d", "reference")])
def test_card_entry_zeroes_subnormal_inputs(name, execution, one_thread, monkeypatch):
    """A caller's state with f32 subnormals in interior and pinned boundary
    cells, run with capture and with the card's scope taken on the CPU's
    tensors (the flush mode where PyTorch computes, no input flush): the
    run's entry zeroes the subnormals (keeping their sign) but in the cells
    whose bits the stepper uses as they are (``Stepper.raw_cells``: heat's
    pinned boundary; every cell of advection1d, whose capture bins the
    state), and the run and its profile equal the run under the CPU's own
    FTZ/DAZ flags, which keep a pinned cell's bits and count a subnormal
    operand in the low edge bin as repro does. Without the entry's zeroing,
    swe2d's momentum takes a zero of the other sign (0 + -sub flushes to -0
    where DAZ reads +0)."""
    from repro_torch.pde import AdvectionConfig, Heat2DConfig

    cfg = {"swe2d": SWEConfig(nx=64, ny=64), "heat1d": HeatConfig(nx=64), "heat2d": Heat2DConfig(nx=24, ny=24),
           "advection1d": AdvectionConfig(nx=128)}[name]
    cells = {"swe2d": [(1, 0, 3), (1, 5, 5), (2, 7, 0), (2, 6, 9)], "heat1d": [(0,), (5,), (63,), (17,)],
             "heat2d": [(0, 4), (5, 5), (23, 7), (3, 8)], "advection1d": [(3,), (20,), (21,), (40,)]}[name]
    sim = Simulation(name, cfg, PRESETS["r2f2_16"], device="cpu")
    u0 = _with_subnormals(sim.stepper.init_state(cfg, device="cpu"), cells)

    def run():
        return Simulation(name, cfg, PRESETS["r2f2_16"], device="cpu").run(24, snapshot_every=8, state0=u0,
                                                                            execution=execution, capture=True)

    torch.set_flush_denormal(True)
    want = run()
    torch.set_flush_denormal(False)
    monkeypatch.setattr(ftz, "on_card", lambda device: True)
    got = run()
    assert torch.equal(_bits(got.state), _bits(want.state)) and torch.equal(_bits(got.snapshots), _bits(want.snapshots))
    assert torch.equal(got.profile.exp_total, want.profile.exp_total)
    if name in ("heat1d", "heat2d"):  # the pinned cells keep their bits
        assert _bits(want.state)[cells[0]] == 0x000116C2
    elif name == "swe2d":
        monkeypatch.setattr(ftz, "zero_subnormal_inputs", lambda x, keep=None: x)
        assert not torch.equal(_bits(run().state), _bits(want.state))


@pytest.mark.parametrize("name", ["heat1d", "heat2d"])
def test_card_entry_keeps_pinned_subnormals_of_a_state_from_elsewhere(name, one_thread, monkeypatch):
    """On the card a caller's state arrives from the host, and the copy to
    the card is a PyTorch result that the flush mode would flush, pinned
    cells included: ``Simulation.run`` moves the state before it enters the
    mode, as ``run_ensemble`` does. A numpy state under the card's scope
    takes the same path on the CPU: its pinned cells keep their bits, and
    the run equals the run under the CPU's own FTZ/DAZ flags."""
    from repro_torch.pde import Heat2DConfig

    cfg = {"heat1d": HeatConfig(nx=64), "heat2d": Heat2DConfig(nx=24, ny=24)}[name]
    cells = {"heat1d": [(0,), (5,), (63,), (17,)], "heat2d": [(0, 4), (5, 5), (23, 7), (3, 8)]}[name]
    u0 = _with_subnormals(Simulation(name, cfg, PRESETS["r2f2_16"], device="cpu").stepper.init_state(
        cfg, device="cpu"), cells)

    def run(state0):
        return Simulation(name, cfg, PRESETS["r2f2_16"], device="cpu").run(16, snapshot_every=8, state0=state0,
                                                                            execution="megakernel")

    torch.set_flush_denormal(True)
    want = run(u0)
    torch.set_flush_denormal(False)
    monkeypatch.setattr(ftz, "on_card", lambda device: True)
    got = run(u0.numpy())
    assert _bits(want.state)[cells[0]] == 0x000116C2
    assert torch.equal(_bits(got.state), _bits(want.state)) and torch.equal(_bits(got.snapshots), _bits(want.snapshots))
