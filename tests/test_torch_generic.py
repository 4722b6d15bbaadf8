"""Any fused body on the card's planes: the tape that kernels K8 and K9 run
(``repro_torch/kernels/tape.py``), held here on the CPU, where no card is.

* The tape executor (``run_tape``, the tape's rows run in PyTorch as the
  kernels run them) stands in for the body inside ``fused_sweep`` and
  ``mega_sweep``'s plain versions, and equals the body itself bit for bit:
  the five builtin bodies and the add/rsqrt test bodies, six modes, with
  evidence, floors, pinned splits, capture (on a padded grid too), two
  members, and quantized and packed storage.
* The add/rsqrt test stepper (a 1-D nonlinear diffusion, written below in
  ``jnp`` for ``repro`` and in torch for the port, ``chip_smoke.nl_update``)
  registered in both packages, its hooks on ``mega_sweep`` and
  ``fused_sweep``, ``repro``'s in interpret mode: the
  variant without rsqrt bit for bit; the rsqrt variant within one ulp of
  the target format (``repro``'s rsqrt is XLA's, the port's the correctly
  rounded ``core/rsqrt.py``; they agree bit for bit on this run).
* A registered stepper's planes equal each other bit for bit, and each
  builtin's registered copy (``chip_smoke.generic_stepper``, hooks with no
  ``kernel=``) equals the builtin.
* The trace-time refusals: an op outside the tape's set (named, with the
  body's function), a site called as another op than declared, a site hit
  twice or never reached.
* The CPU rsqrt route against exact rational arithmetic on a sample.

PyTorch runs with subnormals flushed, as XLA:CPU runs ``repro``. The
runs on the card are ``tests/test_torch_cuda.py``'s ``cuda`` tests and
``chip_smoke.py``'s phase 7."""

import dataclasses
import math
import struct
from fractions import Fraction

import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.core.policy import PRESETS, tracker_init, tracker_stack
from repro_torch.core.rsqrt import rsqrt
from repro_torch.kernels.fused import fused_sweep
from repro_torch.kernels.heat_stencil import _heat1d_body
from repro_torch.kernels.mega import _swe2d_body, mega_sweep
from repro_torch.kernels.pde_steps import _advection1d_body, _burgers1d_body, _heat2d_body
from repro_torch.kernels.swe_flux import SWE_OPS, SWE_SITES, _swe_flux_body
from repro_torch.kernels.tape import UntraceableBody, run_tape, tape_for
from repro_torch.pack import pack_array
from repro_torch.pde import Simulation, SWEConfig, get_stepper
from repro_torch.pde.swe2d import initial_state
from repro_torch.profile import CaptureSpec

MODES = ("f32", "bf16", "e5m10", "r2f2_16", "rr_tracked", "deploy")
HEAT_SITES = ("heat.flux", "heat.update")
NL_SITES, NL_OPS = chip_smoke.nl_sites(True)
NLA_SITES, NLA_OPS = chip_smoke.nl_sites(False)


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


def bits(t):
    b = t.detach().to(torch.float32).contiguous().view(torch.int32).clone()
    b[torch.isnan(t)] = 0x7FC00000
    return b


def same(a, b):
    """Two results (tensors, tuples, MegaResults, PackedArrays, trackers) bit for bit."""
    return chip_smoke._hook_result_equal(a, b)


def taped(body, prec, sites, site_ops=None):
    """``body`` as its tape run by the executor: what K8 and K9 compute."""

    def run(state, ops):
        tape = tape_for(body, [tuple(x.shape) for x in state], prec=prec, sites=sites, site_ops=site_ops)
        return run_tape(tape, state, ops)

    return run


def _nl_body(rsqrt_on):
    cfg = chip_smoke.NLConfig(nx=16)

    def body(state, ops):
        return (chip_smoke.nl_update(state[0], cfg, ops, rsqrt_on),)

    return body


def _scalars_body(sites):
    """Python scalars meeting tensors: a quotient by 3.0, products by 0.1."""

    def body(state, ops):
        (u,) = state
        v = ops.mul(u / 3.0, 0.1 * u, sites[0])
        w = ops.add(v, u - 0.7, sites[1])
        return (torch.roll(w, 2, dims=-1) * 1.5,)

    return body


def _rods():
    g = torch.Generator().manual_seed(0)
    rod = (torch.rand(1, 16, generator=g) - 0.3) * 200.0
    rod[0, 0] = rod[0, -1] = 0.0
    return rod


#: (name, body, leaves, sites, site_ops, block): each builtin body on a
#: small block (heat1d on two row blocks), the test bodies, and a body of
#: Python scalars
FUSED_CASES = [
    ("heat1d", _heat1d_body(0.1, 0.4, HEAT_SITES), lambda: [torch.cat([_rods(), _rods() * 0.5])], HEAT_SITES, None, (1, 16)),
    ("heat2d", _heat2d_body(6, 6, 0.1, 0.2, HEAT_SITES), lambda: [_rods()[:, :1].repeat(1, 36) + torch.arange(36.0)],
     HEAT_SITES, None, (1, 36)),
    ("advection1d", _advection1d_body(0.7, 0.5, HEAT_SITES), lambda: [_rods()], HEAT_SITES, None, (1, 16)),
    ("burgers1d", _burgers1d_body(0.01, 0.1, HEAT_SITES), lambda: [_rods()], HEAT_SITES, None, (1, 16)),
    ("swe_flux", _swe_flux_body(SWE_SITES),
     lambda: [torch.randn(10, 12, generator=torch.Generator().manual_seed(1)) * 40.0,
              500.0 + 100.0 * torch.rand(10, 12, generator=torch.Generator().manual_seed(2))],
     SWE_SITES, SWE_OPS, (4, 8)),
    ("nl", _nl_body(True), lambda: [_rods() / 200.0], NL_SITES, NL_OPS, (1, 16)),
    ("nl_add", _nl_body(False), lambda: [_rods() / 200.0], NLA_SITES, NLA_OPS, (1, 16)),
    ("scalars", _scalars_body(("s.mul", "s.add")), lambda: [_rods()], ("s.mul", "s.add"), ("mul", "add"), (1, 16)),
]


@pytest.mark.parametrize("case", FUSED_CASES, ids=[c[0] for c in FUSED_CASES])
def test_tape_executor_equals_the_fused_plain_version(case):
    """fused_sweep's plain version with the body's tape in place of the
    body: bit for bit in six modes, with evidence, floors and pinned splits,
    capture, padded blocks (swe_flux: capture on the valid lanes), two
    members, and packed storage where the block is the field."""
    name, body, leaves_of, sites, site_ops, block = case
    leaves = leaves_of()
    n_out = 1
    pad = (0.0, 1.0) if name == "swe_flux" else None
    floor = torch.tensor([1, 2, 0, 3, 2][:len(sites)], dtype=torch.int32)
    for mode in MODES:
        prec = preset(PRESETS, mode)
        kw = dict(prec=prec, sites=sites, site_ops=site_ops, block=block, n_out=n_out, pad_values=pad)
        steps = 1 if name == "swe_flux" else 3
        runs = [dict(steps=steps, collect_evidence=True, capture=CaptureSpec())]
        if mode in ("r2f2_16", "rr_tracked"):
            runs.append(dict(steps=steps, k_floor=floor, collect_evidence=True))
        if mode == "r2f2_16":
            runs.append(dict(steps=steps, k_floor=floor, prec=dataclasses.replace(prec, pinned=True)))
        if mode in ("e5m10", "r2f2_16"):
            runs.append(dict(steps=steps, members=True, k_floor=torch.stack([floor, floor.flip(0)]), collect_evidence=True))
        for run in runs:
            members = run.get("members", False)
            state = [torch.stack([x, x * -0.5]) for x in leaves] if members else leaves
            args = dict(kw, **run)
            want = fused_sweep(body, state, **args)
            got = fused_sweep(taped(body, args["prec"], sites, site_ops), state, **args)
            assert same(got, want), (name, mode, sorted(run))
        whole = block[0] == leaves[0].shape[0] and block[1] == leaves[0].shape[1] and len(leaves) == 1
        if whole and mode in ("e5m10", "r2f2_16"):
            pa = [pack_array(x, prec.fmt) for x in leaves]
            args = dict(kw, steps=steps, storage="packed", k_floor=floor, collect_evidence=True)
            assert same(fused_sweep(taped(body, prec, sites, site_ops), pa, **args), fused_sweep(body, pa, **args)), \
                (name, mode, "packed")


MEGA_CASES = [c for c in FUSED_CASES if c[0] not in ("swe_flux", "heat1d")] + [
    ("heat1d", _heat1d_body(0.1, 0.4, HEAT_SITES), lambda: [_rods()], HEAT_SITES, None, None),
    ("swe2d", _swe2d_body(SWEConfig(nx=8, ny=8), SWE_SITES), lambda: [initial_state(SWEConfig(nx=8, ny=8), device="cpu")],
     SWE_SITES, SWE_OPS, None),
]


@pytest.mark.parametrize("case", MEGA_CASES, ids=[c[0] for c in MEGA_CASES])
def test_tape_executor_equals_the_mega_plain_version(case):
    """mega_sweep's plain version with the body's tape in place of the body:
    bit for bit in six modes, with an evolving tracker (rr_tracked) or a
    pinned one, evidence and capture per interval, quantized and packed
    storage (packed I/O too), and two members."""
    name, body, leaves_of, sites, site_ops, _ = case
    leaves = leaves_of()
    n_sites = len(sites)
    for mode in MODES:
        prec = preset(PRESETS, mode)
        kw = dict(prec=prec, sites=sites, site_ops=site_ops, steps=7, every=3)
        trk = tracker_init(n_sites, prec.fmt, k0=0, device="cpu") if mode == "rr_tracked" else None
        runs = [dict(tracker=trk, collect_evidence=True, capture=CaptureSpec())]
        if mode in ("r2f2_16", "rr_tracked"):
            runs.append(dict(tracker=trk, storage="quantized"))
        if mode in ("e5m10", "rr_tracked"):
            runs.append(dict(tracker=trk, storage="packed"))
        if mode in ("bf16", "rr_tracked"):
            runs.append(dict(members=True, tracker=None if trk is None else tracker_stack([trk, trk])))
        if mode == "r2f2_16":
            runs.append(dict(prec=dataclasses.replace(prec, pinned=True),
                             tracker=tracker_init(n_sites, prec.fmt, k0=3, device="cpu")))
            if leaves[0].dim() == 2:  # packed I/O: a leaf is its payload's 2-D view
                runs.append(dict(storage="packed", packed_io=True))
        for run in runs:
            run = dict(run)
            members = run.get("members", False)
            state = [torch.stack([x, x * 0.5]) for x in leaves] if members else leaves
            if run.pop("packed_io", False):
                state = [pack_array(x, prec.fmt) for x in leaves]
            args = dict(kw, **run)
            want = mega_sweep(body, state, **args)
            got = mega_sweep(taped(body, args["prec"], sites, site_ops), state, **args)
            assert same(got, want), (name, mode, sorted(run))


def test_tape_rows_and_cache():
    """A tape is a few dozen rows for swe2d's Lax-Wendroff step; a fresh
    closure over the same values reuses it, another constant does not."""
    prec = PRESETS["r2f2_16"]
    t1 = tape_for(_swe2d_body(SWEConfig(nx=8, ny=8), SWE_SITES), [(3, 8, 8)], prec=prec, sites=SWE_SITES,
                  site_ops=SWE_OPS)
    t2 = tape_for(_swe2d_body(SWEConfig(nx=8, ny=8), SWE_SITES), [(3, 8, 8)], prec=prec, sites=SWE_SITES,
                  site_ops=SWE_OPS)
    assert t1 is t2 and 20 < t1.code.shape[0] < 200 and t1.site_calls == (0, 3, 1, 2)
    h1 = tape_for(_heat1d_body(0.1, 0.4, HEAT_SITES), [(1, 16)], prec=prec, sites=HEAT_SITES)
    h2 = tape_for(_heat1d_body(0.2, 0.4, HEAT_SITES), [(1, 16)], prec=prec, sites=HEAT_SITES)
    assert h1 is not h2 and not torch.equal(h1.consts, h2.consts)


def _exp_body(state, ops):
    (u,) = state
    return (ops.mul(torch.exp(u), u, "a"),)


def _twice_body(state, ops):
    (u,) = state
    return (ops.mul(ops.mul(u, u, "a"), u, "a"),)


def _partial_body(state, ops):
    (u,) = state
    return (ops.mul(u, u, "a"),)


def _wrong_op_body(state, ops):
    (u,) = state
    return (ops.add(u, u, "a"),)


def test_trace_time_refusals():
    """An op outside the set raises at trace time, naming the aten op and
    the body's function; a site called as another op than site_ops
    declares raises at trace time; a site hit twice in one substep or never
    reached raises where evidence is collected, as the plain version does."""
    prec = PRESETS["r2f2_16"]
    with pytest.raises(UntraceableBody, match=r"_exp_body.*aten\.exp"):
        tape_for(_exp_body, [(1, 8)], prec=prec, sites=("a",))
    with pytest.raises(ValueError, match="declared as a 'mul' op but the fused body called ops.add"):
        tape_for(_wrong_op_body, [(1, 8)], prec=prec, sites=("a",), site_ops=("mul",))
    twice = tape_for(_twice_body, [(1, 8)], prec=prec, sites=("a",))
    twice.check_sites(("a",), collect=False)
    with pytest.raises(ValueError, match="hit site 'a' twice"):
        twice.check_sites(("a",), collect=True)
    partial = tape_for(_partial_body, [(1, 8)], prec=prec, sites=("a", "b"))
    with pytest.raises(ValueError, match=r"never reached sites \['b'\]"):
        partial.check_sites(("a", "b"), collect=True)
    u = torch.ones(1, 8)
    with pytest.raises(ValueError, match="hit site 'a' twice"):
        fused_sweep(_twice_body, (u,), prec=prec, sites=("a",), block=(1, 8), collect_evidence=True)
    with pytest.raises(ValueError, match=r"never reached sites \['b'\]"):
        fused_sweep(_partial_body, (u,), prec=prec, sites=("a", "b"), block=(1, 8), collect_evidence=True)


def _next(v, up):
    b = struct.unpack("<I", struct.pack("<f", v))[0]
    return struct.unpack("<f", struct.pack("<I", b + (1 if up else -1)))[0]


def test_cpu_rsqrt_route_is_correctly_rounded():
    """core/rsqrt.py against exact rational arithmetic: for a sample over
    f32's whole normal range (and [1, 4) densely), the two midpoints around
    the result bracket 1/sqrt(x); zeros, subnormals (read as zeros of their
    sign), negatives, infinities and NaN give IEEE's results."""
    g = torch.Generator().manual_seed(0)
    wide = torch.randint(0x00800000, 0x7F800000, (1500,), generator=g, dtype=torch.int64).to(torch.int32)
    dense = torch.randint(0x3F800000, 0x40800000, (1500,), generator=g, dtype=torch.int64).to(torch.int32)
    x = torch.cat([wide, dense]).view(torch.float32)
    y = rsqrt(x)
    for xv, yv in zip(x.tolist(), y.tolist()):
        X, Y = Fraction(xv), Fraction(yv)
        up, down = (Y + Fraction(_next(yv, True))) / 2, (Y + Fraction(_next(yv, False))) / 2
        assert up * up * X > 1 > down * down * X, (xv, yv)
    specials = torch.tensor([0, 0x80000000, 1, 0x80000001, 0x007FFFFF, 0xBF800000, 0x7F800000, 0xFF800000, 0x7FC00000],
                            dtype=torch.int64).to(torch.int32).view(torch.float32)
    got = rsqrt(specials)
    want = [math.inf, -math.inf, math.inf, -math.inf, math.inf, math.nan, 0.0, math.nan, math.nan]
    for a, b in zip(got.tolist(), want):
        assert (math.isnan(a) and math.isnan(b)) or (a == b and math.copysign(1, a) == math.copysign(1, b))


def test_registered_copies_equal_the_builtins_on_every_plane(test_steppers):
    """Each builtin's registered copy (its hooks pass no kernel=: on the card
    its bodies run on K8 and K9) equals the builtin on the fused and
    megakernel planes (rr_tracked, the tracker included; the fused plane of
    heat1d, whose rod hooks the other 1-D and 2-D rods share, and swe2d's), and the test
    stepper's fused and megakernel planes equal each other, with its
    reference plane where the reference plane rounds as they do (the
    rr_tracked fused plane latches its floor per chunk)."""
    names = chip_smoke.register_generic(chip_smoke.GENERIC_BUILTINS)
    try:
        small = {"heat1d": dict(nx=32), "swe2d": dict(nx=8, ny=8), "heat2d": dict(nx=8, ny=8),
                 "advection1d": dict(nx=32), "burgers1d": dict(nx=32)}
        for name in chip_smoke.GENERIC_BUILTINS:
            cfg = dataclasses.replace(chip_smoke.generic_config(name), **small[name])
            for mode in ("rr_tracked",):
                prec = preset(PRESETS, mode)
                # the rods share one pair of hooks: their fused plane once
                for plane in ("fused", "megakernel") if name in ("heat1d", "swe2d") else ("megakernel",):
                    a = Simulation(f"generic_{name}", cfg, prec, device="cpu").run(8, snapshot_every=3, execution=plane)
                    b = Simulation(name, cfg, prec, device="cpu").run(8, snapshot_every=3, execution=plane)
                    assert same((a.state, a.snapshots, a.tracker.state), (b.state, b.snapshots, b.tracker.state)), \
                        (name, mode, plane)
        for name in chip_smoke.GENERIC_TEST:
            cfg = chip_smoke.NLConfig(nx=24)
            for mode in MODES if name == "nl" else ("e5m10", "rr_tracked"):
                runs = {p: Simulation(name, cfg, preset(PRESETS, mode), device="cpu").run(20, snapshot_every=6, execution=p)
                        for p in ("reference", "fused", "megakernel")}
                assert same((runs["fused"].state, runs["fused"].snapshots),
                            (runs["megakernel"].state, runs["megakernel"].snapshots)), (name, mode)
                if mode != "rr_tracked":
                    assert same((runs["fused"].state, runs["fused"].snapshots),
                                (runs["reference"].state, runs["reference"].snapshots)), (name, mode)
                else:
                    assert runs["fused"].tracker.state.k.tolist() == runs["megakernel"].tracker.state.k.tolist()
    finally:
        chip_smoke.unregister(names)


# ---------------------------------------------------------------------------
# the add/rsqrt test stepper against repro
# ---------------------------------------------------------------------------

def _j_update(u, coef, ops, rsqrt_on):
    """The test stepper's substep in jnp, for repro's planes
    (``chip_smoke.nl_update``'s twin; ``1 + uu`` as ``ops.add(uu, 1)``,
    since repro's rr_tile adder broadcasts its second operand only)."""
    import jax.numpy as jnp

    uu = ops.mul(u, u, "nl.uu")
    s = ops.add(uu, jnp.float32(1.0), "nl.s")
    d = ops.rsqrt(s, "nl.d") if rsqrt_on else s
    lap = (u[..., :-2] - 2.0 * u[..., 1:-1] + u[..., 2:]) * jnp.float32(coef)
    flux = ops.mul(d[..., 1:-1], lap, "nl.flux")
    inner = ops.add(u[..., 1:-1], flux, "nl.update")
    return jnp.concatenate([u[..., :1], inner, u[..., -1:]], axis=-1)


def _repro_stepper(rsqrt_on):
    """The test stepper as a repro Stepper: its hooks run the jnp body through
    repro's fused_sweep and mega_sweep (``chip_smoke.generic_stepper``'s
    "nl"/"nl_add" is the port's)."""
    import jax.numpy as jnp

    from repro.kernels.fused import fused_sweep as jfused
    from repro.kernels.mega import mega_sweep as jmega
    from repro.pde.solver import Stepper as JStepper

    def body_of(cfg):
        return lambda state, ops: (_j_update(state[0], cfg.coef, ops, rsqrt_on),)

    class JNL(JStepper):
        def default_config(self):
            return chip_smoke.NLConfig()

        def init_state(self, cfg):
            return jnp.asarray(chip_smoke.nl_initial(cfg, "cpu").numpy())

        def step(self, u, cfg, ops):
            return _j_update(u, cfg.coef, ops, rsqrt_on)

        def fused_step(self, u, cfg, prec, steps, *, k_floor=None, collect_evidence=False, capture=None,
                       interpret=None, storage="f32"):
            outs, *rest = jfused(body_of(cfg), (u[None, :],), prec=prec, sites=self.sites, site_ops=self.site_ops,
                                 steps=steps, block=(1, cfg.nx), k_floor=k_floor, collect_evidence=collect_evidence,
                                 capture=capture, interpret=interpret)
            return (outs[0][0], *rest)

        def mega_step(self, u, cfg, prec, steps, every, *, tracker=None, collect_evidence=False, capture=None,
                      interpret=None, storage="f32"):
            res = jmega(body_of(cfg), (u[None, :],), prec=prec, sites=self.sites, site_ops=self.site_ops, steps=steps,
                        every=every, tracker=tracker, collect_evidence=collect_evidence, capture=capture,
                        interpret=interpret, storage=storage)
            return res._replace(state=res.state[0][0], snaps=res.snaps[0][:, 0])

    JNL.sites, JNL.site_ops = chip_smoke.nl_sites(rsqrt_on)
    return JNL


NX, STEPS, EVERY = 32, 10, 4
NAMES = {False: "nl_add", True: "nl"}


@pytest.fixture(scope="module")
def test_steppers():
    """The test stepper's two variants registered in both packages, removed
    afterwards."""
    from repro.pde import register_stepper as jregister
    from repro.pde.registry import _STEPPERS as J_STEPPERS

    names = chip_smoke.register_generic(chip_smoke.GENERIC_TEST)
    for rsqrt_on, name in NAMES.items():
        jregister(name, _repro_stepper(rsqrt_on))
    yield NAMES
    chip_smoke.unregister(names)
    for name in NAMES.values():
        J_STEPPERS.pop(name, None)


#: repro's calls (rsqrt variant, plane, mode), each family and both planes
#: for each variant, the adjust unit's add and rsqrt envelopes on the
#: megakernel (rr_tracked): each jitted call compiles for 0.5-4 s
REPRO_CALLS = [(False, "mega", m) for m in ("f32", "e5m10", "rr_tracked")] + [
    (False, "fused", "r2f2_16"), (False, "fused", "deploy"), (True, "mega", "r2f2_16"), (True, "mega", "rr_tracked"),
    (True, "fused", "e5m10"),
]
FLOOR = [1, 2, 0, 3, 2]


@pytest.fixture(scope="module")
def repro_runs(test_steppers):
    """repro's registered test steppers' megakernel and fused hooks
    (:data:`REPRO_CALLS`) in interpret mode, jitted, from the stepper's
    initial state: evidence, and a tracker and capture or a floor."""
    import jax

    from repro.core import policy as jpol
    from repro.pde import get_stepper as jget
    from repro.profile import CaptureSpec as JSpec

    cfg = chip_smoke.NLConfig(nx=NX)
    out = {}
    for rsqrt_on, plane, mode in REPRO_CALLS:
        st = jget(test_steppers[rsqrt_on])
        u0 = st.init_state(cfg)
        prec = preset(jpol.PRESETS, mode)
        trk = jpol.tracker_init(len(st.sites), prec.fmt, k0=0) if mode == "rr_tracked" else None
        floor = np.array(FLOOR[:len(st.sites)], np.int32)

        def mega(u, st=st, prec=prec, trk=trk):
            return st.mega_step(u, cfg, prec, STEPS, EVERY, tracker=trk, collect_evidence=True, capture=JSpec(),
                                interpret=True)

        def fused(u, st=st, prec=prec, floor=floor):
            return st.fused_step(u, cfg, prec, STEPS, k_floor=floor, collect_evidence=True, interpret=True)

        out[(rsqrt_on, plane, mode)] = jax.device_get(jax.jit(mega if plane == "mega" else fused)(u0))
    return out


def _ulps_within(got, want, mode):
    """Raw f32 distance within one ulp of the mode's target format (f32 and
    the bf16 family's f32 results: 1; E5M10: 2**13; r2f2_16: 2**14, its
    widest split's mantissa)."""
    bound = {"e5m10": 1 << 13, "r2f2_16": 1 << 14, "rr_tracked": 1 << 14}.get(mode, 1)
    g = got.detach().contiguous().view(torch.int32).to(torch.int64)
    w = torch.from_numpy(np.array(want, np.float32)).view(torch.int32).to(torch.int64)
    return int((g - w).abs().max()) <= bound


@pytest.mark.parametrize("rsqrt_on", [False, True], ids=["add", "rsqrt"])
def test_test_stepper_against_repro(rsqrt_on, test_steppers, repro_runs):
    """The registered test stepper's megakernel and fused hooks (the plain
    versions, which K8 and K9 equal) against repro's: the add-only variant
    bit for bit (state, snapshots, evidence, tracker, counts); the rsqrt
    variant's state and snapshots within one ulp of the target format, its
    evidence, tracker and counts exact."""
    st = get_stepper(test_steppers[rsqrt_on])
    cfg = chip_smoke.NLConfig(nx=NX)
    u0 = st.init_state(cfg, device="cpu")
    for (flag, plane, mode), want in repro_runs.items():
        if flag != rsqrt_on:
            continue
        prec = preset(PRESETS, mode)
        if plane == "mega":
            trk = tracker_init(len(st.sites), prec.fmt, k0=0, device="cpu") if mode == "rr_tracked" else None
            got = st.mega_step(u0, cfg, prec, STEPS, EVERY, tracker=trk, capture=CaptureSpec())
            pairs = [(got.state, want.state), (got.snaps, want.snaps)]
            exact = [(got.evidence, want.evidence), (got.exp_time, want.exp_time), (got.exp_total, want.exp_total)]
            if trk is not None:
                exact += [(getattr(got.tracker, f), getattr(want.tracker, f)) for f in got.tracker._fields]
        else:
            floor = torch.tensor(FLOOR[:len(st.sites)], dtype=torch.int32)
            out, ev = st.fused_step(u0, cfg, prec, STEPS, k_floor=floor, collect_evidence=True)
            pairs = [(out, want[0])]
            exact = [(ev, want[1])]
        for g, w in exact:
            w = np.array(w)
            if w.dtype == np.float32:
                assert torch.equal(bits(g), bits(torch.from_numpy(w))), (plane, mode)
            else:
                assert np.array_equal(g.numpy(), w), (plane, mode)
        for g, w in pairs:
            if rsqrt_on:
                assert _ulps_within(g, np.asarray(w), mode), (plane, mode)
            else:
                assert torch.equal(bits(g), bits(torch.from_numpy(np.array(w, np.float32)))), (plane, mode)
