"""repro_torch on a CUDA card: the kernels against their plain versions,
the default device, execution="auto" on the megakernel (K4 for heat1d and
swe2d, K5 for heat2d, advection1d and burgers1d), the contraction path
through K6 and K7, K7's split launches against unsplit ones, K3's and
heat2d's (K5a, K5d) thread-block clusters against the plain version, the
card against repro through the port's CPU run under flush, auto where a
kernel cannot hold the field or a stepper has none, and packed storage
(kernel K1's harness, every storage-carrying launch shape, every stepper's
packed and quantized runs, auto beyond heat2d's cluster), and range capture
(every capturing kernel family against its plain version, every stepper's
captured runs against the CPU under flush), and ensembles (every kernel's
member axis against its plain version, every stepper's ensembles against
the CPU under flush, one launch for every member), and the serving plane
and observability (a bucket's launches, its requests against their solo
runs and the CPU under flush, packed and fused buckets, the obs gate, obs
on against off). These tests skip
without a card; on the GPU machine, which has no JAX, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports neither JAX nor repro."""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; chip_smoke.py runs these checks on the GPU")


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """Each PDE kernel against its plain version on the CPU under flush,
    bit for bit with NaNs made canonical, over chip_smoke.py's case list."""
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke

    errs, records = chip_smoke.check_kernels("cuda", 50)
    mega_errs, mega_records = chip_smoke.check_mega("cuda")
    k5_errs, k5_records = chip_smoke.check_k5("cuda", chip_smoke.k5_cases("cuda"))
    assert all(r["ok"] for r in records + mega_records + k5_records)
    assert max(errs.values()) == 0.0 and max(mega_errs.values()) == 0.0 and max(k5_errs.values()) == 0.0


@pytest.mark.cuda
def test_default_device_runs_the_kernels():
    """Simulation without a device runs on the card through K2, one launch
    per chunk, and never through the plain version."""
    _need_card()
    from repro_torch.core.policy import PRESETS
    from repro_torch.kernels.heat_stencil import HEAT1D_SWEEP
    from repro_torch.pde import HeatConfig, Simulation

    sim = Simulation("heat1d", HeatConfig(nx=128), PRESETS["r2f2_16"])
    launches, plain = HEAT1D_SWEEP.launches, HEAT1D_SWEEP.plain_calls
    res = sim.run(400, execution="fused")
    assert res.state.is_cuda
    assert (HEAT1D_SWEEP.launches - launches, HEAT1D_SWEEP.plain_calls - plain) == (8, 0)
    ref = sim.run(400)
    assert torch.equal(res.state.view(torch.int32), ref.state.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["heat1d", "swe2d"])
def test_auto_runs_one_megakernel_launch(name):
    """execution="auto" on the card resolves to the megakernel: one K4
    launch per run, no plain call, bit-equal to the fused plane (state,
    snapshots and tracker, NaNs made canonical)."""
    _need_card()
    import dataclasses

    from repro_torch.core.policy import PRESETS
    from repro_torch.kernels.mega import HEAT1D_MEGA, SWE2D_MEGA
    from repro_torch.pde import HeatConfig, Simulation, SWEConfig

    cfg = HeatConfig(nx=128) if name == "heat1d" else SWEConfig()
    steps = 1000 if name == "heat1d" else 100
    ctr = HEAT1D_MEGA if name == "heat1d" else SWE2D_MEGA
    for prec in (PRESETS["r2f2_16"], dataclasses.replace(PRESETS["r2f2_16"], mode="rr_tracked")):
        sim = Simulation(name, cfg, prec)
        launches, plain = ctr.launches, ctr.plain_calls
        res = sim.run(steps, execution="auto")
        assert (ctr.launches - launches, ctr.plain_calls - plain) == (1, 0)
        fus = sim.run(steps, execution="fused")

        def bits(t):
            b = t.float().contiguous().view(torch.int32).clone()
            b[torch.isnan(t.float())] = 0x7FC00000
            return b

        assert torch.equal(bits(res.state), bits(fus.state))
        assert torch.equal(bits(res.snapshots), bits(fus.snapshots))
        if fus.tracker is not None:
            for a, b in zip(res.tracker.state, fus.tracker.state):
                assert torch.equal(bits(a), bits(b))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["heat2d", "advection1d", "burgers1d"])
def test_k5_planes_launch_their_kernels(name):
    """heat2d, advection1d and burgers1d on the card: the fused plane
    launches its K5 sweep once per snapshot interval (and once for the
    remainder), execution="auto" one K5 megakernel per run, no plain call
    runs, and the two planes agree bit for bit (NaNs made canonical)."""
    _need_card()
    import dataclasses

    from repro_torch.core.policy import PRESETS
    from repro_torch.kernels import mega, pde_steps
    from repro_torch.pde import Simulation

    sweep = getattr(pde_steps, f"{name.upper()}_SWEEP")
    meg = getattr(mega, f"{name.upper()}_MEGA")
    steps, every = 100, 30  # three chunks and a remainder
    for prec in (PRESETS["e5m10"], dataclasses.replace(PRESETS["r2f2_16"], mode="rr_tracked")):
        sim = Simulation(name, None, prec)
        before = (sweep.launches, sweep.plain_calls, meg.launches, meg.plain_calls)
        fus = sim.run(steps, snapshot_every=every, execution="fused")
        res = sim.run(steps, snapshot_every=every, execution="auto")
        after = (sweep.launches, sweep.plain_calls, meg.launches, meg.plain_calls)
        assert tuple(a - b for a, b in zip(after, before)) == (4, 0, 1, 0)
        assert res.state.is_cuda

        def bits(t):
            b = t.float().contiguous().view(torch.int32).clone()
            b[torch.isnan(t.float())] = 0x7FC00000
            return b

        assert torch.equal(bits(res.state), bits(fus.state))
        assert torch.equal(bits(res.snapshots), bits(fus.snapshots))
        if fus.tracker is not None:
            for a, b in zip(res.tracker.state, fus.tracker.state):
                assert torch.equal(bits(a), bits(b))


@pytest.mark.cuda
def test_cuda_k6_k7_match_plain_versions():
    """K6 bit for bit, K7 within the spread of two f32 summation orders
    (dyadic and rounded-dyadic cases bit for bit), over chip_smoke.py's case
    list."""
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke

    _, records = chip_smoke.check_contract_kernels("cuda")
    assert records and all(r["ok"] for r in records)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["r2f2_matmul", "r2f2_quantize"])
def test_k6_k7_flush_subnormals_as_the_cpu_does(kernel):
    """K7 and K6 on operands whose products (K7 at the r2f2_16_384 preset's
    (3, 8, 4): its E7M8 split reaches 2**-70) or inputs (K6) are f32
    subnormal, against their plain versions on the CPU under flush, raw
    bits with NaNs canonical: split and unsplit, with and without
    round_products, and at r2f2_16's (3, 9, 3) (chip_smoke.flush_contract_cases).
    K7's unrounded (3, 8, 4) cases must differ from the CPU run keeping
    subnormals, so the check sees the flush."""
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke

    records = [r for r in chip_smoke.check_flush_contract("cuda") if r["kernel"] == kernel]
    assert len(records) == {"r2f2_matmul": 6, "r2f2_quantize": 2}[kernel]
    failed = [r["case"] for r in records if not r["ok"]]
    assert not failed, failed


@pytest.mark.cuda
def test_contract_on_cuda_launches_k7():
    """rr_tile with use_kernels sends a 2-D matmul on CUDA tensors to K7 (one
    launch, no plain call); other specs and modes do not reach it."""
    _need_card()
    import dataclasses

    from repro_torch.core.policy import PRESETS
    from repro_torch.kernels.r2f2_matmul import R2F2_MATMUL, r2f2_matmul_plain
    from repro_torch.precision import contract, dot

    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(200, 136, generator=g).cuda(), torch.randn(136, 72, generator=g).cuda()
    cfg = dataclasses.replace(PRESETS["r2f2_16"], use_kernels=True)
    before = (R2F2_MATMUL.launches, R2F2_MATMUL.plain_calls)
    out = contract("ij,jk->ik", a, b, cfg)
    dot(a[None], b, cfg)
    contract("ij,jk->ik", a, b, PRESETS["r2f2_16"])
    assert (R2F2_MATMUL.launches - before[0], R2F2_MATMUL.plain_calls - before[1]) == (1, 0)
    want = r2f2_matmul_plain(a, b, fmt=cfg.fmt)
    bound = 136 * 2.0**-23 * r2f2_matmul_plain(a.abs(), b.abs(), fmt=cfg.fmt).double() * 1.01
    assert bool(((out.double() - want.double()).abs() <= bound).all())


@pytest.mark.cuda
def test_generate_on_cuda_runs_k7():
    """reduced llama4-scout (2 layers) served on the card under r2f2_16 with
    use_kernels: K7 at the router and the shared expert's three sites of each
    layer per forward, the same tokens as with K7's plain version."""
    _need_card()
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.policy import PRESETS
    from repro_torch.kernels import ops
    from repro_torch.kernels.r2f2_matmul import R2F2_MATMUL
    from repro_torch.models import model_init
    from repro_torch.serve import generate

    cfg = dataclasses.replace(reduced(get_config("llama4-scout-17b-a16e")), n_layers=2)
    params = model_init(torch.Generator(device="cuda").manual_seed(0), cfg, "cuda")
    prompts = torch.randint(0, cfg.vocab, (4, 8), generator=torch.Generator().manual_seed(1))
    prec = dataclasses.replace(PRESETS["r2f2_16"], use_kernels=True)
    before = (R2F2_MATMUL.launches, R2F2_MATMUL.plain_calls)
    tokens = generate(params, cfg, prec, prompts, max_new_tokens=6)
    assert (R2F2_MATMUL.launches - before[0], R2F2_MATMUL.plain_calls - before[1]) == (2 * 4 * 6, 0)
    before = (R2F2_MATMUL.launches, R2F2_MATMUL.plain_calls)
    with ops.plain_matmul():
        plain = generate(params, cfg, prec, prompts, max_new_tokens=6)
    assert (R2F2_MATMUL.launches - before[0], R2F2_MATMUL.plain_calls - before[1]) == (0, 2 * 4 * 6)
    assert tokens.is_cuda and torch.equal(tokens, plain)


@pytest.mark.cuda
def test_k7_split_is_bit_identical_to_unsplit():
    """K7's split launches (one CTA per K block, the partials folded in K
    order) against one CTA per output block, bit for bit, and within the
    bound of the plain version: the router at prefill and decode, the shared
    expert's gate and down projections at decode, 512^3, ragged and
    unaligned shapes and round_products (chip_smoke.K7_SPLIT_CASES)."""
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke

    _, records = chip_smoke.check_contract_kernels("cuda")
    split = [r for r in records if r["case"].startswith("split ")]
    assert len(split) == len(chip_smoke.K7_SPLIT_CASES) + 1
    assert all(r["ok"] for r in split)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,block",
    [((127, 128), None), ((255, 256), (64, 128)), ((61, 30), None)],
    ids=["paper-tile", "multi-tile", "unaligned-ragged-bands"],
)
def test_k3_cluster_matches_plain(shape, block):
    """K3 as one thread-block cluster per split tile, against its plain
    version bit for bit, evidence too, over the families: the paper's
    (127, 128) tile (16 CTAs, the last band 7 rows), a (255, 256) field of
    eight (64, 128) tiles, and an unaligned (61, 30) tile (scalar loads,
    bands of 9 rows and a last one of 7)."""
    _need_card()
    from repro_torch.core.policy import PRESETS
    from repro_torch.kernels.swe_flux import SWE_FLUX, cluster_plan, swe_flux_fused, swe_flux_fused_plain

    br, bw = (min(b, s) for b, s in zip(block or (128, 128), shape))
    c, band = cluster_plan(br, bw)
    assert c > 1
    g = torch.Generator().manual_seed(3)
    q3 = (500.0 + 100.0 * torch.rand(*shape, generator=g)).cuda()
    q1 = (40.0 * torch.randn(*shape, generator=g)).cuda()

    def bits(t):
        b = t.float().contiguous().view(torch.int32).clone()
        b[torch.isnan(t.float())] = 0x7FC00000
        return b

    for name in ("f32", "bf16", "e5m10", "r2f2_16", "deploy"):
        before = SWE_FLUX.launches
        got, ev = swe_flux_fused(q1, q3, prec=PRESETS[name], block=block, collect_evidence=True)
        want, ev_want = swe_flux_fused_plain(q1, q3, prec=PRESETS[name], block=block, collect_evidence=True)
        assert SWE_FLUX.launches - before == 1
        assert torch.equal(bits(got), bits(want)), name
        assert torch.equal(bits(ev), bits(ev_want)), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["heat1d", "swe2d", "heat2d", "advection1d", "burgers1d"])
def test_card_equals_the_cpu_under_flush(name):
    """Each builtin stepper on the card, on the reference, fused and
    megakernel planes in the six modes, equals the port's run on the CPU
    under flush bit for bit (state, snapshots, tracker; NaNs canonical),
    which the CPU tests hold equal to repro: the card flushes f32
    subnormals as the reference does. swe2d reaches them within the 56
    steps, so its CPU run that keeps them differs. In r2f2_16 and
    rr_tracked the card also runs with capture (one more line each)."""
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke

    lines, kept_differs = chip_smoke.check_card_vs_cpu("cuda", (name,))
    assert len(lines) == 18 + 3 * len(chip_smoke.LINK_CAPTURE_MODES)
    if name == "swe2d":
        assert kept_differs > 0


def _bits(t):
    b = t.float().contiguous().view(torch.int32).clone()
    b[torch.isnan(t.float())] = 0x7FC00000
    return b


def _on_cpu_flushed(fn):
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    try:
        return fn()
    finally:
        torch.set_flush_denormal(False)
        torch.set_num_threads(prev)


def _assert_runs_equal(got, want):
    assert torch.equal(_bits(got.state.cpu()), _bits(want.state))
    assert torch.equal(_bits(got.snapshots.cpu()), _bits(want.snapshots))
    if want.tracker is not None:
        for a, b in zip(got.tracker.state, want.tracker.state):
            assert torch.equal(_bits(a.float().cpu()), _bits(b.float()))


@pytest.mark.cuda
@pytest.mark.parametrize("name,size,plane,counter", [
    ("heat2d", (200, 200), "megakernel", "heat2d_mega"),
    ("burgers1d", 20_000, "megakernel", "burgers1d_mega"),
    ("heat1d", 30_000, "megakernel", "heat1d_mega"),
], ids=["heat2d-200x200", "burgers1d-20000", "heat1d-30000"])
def test_auto_runs_where_repro_does(name, size, plane, counter):
    """auto on the card at fields beyond one CTA's shared memory: heat2d at
    200x200 runs its cluster megakernel, burgers1d at 20,000 cells K5f and
    heat1d at 30,000 cells K4 on the rod's cooperative grid (one launch
    each, no plain version); each equals the port's CPU run under flush
    from the same initial state (the card's sin and linspace differ from
    the CPU's in the last ulp)."""
    _need_card()
    import dataclasses

    from repro_torch.core.policy import PRESETS
    from repro_torch.kernels import mega, pde_steps
    from repro_torch.kernels.heat_stencil import HEAT1D_SWEEP
    from repro_torch.kernels.swe_flux import SWE_FLUX
    from repro_torch.pde import BurgersConfig, Heat2DConfig, HeatConfig, Simulation

    cfg = {"heat2d": lambda: Heat2DConfig(nx=size[0], ny=size[1]), "burgers1d": lambda: BurgersConfig(nx=size),
           "heat1d": lambda: HeatConfig(nx=size)}[name]()
    counters = [HEAT1D_SWEEP, SWE_FLUX, mega.HEAT1D_MEGA, mega.SWE2D_MEGA] + [
        c for body in pde_steps.BODIES.values() for c in (body.sweep, body.mega)]
    state0 = Simulation(name, cfg, PRESETS["f32"], device="cpu").stepper.init_state(cfg, device="cpu")
    kw = dict(snapshot_every=10, execution="auto", state0=state0)
    for prec in (PRESETS["r2f2_16"], dataclasses.replace(PRESETS["r2f2_16"], mode="rr_tracked")):
        sim = Simulation(name, cfg, prec, device="cuda")
        assert sim._resolve_execution("auto") == plane
        before = {c.name: (c.launches, c.plain_calls) for c in counters}
        got = sim.run(24, **kw)
        after = {c.name: (c.launches, c.plain_calls) for c in counters}
        moved = {k: (after[k][0] - v[0], after[k][1] - v[1]) for k, v in before.items() if after[k] != v}
        assert moved == ({counter: (1, 0)} if counter else {})
        want = _on_cpu_flushed(lambda: Simulation(name, cfg, prec, device="cpu").run(24, **kw))
        _assert_runs_equal(got, want)


#: (stepper, field size) past the one-CTA and cluster limits the K5 kernels
#: had: each runs on the rod's cooperative grid
K5_ANY_SIZE = [("advection1d", dict(nx=30_000)), ("burgers1d", dict(nx=20_000)), ("heat2d", dict(nx=400, ny=400))]


@pytest.mark.cuda
@pytest.mark.parametrize("execution", ["fused", "megakernel"])
@pytest.mark.parametrize("name,size", K5_ANY_SIZE, ids=[n for n, _ in K5_ANY_SIZE])
def test_k5_kernel_planes_take_any_size(name, size, execution):
    """An explicit kernel plane at advection1d nx = 30,000, burgers1d
    20,000 and heat2d 400x400 (all on the rod's grid) runs on the card, one
    K5 sweep launch a chunk or one megakernel launch, no plain version, and
    equals the port's CPU run under flush from the same initial state, in
    r2f2_16, e5m10 and rr_tracked."""
    _need_card()
    import dataclasses

    from repro_torch import pde
    from repro_torch.core.policy import PRESETS
    from repro_torch.kernels import pde_steps

    cfg = dataclasses.replace(pde.get_stepper(name).default_config(), **size)
    body = pde_steps.BODIES[name]
    ctr = body.sweep if execution == "fused" else body.mega
    kw = dict(snapshot_every=10, execution=execution,
              state0=pde.Simulation(name, cfg, PRESETS["f32"], device="cpu").stepper.init_state(cfg, device="cpu"))
    for prec in (PRESETS["r2f2_16"], PRESETS["e5m10"], dataclasses.replace(PRESETS["r2f2_16"], mode="rr_tracked")):
        sim = pde.Simulation(name, cfg, prec, device="cuda")
        assert sim._resolve_execution("auto") == "megakernel"
        before = (ctr.launches, ctr.plain_calls)
        got = sim.run(24, **kw)
        assert (ctr.launches - before[0], ctr.plain_calls - before[1]) == (3 if execution == "fused" else 1, 0)
        want = _on_cpu_flushed(lambda: pde.Simulation(name, cfg, prec, device="cpu").run(24, **kw))
        _assert_runs_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["(3,)", "(256,) [warp", "(2048,)", "(2049,)", "(256,) [grid", "(30000,) [grid shape: 15",
                                   "(30000,) [grid shape: 1 CTA"])
def test_rod_k5_kernels_match_plain_versions(shape):
    """K5b, K5c, K5e and K5f on every rod shape of chip_smoke.ROD_SHAPES
    (by the shape in their labels), against their plain versions on the CPU
    under flush bit for bit, in r2f2_16, e5m10 and rr_tracked."""
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke

    cases = [c for c in chip_smoke.rod_shape_cases("cuda") if f" {shape}" in c[1]]
    assert len(cases) == 12
    errs, records = chip_smoke.check_k5("cuda", cases)
    assert all(r["ok"] for r in records) and max(errs.values()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["(359,359)", "(400,400)", "(64,64)"])
def test_heat2d_grid_matches_plain(shape):
    """K5a and K5d on the rod's grid (fields beyond the cluster, and the
    main path's on a forced grid) against the plain version on the CPU
    under flush, bit for bit, in r2f2_16, e5m10 and rr_tracked."""
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke

    cases = [c for c in chip_smoke.heat2d_grid_cases("cuda") if f" {shape} " in c[1]]
    assert len(cases) == 6
    errs, records = chip_smoke.check_k5("cuda", cases)
    assert all(r["ok"] for r in records) and max(errs.values()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("which", [
    "main path", "forced grid", "two-row bands", "one CTA", "(127,128)", "(130,64)", "(200,200)", "(32,3)",
    "(64,5000)", "boundaries",
])
def test_swe2d_mega_shapes_match_plain(which):
    """K4 swe2d on its band plan at the main path's 128x128 (over the ladder
    and the trackers), on forced grids there (8 CTAs, two-row bands of 512
    threads, one CTA owning every row), with uneven last bands (127x128, 130x64), at
    200x200, (32, 3) and 64x5000 (band arrays in device memory), and tracked
    across six snapshot boundaries and with every = 1, against its plain
    version on the CPU under flush bit for bit: state, snapshots, evidence,
    tracker."""
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke

    from repro_torch.kernels.mega import swe2d_mega

    def picked(label, kw):
        if which == "main path":
            return kw.get("_plan") is None and kw["cfg"].nx == 128 and "boundaries" not in label
        return which in label

    cases = [(label, x, kw) for kern, label, x, kw in chip_smoke.mega_cases("cuda") if kern == "swe2d" and picked(label, kw)]
    assert cases
    for label, x, kw in cases:
        got = swe2d_mega(x, **kw)
        want = chip_smoke.plain_on_cpu(swe2d_mega, x, plain=True, **{k: v for k, v in kw.items() if k != "_plan"})
        assert chip_smoke.same_bits(got.state, want.state) and chip_smoke.same_bits(got.snaps, want.snaps), label
        assert chip_smoke.same_bits(got.evidence, want.evidence), label
        if want.tracker is not None:
            assert all(chip_smoke.same_bits(a.float(), b.float()) for a, b in zip(got.tracker, want.tracker)), label


@pytest.mark.cuda
@pytest.mark.parametrize("execution,counter,launches", [("fused", "heat1d_sweep", 3), ("megakernel", "heat1d_mega", 1)])
def test_heat1d_kernel_planes_take_any_length(execution, counter, launches):
    """An explicit kernel plane at heat1d nx = 30,000 (the grid shape) runs
    on the card, one K2 launch a chunk or one K4 launch, no plain version,
    and equals the port's CPU run under flush from the same initial state,
    in r2f2_16 and rr_tracked."""
    _need_card()
    import dataclasses

    from repro_torch.core.policy import PRESETS
    from repro_torch.kernels.heat_stencil import HEAT1D_SWEEP
    from repro_torch.kernels.mega import HEAT1D_MEGA
    from repro_torch.pde import HeatConfig, Simulation

    cfg = HeatConfig(nx=30_000)
    ctr = {"heat1d_sweep": HEAT1D_SWEEP, "heat1d_mega": HEAT1D_MEGA}[counter]
    kw = dict(snapshot_every=10, execution=execution, state0=Simulation("heat1d", cfg, PRESETS["f32"], device="cpu")
              .stepper.init_state(cfg, device="cpu"))
    for prec in (PRESETS["r2f2_16"], dataclasses.replace(PRESETS["r2f2_16"], mode="rr_tracked")):
        before = (ctr.launches, ctr.plain_calls)
        got = Simulation("heat1d", cfg, prec, device="cuda").run(24, **kw)
        assert (ctr.launches - before[0], ctr.plain_calls - before[1]) == (launches, 0)
        want = _on_cpu_flushed(lambda: Simulation("heat1d", cfg, prec, device="cpu").run(24, **kw))
        _assert_runs_equal(got, want)


#: K2 and K4 heat1d's cases of chip_smoke.heat_cases and mega_cases, by the
#: shape in their labels: the main path's rod (six modes, a k_floor, pinned,
#: r2f2_16_384; K4 with evolving, growing, pinned and bounded trackers), the
#: padded row blocks, eight rows of 128, the 3-cell rod, the warp shape's
#: edge, the grid one cell past it, on several blocks, on the main path's rod
#: and in batches, and rods of 30,000 and 10**6 cells
HEAT1D_SHAPES = ["(1,128)", "(128,)", "(5,64)", "(8,128)", "(1,3)", "(3,)", "(1,2048)", "(2048,)", "(1,2049)", "(2049,)",
                 "(6,700)", "forced grid", "30000", "1000000"]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", HEAT1D_SHAPES)
def test_heat1d_kernels_match_plain_versions(shape):
    """K2 and K4 heat1d on the launch shapes heat1d_plan gives (and the grid
    forced onto the main path's rod), against their plain versions on the
    CPU under flush bit for bit: the field, the evidence and, for K4, the
    snapshots and every tracker row."""
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke

    from repro_torch.kernels.heat_stencil import heat1d_sweep, heat1d_sweep_plain
    from repro_torch.kernels.mega import heat1d_mega

    def picked(label):
        return shape.replace(" ", "") in label.replace(" ", "") and (shape == "forced grid" or "forced" not in label)

    n = 0
    for label, u, kw in chip_smoke.heat_cases("cuda", 200):
        if picked(label):
            got, ev = heat1d_sweep(u, **kw)
            want, ev_want = chip_smoke.plain_on_cpu(heat1d_sweep_plain, u, **{k: v for k, v in kw.items() if k != "_plan"})
            assert chip_smoke.same_bits(got, want) and chip_smoke.same_bits(ev, ev_want), label
            n += 1
    for kern, label, x, kw in chip_smoke.mega_cases("cuda"):
        if kern == "heat1d" and picked(label):
            got = heat1d_mega(x, **kw)
            want = chip_smoke.plain_on_cpu(heat1d_mega, x, plain=True, **{k: v for k, v in kw.items() if k != "_plan"})
            assert chip_smoke.same_bits(got.state, want.state) and chip_smoke.same_bits(got.snaps, want.snaps), label
            assert chip_smoke.same_bits(got.evidence, want.evidence), label
            if want.tracker is not None:
                assert all(chip_smoke.same_bits(a.float(), b.float()) for a, b in zip(got.tracker, want.tracker)), label
            n += 1
    assert n > 0


@pytest.mark.cuda
def test_registered_body_without_kernel_runs_on_the_card():
    """A stepper added with register_stepper, whose fused and megakernel
    hooks run a body with no CUDA kernel, declares none: on the card auto
    gives it the reference plane, and the run equals the CPU's auto run
    (its megakernel plane's plain version) under flush from the same
    initial state."""
    _need_card()
    from repro_torch.core.policy import PRESETS
    from repro_torch.kernels.fused import fused_sweep
    from repro_torch.kernels.heat_stencil import _heat1d_body
    from repro_torch.kernels.mega import mega_sweep
    from repro_torch.pde import HeatConfig, Simulation, register_stepper
    from repro_torch.pde.heat1d import Heat1DStepper
    from repro_torch.pde.registry import _STEPPERS

    class GenericHeat(Heat1DStepper):
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
            return res._replace(state=res.state[0][0], snaps=res.snaps[0][:, 0])

    register_stepper("generic_heat_card", GenericHeat)
    cfg = HeatConfig(nx=64)
    kw = dict(snapshot_every=16, execution="auto", state0=GenericHeat().init_state(cfg, device="cpu"))
    try:
        for mode in ("r2f2_16", "e5m10"):
            got = Simulation("generic_heat_card", cfg, PRESETS[mode]).run(40, **kw)
            assert got.state.is_cuda
            want = _on_cpu_flushed(lambda: Simulation("generic_heat_card", cfg, PRESETS[mode], device="cpu").run(40, **kw))
            _assert_runs_equal(got, want)
    finally:
        _STEPPERS.pop("generic_heat_card", None)


#: chip_smoke.HEAT2D_CLUSTER_SHAPES: 64x64 at every cluster size, 200x200,
#: an unaligned 61x45 and the smallest 3x3, each at the plan's size
HEAT2D_CLUSTER_SHAPES = [((64, 64), c) for c in (1, 2, 4, 8, 16)] + [((200, 200), None), ((61, 45), None), ((3, 3), None)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cluster", HEAT2D_CLUSTER_SHAPES,
                         ids=[f"{nx}x{ny}-C{c or 'plan'}" for (nx, ny), c in HEAT2D_CLUSTER_SHAPES])
def test_heat2d_cluster_matches_plain(shape, cluster):
    """K5a and K5d as one thread-block cluster against the plain version on
    the CPU under flush, bit for bit, in the six modes: the sweep with
    evidence (tracked modes at a carried floor), the megakernel with
    snapshots, evidence and evolving rr_tracked and deploy trackers."""
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke

    cases = chip_smoke.heat2d_cluster_cases("cuda", ((shape, cluster),))
    errs, records = chip_smoke.check_k5("cuda", cases)
    assert len(records) == 12 and all(r["ok"] for r in records)
    assert errs["heat2d_sweep"] == 0.0 and errs["heat2d_mega"] == 0.0


@pytest.mark.cuda
def test_storage_k1_harness_matches_plain():
    """Kernel K1's harness (pack at every split, picked splits, unpack of
    every payload pattern) against the plain pack/unpack on the CPU under
    flush, for every preset's format, the fixed baselines' and a 19-bit one."""
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke

    lines, err = chip_smoke.check_storage_k1("cuda")
    assert len(lines) == len(chip_smoke.STORAGE_FMTS) and err == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["heat1d", "advection1d", "burgers1d", "heat2d", "swe2d"])
def test_storage_kernels_match_plain(family):
    """Every storage-carrying launch shape (the rod's warp shape, a forced
    one-CTA grid and the grid; heat2d's cluster and a forced grid; K4
    swe2d's bands and a forced grid of 8 CTAs) with packed leaves, packed
    from f32 (the host-pack shape) and quantized, against the plain version
    on the CPU under flush: payloads and splits, snapshots, evidence and
    trackers bit for bit."""
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke

    cases = [c for c in chip_smoke.storage_cases("cuda") if c[0].startswith(family)]
    errs, records = chip_smoke.check_storage("cuda", cases)
    assert records and all(r["ok"] for r in records) and max(errs.values()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["heat1d", "swe2d", "heat2d", "advection1d", "burgers1d"])
def test_card_storage_equals_the_cpu_under_flush(name):
    """Each builtin stepper on the fused and megakernel planes, packed and
    quantized, r2f2_16 and rr_tracked, equals the port's run on the CPU
    under flush bit for bit (payload and splits, snapshots, tracker)."""
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke

    assert len(chip_smoke.check_card_vs_cpu_storage("cuda", (name,))) == 8


@pytest.mark.cuda
def test_auto_packed_beyond_the_heat2d_cluster():
    """heat2d at 400x400, beyond its cluster, with packed storage through
    auto: one launch of K5d's packed variant on the rod's grid, equal to the
    CPU run under flush."""
    _need_card()
    from repro_torch.core.policy import PRESETS
    from repro_torch.kernels.mega import HEAT2D_MEGA
    from repro_torch.pack import PackedArray
    from repro_torch.pde import Heat2DConfig, Simulation

    cfg = Heat2DConfig(nx=400, ny=400)
    state0 = Simulation("heat2d", cfg, PRESETS["f32"], device="cpu").stepper.init_state(cfg, device="cpu")
    kw = dict(snapshot_every=5, execution="auto", state0=state0, storage="packed")
    packed, launches = HEAT2D_MEGA.storage["packed"], HEAT2D_MEGA.launches
    got = Simulation("heat2d", cfg, PRESETS["r2f2_16"]).run(12, **kw)
    assert (HEAT2D_MEGA.storage["packed"] - packed, HEAT2D_MEGA.launches - launches) == (1, 1)
    want = _on_cpu_flushed(lambda: Simulation("heat2d", cfg, PRESETS["r2f2_16"], device="cpu").run(12, **kw))
    assert isinstance(got.state, PackedArray) and got.state.payload.is_cuda
    assert torch.equal(got.state.payload.cpu().to(torch.int64), want.state.payload.to(torch.int64))
    assert torch.equal(got.state.k.cpu(), want.state.k)
    assert torch.equal(_bits(got.snapshots.cpu()), _bits(want.snapshots))


#: capture_cases' launch shape classes: the rod (warp and grid shapes, heat2d
#: on the rod's grid too), K3, heat2d's cluster and K4 swe2d
CAPTURE_FAMILIES = {
    "rod": lambda kern, label: kern.split("_")[0] in ("heat1d", "advection1d", "burgers1d")
    or (kern.startswith("heat2d") and "grid shape" in label),
    "k3": lambda kern, label: kern == "swe_flux_fused",
    "heat2d_cluster": lambda kern, label: kern.startswith("heat2d") and "cluster" in label,
    "swe2d": lambda kern, label: kern == "swe2d_mega",
}


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(CAPTURE_FAMILIES))
def test_capture_kernels_match_plain(family):
    """Range capture in each kernel family on every launch shape of
    chip_smoke.capture_cases, against the plain version on the CPU under
    flush: the counts exactly (a megakernel's per interval and in total),
    the evidence, state, snapshots and tracker bit for bit."""
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke

    cases = [c for c in chip_smoke.capture_cases("cuda") if CAPTURE_FAMILIES[family](c[0], c[1])]
    assert cases
    _, records = chip_smoke.check_capture("cuda", cases)
    assert len(records) == len(cases) and all(r["ok"] and r["counted"] > 0 for r in records)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["heat1d", "swe2d", "heat2d", "advection1d", "burgers1d"])
def test_card_capture_equals_the_cpu_under_flush(name):
    """Simulation.run(capture=True) on the card on every plane in r2f2_16
    and rr_tracked against the port's CPU run under flush: state, tracker
    and the profile's evidence bit for bit, its counts exactly."""
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke

    lines, _ = chip_smoke.check_card_vs_cpu("cuda", (name,), modes=("r2f2_16", "rr_tracked"))
    assert sum(", capture:" in line for line in lines) == 6


@pytest.mark.cuda
def test_captured_launches_are_counted_and_capture_off_is_unchanged():
    """A captured run on the card launches the kernel with capture (its
    counter's ``captured``) and changes no bit of the state; a run without
    capture launches it without."""
    _need_card()
    from repro_torch.core.policy import PRESETS
    from repro_torch.kernels.mega import HEAT1D_MEGA
    from repro_torch.pde import HeatConfig, Simulation

    sim = Simulation("heat1d", HeatConfig(nx=128), PRESETS["r2f2_16"])
    launches, captured = HEAT1D_MEGA.launches, HEAT1D_MEGA.captured
    off = sim.run(400, execution="megakernel")
    assert (HEAT1D_MEGA.launches - launches, HEAT1D_MEGA.captured - captured) == (1, 0)
    on = sim.run(400, execution="megakernel", capture=True)
    assert (HEAT1D_MEGA.launches - launches, HEAT1D_MEGA.captured - captured) == (2, 1)
    assert torch.equal(off.state.view(torch.int32), on.state.view(torch.int32))
    assert on.profile.exp_time.shape[0] == 8 and 0 < int(on.profile.exp_total.sum()) <= 2 * 2 * 126 * 400


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["rod", "heat2d", "k3", "swe2d"])
def test_member_axis_kernels_match_plain(group):
    """Every kernel's member axis (three members, each with its own floor or
    tracker rows, capture and packed storage; the rod's warp and grid
    shapes, heat2d's cluster and grid, K3 on one and on padded tiles, K4
    swe2d's member bands and a plan of two waves) against the plain version
    on the CPU under flush, bit for bit."""
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke

    errs, records = chip_smoke.check_ensemble_kernels("cuda", group)
    assert records and all(r["ok"] for r in records) and max(errs.values()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["heat1d", "swe2d", "heat2d", "advection1d", "burgers1d"])
def test_card_ensemble_equals_the_cpu_under_flush(name):
    """Each stepper's ensemble (three members and one with subnormals) on
    both kernel planes, r2f2_16 and rr_tracked, plain, captured and packed,
    against the port's ensemble on the CPU under flush."""
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke

    assert chip_smoke.check_card_vs_cpu_ensemble("cuda", name)


@pytest.mark.cuda
@pytest.mark.parametrize("execution", ["fused", "megakernel"])
def test_ensemble_launches_once_for_every_member(execution):
    """An 8-member heat1d ensemble on a kernel plane launches its kernel as
    often as one run does (8 chunks, or one horizon), each member equal to
    the member run alone."""
    _need_card()
    from repro_torch.core.policy import PRESETS
    from repro_torch.kernels.heat_stencil import HEAT1D_SWEEP
    from repro_torch.kernels.mega import HEAT1D_MEGA
    from repro_torch.pde import HeatConfig, Simulation

    ctr = HEAT1D_SWEEP if execution == "fused" else HEAT1D_MEGA
    sim = Simulation("heat1d", HeatConfig(nx=128), PRESETS["r2f2_16"])
    u0 = sim.stepper.init_state(sim.cfg, device="cpu").cuda()
    batch = torch.stack([u0 * (0.9 + 0.05 * i) for i in range(8)])
    before = (ctr.launches, ctr.plain_calls)
    ens = sim.run_ensemble(batch, 400, execution=execution)
    assert (ctr.launches - before[0], ctr.plain_calls - before[1]) == (8 if execution == "fused" else 1, 0)
    for i in (0, 7):
        alone = sim.run(400, state0=batch[i], execution=execution)
        assert torch.equal(ens.state[i].view(torch.int32), alone.state.view(torch.int32))


def _serve_mixed_bucket(device, name, cfg, execution="auto", storage="f32", cadences=(8, 5, 4)):
    """Three r2f2_16 requests of 40 steps at ``cadences``, the third a
    mid-flight joiner, served on ``device``; returns the service and its
    handles."""
    from repro_torch.core.policy import PRESETS
    from repro_torch.pde import Simulation
    from repro_torch.service import ServiceConfig, SimRequest, SimService

    s0 = Simulation(name, cfg, PRESETS["f32"], device="cpu").stepper.init_state(cfg, device="cpu")
    svc = SimService(ServiceConfig(), device=device)
    reqs = [SimRequest(name, 40, "r2f2_16", cfg=cfg, state0=s0 * (0.9 + 0.05 * i), snapshot_every=every,
                       execution=execution, storage=storage) for i, every in enumerate(cadences)]
    hs = [svc.submit(r) for r in reqs[:2]]
    svc.pump()
    hs.append(svc.submit(reqs[2]))
    svc.run_until_idle()
    return svc, hs


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["heat1d", "swe2d", "heat2d", "advection1d", "burgers1d"])
def test_service_on_the_card_launches_once_a_chunk_and_equals_the_cpu(name):
    """SimService on the card (its default device) through auto: one
    megakernel launch a bucket chunk for every member, dispatches counted
    by repro_torch.obs, every request equal to its solo run on the card and
    to the same bucket served on the CPU under flush, bit for bit."""
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke
    import repro_torch.obs as obs

    cfg = chip_smoke.link_configs()[name]
    ctr = chip_smoke.counters()[f"{name}_mega"]
    before = (ctr.launches, ctr.plain_calls)
    scope = obs.enable()
    try:
        svc, hs = _serve_mixed_bucket(None, name, cfg)
    finally:
        obs.disable()
    chunks = svc.metrics.chunks
    assert all(h.bucket_key.execution == "megakernel" for h in hs)
    assert (ctr.launches - before[0], ctr.plain_calls - before[1]) == (chunks, 0)
    assert scope.registry.counter("repro_cuda_dispatch_total").value(kernel="mega_sweep") == chunks
    with chip_smoke.cpu_flushed():
        _, cpu = _serve_mixed_bucket("cpu", name, cfg)
    for h, c in zip(hs, cpu):
        assert chip_smoke.served_equals_solo(h, chip_smoke.serve_solo(h, "cuda"))
        assert np.array_equal(chip_smoke.canon_bits(torch.from_numpy(h.result().state)).numpy(),
                              chip_smoke.canon_bits(torch.from_numpy(c.result().state)).numpy())
        assert all(np.array_equal(chip_smoke.canon_bits(torch.from_numpy(a)).numpy(),
                                  chip_smoke.canon_bits(torch.from_numpy(b)).numpy())
                   for a, b in zip(h.snapshots, c.snapshots))


@pytest.mark.cuda
def test_service_packed_and_fused_buckets_on_the_card():
    """swe2d r2f2_16 with packed storage, and heat1d on the fused plane (K2
    once a chunk), served on the card: each request equals its solo run."""
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke
    from repro_torch.kernels.heat_stencil import HEAT1D_SWEEP

    links = chip_smoke.link_configs()
    # carried storage rounds at every bucket chunk boundary: one cadence
    svc, hs = _serve_mixed_bucket("cuda", "swe2d", links["swe2d"], storage="packed", cadences=(4, 4, 4))
    for h in hs:
        assert chip_smoke.served_equals_solo(h, chip_smoke.serve_solo(h, "cuda"))
    before = HEAT1D_SWEEP.launches
    svc, hs = _serve_mixed_bucket("cuda", "heat1d", links["heat1d"], execution="fused")
    assert HEAT1D_SWEEP.launches - before == svc.metrics.chunks
    for h in hs:
        assert chip_smoke.served_equals_solo(h, chip_smoke.serve_solo(h, "cuda"))


@pytest.mark.cuda
def test_obs_smoke_gate_on_the_card(tmp_path):
    """python -m repro_torch.obs --smoke on the card (its default device)."""
    _need_card()
    from repro_torch.obs.__main__ import main

    assert main(["--smoke", "--out", str(tmp_path / "obs")]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["heat1d", "swe2d"])
@pytest.mark.parametrize("execution", ["reference", "fused", "megakernel"])
def test_obs_is_passive_on_the_card(name, execution):
    """rr_tracked with repro_torch.obs on and off: the same bits on the card."""
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke
    import repro_torch.obs as obs
    from repro_torch.pde import Simulation

    sim = Simulation(name, chip_smoke.link_configs()[name], chip_smoke.ladder()["rr_tracked"])
    off = sim.run(40, snapshot_every=8, execution=execution)
    scope = obs.enable()
    try:
        on = sim.run(40, snapshot_every=8, execution=execution)
    finally:
        obs.disable()
    assert len(scope.telemetry) > 0
    assert chip_smoke.same_tree(off.state, on.state) and chip_smoke.same_tree(off.tracker, on.tracker)
    assert chip_smoke.same_bits(off.snapshots.cpu(), on.snapshots.cpu())
