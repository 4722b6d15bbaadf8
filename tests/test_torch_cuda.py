"""repro_torch on a CUDA card: the kernels against their plain versions,
the default device, execution="auto" on the megakernel (K4 for heat1d and
swe2d, K5 for heat2d, advection1d and burgers1d), the contraction path
through K6 and K7, K7's split launches against unsplit ones and K3's
thread-block clusters against the plain version. These tests skip
without a card; on the GPU machine, which has no JAX, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The file imports neither JAX nor repro."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc; chip_smoke.py runs these checks on the GPU")


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """Each CUDA kernel against its plain version on the same CUDA tensors,
    bit for bit with NaNs made canonical, over chip_smoke.py's case list."""
    _need_card()
    sys.path.insert(0, ROOT)
    import chip_smoke

    errs, records = chip_smoke.check_kernels("cuda", 50)
    mega_errs, mega_records = chip_smoke.check_mega("cuda")
    k5_errs, k5_records = chip_smoke.check_k5("cuda")
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
