#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only

Phases, each of which raises on failure (the script then exits non-zero):

1. the card, the software versions, and the build of the CUDA kernels from
   ``src/repro_torch/csrc`` (into ``build/kernels/``);
2. each kernel against its plain PyTorch version on the card, bit for bit
   with every NaN made canonical: K2 and K3 across the precision families,
   carried splits (``k_floor``), pinned splits, evidence, and padded shapes;
   K4 (both megakernels) over the mode ladder at full width, with evolving,
   growing, pinned and bounded trackers, snapshots and evidence; K5 (the
   fused sweeps and megakernels of heat2d, advection1d and burgers1d) the
   same way at full width;
3. the paper's experiment on the fused plane, then on the megakernel plane
   and through ``execution="auto"``: heat1d (nx=128, 4000 steps), swe2d
   (128x128, 400 steps), heat2d (64x64, 1500 steps), advection1d (nx=256,
   256 steps) and burgers1d (nx=256, 1200 steps) over the mode ladder, with
   the paper's verdicts and each plane's launch counts asserted (counts
   zeroed right before each ladder), and swe2d, heat2d, advection1d and
   burgers1d at 60 steps against the rows of
   ``artifacts/bench/BENCH_pde.json`` on both planes;
4. the fused plane against the reference plane (the reference plane at a
   cut depth), and the megakernel plane against the fused plane at the
   full horizons;
5. kernel times (CUDA events) beside their bounds and the plain versions.

It prints the card's name and power limit, then one JSON line of kernel
records, then ``{"ok": true, "device": {...}}`` as its last line. Details go
to ``chiprun_out/chip_smoke.json``. It imports nothing of JAX or ``repro``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

#: H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and f32 FLOP/s
#: outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
HEAT_CHUNK = 500  # substeps per fused chunk on the main path (4000 // 8)
SWE_EVERY = 100  # the swe2d snapshot cadence on the main path (400 // 4)
#: the workloads of kernel K5 and the split each pins at without starving a
#: product (heat2d's flux fits k=2; a 1e5 pulse and u*u ~ 1.2e5 need k=3)
K5_CASES = ("heat2d", "advection1d", "burgers1d")
K5_PINNED_K = {"heat2d": 2, "advection1d": 3, "burgers1d": 3}
#: every workload's horizon on the main path (its BENCH_STEPS)
MAIN_STEPS = {"heat1d": 4000, "swe2d": 400, "heat2d": 1500, "advection1d": 256, "burgers1d": 1200}
BENCH_JSON = os.path.join(ROOT, "artifacts", "bench", "BENCH_pde.json")
OUT_DIR = os.path.join(ROOT, "chiprun_out")


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def ladder():
    """The paper's mode ladder: the six modes, plus the 384-exponent R2F2
    preset the swe2d bench rows carry."""
    from repro_torch.core.policy import PRESETS

    return {
        "f32": PRESETS["f32"],
        "bf16": PRESETS["bf16"],
        "e5m10": PRESETS["e5m10"],
        "r2f2_16": PRESETS["r2f2_16"],
        "rr_tracked": dataclasses.replace(PRESETS["r2f2_16"], mode="rr_tracked"),
        "deploy": PRESETS["deploy"],
        "r2f2_16_384": PRESETS["r2f2_16_384"],
    }


def canon_bits(t):
    """Raw f32 bits with every NaN mapped to one pattern (CUDA and x86 make
    different NaNs)."""
    import torch

    b = t.detach().to(torch.float32).contiguous().view(torch.int32).clone()
    b[torch.isnan(t)] = 0x7FC00000
    return b


def same_bits(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return a.shape == b.shape and bool((canon_bits(a) == canon_bits(b)).all())


def max_abs_err(a, b) -> float:
    import torch

    both = torch.isfinite(a) & torch.isfinite(b)
    if not bool(both.any()):
        return 0.0
    return float((a[both].double() - b[both].double()).abs().max())


def measure(out, ref, judge):
    """The bench's verdict: finite, rel L2, corr, and the paper's gate."""
    import numpy as np

    finite = bool(np.isfinite(out).all())
    if finite:
        rel = float(np.linalg.norm(out - ref) / np.linalg.norm(ref))
        corr = float(np.corrcoef(out.reshape(-1), ref.reshape(-1))[0, 1])
    else:
        rel = corr = float("nan")
    ok = finite and (corr > 0.98 if judge == "corr" else rel < 0.1)
    status = "DESTROYED(NaN)" if not finite else ("CORRECT" if ok else "WRONG")
    return dict(rel=rel, corr=corr, status=status)


def cuda_time_ms(fn, reps: int, warmup: int = 1):
    """Mean ms per call over ``reps`` calls after ``warmup`` calls, and the
    last call's result."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    require(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def heat_cases(device, steps):
    """(label, input, kwargs) for kernel K2: the main path's (1, 128) row,
    then padded row blocks."""
    import torch

    from repro_torch.configs import heat1d as heat_cfg
    from repro_torch.pde.heat1d import initial_condition

    cfg = heat_cfg.CONFIG
    L = ladder()
    u = initial_condition(cfg, device=device)[None, :]
    g = torch.Generator().manual_seed(0)
    rows5 = (torch.randn(5, 64, generator=g) * 300.0).to(device)
    rows5[:, 0] = 0.0
    rows5[:, -1] = 0.0
    rows5[3] = 0.0  # an all-zero row: block max exponent -127 on its block
    base = dict(alpha=cfg.alpha, dtodx2=cfg.dtodx2, steps=steps, block_rows=1)
    cases = []
    for name in ("f32", "bf16", "e5m10", "r2f2_16", "r2f2_16_384"):
        cases.append((f"{name} (1,128) ev", u, dict(base, prec=L[name], collect_evidence=True)))
    floor = torch.tensor([2, 1], dtype=torch.int32, device=device)
    cases.append(("rr_tracked (1,128) k_floor ev", u, dict(base, prec=L["rr_tracked"], k_floor=floor, collect_evidence=True)))
    pinned = dataclasses.replace(L["rr_tracked"], pinned=True)
    cases.append(("rr_tracked pinned k=3,3 (1,128)", u, dict(base, prec=pinned, k_floor=torch.tensor([3, 3], dtype=torch.int32, device=device))))
    cases.append(("deploy (1,128) k_floor ev", u, dict(base, prec=L["deploy"], k_floor=floor, collect_evidence=True)))
    pad = dict(base, block_rows=2, steps=min(steps, 100))
    for name in ("r2f2_16", "e5m10", "bf16"):
        cases.append((f"{name} (5,64) block_rows=2 ev", rows5, dict(pad, prec=L[name], collect_evidence=True)))
    return cases


def swe_cases(device):
    """(label, q1, q3, kwargs) for kernel K3: the main path's (127, 128)
    x-midpoint fields in one tile, then padded tilings."""
    import torch

    L = ladder()
    g = torch.Generator().manual_seed(1)
    q3 = (500.0 + 100.0 * torch.rand(127, 128, generator=g)).to(device)
    q1 = (40.0 * torch.randn(127, 128, generator=g)).to(device)
    q1_zero = torch.zeros_like(q1)
    ev4 = dict(collect_evidence=True)
    cases = []
    for name in ("f32", "bf16", "e5m10", "r2f2_16", "r2f2_16_384", "deploy"):
        cases.append((f"{name} (127,128) ev", q1, q3, dict(prec=L[name], **ev4)))
    floor = torch.tensor([3, 2, 1, 3], dtype=torch.int32, device=device)
    cases.append(("rr_tracked (127,128) k_floor ev", q1, q3, dict(prec=L["rr_tracked"], k_floor=floor, **ev4)))
    pinned = dataclasses.replace(L["rr_tracked"], pinned=True)
    cases.append(("rr_tracked pinned (127,128)", q1, q3, dict(prec=pinned, k_floor=torch.full((4,), 3, dtype=torch.int32, device=device))))
    cases.append(("r2f2_16 zero momentum (127,128) ev", q1_zero, q3, dict(prec=L["r2f2_16"], **ev4)))
    blocks = dataclasses.replace(L["r2f2_16"], kernel_blocks=(64, 128, 128))
    cases.append(("r2f2_16 (127,128) blocks (64,128) ev", q1, q3, dict(prec=blocks, **ev4)))
    cases.append(("e5m10 (100,96) block (64,64) ev", q1[:100, :96], q3[:100, :96], dict(prec=L["e5m10"], block=(64, 64), **ev4)))
    cases.append(("r2f2_16 (100,96) block (64,64) ev", q1[:100, :96], q3[:100, :96], dict(prec=L["r2f2_16"], block=(64, 64), **ev4)))
    return cases


def check_kernels(device, heat_steps):
    """Every K2/K3 case: kernel output and evidence bit-equal to the plain
    version on the same device. Returns per-kernel max abs error."""
    from repro_torch.kernels.heat_stencil import heat1d_sweep, heat1d_sweep_plain
    from repro_torch.kernels.swe_flux import swe_flux_fused, swe_flux_fused_plain

    records = []
    errs = {"heat1d_sweep": 0.0, "swe_flux_fused": 0.0}
    for label, u, kw in heat_cases(device, heat_steps):
        got, ev = heat1d_sweep(u, **kw)
        want, ev_want = heat1d_sweep_plain(u, **kw)
        ok = same_bits(got, want) and (ev is None) == (ev_want is None) and (ev is None or same_bits(ev, ev_want))
        err = max_abs_err(got, want)
        errs["heat1d_sweep"] = max(errs["heat1d_sweep"], err)
        log(f"K2 heat1d_sweep {label} steps={kw['steps']}: {'bit-exact' if ok else 'MISMATCH'} max_abs_err={err}")
        records.append(dict(kernel="heat1d_sweep", case=label, ok=ok, max_abs_err=err))
        require(ok, f"heat1d_sweep disagrees with its plain version: {label}")
    for label, q1, q3, kw in swe_cases(device):
        got, ev = swe_flux_fused(q1, q3, **kw)
        want, ev_want = swe_flux_fused_plain(q1, q3, **kw)
        ok = same_bits(got, want) and (ev is None) == (ev_want is None) and (ev is None or same_bits(ev, ev_want))
        err = max_abs_err(got, want)
        errs["swe_flux_fused"] = max(errs["swe_flux_fused"], err)
        log(f"K3 swe_flux_fused {label}: {'bit-exact' if ok else 'MISMATCH'} max_abs_err={err}")
        records.append(dict(kernel="swe_flux_fused", case=label, ok=ok, max_abs_err=err))
        require(ok, f"swe_flux_fused disagrees with its plain version: {label}")
    return errs, records


def mega_cases(device):
    """(kernel, label, input, kwargs) for kernel K4 at full width: heat1d's
    (128,) rod at 120 substeps with every=50 and swe2d's (3, 128, 128)
    state at 12 substeps with every=5 (each a remainder after the last
    snapshot), over the ladder and with evolving, growing (k0=0), pinned
    and bounded trackers."""
    from repro_torch.configs import heat1d as heat_cfg
    from repro_torch.configs import swe2d as swe_cfg
    from repro_torch.core.policy import tracker_init
    from repro_torch.pde.heat1d import initial_condition
    from repro_torch.pde.swe2d import initial_state
    from repro_torch.precision import get_engine

    L = ladder()
    hcfg, scfg = heat_cfg.CONFIG, swe_cfg.CONFIG
    u = initial_condition(hcfg, device=device)
    U = initial_state(scfg, device=device)
    sites = {"heat1d": ("heat.flux", "heat.update"), "swe2d": ("swe.q1q1", "swe.q3q3", "swe.gq3", "swe.div")}
    base = {
        "heat1d": dict(alpha=hcfg.alpha, dtodx2=hcfg.dtodx2, steps=120, every=50, sites=sites["heat1d"]),
        "swe2d": dict(cfg=scfg, steps=12, every=5, sites=sites["swe2d"], site_ops=("mul", "mul", "mul", "div")),
    }
    state = {"heat1d": u, "swe2d": U}
    tracked = L["rr_tracked"]
    cases = []
    for kern in ("heat1d", "swe2d"):
        n = len(sites[kern])
        pinned_k = 2 if kern == "heat1d" else 3  # swe2d's h*h needs k=3
        extra = {
            "rr_tracked k0=0": (tracked, 0),
            f"rr_tracked pinned k={pinned_k}": (dataclasses.replace(tracked, pinned=True), pinned_k),
            "rr_tracked k_bounds (1,2)": (dataclasses.replace(tracked, k_bounds=((1, 2),) * n), None),
        }
        for name, prec in L.items():
            trk = tracker_init(n, prec.fmt, device=device) if get_engine(prec).tracks else None
            cases.append((kern, name, state[kern], dict(base[kern], prec=prec, tracker=trk, collect_evidence=True)))
        for name, (prec, k0) in extra.items():
            trk = tracker_init(n, prec.fmt, k0=k0, device=device)
            cases.append((kern, name, state[kern], dict(base[kern], prec=prec, tracker=trk, collect_evidence=True)))
    return cases


def check_mega(device):
    """Every K4 case: state, snapshots, evidence and every tracker field
    bit-equal to ``mega_sweep_plain`` on the same device."""
    from repro_torch.kernels.mega import heat1d_mega, swe2d_mega

    entry = {"heat1d": heat1d_mega, "swe2d": swe2d_mega}
    records = []
    errs = {"heat1d_mega": 0.0, "swe2d_mega": 0.0}
    for kern, label, x, kw in mega_cases(device):
        got = entry[kern](x, **kw)
        want = entry[kern](x, plain=True, **kw)
        ok = same_bits(got.state, want.state) and same_bits(got.snaps, want.snaps)
        ok = ok and same_bits(got.evidence, want.evidence)
        if want.tracker is not None:
            ok = ok and all(same_bits(a.float(), b.float()) for a, b in zip(got.tracker, want.tracker))
        err = max(max_abs_err(got.state, want.state), max_abs_err(got.snaps, want.snaps))
        name = f"{kern}_mega"
        errs[name] = max(errs[name], err)
        trk = "" if got.tracker is None else f" k={got.tracker.k.tolist()} adj=+{int(got.tracker.overflow_steps.sum())}/-{int(got.tracker.shrink_steps.sum())}"
        log(f"K4 {name} {label} steps={kw['steps']} every={kw['every']}: {'bit-exact' if ok else 'MISMATCH'} max_abs_err={err}{trk}")
        records.append(dict(kernel=name, case=label, ok=ok, max_abs_err=err))
        require(ok, f"{name} disagrees with its plain version: {label}")
    return errs, records


def k5_workload(case, device):
    """One K5 workload at full width: its config, initial state, the
    physical arguments its kernels take, its sites and its entry points."""
    from repro_torch.configs import advection1d, burgers1d, heat2d
    from repro_torch.kernels import mega, pde_steps
    from repro_torch.pde import get_stepper

    cfg = {"heat2d": heat2d, "advection1d": advection1d, "burgers1d": burgers1d}[case].CONFIG
    args = {
        "heat2d": lambda: dict(alpha=cfg.alpha, dtodx2=cfg.dtodx2),
        "advection1d": lambda: dict(speed=cfg.speed, dtodx=cfg.dtodx),
        "burgers1d": lambda: dict(dt=cfg.dt, dx=cfg.dx),
    }[case]()
    stepper = get_stepper(case)
    return dict(
        cfg=cfg, state=stepper.init_state(cfg, device=device), args=args, sites=stepper.sites,
        sweep=getattr(pde_steps, f"{case}_sweep"), plain=getattr(pde_steps, f"{case}_sweep_plain"),
        mega=getattr(mega, f"{case}_mega"),
    )


#: phase 2's K5 depths: fused substeps, and megakernel (substeps, every) with
#: a remainder after the last snapshot (the plain versions take ~13 ms a
#: substep on the card)
K5_CHECK_STEPS = {"heat2d": (40, (45, 20)), "advection1d": (64, (70, 30)), "burgers1d": (80, (90, 40))}


def k5_cases(device):
    """(kernel, label, input, entry kwargs) for K5a-f at full width: the
    fused sweeps across the families with evidence, carried floors (k0=0
    too), pinned and deploy splits; the megakernels over the ladder with
    evolving, growing (k0=0), pinned and bounded trackers."""
    import torch

    from repro_torch.core.policy import tracker_init
    from repro_torch.precision import get_engine

    L = ladder()
    tracked = L["rr_tracked"]
    pinned = dataclasses.replace(tracked, pinned=True)
    cases = []
    for case in K5_CASES:
        w = k5_workload(case, device)
        sweep_steps, (mega_steps, every) = K5_CHECK_STEPS[case]
        base = dict(w["args"], steps=sweep_steps, sites=w["sites"])
        u, pk = w["state"], K5_PINNED_K[case]

        def floor(*ks):
            return torch.tensor(ks, dtype=torch.int32, device=device)

        for name in ("f32", "bf16", "e5m10", "r2f2_16", "r2f2_16_384"):
            cases.append((f"{case}_sweep", f"{name} ev", u, dict(base, prec=L[name], collect_evidence=True)))
        cases.append((f"{case}_sweep", "rr_tracked k_floor=2,1 ev", u, dict(base, prec=tracked, k_floor=floor(2, 1), collect_evidence=True)))
        cases.append((f"{case}_sweep", "rr_tracked k_floor=0,0 ev", u, dict(base, prec=tracked, k_floor=floor(0, 0), collect_evidence=True)))
        cases.append((f"{case}_sweep", f"rr_tracked pinned k={pk}", u, dict(base, prec=pinned, k_floor=floor(pk, pk))))
        cases.append((f"{case}_sweep", "deploy k_floor=2,1 ev", u, dict(base, prec=L["deploy"], k_floor=floor(2, 1), collect_evidence=True)))

        mbase = dict(w["args"], steps=mega_steps, every=every, sites=w["sites"], collect_evidence=True)
        for name, prec in L.items():
            trk = tracker_init(2, prec.fmt, device=device) if get_engine(prec).tracks else None
            cases.append((f"{case}_mega", name, u, dict(mbase, prec=prec, tracker=trk)))
        extra = {
            "rr_tracked k0=0": (tracked, 0),
            f"rr_tracked pinned k={pk}": (pinned, pk),
            "rr_tracked k_bounds (1,2)": (dataclasses.replace(tracked, k_bounds=((1, 2),) * 2), None),
        }
        for name, (prec, k0) in extra.items():
            cases.append((f"{case}_mega", name, u, dict(mbase, prec=prec, tracker=tracker_init(2, prec.fmt, k0=k0, device=device))))
    return cases


def check_k5(device):
    """Every K5 case: state, evidence and (megakernels) snapshots and every
    tracker field bit-equal to the plain version on the same device."""
    workloads = {case: k5_workload(case, device) for case in K5_CASES}
    records = []
    errs = {f"{case}_{kind}": 0.0 for case in K5_CASES for kind in ("sweep", "mega")}
    for kern, label, x, kw in k5_cases(device):
        case, kind = kern.rsplit("_", 1)
        w = workloads[case]
        if kind == "sweep":
            got, ev = w["sweep"](x, **kw)
            want, ev_want = w["plain"](x, **kw)
            ok = same_bits(got, want) and same_bits(ev, ev_want)
            err, trk = max_abs_err(got, want), ""
        else:
            got, want = w["mega"](x, **kw), w["mega"](x, plain=True, **kw)
            ok = same_bits(got.state, want.state) and same_bits(got.snaps, want.snaps) and same_bits(got.evidence, want.evidence)
            if want.tracker is not None:
                ok = ok and all(same_bits(a.float(), b.float()) for a, b in zip(got.tracker, want.tracker))
            err = max(max_abs_err(got.state, want.state), max_abs_err(got.snaps, want.snaps))
            trk = "" if got.tracker is None else f" k={got.tracker.k.tolist()} adj=+{int(got.tracker.overflow_steps.sum())}/-{int(got.tracker.shrink_steps.sum())}"
        errs[kern] = max(errs[kern], err)
        every = f" every={kw['every']}" if "every" in kw else ""
        log(f"K5 {kern} {label} steps={kw['steps']}{every}: {'bit-exact' if ok else 'MISMATCH'} max_abs_err={err}{trk}")
        records.append(dict(kernel=kern, case=label, ok=ok, max_abs_err=err))
        require(ok, f"{kern} disagrees with its plain version: {label}")
    return errs, records


# ---------------------------------------------------------------------------
# phase 3: the paper's ladder on the fused and megakernel planes
# ---------------------------------------------------------------------------


def counters():
    from repro_torch.kernels import mega, pde_steps
    from repro_torch.kernels.heat_stencil import HEAT1D_SWEEP
    from repro_torch.kernels.swe_flux import SWE_FLUX

    return {
        "heat1d_sweep": HEAT1D_SWEEP, "swe_flux_fused": SWE_FLUX,
        "heat1d_mega": mega.HEAT1D_MEGA, "swe2d_mega": mega.SWE2D_MEGA,
        "heat2d_sweep": pde_steps.HEAT2D_SWEEP, "advection1d_sweep": pde_steps.ADVECTION1D_SWEEP,
        "burgers1d_sweep": pde_steps.BURGERS1D_SWEEP, "heat2d_mega": mega.HEAT2D_MEGA,
        "advection1d_mega": mega.ADVECTION1D_MEGA, "burgers1d_mega": mega.BURGERS1D_MEGA,
    }


def workload_config(case):
    """A workload's paper configuration (configs/), its verdict and the
    background its observable carries."""
    import importlib

    cfg = importlib.import_module(f"repro_torch.configs.{case}").CONFIG
    if case == "swe2d":
        return cfg, "corr", cfg.depth
    return cfg, "rel", 0.0


def run_ladder(device, steps_by_case, precs_by_case, execution="fused"):
    """The ladder on one plane, ``steps_by_case[case]`` steps per run.
    Returns rows and the launch totals read right after the loop (counters
    zeroed right before it)."""
    import numpy as np
    import torch

    from repro_torch.pde import Simulation

    L = ladder()
    plan = {case: (*workload_config(case), steps_by_case[case]) for case in precs_by_case}
    refs = {}
    for case, (cfg, _, offset, steps) in plan.items():
        sim = Simulation(case, cfg, L["f32"], device=device)
        refs[case] = np.asarray(sim.stepper.observables(sim.run(steps).state, cfg).cpu()) - offset
    rows = []
    ctr = counters()
    for c in ctr.values():
        c.reset()
    for case, (cfg, judge, offset, steps) in plan.items():
        for prec_name in precs_by_case[case]:
            sim = Simulation(case, cfg, L[prec_name], device=device)
            before = {k: (c.launches, c.plain_calls) for k, c in ctr.items()}
            torch.cuda.synchronize() if device != "cpu" else None
            t0 = time.perf_counter()
            res = sim.run(steps, execution=execution)
            torch.cuda.synchronize() if device != "cpu" else None
            us = (time.perf_counter() - t0) * 1e6 / steps
            out = np.asarray(sim.stepper.observables(res.state, cfg).cpu()) - offset
            row = dict(case=case, prec=prec_name, execution=execution, us_per_step=us, steps=steps, **measure(out, refs[case], judge))
            row["launches"] = {k: c.launches - before[k][0] for k, c in ctr.items()}
            row["plain_calls"] = {k: c.plain_calls - before[k][1] for k, c in ctr.items()}
            if res.tracker is not None:
                row["adj"] = (int(res.tracker.state.overflow_steps.sum()), int(res.tracker.state.shrink_steps.sum()))
                row["k"] = res.tracker.state.k.tolist()
            rows.append(row)
    totals = {k: (c.launches, c.plain_calls) for k, c in ctr.items()}
    return rows, totals


def plane_kernel(case, execution) -> str:
    """The counter that one run of ``case`` on a plane launches."""
    if execution == "fused":
        return "swe_flux_fused" if case == "swe2d" else f"{case}_sweep"
    return f"{case}_mega"


def snapshot_every(case, steps) -> int:
    """The snapshot interval a run of ``steps`` takes by default, as
    ``Simulation.run`` computes it from the stepper."""
    from repro_torch.pde import get_stepper

    return max(1, steps // get_stepper(case).snapshots_default)


def fused_launches(case, steps) -> int:
    """Fused-plane launches of one run: K3 once per swe2d step, every other
    sweep once per snapshot interval plus once for a remainder."""
    if case == "swe2d":
        return steps
    every = snapshot_every(case, steps)
    return steps // every + int(steps % every > 0)


def format_row(r) -> str:
    kern = plane_kernel(r["case"], r["execution"])
    derived = f"rel={r['rel']:.4f};corr={r['corr']:.4f};{r['status']};launches={r['launches'][kern]}"
    if "adj" in r:
        derived += f";adj=+{r['adj'][0]}/-{r['adj'][1]}"
    return f"pde/{r['case']}/{r['prec']}/{r['execution']},{r['us_per_step']:.1f},{derived}"


def check_ladder(rows):
    """The paper's verdicts (the thresholds of ``tests/test_pde.py`` and
    ``tests/test_pde_workloads.py``) and the launch contract of one plane:
    the fused plane launches its sweep once per chunk (K3 once per swe2d
    step); the megakernel plane (and ``auto``, which resolves to it)
    launches the workload's megakernel once per run. Every other kernel
    launches no time, and no plain version runs."""
    by = {(r["case"], r["prec"]): r for r in rows}
    require(by[("swe2d", "e5m10")]["status"] == "DESTROYED(NaN)", "swe2d e5m10 is not destroyed")
    require(by[("swe2d", "r2f2_16")]["status"] == "CORRECT", "swe2d r2f2_16 is not correct")
    require(by[("swe2d", "r2f2_16")]["corr"] > 0.98, "swe2d r2f2_16 corr <= 0.98")
    require(by[("heat1d", "r2f2_16")]["status"] == "CORRECT", "heat1d r2f2_16 is not correct")
    require(by[("heat1d", "r2f2_16")]["rel"] < 0.1, "heat1d r2f2_16 rel >= 0.1")
    require(by[("heat2d", "e5m10")]["rel"] > 1.0, "heat2d e5m10 rel <= 1: E5M10 did not freeze the decay")
    require(by[("heat2d", "r2f2_16")]["rel"] < 0.05, "heat2d r2f2_16 rel >= 0.05")
    for case in ("advection1d", "burgers1d"):
        require(by[(case, "e5m10")]["status"] == "DESTROYED(NaN)", f"{case} e5m10 is not destroyed")
        require(by[(case, "r2f2_16")]["rel"] < 0.05, f"{case} r2f2_16 is not finite with rel < 0.05")
    for r in rows:
        kern = plane_kernel(r["case"], r["execution"])
        want = fused_launches(r["case"], r["steps"]) if r["execution"] == "fused" else 1
        others = {k: v for k, v in r["launches"].items() if k != kern}
        require(r["launches"][kern] == want, f"{r['case']}/{r['prec']}/{r['execution']}: {r['launches'][kern]} {kern} launches, want {want}")
        require(not any(others.values()), f"{r['case']}/{r['prec']}/{r['execution']}: other kernels launched: {others}")
        require(sum(r["plain_calls"].values()) == 0, f"{r['case']}/{r['prec']}/{r['execution']}: plain versions ran on the card")


def bench_rows():
    """The 60-step rows of the committed CPU smoke run, by (case, prec, plane)."""
    with open(BENCH_JSON) as f:
        data = json.load(f)
    out = {}
    for row in data["rows"]:
        _, case, prec, plane = row["name"].split("/")
        fields = dict(kv.split("=", 1) for kv in row["derived"].split(";") if "=" in kv)
        out[case, prec, plane] = dict(rel=fields["rel"], adj=fields.get("adj"), status=row["derived"].split(";")[2])
    return out


#: 60-step rows whose rel-L2 sits at a rounding edge of the 4th decimal: the
#: port starts from its own initial state, which differs from repro's in the
#: last ulps (ROADMAP queue 3), and heat2d rr_tracked gives rel 4.988e-05 from
#: the port's state, 5.037e-05 from repro's (on the CPU, both planes), printed
#: 0.0000 against BENCH_pde.json's 0.0001
REL_EDGE_ROWS = {("heat2d", "rr_tracked")}


def check_bench(rows):
    """Each 60-step row against its BENCH_pde.json row: the verdict, the
    tracker's adjust counts and the rel-L2 as printed (4 decimals), all
    exactly, except on the rows of :data:`REL_EDGE_ROWS`."""
    want = bench_rows()
    lines = []
    for r in rows:
        w = want.get((r["case"], r["prec"], r["execution"]))
        if w is None:
            continue
        rel = "nan" if r["rel"] != r["rel"] else f"{r['rel']:.4f}"
        adj = None if "adj" not in r else f"+{r['adj'][0]}/-{r['adj'][1]}"
        if (r["case"], r["prec"]) in REL_EDGE_ROWS and "nan" not in (rel, w["rel"]):
            rel_ok = abs(float(rel) - float(w["rel"])) <= 1e-4 + 1e-9  # one unit of the 4th decimal
        else:
            rel_ok = rel == w["rel"]
        ok = rel_ok and adj == w["adj"] and r["status"] == w["status"]
        lines.append(f"{r['case']} 60 steps {r['execution']} {r['prec']}: rel={rel} adj={adj} {r['status']} vs BENCH_pde.json rel={w['rel']} adj={w['adj']} {w['status']}: {'match' if ok else 'MISMATCH'}")
        log(lines[-1])
        require(ok, f"{r['case']} {r['prec']} {r['execution']} at 60 steps disagrees with BENCH_pde.json")
    require(len(lines) >= len(rows), "a 60-step row has no BENCH_pde.json counterpart")
    return lines


# ---------------------------------------------------------------------------
# phase 4: fused against reference, megakernel against fused
# ---------------------------------------------------------------------------

SIX = ("f32", "bf16", "e5m10", "r2f2_16", "deploy", "rr_tracked")


def check_planes(device, steps_by_case):
    """The fused plane against the reference plane, six modes: state,
    snapshots and tracker bit-identical (rr_tracked, whose fused plane
    latches its floor per chunk: the same final k)."""
    from repro_torch.pde import Simulation

    L = ladder()
    out = []
    for case, steps in steps_by_case.items():
        cfg = workload_config(case)[0]
        for name in SIX:
            ref = Simulation(case, cfg, L[name], device=device).run(steps)
            fus = Simulation(case, cfg, L[name], device=device).run(steps, execution="fused")
            if name == "rr_tracked":
                ok = ref.tracker.state.k.tolist() == fus.tracker.state.k.tolist()
                what = f"final k {fus.tracker.state.k.tolist()} (reference {ref.tracker.state.k.tolist()})"
            else:
                ok = same_bits(ref.state, fus.state) and same_bits(ref.snapshots, fus.snapshots)
                if ref.tracker is not None:
                    ok = ok and all(same_bits(a.float(), b.float()) for a, b in zip(ref.tracker.state, fus.tracker.state))
                what = "state, snapshots" + (", tracker" if ref.tracker is not None else "") + " bit-identical"
            line = f"fused vs reference {case} {name} {steps} steps: {what}: {'ok' if ok else 'MISMATCH'}"
            log(line)
            out.append(line)
            require(ok, line)
    return out


def check_mega_planes(device, steps_by_case):
    """The megakernel plane against the fused plane at full horizons, six
    modes: state, snapshots and every tracker field bit-identical."""
    from repro_torch.pde import Simulation

    L = ladder()
    out = []
    for case, steps in steps_by_case.items():
        cfg = workload_config(case)[0]
        for name in SIX:
            sim = Simulation(case, cfg, L[name], device=device)
            fus, meg = sim.run(steps, execution="fused"), sim.run(steps, execution="megakernel")
            ok = same_bits(fus.state, meg.state) and same_bits(fus.snapshots, meg.snapshots)
            what = "state, snapshots"
            if fus.tracker is not None:
                ok = ok and all(same_bits(a.float(), b.float()) for a, b in zip(fus.tracker.state, meg.tracker.state))
                what += f", tracker (k {meg.tracker.state.k.tolist()})"
            line = f"megakernel vs fused {case} {name} {steps} steps: {what} bit-identical: {'ok' if ok else 'MISMATCH'}"
            log(line)
            out.append(line)
            require(ok, line)
    return out


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------


def swe_flops_per_substep(nx, ny) -> int:
    """f32 operations that one Lax-Wendroff step of ``pde/swe2d.py`` needs
    (an fma counts two; the policy's integer rounding work is not counted),
    each counted only where a later read or a block maximum uses it. The
    interior update reads Fx on columns 1..ny-2 and Gy on rows 1..nx-2; the
    block maxima read Ux's h and hu and both policy products everywhere.

    - mom(hu, h) (5) everywhere, for Ux's hu;
    - hu*hv/h (2), F's third and G's second component, everywhere but the
      corners (Ux's hv on inner columns, Uy on inner rows);
    - mom(hv, h) (5) on inner rows, for Uy's hv;
    - Ux: h and hu (5 each) everywhere, hv (5) on inner columns;
    - Uy: three half steps (5 each) on inner rows;
    - Fx: q1*q1 and q3*q3 (1 each) everywhere, the divide, the fma and
      hu*hv/h (5) on inner columns;
    - Gy: hu*hv/h and mom(hv, h) (7) on inner rows;
    - the interior update: two subtractions, two fmas per component (18).
    """
    n, nxm = nx * ny, (nx - 1) * ny
    ux_in, uy_in, nint = (nx - 1) * (ny - 2), (nx - 2) * (ny - 1), (nx - 2) * (ny - 2)
    fluxes = 5 * n + 2 * (n - 4) + 5 * (nx - 2) * ny
    half_steps = 10 * nxm + 5 * ux_in + 15 * uy_in
    midpoint_fluxes = 2 * nxm + 5 * ux_in + 7 * uy_in
    return fluxes + half_steps + midpoint_fluxes + 18 * nint


#: the TPU kernel each K5 kernel replaces: the fused sweep's entry in
#: repro/kernels/pde_steps.py (through fused.py:366), the megakernel's in mega.py
K5_REPLACES = {
    "heat2d_sweep": "src/repro/kernels/pde_steps.py:67", "advection1d_sweep": "src/repro/kernels/pde_steps.py:136",
    "burgers1d_sweep": "src/repro/kernels/pde_steps.py:204", "heat2d_mega": "src/repro/kernels/mega.py:526",
    "advection1d_mega": "src/repro/kernels/mega.py:548", "burgers1d_mega": "src/repro/kernels/mega.py:570",
}


def k5_flops_per_substep(case, shape) -> int:
    """f32 operations of one K5 substep, counted from its body (an fma counts
    two; the policy's integer rounding work is not counted):

    - heat2d, per interior cell: the three adds of the four neighbours,
      ``4*u`` and the subtraction, the two products and the update add (8);
    - advection1d, per cell: the flux product, the difference, the update
      product and the subtraction (4);
    - burgers1d, per cell: ``u*u``, ``0.5*uu``, the average's add and
      multiply, the flux difference, its product and the subtraction (7).
    """
    if case == "heat2d":
        return 8 * (shape[0] - 2) * (shape[1] - 2)
    return {"advection1d": 4, "burgers1d": 7}[case] * shape[-1]


def time_kernels(device, main_launches, errs, card):
    """Kernel, plain-version and bound times at the main path's shapes."""
    import torch

    from repro_torch.configs import heat1d as heat_cfg
    from repro_torch.configs import swe2d as swe_cfg
    from repro_torch.kernels.heat_stencil import heat1d_sweep, heat1d_sweep_plain
    from repro_torch.kernels.mega import heat1d_mega, swe2d_mega
    from repro_torch.kernels.swe_flux import swe_flux_fused, swe_flux_fused_plain
    from repro_torch.pde.heat1d import initial_condition
    from repro_torch.pde.swe2d import initial_state

    L = ladder()
    cfg = heat_cfg.CONFIG
    u = initial_condition(cfg, device=device)[None, :]
    hk = dict(alpha=cfg.alpha, dtodx2=cfg.dtodx2, prec=L["r2f2_16"], steps=HEAT_CHUNK, block_rows=1)
    g = torch.Generator().manual_seed(1)
    q3 = (500.0 + 100.0 * torch.rand(127, 128, generator=g)).to(device)
    q1 = (40.0 * torch.randn(127, 128, generator=g)).to(device)
    sk = dict(prec=L["r2f2_16"])

    n_int = u.shape[1] - 2
    heat_bytes = 2 * u.numel() * 4  # the row in, the row out
    heat_flops = HEAT_CHUNK * n_int * 6  # laplacian (3), two products, the update add
    swe_bytes = 3 * q1.numel() * 4  # q1, q3 in, flux out
    swe_flops = q1.numel() * 5  # three products, one quotient, one add

    # K4 at the main path's horizons: heat1d 4000 substeps with a snapshot
    # every 500, swe2d 400 with one every 100
    hsteps, ssteps = 4000, 400
    mk = dict(alpha=cfg.alpha, dtodx2=cfg.dtodx2, prec=L["r2f2_16"], steps=hsteps, every=HEAT_CHUNK,
              sites=("heat.flux", "heat.update"))
    scfg = swe_cfg.CONFIG
    U = initial_state(scfg, device=device)
    mk_swe = dict(cfg=scfg, prec=L["r2f2_16"], steps=ssteps, every=SWE_EVERY,
                  sites=("swe.q1q1", "swe.q3q3", "swe.gq3", "swe.div"), site_ops=("mul", "mul", "mul", "div"))
    u1 = u[0]
    heat_mega_bytes = (2 + hsteps // HEAT_CHUNK) * u1.numel() * 4  # rod in, rod out, snapshots
    heat_mega_flops = hsteps * n_int * 6
    swe_mega_bytes = (2 + ssteps // SWE_EVERY) * U.numel() * 4  # state in, state out, snapshots
    swe_mega_flops = ssteps * swe_flops_per_substep(scfg.nx, scfg.ny)

    def bound(nbytes, flops):
        tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    def same_result(a, b):
        """Kernel and plain outputs of one timed call, bit for bit."""
        if isinstance(a, tuple) and not hasattr(a, "state"):
            return all(same_bits(x, y) for x, y in zip(a, b))
        ok = same_bits(a.state, b.state) and same_bits(a.snaps, b.snaps) and same_bits(a.evidence, b.evidence)
        return ok and (a.tracker is None) == (b.tracker is None)

    # (name, source, replaces, kernel, plain, bound, kernel reps, plain reps,
    # plain warm-up calls, shape); the plain K4 runs once, cold, at the full
    # horizon (tens of seconds), and its result is held against the kernel's
    recs = []
    specs = [
        ("heat1d_sweep", "fused_pde.cu", "src/repro/kernels/heat_stencil.py:65",
         lambda: heat1d_sweep(u, **hk), lambda: heat1d_sweep_plain(u, **hk), bound(heat_bytes, heat_flops), 20, 2, 1,
         f"(1,128) r2f2_16, {HEAT_CHUNK} substeps per launch"),
        ("swe_flux_fused", "fused_pde.cu", "src/repro/kernels/swe_flux.py:51",
         lambda: swe_flux_fused(q1, q3, **sk), lambda: swe_flux_fused_plain(q1, q3, **sk), bound(swe_bytes, swe_flops), 200, 5, 1,
         "(127,128) r2f2_16, one tile"),
        ("heat1d_mega", "mega_pde.cu", "src/repro/kernels/mega.py:503",
         lambda: heat1d_mega(u1, **mk), lambda: heat1d_mega(u1, plain=True, **mk), bound(heat_mega_bytes, heat_mega_flops), 5, 1, 0,
         f"(128,) r2f2_16, one {hsteps}-substep horizon per launch"),
        ("swe2d_mega", "mega_pde.cu", "src/repro/kernels/mega.py:607",
         lambda: swe2d_mega(U, **mk_swe), lambda: swe2d_mega(U, plain=True, **mk_swe), bound(swe_mega_bytes, swe_mega_flops), 5, 1, 0,
         f"(3,128,128) r2f2_16, one {ssteps}-substep horizon per launch"),
    ]
    # K5 at the main path's shapes: a fused chunk of one snapshot interval,
    # and the whole horizon with a snapshot at every interval
    tracked = []
    for case in K5_CASES:
        w = k5_workload(case, device)
        x, steps = w["state"], MAIN_STEPS[case]
        every, n = snapshot_every(case, steps), w["state"].numel()
        flops = k5_flops_per_substep(case, tuple(x.shape))
        kw = dict(w["args"], prec=L["r2f2_16"], sites=w["sites"])
        fk, mk5 = dict(kw, steps=every), dict(kw, steps=steps, every=every)
        shape = "x".join(map(str, x.shape))
        specs += [
            (f"{case}_sweep", "pde_steps.cu", K5_REPLACES[f"{case}_sweep"],
             lambda w=w, x=x, fk=fk: w["sweep"](x, **fk), lambda w=w, x=x, fk=fk: w["plain"](x, **fk),
             bound(2 * n * 4, every * flops), 20, 2, 1, f"({shape}) r2f2_16, {every} substeps per launch"),
            (f"{case}_mega", "pde_steps.cu", K5_REPLACES[f"{case}_mega"],
             lambda w=w, x=x, mk5=mk5: w["mega"](x, **mk5), lambda w=w, x=x, mk5=mk5: w["mega"](x, plain=True, **mk5),
             bound((2 + steps // every) * n * 4, steps * flops), 5, 1, 0,
             f"({shape}) r2f2_16, one {steps}-substep horizon per launch"),
        ]
        tracked.append((f"{case}_mega", w["mega"], x, mk5, 2))
    for name, src, replaces, kern, plain, (bound_ms, bound_by), reps, plain_reps, plain_warmup, shape in specs:
        ms, got = cuda_time_ms(kern, reps)
        plain_ms, want = cuda_time_ms(plain, plain_reps, warmup=plain_warmup)
        ok = same_result(got, want)
        line = (f"time {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({plain_warmup} warm-up), "
                f"bound {bound_ms:.6f} ms ({bound_by}), library call: none; kernel vs plain of the timed calls: "
                f"{'bit-exact' if ok else 'MISMATCH'} [{card}]")
        log(line)
        require(ok, f"{name} disagrees with its plain version at the timed shape")
        recs.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}", replaces=replaces,
            launches=main_launches[name], max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        ))
    # the tracked horizons, for the record (the adjust unit ticks every substep)
    for name, fn, x, kw, n_sites in [("heat1d_mega", heat1d_mega, u1, mk, 2), ("swe2d_mega", swe2d_mega, U, mk_swe, 4)] + tracked:
        from repro_torch.core.policy import tracker_init

        kw = dict(kw, prec=L["rr_tracked"])
        trk = tracker_init(n_sites, kw["prec"].fmt, device=device)
        ms, _ = cuda_time_ms(lambda: fn(x, tracker=trk, **kw), 5)
        log(f"time {name} rr_tracked, one horizon: kernel {ms:.4f} ms [{card}]")
    return recs


# ---------------------------------------------------------------------------


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import _cuda
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable from {ROOT}/src: {exc}", file=sys.stderr)
        return 2
    quick = "--quick" in argv
    device = "cuda"
    t_start = time.perf_counter()
    report = {}

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    lib = _cuda.build()
    build_s = time.perf_counter() - t0
    _cuda.library()
    log(f"build: {lib.name} in {build_s:.1f} s ({_cuda.nvcc_version()}; nvcc {' '.join(_cuda.NVCC_FLAGS)})")
    log_path = lib.with_suffix(".log")
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill")):
                log(f"  ptxas: {line.strip()}")
    report["build_s"] = build_s

    errs, records = check_kernels(device, 100 if quick else HEAT_CHUNK)
    mega_errs, mega_records = check_mega(device)
    k5_errs, k5_records = check_k5(device)
    errs.update(mega_errs)
    errs.update(k5_errs)
    report["kernel_checks"] = records + mega_records + k5_records
    if quick:
        log(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
        return 0

    six = ("f32", "bf16", "e5m10", "r2f2_16", "rr_tracked", "deploy")
    plan = {case: six for case in MAIN_STEPS}
    plan["swe2d"] = six + ("r2f2_16_384",)
    main_launches = {}
    report["ladder"] = []
    for execution in ("fused", "megakernel", "auto"):
        kernels = [plane_kernel(case, execution) for case in MAIN_STEPS]
        rows, totals = run_ladder(device, MAIN_STEPS, plan, execution)
        for r in rows:
            log(format_row(r))
        check_ladder(rows)
        launches = {k: totals[k][0] for k in kernels}
        log(f"{execution} path launches: { {k: v[0] for k, v in totals.items()} }; plain-version calls: { {k: v[1] for k, v in totals.items()} }")
        require(all(v > 0 for v in launches.values()), f"a kernel of the {execution} path never launched")
        require(all(v[1] == 0 for v in totals.values()), f"plain versions ran on the {execution} path")
        if execution != "auto":
            main_launches.update(launches)
        report["ladder"] += rows

    four = ("e5m10", "r2f2_16", "bf16", "rr_tracked")
    bench_precs = {"swe2d": four + ("r2f2_16_384",), **{case: four for case in K5_CASES}}
    report["bench_compare"] = []
    for execution in ("fused", "megakernel"):
        bench, _ = run_ladder(device, {case: 60 for case in bench_precs}, bench_precs, execution)
        report["bench_compare"] += check_bench(bench)
    # the reference plane at a cut depth (heat1d 1000 of 4000 steps, heat2d
    # 300 of 1500, burgers1d 600 of 1200), the megakernel at the full horizons
    cut = {"heat1d": 1000, "swe2d": 400, "heat2d": 300, "advection1d": 256, "burgers1d": 600}
    report["planes"] = check_planes(device, cut) + check_mega_planes(device, MAIN_STEPS)

    recs = time_kernels(device, main_launches, errs, card)
    report["kernels"] = recs
    report["card"] = card
    report["seconds"] = time.perf_counter() - t_start
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    log(f"total {report['seconds']:.1f} s")
    log(card)
    print(json.dumps({"kernels": recs}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
