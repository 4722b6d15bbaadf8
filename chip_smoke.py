#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # the full run
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only

Phases, each of which raises on failure (the script then exits non-zero):

1. the card, the software versions, and the build of the CUDA kernels from
   ``src/repro_torch/csrc`` (into ``build/kernels/``);
2. each kernel against its plain PyTorch version on the card, bit for bit
   with every NaN made canonical, across the precision families, carried
   splits (``k_floor``), pinned splits, evidence, and padded shapes;
3. the paper's experiment on the fused plane: heat1d (nx=128, 4000 steps)
   and swe2d (128x128, 400 steps) over the mode ladder, with the paper's
   verdicts and the kernels' launch counts asserted, and swe2d at 60 steps
   against the rows of ``artifacts/bench/BENCH_pde.json``;
4. the fused plane against the reference plane at the paper's sizes;
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


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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


# ---------------------------------------------------------------------------
# phase 3: the paper's ladder on the fused plane
# ---------------------------------------------------------------------------


def counters():
    from repro_torch.kernels.heat_stencil import HEAT1D_SWEEP
    from repro_torch.kernels.swe_flux import SWE_FLUX

    return {"heat1d_sweep": HEAT1D_SWEEP, "swe_flux_fused": SWE_FLUX}


def run_ladder(device, heat_steps, swe_steps, precs_by_case):
    """The fused-plane ladder. Returns rows and the launch totals read right
    after the loop (counters zeroed right before it)."""
    import numpy as np
    import torch

    from repro_torch.configs import heat1d as heat_cfg
    from repro_torch.configs import swe2d as swe_cfg
    from repro_torch.pde import Simulation

    L = ladder()
    plan = {
        "heat1d": (heat_cfg.CONFIG, heat_steps, "rel", 0.0),
        "swe2d": (swe_cfg.CONFIG, swe_steps, "corr", swe_cfg.CONFIG.depth),
    }
    refs = {}
    for case, (cfg, steps, _, offset) in plan.items():
        sim = Simulation(case, cfg, L["f32"], device=device)
        refs[case] = np.asarray(sim.stepper.observables(sim.run(steps).state, cfg).cpu()) - offset
    rows = []
    ctr = counters()
    for c in ctr.values():
        c.reset()
    for case, (cfg, steps, judge, offset) in plan.items():
        for prec_name in precs_by_case[case]:
            sim = Simulation(case, cfg, L[prec_name], device=device)
            before = {k: (c.launches, c.plain_calls) for k, c in ctr.items()}
            torch.cuda.synchronize() if device != "cpu" else None
            t0 = time.perf_counter()
            res = sim.run(steps, execution="fused")
            torch.cuda.synchronize() if device != "cpu" else None
            us = (time.perf_counter() - t0) * 1e6 / steps
            out = np.asarray(sim.stepper.observables(res.state, cfg).cpu()) - offset
            row = dict(case=case, prec=prec_name, us_per_step=us, steps=steps, **measure(out, refs[case], judge))
            row["launches"] = {k: c.launches - before[k][0] for k, c in ctr.items()}
            row["plain_calls"] = {k: c.plain_calls - before[k][1] for k, c in ctr.items()}
            if res.tracker is not None:
                row["adj"] = (int(res.tracker.state.overflow_steps.sum()), int(res.tracker.state.shrink_steps.sum()))
                row["k"] = res.tracker.state.k.tolist()
            rows.append(row)
    totals = {k: (c.launches, c.plain_calls) for k, c in ctr.items()}
    return rows, totals


def format_row(r) -> str:
    kern = "heat1d_sweep" if r["case"] == "heat1d" else "swe_flux_fused"
    derived = f"rel={r['rel']:.4f};corr={r['corr']:.4f};{r['status']};launches={r['launches'][kern]}"
    if "adj" in r:
        derived += f";adj=+{r['adj'][0]}/-{r['adj'][1]}"
    return f"pde/{r['case']}/{r['prec']}/fused,{r['us_per_step']:.1f},{derived}"


def check_ladder(rows, heat_steps, swe_steps):
    """The paper's verdicts and the launch contract of the main path."""
    by = {(r["case"], r["prec"]): r for r in rows}
    require(by[("swe2d", "e5m10")]["status"] == "DESTROYED(NaN)", "swe2d e5m10 is not destroyed")
    require(by[("swe2d", "r2f2_16")]["status"] == "CORRECT", "swe2d r2f2_16 is not correct")
    require(by[("swe2d", "r2f2_16")]["corr"] > 0.98, "swe2d r2f2_16 corr <= 0.98")
    require(by[("heat1d", "r2f2_16")]["status"] == "CORRECT", "heat1d r2f2_16 is not correct")
    require(by[("heat1d", "r2f2_16")]["rel"] < 0.1, "heat1d r2f2_16 rel >= 0.1")
    for r in rows:
        kern, want = ("heat1d_sweep", heat_steps // HEAT_CHUNK) if r["case"] == "heat1d" else ("swe_flux_fused", swe_steps)
        require(r["launches"][kern] == want, f"{r['case']}/{r['prec']}: {r['launches'][kern]} {kern} launches, want {want}")
        require(sum(r["plain_calls"].values()) == 0, f"{r['case']}/{r['prec']}: plain versions ran on the card")


def bench_rows():
    """swe2d fused rows of the committed CPU smoke run (60 steps)."""
    with open(BENCH_JSON) as f:
        data = json.load(f)
    out = {}
    for row in data["rows"]:
        parts = row["name"].split("/")
        if parts[1] == "swe2d" and parts[3] == "fused":
            fields = dict(kv.split("=", 1) for kv in row["derived"].split(";") if "=" in kv)
            out[parts[2]] = dict(rel=fields["rel"], adj=fields.get("adj"), status=row["derived"].split(";")[2])
    return out


def check_bench(rows):
    want = bench_rows()
    lines = []
    for r in rows:
        w = want.get(r["prec"])
        if w is None:
            continue
        rel = "nan" if r["rel"] != r["rel"] else f"{r['rel']:.4f}"
        adj = None if "adj" not in r else f"+{r['adj'][0]}/-{r['adj'][1]}"
        ok = rel == w["rel"] and adj == w["adj"] and r["status"] == w["status"]
        lines.append(f"swe2d 60 steps {r['prec']}: rel={rel} adj={adj} {r['status']} vs BENCH_pde.json rel={w['rel']} adj={w['adj']} {w['status']}: {'match' if ok else 'MISMATCH'}")
        log(lines[-1])
        require(ok, f"swe2d {r['prec']} at 60 steps disagrees with BENCH_pde.json")
    require(len(lines) >= 4, "too few swe2d rows matched BENCH_pde.json")
    return lines


# ---------------------------------------------------------------------------
# phase 4: fused against reference
# ---------------------------------------------------------------------------


def check_planes(device, heat_steps, swe_steps):
    from repro_torch.configs import heat1d as heat_cfg
    from repro_torch.configs import swe2d as swe_cfg
    from repro_torch.pde import Simulation

    L = ladder()
    out = []
    for case, cfg, steps in (("heat1d", heat_cfg.CONFIG, heat_steps), ("swe2d", swe_cfg.CONFIG, swe_steps)):
        for name in ("f32", "bf16", "e5m10", "r2f2_16", "deploy", "rr_tracked"):
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


# ---------------------------------------------------------------------------
# phase 5: times
# ---------------------------------------------------------------------------


def time_kernels(device, main_launches, errs, card):
    """Kernel, plain-version and bound times at the main path's shapes."""
    import torch

    from repro_torch.configs import heat1d as heat_cfg
    from repro_torch.kernels.heat_stencil import heat1d_sweep, heat1d_sweep_plain
    from repro_torch.kernels.swe_flux import swe_flux_fused, swe_flux_fused_plain
    from repro_torch.pde.heat1d import initial_condition

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

    def bound(nbytes, flops):
        tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
        return (tb, "bytes") if tb >= tf else (tf, "operations")

    recs = []
    specs = [
        ("heat1d_sweep", "src/repro/kernels/heat_stencil.py:65",
         lambda: heat1d_sweep(u, **hk), lambda: heat1d_sweep_plain(u, **hk), bound(heat_bytes, heat_flops), 20, 2,
         f"(1,128) r2f2_16, {HEAT_CHUNK} substeps per launch"),
        ("swe_flux_fused", "src/repro/kernels/swe_flux.py:51",
         lambda: swe_flux_fused(q1, q3, **sk), lambda: swe_flux_fused_plain(q1, q3, **sk), bound(swe_bytes, swe_flops), 200, 5,
         "(127,128) r2f2_16, one tile"),
    ]
    for name, replaces, kern, plain, (bound_ms, bound_by), reps, plain_reps, shape in specs:
        ms = cuda_time_ms(kern, reps)
        plain_ms = cuda_time_ms(plain, plain_reps)
        line = (f"time {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
                f"({bound_by}), library call: none [{card}]")
        log(line)
        recs.append(dict(
            name=name, route="cuda", source="src/repro_torch/csrc/fused_pde.cu", replaces=replaces,
            launches=main_launches[name], max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        ))
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
    log(f"build: {lib.name} in {build_s:.1f} s (nvcc {' '.join(_cuda.NVCC_FLAGS)})")
    log_path = lib.with_suffix(".log")
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")
    report["build_s"] = build_s

    errs, records = check_kernels(device, 100 if quick else HEAT_CHUNK)
    report["kernel_checks"] = records
    if quick:
        log(card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
        return 0

    heat_steps, swe_steps = 4000, 400
    six = ("f32", "bf16", "e5m10", "r2f2_16", "rr_tracked", "deploy")
    rows, totals = run_ladder(device, heat_steps, swe_steps, {"heat1d": six, "swe2d": six + ("r2f2_16_384",)})
    for r in rows:
        log(format_row(r))
    check_ladder(rows, heat_steps, swe_steps)
    main_launches = {k: v[0] for k, v in totals.items()}
    log(f"main path launches: {main_launches}; plain-version calls: { {k: v[1] for k, v in totals.items()} }")
    require(all(v > 0 for v in main_launches.values()), "a kernel of the main path never launched")
    require(all(v[1] == 0 for v in totals.values()), "plain versions ran on the main path")
    report["ladder"] = rows

    bench, _ = run_ladder(device, heat_steps, 60, {"heat1d": (), "swe2d": ("e5m10", "r2f2_16", "r2f2_16_384", "bf16", "rr_tracked")})
    report["bench_compare"] = check_bench(bench)
    report["planes"] = check_planes(device, 1000, swe_steps)

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
