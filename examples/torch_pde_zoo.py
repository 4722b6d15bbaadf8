"""The registered PDE scenario zoo on the PyTorch/CUDA port, one precision
ladder each, as ``examples/pde_zoo.py`` runs it on the JAX package.

    PYTHONPATH=src python examples/torch_pde_zoo.py [--steppers a,b] [--ensemble N] [--profile]
        [--execution reference|fused|megakernel|auto] [--steps N] [--device cpu]

Every workload goes through the shared ``repro_torch.pde.Simulation``: f32
reference, the failing E5M10 baseline, 16-bit R2F2, and a tracked R2F2 run
whose final per-site splits are printed (the paper's precision-adjust unit
carried across the whole simulation). The scenarios are the port's
configurations (``repro_torch/configs``: shapes, horizons, the swe2d
correlation verdict against its resting depth); ``--steps`` overrides every
horizon.

``--profile`` also captures each scenario's range distributions on the f32
run and prints the ``repro_torch.profile`` RangeReport and the splits the
policy autotuner would deploy. ``--ensemble N`` also runs an N-member
ensemble of scaled initial conditions through ``run_ensemble`` (on the
kernel planes, one launch a chunk for every member) and prints each
member's verdict against the member run alone in f32.

Runs on the CUDA card unless ``--device cpu`` is given.
"""

import argparse
import dataclasses
import importlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.pde import Simulation, get_stepper, known_steppers
from repro_torch.precision import PRESETS

TRACKED = dataclasses.replace(PRESETS["r2f2_16"], mode="rr_tracked")


class Scenario(NamedTuple):
    cfg: object
    steps: int
    judge: str = "rel"
    offset: float = 0.0


def scenarios():
    """The port's configurations and horizons, keyed by stepper name."""
    def config(name):
        return importlib.import_module(f"repro_torch.configs.{name}")

    heat1d, swe2d = config("heat1d"), config("swe2d")
    table = {"heat1d": Scenario(heat1d.CONFIG, heat1d.BENCH_STEPS["sin"])}
    for name in ("heat2d", "advection1d", "burgers1d"):
        table[name] = Scenario(config(name).CONFIG, config(name).BENCH_STEPS)
    table["swe2d"] = Scenario(swe2d.CONFIG, swe2d.BENCH_STEPS, "corr", swe2d.CONFIG.depth)
    return table


def observe(stepper, cfg, state, offset=0.0):
    """A run's observable as a numpy array, its background removed."""
    return stepper.observables(state, cfg).cpu().numpy() - offset


def measure(out, ref, judge="rel"):
    """finite / rel L2 / corr / correct, the benchmark's verdict."""
    finite = bool(np.isfinite(out).all())
    rel = corr = float("nan")
    if finite:
        rel = float(np.linalg.norm(out - ref) / np.linalg.norm(ref))
        corr = float(np.corrcoef(out.reshape(-1), ref.reshape(-1))[0, 1])
    return dict(rel=rel, corr=corr, finite=finite, correct=finite and (corr > 0.98 if judge == "corr" else rel < 0.1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steppers", default=None, help="comma-separated subset")
    ap.add_argument("--ensemble", type=int, default=0, help="ensemble size")
    ap.add_argument("--execution", default="reference", choices=("reference", "fused", "megakernel", "auto"))
    ap.add_argument("--profile", action="store_true", help="capture the f32 run's ranges and autotune splits")
    ap.add_argument("--steps", type=int, default=None, help="every scenario's horizon (default: its own)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    names = args.steppers.split(",") if args.steppers else known_steppers()
    table = scenarios()
    dev = args.device
    out = {}

    for name in names:
        stepper = get_stepper(name)
        sc = table.get(name) or Scenario(stepper.default_config(), 400)  # a registered stepper runs on defaults
        steps = args.steps or sc.steps
        print(f"\n=== {name} [{stepper.failure_mode}] — {stepper.story} (execution={args.execution}, {dev})")
        ref, rows = None, {}
        for prec_name, prec in (("f32", PRESETS["f32"]), ("e5m10", PRESETS["e5m10"]), ("r2f2_16", PRESETS["r2f2_16"]),
                                ("rr_tracked", TRACKED)):
            sim = Simulation(name, sc.cfg, prec, device=dev)
            res = sim.run(steps, execution=args.execution)
            obs = observe(stepper, sim.cfg, res.state, sc.offset)
            if ref is None:
                ref = obs
                print(f"  {prec_name:11s} reference |max|={np.abs(ref).max():.4g}")
                continue
            m = rows[prec_name] = measure(obs, ref, sc.judge)
            if not m["finite"]:
                print(f"  {prec_name:11s} DESTROYED (NaN/inf)")
                continue
            line = f"  {prec_name:11s} rel L2 {m['rel']:.5f}"
            if sc.judge == "corr":
                line += f" corr {m['corr']:.4f}"
            line += "" if m["correct"] else "  [WRONG]"
            if res.tracker is not None:
                line += f"   final splits { {n: int(res.tracker.k(n)) for n in res.tracker.names} }"
            print(line)
        out[name] = rows

        if args.profile:
            from repro_torch.profile import capture_profile, synthesize_policy

            profile, _ = capture_profile(name, sc.cfg, steps=steps, device=dev,
                                         execution=args.execution if args.execution != "auto" else "reference")
            print("  " + profile.report().summary().replace("\n", "\n  "))
            pol = synthesize_policy(profile)
            print("  autotuned splits: " + ", ".join(f"{n}: k={d['k']} [{d['k_lo']},{d['k_hi']}]"
                                                     for n, d in pol.sites.items()))

        if args.ensemble:
            sim = Simulation(name, sc.cfg, TRACKED, device=dev)
            u0 = sim.stepper.init_state(sim.cfg, device=dev)
            scales = torch.linspace(0.5, 1.5, args.ensemble, dtype=torch.float32, device=dev)
            ens = sim.run_ensemble(scales.reshape((-1,) + (1,) * u0.dim()) * u0[None], steps, execution=args.execution)
            f32 = Simulation(name, sc.cfg, PRESETS["f32"], device=dev)
            verdicts = []
            for i in range(args.ensemble):
                alone = f32.run(steps, state0=scales[i] * u0, execution=args.execution)
                m = measure(observe(stepper, sim.cfg, ens.state[i], sc.offset),
                            observe(stepper, sim.cfg, alone.state, sc.offset), sc.judge)
                verdicts.append("CORRECT" if m["correct"] else ("DESTROYED" if not m["finite"] else "WRONG"))
            ks = {n: ens.tracker.k(n).tolist() for n in ens.tracker.names}
            print(f"  ensemble[{args.ensemble}] rr_tracked state {tuple(ens.state.shape)}: {verdicts}; "
                  f"final splits per member {ks}")
            out[name]["ensemble"] = verdicts
    return out


if __name__ == "__main__":
    main()
