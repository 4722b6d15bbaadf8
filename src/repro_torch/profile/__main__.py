"""One command from profile to deploy (the port of ``python -m repro.profile``).

    PYTHONPATH=src python -m repro_torch.profile <stepper> [--steps 400]
        [--execution both|reference|fused] [--capture-mode f32] [--tol 0.1]
        [--out artifacts/profile] [--smoke] [--device cuda|cpu]

1. capture a range profile of the stepper (the reference plane, and the
   fused plane too under ``both``/``fused``, with an exact histogram and
   evidence parity check between the two under ``both``);
2. print the RangeReport;
3. synthesize a PrecisionPolicy;
4. validate it (rr_tracked and static replays against the f32 oracle);
5. save the artifact, reload it from disk, and run a pinned ``deploy``
   simulation under it, checking that its rel-L2 reproduces the recorded one.

Exit status 0 only if the artifact was accepted and the deploy replay
reproduced; 2 otherwise. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from repro_torch.core.policy import PrecisionConfig

from .analysis import RangeProfile
from .artifact import PrecisionPolicy
from .autotune import _rel_l2, synthesize_policy, validate_policy
from .capture import CaptureSpec
from .pipeline import capture_profile


def _parity(a: RangeProfile, b: RangeProfile) -> bool:
    return bool(
        np.array_equal(a.evidence, b.evidence)
        and np.array_equal(a.exp_total, b.exp_total)
        and np.array_equal(a.exp_time, b.exp_time)
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.profile")
    ap.add_argument("stepper", help="registered PDE stepper name (e.g. heat1d)")
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--snapshot-every", type=int, default=None)
    ap.add_argument("--execution", default="both", choices=("both", "reference", "fused"),
                    help="capture plane(s); 'both' also checks histogram parity")
    ap.add_argument("--capture-mode", default="f32", help="precision mode the profiling run executes under")
    ap.add_argument("--tol", type=float, default=0.1, help="validation rel-L2 gate")
    ap.add_argument("--out", default="artifacts/profile", help="artifact directory")
    ap.add_argument("--smoke", action="store_true", help="reduced steps for a fast check")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    steps = 64 if args.smoke else args.steps
    cap_prec = PrecisionConfig(mode=args.capture_mode)
    spec = CaptureSpec()
    dev = args.device

    planes = {"both": ("reference", "fused"), "reference": ("reference",), "fused": ("fused",)}[args.execution]
    profiles = {}
    for plane in planes:
        profiles[plane], _ = capture_profile(
            args.stepper, steps=steps, prec=cap_prec, execution=plane, snapshot_every=args.snapshot_every,
            spec=spec, device=dev,
        )
        print(f"[profile] captured {args.stepper} ({steps} steps, {plane} execution)")
    if len(profiles) == 2:
        ok = _parity(profiles["reference"], profiles["fused"])
        print(f"[profile] reference/fused histogram+evidence parity: {'EXACT' if ok else 'MISMATCH'}")
        if not ok:
            return 2
    profile = profiles[planes[0]]

    report = profile.report()
    print()
    print(report.summary())
    print()

    policy = synthesize_policy(profile)
    stamp = validate_policy(policy, steps=steps, tol=args.tol, snapshot_every=args.snapshot_every, device=dev)
    print("[tune] per-site splits: "
          + ", ".join(f"{n}: k={d['k']} [{d['k_lo']},{d['k_hi']}]" for n, d in policy.sites.items()))
    print(f"[validate] rr_tracked rel-L2 {stamp['rel_l2_tracked']:.3e} | "
          f"static@k_hi rel-L2 {stamp['rel_l2_static']:.3e} (tol {args.tol}) | "
          f"deploy rel-L2 {stamp['rel_l2_deploy']:.3e} | {'ACCEPTED' if stamp['accepted'] else 'REJECTED'}")

    path = os.path.join(args.out, f"{args.stepper}_policy.json")
    policy.save(path)
    report_path = os.path.join(args.out, f"{args.stepper}_report.json")
    with open(report_path, "w") as f:
        json.dump(report.to_dict(), f, indent=2, sort_keys=True, default=str)
    print(f"[artifact] wrote {path} and {report_path}")

    loaded = PrecisionPolicy.load(path)
    from repro_torch.pde.solver import Simulation  # lazy: keep the module import light

    deploy_prec = PrecisionConfig(mode="deploy", fmt=loaded.fmt, ema=loaded.ema, headroom=loaded.headroom, pinned=True)
    sim = Simulation(args.stepper, None, deploy_prec, device=dev)
    res = sim.run(steps, snapshot_every=args.snapshot_every, policy=loaded)
    oracle = Simulation(args.stepper, None, PrecisionConfig(mode="f32", fmt=loaded.fmt), device=dev)
    ref = oracle.run(steps, snapshot_every=args.snapshot_every)
    rel = _rel_l2(
        sim.stepper.observables(res.state, sim.cfg), sim.stepper.observables(ref.state, sim.cfg),
        sim.stepper.metric_offset(sim.cfg),
    )
    recorded = loaded.validation["rel_l2_deploy"]
    reproduced = abs(rel - recorded) <= 1e-12 * max(1.0, abs(recorded))
    ks = {n: int(res.tracker.k(n)) for n in res.tracker.names} if res.tracker else {}
    print(f"[deploy] pinned run under loaded artifact: rel-L2 {rel:.3e} (validation recorded {recorded:.3e}) — "
          f"{'REPRODUCED' if reproduced else 'DRIFTED'} | static splits {ks}")
    return 0 if (stamp["accepted"] and reproduced) else 2


if __name__ == "__main__":
    sys.exit(main())
