"""Headless service burst: submit a mixed burst, pump to idle, report.

    PYTHONPATH=src python -m repro_torch.service [--steppers a,b] [--per 2]
        [--precisions f32,r2f2_16,rr_tracked] [--steps 240]
        [--execution auto] [--max-bucket 8] [--smoke] [--device cpu]

Submits ``--per`` requests per (registered stepper x precision) with scaled
initial conditions: compatible members pack into shared buckets (the
occupancy line shows it), different precisions and steppers land in
sibling buckets. Then it drives the service to idle and prints one line per
request and the metrics report. The exit status is 0 only if every
admitted request completed. Runs on the CUDA card unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.pde import known_steppers

from .request import SimRequest, scaled_state0
from .scheduler import ServiceConfig, SimService


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.service")
    ap.add_argument("--steppers", default=None, help="comma-separated subset")
    ap.add_argument("--per", type=int, default=2,
                    help="requests per (stepper, precision): bucket packing")
    ap.add_argument("--precisions", default="f32,r2f2_16,rr_tracked",
                    help="comma-separated presets/modes")
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--execution", default="auto",
                    choices=("auto", "reference", "fused", "megakernel"))
    ap.add_argument("--max-bucket", type=int, default=8)
    ap.add_argument("--smoke", action="store_true", help="a reduced burst")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    names = args.steppers.split(",") if args.steppers else known_steppers()
    steps = 48 if args.smoke else args.steps
    precs = ("f32", "rr_tracked") if args.smoke else tuple(args.precisions.split(","))

    svc = SimService(ServiceConfig(max_bucket=args.max_bucket, max_queue=1024), device=args.device)
    handles = []
    for name in names:
        for prec in precs:
            for i in range(args.per):
                handles.append(
                    svc.submit(
                        SimRequest(
                            name,
                            steps=steps,
                            precision=prec,
                            execution=args.execution,
                            state0=scaled_state0(name, 0.6 + 0.2 * i, device=svc.device),
                            tag=f"{name}/{prec}#{i}",
                        )
                    )
                )
    print(f"[service] submitted {len(handles)} requests "
          f"({len(names)} steppers x {len(precs)} precisions x {args.per}, "
          f"{steps} steps, execution={args.execution}, device={svc.device})")

    svc.run_until_idle()

    ok = True
    for h in handles:
        if h.status != "done":
            ok = False
            print(f"  {h.tag:24s} {h.status.upper()}")
            continue
        res = h.result()
        amax = max(
            (float(np.abs(s).max()) for s in res.snapshots), default=float("nan")
        )
        line = (f"  {h.tag:24s} done: {len(res.snapshots)} snapshots, "
                f"{res.chunks} chunks, |max|={amax:.4g}")
        if res.final_k is not None:
            line += f", k={res.final_k}"
        print(line)

    print()
    print(svc.metrics.report())
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
