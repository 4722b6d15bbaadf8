"""Serving quickstart on the PyTorch/CUDA port: a mixed burst through the
simulation service, as ``examples/pde_service.py`` runs it on the JAX package.

    PYTHONPATH=src python examples/torch_pde_service.py [--steps 240] [--smoke] [--trace [DIR]] [--health]
        [--device cpu]

The production loop end to end (DESIGN.md §11 and §12):

1. **autotune**: for each workload (heat2d, advection1d, burgers1d), run the
   ``repro_torch.profile`` pipeline once: capture the f32 range profile,
   synthesize a per-site ``PrecisionPolicy``, validate it in closed loop;
2. **serve**: submit a mixed burst to one ``repro_torch.service.SimService``:
   per workload an f32 oracle request, two ``rr_tracked`` requests at
   different scales of the initial state carrying the validated artifact
   (tracker seeded at the tuned splits, re-picks clamped to its ``[k_lo,
   k_hi]`` hints), and a **pinned deploy** request. The scheduler buckets
   compatible requests onto shared ``run_ensemble`` calls (one kernel launch
   a chunk for every member on the kernel planes);
3. **report**: per request, the snapshots streamed, the final splits and
   the rel-L2 of the final state against the f32 request of the same burst;
   then the service's metrics (throughput, p50/p99 chunk latency, bucket
   occupancy, the §5.3 adjust counters).

With ``--trace [DIR]`` (default ``artifacts/obs``) the burst runs under
``repro_torch.obs``: request lifecycle, chunk calls and CUDA dispatches are
spanned, and on exit the Chrome trace, the Prometheus text metrics and the
per-site precision telemetry are exported to DIR; print them with ``python
-m repro_torch.obs --dir DIR``. The served numerics are bit-identical with or
without it. Runs on the CUDA card unless ``--device cpu`` is given.

With ``--health`` the burst also runs under the
:mod:`repro_torch.obs.health` monitor (DESIGN.md §16): a deterministic shadow
sampler replays a fraction of the requests at f32 on the card and books the
rel-L2 drift into the error-budget metric, anomaly detectors watch the
precision telemetry and the streamed frames, and SLO rules watch the service
metrics. After the healthy burst the demo **deploys a stale artifact**, an
advection1d policy pinned at the starved split k=0, against traffic (pulse
amplitude ~1e5) whose dynamic range the artifact no longer matches: the
quantised states overflow, the ``overflow_storm`` detector fires, a
flight-recorder dump lands in ``artifacts/flightrec/``, and the process
exits 3 (the headless alerting contract: an alert is an
alarm).
"""

import argparse
import dataclasses
import sys

import numpy as np

import repro_torch.obs as obs
import repro_torch.obs.health as health
from repro_torch.core.policy import PrecisionConfig
from repro_torch.pde import AdvectionConfig, get_stepper
from repro_torch.precision import PRESETS
from repro_torch.profile import tune_policy
from repro_torch.service import ServiceConfig, SimRequest, SimService, scaled_state0

WORKLOADS = ("heat2d", "advection1d", "burgers1d")
TRACKED = dataclasses.replace(PRESETS["r2f2_16"], mode="rr_tracked")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=240)
    ap.add_argument("--smoke", action="store_true", help="reduced steps")
    ap.add_argument("--trace", nargs="?", const="artifacts/obs", default=None, metavar="DIR",
                    help="enable repro_torch.obs and export trace/metrics/telemetry artifacts to DIR "
                         "(default: artifacts/obs)")
    ap.add_argument("--health", action="store_true",
                    help="run under the repro_torch.obs.health monitor (shadow-oracle sampling, detectors, SLOs), "
                         "then deploy a starved pinned advection1d policy and watch the overflow-storm alert fire "
                         "(exits 3: the alarm working)")
    ap.add_argument("--workloads", default=",".join(WORKLOADS), help="comma-separated steppers")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    steps = 64 if args.smoke else args.steps
    names = args.workloads.split(",")
    monitor = None
    if args.trace or args.health:
        obs.enable(sample=1.0)
    if args.health:
        monitor = health.enable(shadow_rate=0.5)

    # -- 1. autotune one policy artifact per workload -----------------------
    policies = {}
    for name in names:
        _, _, policy = tune_policy(name, steps=steps, device=args.device)
        stamp = policy.validation or {}
        policies[name] = policy
        print(f"[tune] {name}: "
              + ", ".join(f"{s}: k={d['k']} [{d['k_lo']},{d['k_hi']}]" for s, d in policy.sites.items())
              + f" — {'ACCEPTED' if policy.accepted else 'REJECTED'}"
              f" (rr_tracked rel-L2 {stamp.get('rel_l2_tracked', float('nan')):.2e})")

    # -- 2. the mixed burst --------------------------------------------------
    svc = SimService(ServiceConfig(max_queue=256), device=args.device)
    deploy_pinned = PrecisionConfig(mode="deploy", pinned=True)
    handles = []
    for name in names:
        pol = policies[name]
        handles += [
            svc.submit(SimRequest(name, steps=steps, precision="f32", tag=f"{name}/f32")),
            svc.submit(SimRequest(name, steps=steps, precision=TRACKED, policy=pol, tag=f"{name}/rr_tracked@policy")),
            svc.submit(SimRequest(name, steps=steps, precision=TRACKED, policy=pol,
                                  state0=scaled_state0(name, 0.8, device=svc.device),
                                  tag=f"{name}/rr_tracked@policy(0.8x)")),
            svc.submit(SimRequest(name, steps=steps, precision=deploy_pinned, policy=pol,
                                  tag=f"{name}/deploy-pinned@policy")),
        ]
    print(f"\n[serve] submitted {len(handles)} requests across {len(names)} workloads on {svc.device}; "
          "pumping to idle...")
    svc.run_until_idle()

    # -- 3. per-request results + metrics -----------------------------------
    oracle = {h.tag.split("/")[0]: h for h in handles if h.tag.endswith("/f32")}
    rels = {}
    print()
    for h in handles:
        if h.status != "done":
            print(f"  {h.tag:32s} {h.status.upper()}")
            continue
        res = h.result()
        name = h.tag.split("/")[0]
        stepper = get_stepper(name)
        offset = stepper.metric_offset(stepper.default_config())
        line = f"  {h.tag:32s} {len(res.snapshots)} snapshots, {res.chunks} chunks on {h.bucket_key.execution}"
        ref = oracle[name]
        if h is not ref and "(0.8x)" not in h.tag:
            a = np.asarray(res.state, np.float64) - offset
            b = np.asarray(ref.result().state, np.float64) - offset
            rels[h.tag] = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
            line += f", rel-L2 vs f32 {rels[h.tag]:.3e}"
        if res.final_k is not None:
            line += f", final splits {res.final_k}"
        print(line)

    print()
    print(svc.metrics.report())

    # -- 4. (--health) the bad deploy: a starved pinned policy vs hot traffic
    verdict, alerts = None, []
    if monitor is not None:
        print("\n[health] clean burst verdict:")
        verdict = monitor.verdict()
        print(f"  status {verdict['status']}, {verdict['alerts']['total']} alert(s), shadow sampled "
              f"{verdict['shadow']['sampled']} (error-budget burn {verdict['shadow']['burn']})")
        print("[health] deploying a STALE artifact: advection1d pinned at the starved split k=0, traffic amplitude "
              "~1e5 ...")
        stale = health._starved_policy("advection1d")
        hot_cfg = AdvectionConfig(nx=64, amplitude=1.0)
        pinned_trk = dataclasses.replace(TRACKED, pinned=True)
        for m in range(3):
            svc.submit(SimRequest(
                "advection1d", steps=32, precision=pinned_trk, cfg=hot_cfg, policy=stale, snapshot_every=8,
                tag=f"advection1d/stale-pinned#{m}",
                state0=scaled_state0("advection1d", scale=(1.0 + 0.1 * m) * 1e5,
                                     overrides={"nx": 64, "amplitude": 1.0}, device=svc.device),
            ))
        svc.run_until_idle()
        alerts = list(monitor.alerts)
        print(f"[health] {len(alerts)} alert(s) after the bad deploy:")
        for a in alerts:
            print(f"  ALERT {a}")
        for p in monitor.dump_paths:
            print(f"  flight dump: {p}")

    if args.trace:
        paths = obs.export(args.trace)
        print("\n[obs] artifacts exported:")
        for kind, path in sorted(paths.items()):
            print(f"  {kind:12s} {path}")
        print(f"  open the trace at https://ui.perfetto.dev, or run `python -m repro_torch.obs --dir {args.trace}`")
    if monitor is not None:
        health.disable()
    obs.disable()
    if alerts:
        print("\n[health] alert(s) fired: exiting nonzero (the alarm working)")
    done = all(h.status == "done" for h in handles)
    return {"done": done, "rels": rels, "summary": svc.metrics.summary(), "verdict": verdict, "alerts": alerts}


if __name__ == "__main__":
    out = main()
    sys.exit(3 if out["alerts"] else 0 if out["done"] else 2)
