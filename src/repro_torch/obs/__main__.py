"""``python -m repro_torch.obs``: the headless reporter over exported artifacts.

Default mode loads a directory of artifacts written by
:func:`repro_torch.obs.export` (``trace.json``, ``metrics.prom``,
``telemetry.json``; ``repro.obs``'s artifacts too) and prints the fleet
view: top-k slow spans, per-bucket chunk latency, per-site carried-k
trajectories. It needs only the standard library and numpy.

``--smoke`` is the gate: serve a small mixed burst in-process on
``--device`` (default the CUDA card) with observability enabled, export,
reload the artifacts through the strict loaders, and check the contract:
the trace loads and has ``service.chunk`` spans, the Prometheus text
round-trips through the strict parser with the chunk-latency histogram in
it, compiles are recorded, the telemetry's final carried k equals the
request's, and the recorder's measured self-time stays under 5% of busy
plus compile time (the fraction is printed). Exit 0 on pass, 2 on any
failure (printed with a ``SMOKE FAIL`` prefix).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Dict, List, Optional

OVERHEAD_BUDGET = 0.05  # recorder self-time / (busy + compile) time


# ---------------------------------------------------------------------------
# report mode
# ---------------------------------------------------------------------------

def _fmt_us(us: float) -> str:
    if us >= 1e6:
        return f"{us / 1e6:.2f}s"
    if us >= 1e3:
        return f"{us / 1e3:.1f}ms"
    return f"{us:.0f}us"


def report_trace(path: str, top: int = 10) -> List[str]:
    from .trace import load_trace

    doc = load_trace(path)
    events = doc["traceEvents"]
    complete = [e for e in events if e.get("ph") == "X"]
    dropped = doc.get("otherData", {}).get("dropped", 0)
    lines = [
        f"trace: {len(complete)} spans, "
        f"{len(events) - len(complete)} instants, "
        f"{dropped} dropped past capacity ({path})"
    ]
    if dropped:
        lines.append(
            f"  WARNING: {dropped} sampled event(s) fell past the recorder "
            "capacity — raise capacity or lower sample for complete traces"
        )
    slow = sorted(complete, key=lambda e: -e.get("dur", 0.0))[:top]
    if slow:
        lines.append(f"  top {len(slow)} slow spans:")
        width = max(len(e["name"]) for e in slow)
        for e in slow:
            args = e.get("args", {})
            brief = ", ".join(
                f"{k}={v}" for k, v in sorted(args.items()) if k != "depth"
            )
            lines.append(
                f"    {e['name']:<{width}}  {_fmt_us(e.get('dur', 0.0)):>9}"
                + (f"  [{brief}]" if brief else "")
            )
    return lines


def report_metrics(path: str) -> List[str]:
    from .metrics import parse_prometheus

    with open(path) as f:
        families = parse_prometheus(f.read())
    lines = [f"metrics: {len(families)} families ({path})"]
    for name, fam in sorted(families.items()):
        if fam["type"] == "histogram":
            # per-label-set mean latency from _sum/_count
            sums: Dict[Any, float] = {}
            counts: Dict[Any, float] = {}
            for sname, labels, value in fam["samples"]:
                key = tuple(sorted(labels.items()))
                if sname.endswith("_sum"):
                    sums[key] = value
                elif sname.endswith("_count"):
                    counts[key] = value
            lines.append(f"  {name} (histogram):")
            for key in sorted(sums):
                n = counts.get(key, 0.0)
                mean = sums[key] / n if n else float("nan")
                lbl = ", ".join(f"{k}={v}" for k, v in key) or "(no labels)"
                lines.append(
                    f"    {lbl}: n={n:.0f} mean={_fmt_us(mean * 1e6)}"
                )
        else:
            for sname, labels, value in fam["samples"]:
                lbl = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
                lines.append(
                    f"  {sname}{{{lbl}}} = {value:g}" if lbl
                    else f"  {sname} = {value:g}"
                )
    return lines


def report_telemetry(path: str) -> List[str]:
    from .precision import load_telemetry

    tel = load_telemetry(path)
    lines = [f"telemetry: {len(tel)} site series ({path})"]
    for s in tel.all_series():
        if not s.k:
            continue
        traj = "->".join(str(k) for k in _dedup(s.k))
        cov = f" coverage={s.coverage:.3f}" if s.coverage is not None else ""
        lines.append(
            f"  {s.scope}:{s.site}  k {traj}  "
            f"(grew {s.grew[-1]}, shrank {s.shrank[-1]}, "
            f"{len(s.steps)} samples){cov}"
        )
    return lines


def _dedup(ks: List[int]) -> List[int]:
    out: List[int] = []
    for k in ks:
        if not out or out[-1] != k:
            out.append(int(k))
    return out


def run_report(dir: str, top: int) -> int:
    """Report every artifact that is present and loadable; a missing or
    malformed file (a partial export, a truncated write) degrades to a
    warning line instead of crashing the whole report."""
    any_found = False
    for fname, fn in (
        ("trace.json", lambda p: report_trace(p, top)),
        ("metrics.prom", report_metrics),
        ("telemetry.json", report_telemetry),
    ):
        path = os.path.join(dir, fname)
        if not os.path.exists(path):
            print(f"({fname}: not found in {dir})")
            continue
        try:
            lines = fn(path)
        except Exception as e:  # partial/corrupt artifact: report and move on
            print(f"({fname}: unreadable — {e})")
            continue
        any_found = True
        for line in lines:
            print(line)
    if not any_found:
        print(f"no obs artifacts in {dir!r} — run with repro_torch.obs.export() first")
        return 1
    return 0


# ---------------------------------------------------------------------------
# smoke mode (the CI gate)
# ---------------------------------------------------------------------------

def run_smoke(out_dir: str, device=None) -> int:
    failures: List[str] = []

    def check(ok: bool, what: str) -> None:
        print(("  ok   " if ok else "  FAIL ") + what)
        if not ok:
            failures.append(what)

    import numpy as np

    import repro_torch.obs as obs
    from repro_torch.service import SimRequest, SimService

    obs.enable(sample=1.0)
    try:
        svc = SimService(device=device)
        print(f"smoke: serving a mixed burst on {svc.device} with observability enabled")
        h_f32 = svc.submit(SimRequest("heat1d", steps=64, precision="f32",
                                      snapshot_every=16))
        h_trk = svc.submit(SimRequest("heat1d", steps=64,
                                      precision="rr_tracked",
                                      snapshot_every=16))
        svc.run_until_idle()
        res_trk = h_trk.result()
        h_f32.result()
        summary = svc.metrics.summary()
        paths = obs.export(out_dir)
        o = obs.active()
        tracer_self = o.tracer.self_seconds if o.tracer else 0.0
        n_spans = len(o.tracer.spans) if o.tracer else 0
    finally:
        obs.disable()

    # 1. trace artifact loads and has complete spans
    doc = obs.load_trace(paths["trace"])
    complete = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    check(len(complete) >= 1, f"trace has complete spans ({len(complete)})")
    check(any(e["name"] == "service.chunk" for e in complete),
          "trace covers service.chunk spans")

    # 2. Prometheus export round-trips through the strict parser
    with open(paths["prometheus"]) as f:
        prom_text = f.read()
    try:
        families = obs.parse_prometheus(prom_text)
        check(len(families) >= 1, f"prometheus parses ({len(families)} families)")
    except ValueError as e:
        check(False, f"prometheus parses ({e})")
        families = {}
    check("repro_service_chunk_latency_seconds" in families,
          "chunk-latency histogram exported")

    # 3. compile/execute split landed in the metrics
    check(summary.get("compiles", 0) >= 1,
          f"compile calls recorded ({summary.get('compiles')})")
    check(summary.get("compile_seconds", 0.0) > 0.0,
          "compile_seconds > 0")
    check(np.isfinite(summary.get("chunk_latency_p50_us", float("nan"))),
          "execute-only latency percentile is finite")

    # 4. telemetry: final carried k in the series matches the request result
    tel = obs.load_telemetry(paths["telemetry"])
    check(len(tel) >= 1, f"telemetry has site series ({len(tel)})")
    ok_k = False
    if res_trk.final_k:
        for scope in tel.scopes():
            if tel.final_k(scope) == res_trk.final_k:
                ok_k = True
                break
    check(ok_k, f"telemetry final k matches request result {res_trk.final_k}")

    # 5. measured recorder overhead under budget
    busy = summary.get("busy_seconds", 0.0) + summary.get("compile_seconds", 0.0)
    frac = tracer_self / busy if busy > 0 else 0.0
    check(frac < OVERHEAD_BUDGET,
          f"recorder self-time {frac * 100:.2f}% of busy plus compile time "
          f"(budget {OVERHEAD_BUDGET * 100:.0f}%, {n_spans} spans; "
          f"self {tracer_self:.6f} s, busy {summary.get('busy_seconds', 0.0):.6f} s, "
          f"compile {summary.get('compile_seconds', 0.0):.6f} s)")

    if failures:
        print(f"SMOKE FAIL: {len(failures)} check(s) failed")
        return 2
    print(f"smoke passed; artifacts in {out_dir}")
    return 0


# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="Fleet reporter over exported repro_torch.obs artifacts.",
    )
    ap.add_argument("--dir", default="artifacts/obs",
                    help="artifact directory to report on (default: %(default)s)")
    ap.add_argument("--top", type=int, default=10,
                    help="how many slow spans to show (default: %(default)s)")
    ap.add_argument("--smoke", action="store_true",
                    help="serve a tiny instrumented burst and gate the "
                         "whole obs contract (CI mode; exit 2 on failure)")
    ap.add_argument("--out", default=None,
                    help="smoke-mode export directory (default: --dir)")
    ap.add_argument("--device", default=None,
                    help="smoke-mode torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.smoke:
        return run_smoke(args.out or args.dir, args.device)
    return run_report(args.dir, args.top)


if __name__ == "__main__":
    sys.exit(main())
