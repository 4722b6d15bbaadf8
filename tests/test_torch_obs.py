"""repro_torch.obs against repro.obs: the recorder, the registry, the strict
parser and the telemetry replay give the same results on the same calls and
the same numpy evidence; the port's hooks are passive (heat1d and swe2d in
rr_tracked on the reference, fused and megakernel planes, obs on and off,
the same bits); a captured run's replayed k series equals the carried
tracker at every chunk boundary; the service drains its members under
repro's scopes only; and ``python -m repro_torch.obs --smoke --device cpu``
passes. The port's side runs on the CPU (its kernels' plain versions)."""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as obs
from repro.core import policy as jpol
from repro.obs import precision as jprec
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.obs.metrics import parse_prometheus as jparse
from repro.obs.trace import Tracer as JTracer
from repro_torch.core import policy as tpol
from repro_torch.obs import health
from repro_torch.obs import precision as tprec
from repro_torch.obs.metrics import MetricsRegistry, parse_prometheus
from repro_torch.obs.timing import measure
from repro_torch.obs.trace import Tracer, load_trace
from repro_torch.pde import HeatConfig, Simulation, SWEConfig
from repro_torch.precision import site_tracker_init
from repro_torch.service import ServiceConfig, SimRequest, SimService

TRACKED = dataclasses.replace(tpol.PRESETS["r2f2_16"], mode="rr_tracked")
JTRACKED = dataclasses.replace(jpol.PRESETS["r2f2_16"], mode="rr_tracked")
SMALL = {"heat1d": HeatConfig(nx=32), "swe2d": SWEConfig(nx=16, ny=16)}
PLANES = ("reference", "fused", "megakernel")


@pytest.fixture(autouse=True)
def _obs_off():
    """Every test starts and ends with both packages' observability off."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    obs.disable()
    jobs.disable()
    yield
    obs.disable()
    jobs.disable()
    torch.set_num_threads(prev)


def bits(x):
    x = np.ascontiguousarray(np.asarray(x, np.float32))
    b = x.view(np.uint32).copy()
    b[np.isnan(x)] = 0x7FC00000
    return b


def same_run(a, b):
    np.testing.assert_array_equal(bits(a.state), bits(b.state))
    np.testing.assert_array_equal(bits(a.snapshots), bits(b.snapshots))
    for x, y in zip(a.tracker.state, b.tracker.state):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


# ---------------------------------------------------------------------------
# the registry, the recorder and the parser against repro's
# ---------------------------------------------------------------------------


def drive_registry(reg):
    """One sequence of registry calls: labels, every type, a cardinality drop."""
    reg.counter("c_total", "a counter").inc(3, stage="x")
    reg.counter("c_total").inc(0.5, stage="y")
    reg.gauge("g", "a gauge").set(1.5)
    reg.gauge("g").inc(2.0, zone="a")
    h = reg.histogram("h_seconds", "a histogram", buckets=(0.01, 0.1))
    for v in (0.05, 0.2, 0.001, float("inf")):
        h.observe(v, op="mul")
    reg.histogram("lat_seconds").observe(3e-4, kernel='q"uote')
    wide = reg.counter("wide_total")
    for i in range(6):
        wide.inc(member=str(i))
    return reg


def test_registry_exports_the_same_text_and_json():
    port, ref = drive_registry(MetricsRegistry(max_series=4)), drive_registry(JRegistry(max_series=4))
    assert port.export_prometheus() == ref.export_prometheus()
    assert json.dumps(port.export_json(), sort_keys=True) == json.dumps(ref.export_json(), sort_keys=True)
    assert port.dropped_series == ref.dropped_series == 2
    assert parse_prometheus(port.export_prometheus()) == jparse(ref.export_prometheus())
    assert port.histogram("h_seconds").quantile(0.5) == ref.histogram("h_seconds").quantile(0.5)


def drive_tracer(tr):
    with tr.span("outer", a=1) as args:
        with tr.span("mid", n=2):
            tr.instant("event", x="y")
        args["late"] = 42
    tr.instant("lifecycle", request=7)
    with tr.span("second"):
        pass
    return tr


def test_chrome_trace_events_match_repro():
    def events(tr):
        out = []
        for ev in tr.chrome_trace()["traceEvents"]:
            out.append({k: v for k, v in ev.items() if k not in ("ts", "dur", "pid", "tid")})
        return out

    assert events(drive_tracer(Tracer())) == events(drive_tracer(JTracer()))


@pytest.mark.parametrize("sample", (0.0, 0.3, 0.5, 1.0))
def test_sampling_decision_and_capacity_bound_match_repro(sample):
    def record(cls):
        tr = cls(sample=sample, capacity=5)
        for i in range(10):
            with tr.span(f"s{i}"):
                tr.instant(f"e{i}")
        return [s.name for s in tr.spans], tr.dropped

    port, ref = record(Tracer), record(JTracer)
    assert port == ref
    kept = [n for n in range(10) if math.floor((n + 1) * sample) > math.floor(n * sample)]
    assert port[1] == max(0, 2 * len(kept) - 5)


@pytest.mark.parametrize(
    "text",
    [
        "no_type_decl 1.0\n",
        "# TYPE h histogram\nh_bucket{le=\"+Inf\"} 2\nh_count 2\n",
        "# TYPE h histogram\nh_bucket{le=\"0.1\"} 1\nh_sum 1\nh_count 1\n",
        "# TYPE h histogram\nh_bucket{le=\"0.1\"} 3\nh_bucket{le=\"+Inf\"} 2\nh_sum 1\nh_count 2\n",
        "# TYPE h histogram\nh_bucket{le=\"+Inf\"} 2\nh_sum 1\nh_count 5\n",
        "# TYPE c counter\nc not-a-number\n",
        "# TYPE c counter\nc{bad-label=\"x\"} 1\n",
        "# TYPE c counter\n# TYPE c gauge\nc 1\n",
    ],
)
def test_strict_parser_rejects_what_repro_rejects(text):
    with pytest.raises(ValueError):
        jparse(text)
    with pytest.raises(ValueError):
        parse_prometheus(text)


# ---------------------------------------------------------------------------
# telemetry: the replay against repro's, on the same numpy evidence
# ---------------------------------------------------------------------------


def evidence(steps, n_sites, seed=0):
    """Per-step exponent evidence with jumps, so the adjust law grows and
    shrinks; a zero-operand floor (-127) in some steps."""
    g = np.random.default_rng(seed)
    ev = g.integers(-12, 12, size=(steps, n_sites, 2)).astype(np.float32)
    ev[g.random((steps, n_sites)) < 0.1] = -127.0
    ev[steps // 2 :, 0] += 20.0
    return ev


@pytest.mark.parametrize("every", (5, 7))
def test_replay_and_coverage_equal_repro(every):
    sites, ops = ("heat.flux", "heat.update"), ("mul", "add")
    ev = evidence(30, 2, seed=every)
    k0 = np.array([1, 4], np.int32)
    port = tprec.replay_k_series(torch.from_numpy(ev), TRACKED, sites, site_ops=ops, every=every, k0=k0)
    ref = jprec.replay_k_series(ev, JTRACKED, sites, site_ops=ops, every=every, k0=k0)
    assert port[0] == ref[0]
    for a, b in zip(port[1:], ref[1:]):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert port[2].max() > 0 and port[3].max() > 0  # the evidence really moved the splits
    final = dict(zip(sites, port[1][-1].tolist()))
    assert tprec.coverage_fraction(ev, TRACKED, sites, final, site_ops=ops) == jprec.coverage_fraction(
        ev, JTRACKED, sites, final, site_ops=ops)


def test_telemetry_artifacts_load_in_either_package(tmp_path):
    t = tprec.PrecisionTelemetry()
    t.record_series("s", ["a"], [6, 12], np.array([[3], [4]]), np.array([[1], [1]]), np.array([[0], [0]]),
                    coverage={"a": 0.97})
    back = jprec.load_telemetry(t.save(str(tmp_path / "port.json")))
    assert back.all_series()[0].k == [3, 4] and back.all_series()[0].coverage == 0.97
    j = jprec.PrecisionTelemetry()
    j.record_series("s", ["a"], [6], np.array([[2]]), np.array([[0]]), np.array([[1]]))
    assert tprec.load_telemetry(j.save(str(tmp_path / "ref.json"))).final_k("s") == {"a": 2}
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "other"}))
    with pytest.raises(ValueError):
        tprec.load_telemetry(str(bad))


# ---------------------------------------------------------------------------
# passivity and the solver's drains (the port only)
# ---------------------------------------------------------------------------


def run(name, execution, steps=14, every=6, **kw):
    sim = Simulation(name, SMALL[name], TRACKED, device="cpu")
    return sim.run(steps, snapshot_every=every, execution=execution, **kw)


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("execution", PLANES)
def test_tracked_run_bit_identical_under_obs(name, execution):
    base = run(name, execution)
    scope = obs.enable(sample=1.0)
    inst = run(name, execution)
    obs.disable()
    assert any(s.name == "sim.run" for s in scope.tracer.spans)
    assert scope.telemetry.scopes() == [f"sim:{name}"]
    assert scope.registry.counter("repro_sim_runs_total").value(
        stepper=name, mode="rr_tracked", execution=execution) == 1
    same_run(base, inst)


@pytest.mark.parametrize("name", sorted(SMALL))
@pytest.mark.parametrize("execution", ("reference", "fused"))
def test_replayed_series_equals_carried_k(name, execution):
    """A captured run's telemetry equals the carried tracker at every chunk
    boundary (14 steps at 6: a remainder chunk), observed by threading the
    tracker through per-chunk runs."""
    sim = Simulation(name, SMALL[name], TRACKED, device="cpu")
    state, tracker, truth = None, None, []
    for n in (6, 6, 2):
        res = sim.run(n, snapshot_every=n, state0=state, tracker=tracker, execution=execution)
        state, tracker = res.state, res.tracker
        truth.append(res.tracker.state.k.tolist())
    scope = obs.enable()
    res = run(name, execution, capture=True)
    tel = scope.telemetry
    for j, site in enumerate(sim.stepper.sites):
        steps, k = tel.k_series(f"sim:{name}", site)
        assert steps.tolist() == [6, 12, 14]
        assert k.tolist() == [t[j] for t in truth]
        cov = tel.series(f"sim:{name}", site).coverage
        assert cov is not None and 0.0 <= cov <= 1.0
    assert res.tracker.state.k.tolist() == truth[-1]


def test_ensemble_drains_per_member_unless_the_caller_drains():
    sim = Simulation("heat1d", SMALL["heat1d"], TRACKED, device="cpu")
    batch = torch.stack([sim.stepper.init_state(sim.cfg, device="cpu") * s for s in (1.0, 0.5)])
    scope = obs.enable()
    res = sim.run_ensemble(batch, 8, snapshot_every=4, execution="megakernel")
    assert scope.telemetry.scopes() == ["ens:heat1d/m0", "ens:heat1d/m1"]
    assert scope.telemetry.final_k("ens:heat1d/m1") == dict(zip(res.tracker.names, res.tracker.state.k[1].tolist()))
    sim.run_ensemble(batch, 8, snapshot_every=4, execution="reference", _drain=False)
    assert len(scope.telemetry.scopes()) == 2
    assert [s.name for s in scope.tracer.spans].count("sim.run_ensemble") == 2


def test_record_tracker_refuses_meta_rows():
    scope = obs.enable()
    tracker = site_tracker_init(("a", "b"), TRACKED.fmt, device="meta")
    obs.record_tracker("template", tracker, 0)
    assert len(scope.telemetry) == 0
    obs.record_tracker("real", site_tracker_init(("a", "b"), TRACKED.fmt, device="cpu"), 0)
    assert scope.telemetry.final_k("real") == {"a": TRACKED.fmt.fx, "b": TRACKED.fmt.fx}


def test_service_drains_only_the_requests_scopes():
    """repro's chunk runs under jit, where the solver's drains skip: the
    port's telemetry holds the request's scope and nothing else, one sample
    per chunk at the request's elapsed steps."""
    scope = obs.enable()
    svc = SimService(ServiceConfig(), device="cpu")
    h = svc.submit(SimRequest("heat1d", steps=12, precision=TRACKED, cfg=SMALL["heat1d"], snapshot_every=4))
    svc.run_until_idle()
    res = h.result()
    tel = scope.telemetry
    assert tel.scopes() == [f"req{h.id}:heat1d"]
    assert tel.final_k(f"req{h.id}:heat1d") == res.final_k
    steps, _ = tel.k_series(f"req{h.id}:heat1d", res.tracker.names[0])
    assert steps.tolist() == [4, 8, 12] and res.chunks == 3
    names = [s.name for s in scope.tracer.spans]
    assert names.count("service.chunk") == 3 and names.count("sim.run_ensemble") == 3


# ---------------------------------------------------------------------------
# the health registry, timing, export and the reporter
# ---------------------------------------------------------------------------


def test_health_registry_has_no_monitor_until_ported(tmp_path):
    """No monitor until one is enabled; ``enable`` installs one (the health
    plane is ported: tests/test_torch_health.py) and ``disable`` removes it."""
    assert health.active() is None
    mon = health.enable(shadow_rate=0.5, flight_dir=str(tmp_path))
    assert health.active() is mon and mon.config.shadow_rate == 0.5
    health.disable()
    assert health.active() is None


def test_measure_splits_first_call_from_steady_state():
    calls = []

    def f(x):
        calls.append(1)
        return x * 2.0

    t = measure(f, torch.ones(64), iters=3)
    assert t.iters == 3 and len(calls) == 4 and t.compile_us > 0 and t.us_per_call > 0
    np.testing.assert_array_equal(t.result.numpy(), np.full(64, 2.0, np.float32))
    with pytest.raises(ValueError):
        measure(f, torch.ones(1), iters=0)


def test_enable_export_disable_round_trip(tmp_path):
    obs.enable()
    with obs.span("unit", n=1):
        obs.inc("repro_test_events_total", kind="unit")
        obs.observe("repro_test_seconds", 0.5)
        obs.set_gauge("repro_test_gauge", 2.0)
    paths = obs.export(str(tmp_path))
    obs.disable()
    assert any(e["name"] == "unit" for e in load_trace(paths["trace"])["traceEvents"])
    with open(paths["prometheus"]) as f:
        text = f.read()
    assert {"repro_test_events_total", "repro_test_seconds", "repro_test_gauge"} <= set(jparse(text))
    with pytest.raises(RuntimeError):
        obs.export(str(tmp_path))


def test_reporter_smoke_gate_passes_on_the_cpu(tmp_path, capsys):
    from repro_torch.obs.__main__ import main

    assert main(["--smoke", "--device", "cpu", "--out", str(tmp_path / "obs")]) == 0
    assert main(["--dir", str(tmp_path / "obs"), "--top", "3"]) == 0
    out = capsys.readouterr().out
    assert "smoke passed" in out and "recorder self-time" in out and "service.chunk" in out
