"""repro_torch.obs.health, the numerics-health plane, against repro.obs.health
on the CPU (the port's kernels' plain versions).

The pure parts give repro's results on the same inputs: the detectors over
the same synthetic telemetry streams (storm, thrash, coverage, fire-once;
the live sweep however the chunks fall), SLO rising edges, the sampler's
floor law, the flight ring and its dumps loaded across the packages, and
``rel_l2``/``nonfinite_fraction`` on tensors, numpy arrays and
PackedArrays. ``Simulation.oracle_replay`` equals repro's bit for bit
(heat1d and swe2d). Served through the service with the monitor on
(``shadow_rate=1.0``), two rr_tracked requests equal the same bucket with it
off, bit for bit, on all three planes, every request is shadowed and its
``shadow_rel`` equals repro's as a float. The starved pinned storm raises
repro's alerts; ``run_smoke`` passes clean (exit 0) and alarms on the
storm (exit 3); a request whose pinned cells hold f32 subnormals keeps their
bits in its shadow copy. repro's monitored bursts run once per module, and
the port's runs that are compared with them run under
``torch.set_flush_denormal`` because XLA:CPU flushes subnormal results."""

import dataclasses
import json
import math
import os
from urllib.error import HTTPError
from urllib.request import urlopen

import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro.obs.health as jhealth
import repro_torch.obs as obs
import repro_torch.obs.health as health
from repro.obs import flightrec as jflight
from repro.obs import precision as jprec
from repro.obs import shadow as jshadow
from repro_torch.core import ftz
from repro_torch.core.policy import PRESETS
from repro_torch.obs import flightrec, shadow
from repro_torch.obs import precision as tprec
from repro_torch.obs.health import Alert, HealthConfig, HealthMonitor, SLORule, detect_series, run_detectors
from repro_torch.obs.server import HealthServer, _sanitize
from repro_torch.pack import PackedArray, pack_state, unpack_state
from repro_torch.pde import Simulation
from repro_torch.service import ServiceConfig, SimRequest, SimService

TRACKED = dataclasses.replace(PRESETS["r2f2_16"], mode="rr_tracked")
#: repro's small grids for the served passivity matrix (tests/test_health.py)
SMALL_OV = {"heat1d": {"nx": 64}, "swe2d": {"nx": 32, "ny": 32}}
STEPS, EVERY = 16, 8
PLANES = ("reference", "fused", "megakernel")
#: f32 subnormals as bits: 1e-40, -3e-39, the smallest, the largest
SUBNORMALS = (0x000116C2, -2**31 | 0x0020AB1B, 0x00000001, 0x007FFFFF)


@pytest.fixture(autouse=True)
def _health_off():
    """Every test starts and ends with both packages' monitors and obs off,
    PyTorch on one thread and the CPU's flush flag clear."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    for m in (health, obs, jhealth, jobs):
        m.disable()
    yield
    for m in (health, obs, jhealth, jobs):
        m.disable()
    torch.set_flush_denormal(False)
    torch.set_num_threads(prev)


def bits(x):
    x = np.ascontiguousarray(np.asarray(x, np.float32))
    b = x.view(np.uint32).copy()
    b[np.isnan(x)] = 0x7FC00000
    return b


def state0s(name):
    """The two requests' initial states, repro's ``scaled_state0`` at 0.6
    and 0.8, as numpy arrays that both packages take."""
    from repro.service import scaled_state0

    return [np.array(scaled_state0(name, 0.6 + 0.2 * i, overrides=SMALL_OV[name]), np.float32) for i in range(2)]


class _Key:
    def short(self):
        return "bucket"


# ---------------------------------------------------------------------------
# repro's monitored bursts, once per module
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def repro_health(tmp_path_factory):
    """repro.service's monitored megakernel bursts of heat1d and swe2d
    (two rr_tracked requests, ``shadow_rate=1.0``), its oracle replays of
    the same initial states (the shadow jobs' own programs), and its storm
    burst of one member."""
    from repro.core import policy as jpol
    from repro.service import ServiceConfig as JConfig
    from repro.service import SimRequest as JRequest
    from repro.service import SimService as JService

    where = tmp_path_factory.mktemp("repro_health")
    jtracked = dataclasses.replace(jpol.PRESETS["r2f2_16"], mode="rr_tracked")
    out = {}
    for name in SMALL_OV:
        jobs.enable(sample=1.0)
        mon = jhealth.enable(shadow_rate=1.0, flight_dir=str(where / name))
        svc = JService(JConfig(max_bucket=4))
        hs = [svc.submit(JRequest(name, steps=STEPS, precision=jtracked, overrides=SMALL_OV[name],
                                  snapshot_every=EVERY, execution="megakernel", state0=s0))
              for s0 in state0s(name)]
        svc.run_until_idle()
        jhealth.disable()
        jobs.disable()
        sim = hs[0]._record.sim
        replays = [sim.oracle_replay(STEPS, state0=s0) for s0 in state0s(name)]
        out[name] = dict(rel=dict(mon.shadow_rel), alerts=list(mon.alerts),
                         replays=[(np.asarray(r.state), np.asarray(r.snapshots)) for r in replays])
    jobs.enable(sample=1.0)
    mon = jhealth.enable(flight_dir=str(where / "storm"))
    svc = JService()
    jhealth._storm_burst(svc, members=1)
    svc.run_until_idle()
    jhealth.disable()
    jobs.disable()
    out["storm"] = dict(alerts=[a.to_dict() for a in mon.alerts], verdict=mon.verdict(), dumps=list(mon.dump_paths))
    return out


# ---------------------------------------------------------------------------
# detectors: the same streams give repro's alerts
# ---------------------------------------------------------------------------

#: synthetic streams: {site: (steps, k, grew, shrank, coverage)}
STREAMS = {
    "storm": {"s": ([8, 16, 24, 32], [2, 2, 2, 2], [0, 0, 4, 8], [0, 0, 0, 0], None)},
    "storm_needs_events": {"s": ([4], [2], [1], [0], None)},
    "storm_fires_once": {"s": ([8, 16, 24, 32, 40, 48], [2] * 6, [0, 0, 4, 8, 12, 16], [0] * 6, None)},
    "thrash": {"s": ([8, 16, 24, 32, 40], [3, 2, 3, 2, 3], [0, 0, 1, 1, 2], [0, 1, 1, 2, 2], None)},
    "monotone": {"s": ([8, 16, 24, 32], [0, 1, 2, 3], [1, 2, 3, 4], [0, 0, 0, 0], None)},
    "coverage_drop": {"s": ([8, 16], [2, 2], [0, 0], [0, 0], 0.5)},
    "coverage_ok": {"s": ([8, 16], [2, 2], [0, 0], [0, 0], 0.95)},
    "mixed": {
        "a": ([8, 16, 24, 32, 40], [3, 2, 3, 2, 3], [0, 0, 1, 1, 2], [0, 0, 0, 0, 0], None),
        "b": ([8, 16, 24, 32, 40], [2, 2, 2, 2, 2], [0, 4, 8, 12, 16], [0, 0, 0, 0, 0], 0.4),
        "c": ([8, 16, 24, 32, 40, 48, 56], [3, 2, 3, 2, 3, 3, 3], [0, 0, 1, 1, 2, 6, 14], [0] * 7, None),
    },
}
CFG = dict(window=8, grow_rate=0.25, grow_min_events=4, thrash_reversals=3, coverage_min=0.9)


def telemetry(mod, stream, scope="svc"):
    tel = mod.PrecisionTelemetry()
    for site, (steps, ks, gs, ss, cov) in stream.items():
        s = tel.series(scope, site)
        for step, k, g, sh in zip(steps, ks, gs, ss):
            s.append(step, k, g, sh)
        s.coverage = cov
    return tel


@pytest.mark.parametrize("case", sorted(STREAMS))
def test_detectors_equal_repro(case):
    got = [a.to_dict() for a in run_detectors(telemetry(tprec, STREAMS[case]), HealthConfig(**CFG))]
    want = [a.to_dict() for a in jhealth.run_detectors(telemetry(jprec, STREAMS[case]), jhealth.HealthConfig(**CFG))]
    assert got == want
    assert got == [a.to_dict() for a in run_detectors(telemetry(tprec, STREAMS[case]), HealthConfig(**CFG))]
    kinds = {"storm": ["overflow_storm"], "storm_needs_events": [], "storm_fires_once": ["overflow_storm"],
             "thrash": ["k_thrash"], "monotone": [], "coverage_drop": ["coverage_drop"], "coverage_ok": [],
             "mixed": ["k_thrash", "overflow_storm", "coverage_drop", "k_thrash", "overflow_storm"]}[case]
    assert [a["kind"] for a in got] == kinds


@pytest.mark.parametrize("chunking", [[1] * 7, [7], [2, 3, 2]])
def test_live_sweep_equals_offline_replay(chunking, tmp_path):
    """The live monitor emits each series' fresh suffix as the stream grows;
    the accumulated alerts equal one offline pass (the port's and repro's)
    however the sweeps fall."""
    steps, ks, gs, ss, _ = STREAMS["mixed"]["c"]
    obs.enable(sample=0.0)
    mon = HealthMonitor(HealthConfig(flight_dir=str(tmp_path), **CFG))
    s = obs.active().telemetry.series("svc", "c")
    i = 0
    for n in chunking:
        for _ in range(n):
            s.append(steps[i], ks[i], gs[i], ss[i])
            i += 1
        mon.sweep()
    want = jhealth.run_detectors(telemetry(jprec, {"c": STREAMS["mixed"]["c"]}), jhealth.HealthConfig(**CFG))
    assert [a.to_dict() for a in mon.alerts] == [a.to_dict() for a in want]
    assert [a.kind for a in mon.alerts] == ["k_thrash", "overflow_storm"]
    assert len(mon.dump_paths) == 2 and mon.verdict()["status"] == "alerting"
    assert obs.active().registry.counter("repro_health_alerts_total").value(kind="k_thrash") == 1


def test_reversals_and_series_detector_equal_repro():
    for ks in ([3, 2, 3, 2, 3], [0, 1, 2, 3], [1, 1, 2, 2, 1, 1, 2], []):
        assert health._reversals(ks) == jhealth._reversals(ks)
    s = tprec.SiteSeries.from_dict({"scope": "x", "site": "y", "steps": [8, 16, 24, 32], "k": [2] * 4,
                                    "grew": [0, 0, 4, 8], "shrank": [0] * 4, "coverage": 0.5})
    js = jprec.SiteSeries.from_dict(s.to_dict())
    got = detect_series(s, HealthConfig(**CFG))
    assert [a.to_dict() for a in got] == [a.to_dict() for a in jhealth.detect_series(js, jhealth.HealthConfig(**CFG))]
    assert str(got[0]) == str(jhealth.Alert(**got[0].to_dict()))


# ---------------------------------------------------------------------------
# SLO rules: rising edges, as repro evaluates them
# ---------------------------------------------------------------------------


def test_slo_rule_schema_equals_repro():
    for bad in (dict(op="<"), dict(window=0)):
        with pytest.raises(ValueError):
            SLORule("x", "queue_depth", **{"op": "<=", "threshold": 1.0, **bad})
    r = SLORule("q", "queue_depth", "<=", 4.0, window=16)
    assert SLORule.from_dict(r.to_dict()) == r and r.to_dict() == jhealth.SLORule(**r.to_dict()).to_dict()
    assert [x.to_dict() for x in health.DEFAULT_SLOS] == [x.to_dict() for x in jhealth.DEFAULT_SLOS]
    for v in (2.0, 2.1, 1.9, float("nan")):
        for op in ("<=", ">="):
            assert SLORule("r", "m", op, 2.0).ok(v) == jhealth.SLORule("r", "m", op, 2.0).ok(v)


def drive_slos(obs_mod, health_mod, where):
    """One sequence of chunks against a queue rule and a latency rule: the
    queue breaches, holds, recovers, breaches again; the latency histogram
    holds one 0.5 s chunk against a 1 us threshold."""
    obs_mod.enable(sample=0.0)
    mon = health_mod.HealthMonitor(health_mod.HealthConfig(
        slos=(health_mod.SLORule("queue", "queue_depth", "<=", 2.0),
              health_mod.SLORule("lat", "chunk_latency_p99_us", "<=", 1.0),
              health_mod.SLORule("thrash", "thrash_rate", "<=", 0.5, window=4)),
        flight_dir=str(where)))
    obs_mod.active().registry.histogram("repro_service_chunk_latency_seconds").observe(0.5)
    for queued in (5, 5, 0, 9):
        mon.note_occupancy(queued=queued, active=1)
        mon.on_chunk(_Key(), 1, 8, 0.5, compiled=False)
    out = [a.to_dict() for a in mon.alerts], mon.verdict()
    obs_mod.disable()
    return out


def test_slo_rising_edges_equal_repro(tmp_path):
    (got, verdict), (want, jverdict) = drive_slos(obs, health, tmp_path / "t"), drive_slos(jobs, jhealth, tmp_path / "j")
    assert got == want
    assert [(a["kind"], a["scope"], a["step"]) for a in got] == [
        ("slo_breach", "queue", 1), ("slo_breach", "lat", 1), ("slo_breach", "queue", 4)]
    assert verdict["slo"]["queue"]["ok"] is False and verdict["slo"]["lat"]["value"] == got[1]["detail"]["value"]
    for v in (verdict, jverdict):
        v.pop("flight_dumps")
        v["shadow"].pop("seconds")
    assert json.dumps(_sanitize(verdict), sort_keys=True) == json.dumps(_sanitize(jverdict), sort_keys=True)


def test_verdict_sanitizes_to_strict_json(tmp_path):
    obs.enable(sample=0.0)
    mon = HealthMonitor(HealthConfig(flight_dir=str(tmp_path)))
    text = json.dumps(_sanitize(mon.verdict()), allow_nan=False)
    assert json.loads(text)["status"] == "ok" and json.loads(text)["shadow"]["burn"] is None
    assert json.loads(text)["schema"] == jhealth.VERDICT_SCHEMA == health.VERDICT_SCHEMA


# ---------------------------------------------------------------------------
# the flight recorder: the ring, and dumps across the packages
# ---------------------------------------------------------------------------


def test_flight_ring_keeps_the_tail_as_repro_does():
    rings = [flightrec.FlightRecorder(capacity=4), jflight.FlightRecorder(capacity=4)]
    for fr in rings:
        for i in range(10):
            fr.record("ev", i=i)
    assert rings[0].events() == rings[1].events() and [e["i"] for e in rings[0].events()] == [6, 7, 8, 9]
    assert rings[0].recorded == 10 and len(rings[0]) == 4
    with pytest.raises(ValueError):
        flightrec.FlightRecorder(capacity=0)


@pytest.mark.parametrize("writer,reader", [(flightrec, jflight), (jflight, flightrec), (flightrec, flightrec)])
def test_flight_dump_loads_across_packages(writer, reader, tmp_path):
    assert writer.SCHEMA == reader.SCHEMA == "repro.obs/flightrec@1"
    fr = writer.FlightRecorder(capacity=8)
    fr.record("submit", request=1)
    fr.record("alert", alert={"kind": "overflow_storm"})
    path = fr.dump(str(tmp_path), "overflow storm!", metrics={"m": 1}, verdict={"status": "alerting"})
    assert os.path.basename(path) == "flightrec-0001-overflow-storm.json"
    doc = reader.load_flightrec(path)
    assert doc["reason"] == "overflow storm!" and doc["recorded"] == 2 and doc["metrics"] == {"m": 1}
    assert [e["kind"] for e in doc["events"]] == ["submit", "alert"]
    for key, value in (("schema", "bogus@9"), ("events", [{"seq": 2, "kind": "a"}, {"seq": 1, "kind": "b"}])):
        bad = dict(doc, **{key: value})
        p = tmp_path / f"bad_{key}.json"
        p.write_text(json.dumps(bad))
        with pytest.raises(ValueError):
            reader.load_flightrec(str(p))


def test_repro_chunk_events_break_its_dumps(tmp_path):
    """A fault of the reference, kept out of the port: repro's chunk event
    passes ``seq=`` to the recorder, overwriting the event's sequence
    number, so a dump taken after a chunk fails repro's own loader. The
    port's chunk event carries ``chunk=`` and its dumps load in both
    packages; its recorder refuses a field named ``seq``."""
    dumps = {}
    for name, (obs_mod, health_mod) in {"repro": (jobs, jhealth), "port": (obs, health)}.items():
        obs_mod.enable(sample=0.0)
        mon = health_mod.HealthMonitor(health_mod.HealthConfig(flight_dir=str(tmp_path / name)))
        mon.flight.record("submit", request=1)  # as the service's on_submit does before any chunk
        for _ in range(2):
            mon.on_chunk(_Key(), 1, 8, 1e-4, compiled=False)
        dumps[name] = mon.dump("after_chunks")
        obs_mod.disable()
    with pytest.raises(ValueError, match="not strictly increasing"):
        jflight.load_flightrec(dumps["repro"])
    for load in (flightrec.load_flightrec, jflight.load_flightrec):
        doc = load(dumps["port"])
        assert [(e["seq"], e["kind"], e.get("chunk")) for e in doc["events"]] == [
            (1, "submit", None), (2, "chunk", 1), (3, "chunk", 2)]
    with pytest.raises(ValueError, match="seq"):
        flightrec.FlightRecorder().record("chunk", seq=3)


# ---------------------------------------------------------------------------
# shadow sampling: the floor law, the drift metric
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rate", [0.0, 0.25, 0.3, 1 / 3, 0.5, 1.0])
def test_sampler_follows_repro_floor_law(rate):
    mine, ref = shadow.ShadowSampler(rate), jshadow.ShadowSampler(rate)
    picks = [mine.pick() for _ in range(40)]
    assert picks == [ref.pick() for _ in range(40)]
    assert picks == [math.floor((n + 1) * rate) > math.floor(n * rate) for n in range(40)] if rate else not any(picks)
    with pytest.raises(ValueError):
        shadow.ShadowSampler(1.5)


def _drift_pairs():
    g = np.random.default_rng(3)
    b = g.standard_normal((3, 8, 8)).astype(np.float32) + 10
    a = b + g.standard_normal(b.shape).astype(np.float32) * 1e-3
    c = a.copy()
    c[1, 2, 3] = np.inf
    return [(a, b, 0.0), (a, b, 10.0), (b, b, 0.0), (c, b, 0.0), (b, c, 0.0), (np.zeros(4, np.float32), np.zeros(4, np.float32), 0.0),
            (np.ones(4, np.float32), np.zeros(4, np.float32), 0.0)]


@pytest.mark.parametrize("form", ["numpy", "tensor", "packed"])
def test_rel_l2_and_nonfinite_equal_repro(form):
    for a, b, off in _drift_pairs():
        want = jshadow.rel_l2(a, b, offset=off)
        if form == "numpy":
            got = shadow.rel_l2(a, b, offset=off)
        elif form == "tensor":
            got = shadow.rel_l2(torch.from_numpy(a), (torch.from_numpy(b),), offset=off)
        else:
            p = pack_state(torch.from_numpy(a), PRESETS["r2f2_16"].fmt)
            assert isinstance(p, PackedArray)
            got = shadow.rel_l2(p, b, offset=off)
            want = jshadow.rel_l2(unpack_state(p).numpy(), b, offset=off)
            as_numpy = PackedArray(p.payload.numpy(), p.k.numpy(), p.fmt, p.shape, p.block)
            assert shadow.rel_l2(as_numpy, b, offset=off) == want
        assert got == want or (math.isnan(got) and math.isnan(want))
    x = np.array([1.0, np.nan, np.inf, 4.0], np.float32)
    tree = {"u": x, "k": np.arange(4, dtype=np.int32)}
    assert shadow.nonfinite_fraction(tree) == jshadow.nonfinite_fraction(tree) == 0.5
    assert shadow.nonfinite_fraction({"u": torch.from_numpy(x), "k": torch.arange(4)}) == 0.5
    p = pack_state(torch.from_numpy(np.where(np.isfinite(x), x, np.float32(2.0))), PRESETS["r2f2_16"].fmt)
    assert shadow.nonfinite_fraction(p) == 0.0 and shadow.nonfinite_fraction({"k": np.arange(3)}) == 0.0
    with pytest.raises(ValueError):
        shadow.rel_l2(np.zeros(3, np.float32), np.zeros(4, np.float32))


# ---------------------------------------------------------------------------
# the oracle: repro's replay, bit for bit
# ---------------------------------------------------------------------------


def _cfg(name):
    from repro_torch.pde import get_stepper

    return dataclasses.replace(get_stepper(name).default_config(), **SMALL_OV[name])


@pytest.mark.parametrize("name", sorted(SMALL_OV))
def test_oracle_replay_equals_repro(name, repro_health):
    sim = Simulation(name, _cfg(name), TRACKED, device="cpu")
    oracle = sim.oracle()
    assert oracle.prec.mode == "f32" and oracle.device == sim.device and oracle.cfg == sim.cfg
    torch.set_flush_denormal(True)  # XLA:CPU flushes subnormal results
    for s0, (state, snaps) in zip(state0s(name), repro_health[name]["replays"]):
        res = sim.oracle_replay(STEPS, state0=s0)
        np.testing.assert_array_equal(bits(res.state), bits(state))
        np.testing.assert_array_equal(bits(res.snapshots), bits(snaps))
        assert res.tracker is None
    packed = pack_state(torch.from_numpy(state0s(name)[0]), PRESETS["r2f2_16"].fmt)
    from_packed = sim.oracle_replay(STEPS, state0=packed, snapshot_every=EVERY)
    decoded = sim.oracle_replay(STEPS, state0=unpack_state(packed), snapshot_every=EVERY)
    np.testing.assert_array_equal(bits(from_packed.state), bits(decoded.state))


def test_oracle_replay_is_an_obs_citizen():
    """Under an enabled scope the replay records its ``sim.run`` span on the
    reference plane and counts ``repro_sim_runs_total``, as repro's does."""
    scope = obs.enable(sample=1.0)
    sim = Simulation("heat1d", _cfg("heat1d"), TRACKED, device="cpu")
    sim.oracle_replay(4)
    spans = [s for s in scope.tracer.spans if s.name == "sim.run"]
    assert len(spans) == 1 and spans[0].args["mode"] == "f32" and spans[0].args["execution"] == "reference"
    assert scope.registry.counter("repro_sim_runs_total").value(stepper="heat1d", mode="f32",
                                                                 execution="reference") == 1


# ---------------------------------------------------------------------------
# the monitored service: passive, every request shadowed, repro's drift
# ---------------------------------------------------------------------------


def serve(name, execution, flight_dir=None):
    """Two rr_tracked requests in one bucket; with ``flight_dir`` under obs
    and the monitor at ``shadow_rate=1.0``. Returns results and monitor."""
    if flight_dir is not None:
        obs.enable(sample=1.0)
        health.enable(shadow_rate=1.0, flight_dir=str(flight_dir))
    svc = SimService(ServiceConfig(max_bucket=4), device="cpu")
    hs = [svc.submit(SimRequest(name, steps=STEPS, precision=TRACKED, overrides=SMALL_OV[name],
                                snapshot_every=EVERY, execution=execution, state0=s0)) for s0 in state0s(name)]
    svc.run_until_idle()
    monitor = health.active()
    health.disable()
    obs.disable()
    assert svc.metrics.occupancy()[1] == 2 and all(h.bucket_key.execution == execution for h in hs)
    return [h.result() for h in hs], monitor


@pytest.mark.parametrize("name", sorted(SMALL_OV))
@pytest.mark.parametrize("execution", PLANES)
def test_served_bits_identical_under_health(name, execution, repro_health, tmp_path):
    """Monitor on = monitor off, bit for bit (state, snapshots, tracker k and
    §5.3 counters, final_k); both requests shadowed, none alerted; and each
    ``shadow_rel`` equals repro's megakernel burst's as a float (on the
    megakernel plane it is repro's own plane; the port's three planes serve
    the same bits)."""
    torch.set_flush_denormal(True)  # XLA:CPU flushes subnormal results
    base, _ = serve(name, execution)
    inst, monitor = serve(name, execution, tmp_path)
    assert len(monitor.shadow_rel) == 2 and monitor.alerts == [] and not monitor.dump_paths
    assert all(rel <= monitor.config.err_budget for rel in monitor.shadow_rel.values())
    assert list(monitor.shadow_rel.values()) == list(repro_health[name]["rel"].values())
    assert repro_health[name]["alerts"] == []
    for b, i in zip(base, inst):
        np.testing.assert_array_equal(bits(b.state), bits(i.state))
        assert b.snapshot_steps == i.snapshot_steps
        np.testing.assert_array_equal(bits(np.stack(b.snapshots)), bits(np.stack(i.snapshots)))
        np.testing.assert_array_equal(b.tracker.state.k.numpy(), i.tracker.state.k.numpy())
        np.testing.assert_array_equal(b.tracker.state.overflow_steps.numpy(), i.tracker.state.overflow_steps.numpy())
        assert b.final_k == i.final_k
    v = monitor.verdict()
    assert v["shadow"]["sampled"] == 2 and v["shadow"]["breaches"] == 0 and v["shadow"]["burn"] == 0.0
    assert v["chunks"] == 2 and v["status"] == "ok"


def test_storm_burst_equals_repro(repro_health, tmp_path):
    torch.set_flush_denormal(True)  # XLA:CPU flushes subnormal results
    obs.enable(sample=1.0)
    monitor = health.enable(flight_dir=str(tmp_path))
    svc = SimService(device="cpu")
    handles = health._storm_burst(svc, members=1)
    svc.run_until_idle()
    assert all(h.status == "done" for h in handles)  # overflow, not crash
    got = [a.to_dict() for a in monitor.alerts]
    assert got == repro_health["storm"]["alerts"]
    assert [(a["kind"], a["detail"]["signal"]) for a in got] == [("overflow_storm", "nonfinite")]
    assert got[0]["detail"]["fraction"] > 0
    v = monitor.verdict()
    assert v["status"] == "alerting" == repro_health["storm"]["verdict"]["status"]
    assert v["alerts"] == repro_health["storm"]["verdict"]["alerts"]
    assert len(monitor.dump_paths) == len(repro_health["storm"]["dumps"]) == 1
    docs = [load(monitor.dump_paths[0]) for load in (flightrec.load_flightrec, jflight.load_flightrec)]
    assert docs[0] == docs[1] and docs[0]["reason"] == "overflow_storm"
    assert {"alert", "submit"} <= {e["kind"] for e in docs[0]["events"]}
    theirs = jflight.load_flightrec(repro_health["storm"]["dumps"][0])
    assert [e["kind"] for e in docs[0]["events"]] == [e["kind"] for e in theirs["events"]]


def test_packed_request_replays_from_its_f32_state(tmp_path):
    """A packed request's shadow job keeps the f32 state it was admitted
    with (the record's state is packed at admission), so its drift counts
    the entry pack, as repro's replay of its f32 record does."""
    obs.enable(sample=1.0)
    monitor = health.enable(shadow_rate=1.0, flight_dir=str(tmp_path))
    svc = SimService(device="cpu")
    s0 = state0s("heat1d")[0]
    h = svc.submit(SimRequest("heat1d", steps=STEPS, precision="r2f2_16", overrides=SMALL_OV["heat1d"],
                              snapshot_every=EVERY, storage="packed", state0=s0))
    job = monitor._pending[h.id]
    assert isinstance(h._record.state, PackedArray) and isinstance(job.state0, np.ndarray)
    np.testing.assert_array_equal(bits(job.state0), bits(s0))
    svc.run_until_idle()
    want = shadow.rel_l2(h.result().state, job.sim.oracle_replay(STEPS, state0=s0).state)
    assert monitor.shadow_rel == {h.id: want} and 0 < want < monitor.config.err_budget


@pytest.mark.parametrize("card", [False, True])
def test_shadow_copy_keeps_pinned_subnormals(card, monkeypatch, tmp_path):
    """A heat1d request whose pinned boundary cells (and two interior cells)
    hold f32 subnormals set from bits: its shadow copy keeps every bit, and
    the oracle replays from them. With ``card`` the card's scope is emulated
    on the CPU (``on_card`` True, the flush mode in force, the CPU's own flag
    clear): the copy is made outside the mode, and the replay's run moves
    it before it enters the mode, so the pinned cells keep their bits to the
    oracle's final state."""
    if card:
        monkeypatch.setattr(ftz, "on_card", lambda device: True)
    else:
        torch.set_flush_denormal(True)
    cfg = _cfg("heat1d")
    u0 = Simulation("heat1d", cfg, TRACKED, device="cpu").stepper.init_state(cfg, device="cpu").clone()
    cells = [(0,), (5,), (cfg.nx - 1,), (17,)]
    for at, b in zip(cells, SUBNORMALS):
        u0.view(torch.int32)[at] = b
    want = bits(u0.numpy())
    obs.enable(sample=1.0)
    monitor = health.enable(shadow_rate=1.0, flight_dir=str(tmp_path))
    svc = SimService(device="cpu")
    h = svc.submit(SimRequest("heat1d", steps=STEPS, precision=TRACKED, cfg=cfg, snapshot_every=EVERY, state0=u0))
    job = monitor._pending[h.id]
    np.testing.assert_array_equal(bits(job.state0), want)
    svc.run_until_idle()
    np.testing.assert_array_equal(bits(job.state0), want)
    oracle = job.sim.oracle_replay(STEPS, state0=job.state0)
    got = bits(oracle.state.numpy())
    assert got[0] == want[0] and got[-1] == want[-1]  # the pinned cells' bits, to the end
    assert monitor.shadow_rel == {h.id: shadow.rel_l2(h.result().state, oracle.state, offset=job.offset)}
    assert monitor.alerts == []


# ---------------------------------------------------------------------------
# the gate, the server and the offline report
# ---------------------------------------------------------------------------


def test_run_smoke_clean_and_storm(tmp_path, capsys):
    assert health.run_smoke(str(tmp_path / "clean"), "clean", device="cpu") == 0
    assert health.run_smoke(str(tmp_path / "storm"), "storm", device="cpu") == 3
    out = capsys.readouterr().out
    assert "health smoke passed" in out and "storm burst alerted (exit 3" in out and "FAIL" not in out
    assert health.active() is None and obs.active() is None
    # the offline report over the storm's exported artifacts: repro's replay of the same telemetry
    v = health.offline_verdict(str(tmp_path / "storm"))
    assert v == jhealth.offline_verdict(str(tmp_path / "storm"))
    assert health.main(["--dir", str(tmp_path / "storm")]) == 0  # the pinned storm never moved a grow counter


def test_service_cli_health(tmp_path, monkeypatch, capsys):
    """``python -m repro_torch.service --health``: a clean burst under the
    monitor exits 0 with every request shadowed (an alert would exit 3)."""
    from repro_torch.service.__main__ import main

    monkeypatch.chdir(tmp_path)
    assert main(["--smoke", "--device", "cpu", "--steppers", "heat1d", "--per", "1", "--health",
                 "--shadow-rate", "1.0"]) == 0
    assert "health: ok — 0 alert(s), shadow sampled 2" in capsys.readouterr().out
    assert health.active().shadow_rel.keys() == {1, 2}


def test_server_routes(tmp_path):
    verdict = {"status": "alerting", "burn": float("nan")}

    def broken():
        raise RuntimeError("provider down")

    server = HealthServer(metrics_fn=lambda: "# HELP x y\n", health_fn=lambda: verdict, telemetry_fn=broken).start()
    try:
        with urlopen(server.url + "/metrics", timeout=10) as r:
            assert r.read().decode() == "# HELP x y\n"
        for route, code in (("/health", 503), ("/telemetry", 500), ("/nope", 404)):
            with pytest.raises(HTTPError) as e:
                urlopen(server.url + route, timeout=10)
            assert e.value.code == code
            body = json.loads(e.value.read().decode())
            assert (body["burn"] is None) if route == "/health" else "error" in body
    finally:
        server.stop()
    server.stop()


def test_enable_installs_a_monitor_on_the_canonical_module(tmp_path):
    mon = health.enable(shadow_rate=0.5, flight_dir=str(tmp_path))
    assert health.active() is mon and isinstance(mon, HealthMonitor) and obs.active() is mon.obs
    assert mon.config.shadow_rate == 0.5 and isinstance(Alert("k", "s", "", 1), Alert)
    again = health.enable(HealthConfig(window=4), shadow_rate=1.0)
    assert health.active() is again and again.config.window == 4 and again.config.shadow_rate == 1.0
    health.disable()
    assert health.active() is None
