"""repro_torch.service, the serving plane, on the CPU (the kernels' plain
versions). Packing is invisible: for every builtin stepper in every mode of
repro's TestPackingInvisibility, on the reference plane and through auto
(the megakernel plane here), two requests share a bucket, the second
joining mid-flight with a misaligned cadence, and each equals the port's
solo ``Simulation.run`` bit for bit, tracker included (the existing tests
hold those solo runs against repro). Around it: the fused plane's rr_tracked
relaxation, the remainder horizon, scheduling, backpressure and admission
rejections, per-request policies from a ``repro.profile/policy`` v1
artifact, eviction and resume (f32 and packed), streams, the metrics
surface, the compile split, the chunk cache, sharding under
``axis_rules(LocalMesh())``, and one anchor across the packages: heat1d
and swe2d rr_tracked buckets with a misaligned mid-flight joiner served by
repro.service and by the port, equal bit for bit (repro's side runs once
per module)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.core.flexformat import FlexFormat
from repro_torch.core.policy import PRESETS, PrecisionConfig
from repro_torch.dist import LocalMesh, axis_rules
from repro_torch.pack import PackedArray
from repro_torch.pde import (
    AdvectionConfig, BurgersConfig, Heat2DConfig, HeatConfig, Simulation, Stepper, SWEConfig, register_stepper,
)
from repro_torch.profile import PrecisionPolicy
from repro_torch.service import (
    ServiceConfig, ServiceOverloaded, SimRequest, SimService, resolve_request, scaled_state0,
)
from repro_torch.service.batcher import tree_slice, tree_stack

TRACKED = dataclasses.replace(PRESETS["r2f2_16"], mode="rr_tracked")
SMALL_CFGS = {
    "heat1d": HeatConfig(nx=48),
    "heat2d": Heat2DConfig(nx=16, ny=16),
    "advection1d": AdvectionConfig(nx=64),
    "burgers1d": BurgersConfig(nx=48),
    "swe2d": SWEConfig(nx=16, ny=16),
}
MODES = {
    "f32": PRESETS["f32"],
    "bf16": PRESETS["bf16"],
    "e5m10": PRESETS["e5m10"],
    "r2f2_16": PRESETS["r2f2_16"],
    "deploy": PRESETS["deploy"],
    "rr_tracked": TRACKED,
}
#: f32 subnormals as bits: 1e-40, -3e-39, the smallest, the largest
SUBNORMALS = np.array([0x000116C2, 0x8020AB1B, 0x00000001, 0x007FFFFF], np.uint32)


@pytest.fixture(autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def service(**kw):
    return SimService(ServiceConfig(**kw), device="cpu")


def bits(x):
    x = np.ascontiguousarray(np.asarray(x, np.float32))
    b = x.view(np.uint32).copy()
    b[np.isnan(x)] = 0x7FC00000
    return b


def assert_trackers_equal(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        for x, y in zip(a.state, b.state):
            np.testing.assert_array_equal(np.asarray(x.cpu()), np.asarray(y.cpu()))


def assert_same_as_solo(h, solo, snapshots_exact=True):
    res = h.result()
    assert_trackers_equal(res.tracker, solo.tracker)
    if snapshots_exact:
        np.testing.assert_array_equal(bits(np.stack(h.snapshots)), bits(solo.snapshots.numpy()))
        np.testing.assert_array_equal(bits(res.state), bits(solo.state.numpy()))
    else:
        np.testing.assert_allclose(np.stack(h.snapshots), solo.snapshots.numpy(), rtol=2e-2, atol=1e-5)


def scaled(sim, s):
    return s * sim.stepper.init_state(sim.cfg, device="cpu")


# ---------------------------------------------------------------------------
# packing invisibility per stepper x mode, on the reference plane and auto
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("execution", ("reference", "auto"))
@pytest.mark.parametrize("stepper", sorted(SMALL_CFGS))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_bucketed_equals_solo(mode, stepper, execution):
    """Two requests share a bucket; the second joins mid-flight with a
    misaligned cadence (chunks of 8, 6, 2, 4, ... steps); each reproduces its
    solo run."""
    prec, cfg = MODES[mode], SMALL_CFGS[stepper]
    sim = Simulation(stepper, cfg, prec, device="cpu")
    s0b = scaled(sim, 0.5)
    svc = service()
    hA = svc.submit(SimRequest(stepper, steps=24, precision=prec, cfg=cfg, snapshot_every=8, execution=execution))
    assert svc.pump()
    hB = svc.submit(SimRequest(stepper, steps=18, precision=prec, cfg=cfg, snapshot_every=6, state0=s0b,
                               execution=execution))
    svc.run_until_idle()
    assert hA.status == hB.status == "done"
    assert svc.metrics.occupancy()[1] == 2  # one bucket, continuous batching
    plane = hA.bucket_key.execution
    assert plane == ("megakernel" if execution == "auto" else "reference")
    soloA = sim.run(24, snapshot_every=8, execution=plane)
    soloB = sim.run(18, snapshot_every=6, state0=s0b, execution=plane)
    for h, solo in ((hA, soloA), (hB, soloB)):
        assert_same_as_solo(h, solo)


def test_fused_bucket_parity():
    """The fused plane: deploy bit-exactly through a bucket with a mid-flight
    joiner; rr_tracked (whose floor latches at the bucket's chunk
    boundaries) to the identical final split and §5.3 counters."""
    cfg = Heat2DConfig(nx=16, ny=16)
    for prec, exact in ((PRESETS["deploy"], True), (TRACKED, False)):
        sim = Simulation("heat2d", cfg, prec, device="cpu")
        svc = service()
        hA = svc.submit(SimRequest("heat2d", steps=12, precision=prec, cfg=cfg, snapshot_every=4, execution="fused"))
        assert svc.pump()
        hB = svc.submit(SimRequest("heat2d", steps=12, precision=prec, cfg=cfg, snapshot_every=3,
                                   state0=scaled(sim, 0.5), execution="fused"))
        svc.run_until_idle()
        assert svc.metrics.occupancy()[1] == 2
        assert_same_as_solo(hA, sim.run(12, snapshot_every=4, execution="fused"), exact)
        assert_same_as_solo(hB, sim.run(12, snapshot_every=3, state0=scaled(sim, 0.5), execution="fused"), exact)


def test_remainder_horizon():
    cfg = HeatConfig(nx=48)
    svc = service()
    h = svc.submit(SimRequest("heat1d", steps=23, precision="r2f2_16", cfg=cfg, snapshot_every=8,
                              execution="reference"))
    svc.run_until_idle()
    assert h.snapshot_steps == [8, 16]
    assert_same_as_solo(h, Simulation("heat1d", cfg, PRESETS["r2f2_16"], device="cpu").run(23, snapshot_every=8))


def test_subnormal_state0_bucketed_against_solo():
    """A request whose state0 holds f32 subnormals set from bits, in interior
    and pinned boundary cells, bucketed with another, equals its solo run."""
    cfg = HeatConfig(nx=48)
    sim = Simulation("heat1d", cfg, TRACKED, device="cpu")
    s = np.array(scaled(sim, 1.0).numpy(), np.float32, copy=True)
    s.view(np.uint32)[[0, 5, 47, 17]] = SUBNORMALS
    svc = service()
    hA = svc.submit(SimRequest("heat1d", steps=16, precision=TRACKED, cfg=cfg, snapshot_every=4))
    hB = svc.submit(SimRequest("heat1d", steps=16, precision=TRACKED, cfg=cfg, snapshot_every=8, state0=s))
    svc.run_until_idle()
    assert svc.metrics.occupancy()[1] == 2
    assert_same_as_solo(hB, sim.run(16, snapshot_every=8, state0=s, execution=hB.bucket_key.execution))


def test_tree_stack_and_slice_carry_packed_members():
    sim = Simulation("swe2d", SWEConfig(nx=16, ny=16), PRESETS["r2f2_16"], device="cpu")
    from repro_torch.pack import pack_state

    members = [pack_state(scaled(sim, s), PRESETS["r2f2_16"].fmt) for s in (1.0, 0.5)]
    stacked = tree_stack(members)
    assert isinstance(stacked, PackedArray) and stacked.payload.shape[0] == 2
    for i, m in enumerate(members):
        back = tree_slice(stacked, i)
        assert torch.equal(back.payload, m.payload) and torch.equal(back.k, m.k)
    trackers = [sim.init_tracker() for _ in range(2)]
    assert trackers[0] is None
    tr = Simulation("swe2d", SWEConfig(nx=16, ny=16), TRACKED, device="cpu").init_tracker()
    assert tree_slice(tree_stack([tr, tr]), 1).state.k.tolist() == tr.state.k.tolist()


# ---------------------------------------------------------------------------
# scheduling, admission, backpressure
# ---------------------------------------------------------------------------


def test_compatible_requests_share_a_bucket_and_others_get_siblings():
    svc = service()
    cfg = HeatConfig(nx=48)
    for _ in range(3):
        svc.submit(SimRequest("heat1d", steps=8, precision="f32", cfg=cfg))
    svc.submit(SimRequest("heat1d", steps=8, precision="bf16", cfg=cfg))  # mode
    svc.submit(SimRequest("heat1d", steps=8, precision="f32", cfg=HeatConfig(nx=32)))  # cfg
    svc.submit(SimRequest("heat2d", steps=8, precision="f32"))  # stepper
    svc.submit(SimRequest("heat1d", steps=8, precision="r2f2_16", cfg=cfg, storage="packed"))  # storage
    svc._fill()
    assert sorted(len(b) for b in svc._live_buckets()) == [1, 1, 1, 1, 3]


def test_max_bucket_caps_members_per_chunk():
    svc = service(max_bucket=2)
    for _ in range(5):
        svc.submit(SimRequest("heat1d", steps=8, precision="f32", cfg=HeatConfig(nx=48)))
    svc._fill()
    assert sorted(len(b) for b in svc._live_buckets()) == [1, 2, 2]


def test_backpressure_raises_and_counts():
    svc = service(max_queue=2)
    svc.submit(SimRequest("heat1d", steps=8))
    svc.submit(SimRequest("heat1d", steps=8))
    with pytest.raises(ServiceOverloaded):
        svc.submit(SimRequest("heat1d", steps=8))
    assert svc.metrics.rejected == 1 and svc.metrics.submitted == 2


def test_bad_requests_rejected_at_admission():
    svc = service()
    with pytest.raises(KeyError, match="no PDE stepper"):
        svc.submit(SimRequest("not-a-stepper", steps=8))
    with pytest.raises(ValueError, match="horizon"):
        svc.submit(SimRequest("heat1d", steps=0))
    with pytest.raises(ValueError, match="snapshot_every"):
        svc.submit(SimRequest("heat1d", steps=8, snapshot_every=-5))
    with pytest.raises(ValueError, match="unknown storage"):
        svc.submit(SimRequest("heat1d", steps=8, storage="bogus"))
    assert svc.metrics.rejected == 4


def test_explicit_fused_ineligible_rejected_at_submit():
    from repro_torch.pde.registry import _STEPPERS

    class NoFused(Stepper):
        sites = ("nf.mul",)

        def default_config(self):
            return None

        def init_state(self, cfg, *, device):
            return torch.ones((8,), dtype=torch.float32, device=device)

        def step(self, u, cfg, ops):
            return ops.mul(torch.tensor(0.5), u, "nf.mul")

    try:
        register_stepper("test_nofused", NoFused)
        svc = service()
        with pytest.raises(ValueError, match="not fused-eligible"):
            svc.submit(SimRequest("test_nofused", steps=4, precision="f32", execution="fused"))
        assert svc.metrics.rejected == 1
        h = svc.submit(SimRequest("test_nofused", steps=4, precision="f32", snapshot_every=2))
        assert h.bucket_key.execution == "reference"
        svc.run_until_idle()
        np.testing.assert_array_equal(h.result().state, np.full(8, 0.0625, np.float32))
    finally:
        _STEPPERS.pop("test_nofused", None)


def test_max_active_members_bounds_occupancy():
    svc = service(max_active_members=2)
    for _ in range(4):
        svc.submit(SimRequest("heat1d", steps=8, precision="f32", cfg=HeatConfig(nx=48), snapshot_every=4))
    svc.run_until_idle()
    assert svc.metrics.completed == 4 and svc.metrics.occupancy()[1] <= 2


def test_service_needs_a_device_or_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: SimService() takes it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimService()


def test_a_failing_chunk_fails_its_members_and_reraises(monkeypatch):
    svc = service()
    h = svc.submit(SimRequest("heat1d", steps=8, precision="f32", cfg=HeatConfig(nx=48), snapshot_every=4))

    def broken(*a, **kw):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(Simulation, "run_ensemble", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        svc.pump()
    assert h.status == "failed" and svc.metrics.failed == 1
    assert [e.kind for e in h.stream.drain()] == ["failed"]
    with pytest.raises(RuntimeError, match="failed"):
        h.result()


# ---------------------------------------------------------------------------
# eviction and resume through repro_torch.ckpt
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stepper,prec,storage,execution", [
    ("burgers1d", TRACKED, "f32", "reference"),
    ("heat1d", TRACKED, "f32", "auto"),
    ("swe2d", PRESETS["r2f2_16"], "packed", "auto"),
])
def test_evicted_and_resumed_is_bit_identical(tmp_path, stepper, prec, storage, execution):
    cfg = SMALL_CFGS[stepper]
    svc = service(ckpt_dir=str(tmp_path), auto_resume=False)
    kw = dict(steps=30, precision=prec, cfg=cfg, snapshot_every=10, storage=storage, execution=execution)
    hA = svc.submit(SimRequest(stepper, **kw))
    hB = svc.submit(SimRequest(stepper, **kw))
    svc.pump()  # both at elapsed=10
    path = svc.evict(hA.id)
    assert hA.status == "evicted" and os.path.isdir(path) and svc.evicted_ids == [hA.id]
    svc.run_until_idle()  # B completes alone; A stays evicted
    assert hB.status == "done" and hA.status == "evicted"
    svc.resume(hA.id)
    svc.run_until_idle()
    solo = Simulation(stepper, cfg, prec, device="cpu").run(30, snapshot_every=10, storage=storage,
                                                           execution=hA.bucket_key.execution)
    if storage == "packed":
        res = hA.result()
        assert isinstance(res.state, PackedArray)
        np.testing.assert_array_equal(res.state.payload, solo.state.payload.numpy())
        np.testing.assert_array_equal(res.state.k, solo.state.k.numpy())
        np.testing.assert_array_equal(bits(np.stack(hA.snapshots)), bits(solo.snapshots.numpy()))
    else:
        assert_same_as_solo(hA, solo)
    kinds = [e.kind for e in hA.stream.drain()]
    assert kinds == ["snapshot", "evicted", "resumed", "snapshot", "snapshot", "done"]
    assert svc.metrics.evicted == 1 and svc.metrics.resumed == 1


def test_auto_evict_spills_long_horizon_under_pressure(tmp_path):
    cfg = HeatConfig(nx=48)
    svc = service(ckpt_dir=str(tmp_path), max_active_members=1, auto_evict=True, evict_min_remaining=0)
    hLong = svc.submit(SimRequest("heat1d", steps=40, precision="r2f2_16", cfg=cfg, snapshot_every=10))
    svc.pump()
    hShort = svc.submit(SimRequest("heat1d", steps=8, precision="r2f2_16", cfg=cfg, snapshot_every=4))
    svc.run_until_idle()
    assert hLong.status == hShort.status == "done"
    assert svc.metrics.evicted >= 1 and svc.metrics.resumed >= 1
    solo = Simulation("heat1d", cfg, PRESETS["r2f2_16"], device="cpu").run(40, snapshot_every=10,
                                                                           execution=hLong.bucket_key.execution)
    assert_same_as_solo(hLong, solo)


# ---------------------------------------------------------------------------
# per-request policies, from a repro.profile/policy v1 artifact
# ---------------------------------------------------------------------------


def accepted_policy():
    return PrecisionPolicy(
        stepper="heat1d",
        fmt=FlexFormat(3, 9, 3),
        sites={"heat.flux": {"k": 1, "k_lo": 0, "k_hi": 2}, "heat.update": {"k": 2, "k_lo": 1, "k_hi": 3}},
        validation={"accepted": True, "rel_l2_deploy": 0.0},
    )


@pytest.fixture
def policy_file(tmp_path):
    """The accepted artifact as repro writes it (its schema v1 JSON)."""
    from repro.core.flexformat import FlexFormat as JFmt
    from repro.profile import PrecisionPolicy as JPolicy

    pol = accepted_policy()
    return JPolicy(stepper=pol.stepper, fmt=JFmt(3, 9, 3), sites=pol.sites,
                   validation=pol.validation).save(str(tmp_path / "policy.json"))


def test_policy_seeds_tracker_and_bounds(policy_file):
    rec = resolve_request(1, SimRequest("heat1d", steps=8, precision=TRACKED, policy=policy_file), device="cpu")
    assert rec.tracker.state.k.tolist() == [1, 2]
    assert rec.key.prec.k_bounds == ((0, 2), (1, 3)) and rec.key.prec.fmt == FlexFormat(3, 9, 3)


def test_policy_admission_rules():
    svc = service()
    pol = accepted_policy()
    pol.validation = None
    with pytest.raises(ValueError, match="never accepted"):
        svc.submit(SimRequest("heat1d", steps=8, precision=TRACKED, policy=pol))
    assert svc.metrics.rejected == 1
    with pytest.raises(ValueError, match="do not transfer"):
        resolve_request(1, SimRequest("burgers1d", steps=8, precision=TRACKED, policy=accepted_policy()),
                        device="cpu")
    recA = resolve_request(1, SimRequest("heat1d", steps=8, precision=TRACKED, policy=accepted_policy()),
                           device="cpu")
    recB = resolve_request(2, SimRequest("heat1d", steps=8, precision=TRACKED, policy=accepted_policy()),
                           device="cpu")
    polC = accepted_policy()
    polC.sites["heat.flux"]["k_hi"] = 3
    recC = resolve_request(3, SimRequest("heat1d", steps=8, precision=TRACKED, policy=polC), device="cpu")
    assert recA.key == recB.key and recC.key != recA.key


@pytest.mark.parametrize("mode", ("rr_tracked", "deploy"))
def test_service_run_with_policy_matches_solo_policy_run(policy_file, mode):
    prec = TRACKED if mode == "rr_tracked" else PrecisionConfig(mode="deploy", fmt=FlexFormat(3, 9, 3), pinned=True)
    svc = service()
    h = svc.submit(SimRequest("heat1d", steps=16, precision=prec, policy=policy_file, snapshot_every=8,
                              cfg=HeatConfig(nx=48)))
    svc.run_until_idle()
    solo = Simulation("heat1d", HeatConfig(nx=48), dataclasses.replace(prec, fmt=FlexFormat(3, 9, 3)),
                      device="cpu").run(16, snapshot_every=8, policy=PrecisionPolicy.load(policy_file),
                                        execution=h.bucket_key.execution)
    assert_same_as_solo(h, solo)


# ---------------------------------------------------------------------------
# streams, metrics, the compile split and the chunk cache, sharding
# ---------------------------------------------------------------------------


def test_stream_events_arrive_in_order():
    svc = service()
    h = svc.submit(SimRequest("heat1d", steps=12, precision="f32", cfg=HeatConfig(nx=48), snapshot_every=4))
    seen = []
    while svc.pump():
        seen += h.stream.drain()
    assert [e.kind for e in seen] == ["snapshot", "snapshot", "snapshot", "done"]
    assert [e.step for e in seen] == [4, 8, 12, 12]
    assert h.stream.closed
    assert isinstance(seen[0].payload, np.ndarray) and seen[0].payload.shape == (48,)


def test_metrics_surface_and_compile_split():
    svc = service()
    cfg = BurgersConfig(nx=48)
    sim = Simulation("burgers1d", cfg, TRACKED, device="cpu")
    for s in (1.0, 0.5):
        svc.submit(SimRequest("burgers1d", steps=12, precision=TRACKED, cfg=cfg, snapshot_every=4,
                              state0=scaled(sim, s)))
    svc.run_until_idle()
    s = svc.metrics.summary()
    assert s["submitted"] == s["completed"] == 2
    assert s["chunks"] == 3 and s["compiles"] == 1  # three shared chunks of one program
    assert s["member_steps"] == 24 and s["compile_seconds"] > 0
    assert s["occupancy_mean"] == 2.0 and s["occupancy_max"] == 2
    assert s["throughput_steps_per_s"] > 0 and np.isfinite(s["chunk_latency_p50_us"])
    assert s["chunk_latency_p99_us"] >= s["chunk_latency_p50_us"]
    assert set(s["site_adjustments"]) == {"burgers.uu", "burgers.flux"}
    assert [c for *_, c in svc.metrics.chunk_samples] == [True, False, False]
    assert "throughput" in svc.metrics.report()


def test_chunk_cache_reused_across_repacks():
    svc = service()
    cfg = HeatConfig(nx=48)
    svc.submit(SimRequest("heat1d", steps=12, precision="f32", cfg=cfg, snapshot_every=4))
    svc.run_until_idle()
    n_first, compiles = len(svc._compiler), svc.metrics.compiles
    svc.submit(SimRequest("heat1d", steps=12, precision="f32", cfg=cfg, snapshot_every=4))
    svc.run_until_idle()
    assert len(svc._compiler) == n_first and svc.metrics.compiles == compiles


def test_service_under_mesh_context():
    cfg = BurgersConfig(nx=48)
    svc = service()  # sharded=None: auto-detect
    with axis_rules(LocalMesh()):
        hs = [svc.submit(SimRequest("burgers1d", steps=12, precision="r2f2_16", cfg=cfg, snapshot_every=4))
              for _ in range(2)]
        svc.run_until_idle()
        assert all(k[3] for k in svc._compiler._cache)  # the chunks ran sharded
    solo = Simulation("burgers1d", cfg, PRESETS["r2f2_16"], device="cpu").run(
        12, snapshot_every=4, execution=hs[0].bucket_key.execution)
    for h in hs:
        assert_same_as_solo(h, solo)


def test_scaled_state0_and_host_results():
    s0 = scaled_state0("heat1d", 0.5, overrides={"nx": 48}, device="cpu")
    sim = Simulation("heat1d", HeatConfig(nx=48), PRESETS["f32"], device="cpu")
    assert torch.equal(s0, 0.5 * sim.stepper.init_state(sim.cfg, device="cpu"))
    svc = service()
    h = svc.submit(SimRequest("heat1d", steps=4, cfg=HeatConfig(nx=48), state0=s0.numpy(), snapshot_every=2))
    svc.run_until_idle()
    assert isinstance(h.result().state, np.ndarray) and h.result().state.dtype == np.float32


# ---------------------------------------------------------------------------
# the anchor across the packages: repro.service against the port's
# ---------------------------------------------------------------------------

ANCHOR = ("heat1d", "swe2d")
#: request A at 8 steps every 4, and B at 6 every 3 joining after A's first
#: chunk: chunks of 4, 3, 1 and 3 steps
ANCHOR_A, ANCHOR_B = dict(steps=8, snapshot_every=4), dict(steps=6, snapshot_every=3)


def anchor_state0(name):
    """repro's config, the port's config fields, and the two numpy states."""
    from repro.pde import Simulation as JSim

    cfg = {"heat1d": ("repro.pde.heat1d", "HeatConfig", dict(nx=32)),
           "swe2d": ("repro.pde.swe2d", "SWEConfig", dict(nx=16, ny=16))}[name]
    import importlib

    jcfg = getattr(importlib.import_module(cfg[0]), cfg[1])(**cfg[2])
    s0 = np.asarray(JSim(name, jcfg, None).stepper.init_state(jcfg), np.float32)
    return jcfg, cfg[2], s0, np.asarray(s0 * np.float32(0.5), np.float32)


@pytest.fixture(scope="module")
def repro_anchor():
    """repro.service's results for the anchor buckets, once per module."""
    import repro.obs as jobs
    from repro.core import policy as jpol
    from repro.service import ServiceConfig as JConfig
    from repro.service import SimRequest as JRequest
    from repro.service import SimService as JService

    jobs.disable()
    jtracked = dataclasses.replace(jpol.PRESETS["r2f2_16"], mode="rr_tracked")
    out = {}
    for name in ANCHOR:
        jcfg, _, s0a, s0b = anchor_state0(name)
        svc = JService(JConfig())
        hA = svc.submit(JRequest(name, precision=jtracked, cfg=jcfg, state0=s0a, **ANCHOR_A))
        svc.pump()
        hB = svc.submit(JRequest(name, precision=jtracked, cfg=jcfg, state0=s0b, **ANCHOR_B))
        svc.run_until_idle()
        out[name] = [(h.bucket_key.execution, h.result()) for h in (hA, hB)]
    return out


@pytest.mark.parametrize("name", ANCHOR)
def test_rr_tracked_buckets_equal_repro_service(name, repro_anchor):
    from repro_torch.pde import get_stepper

    _, kw, s0a, s0b = anchor_state0(name)
    cfg = dataclasses.replace(get_stepper(name).default_config(), **kw)
    torch.set_flush_denormal(True)  # XLA:CPU flushes subnormal results
    try:
        svc = service()
        hA = svc.submit(SimRequest(name, precision=TRACKED, cfg=cfg, state0=s0a, **ANCHOR_A))
        svc.pump()
        hB = svc.submit(SimRequest(name, precision=TRACKED, cfg=cfg, state0=s0b, **ANCHOR_B))
        svc.run_until_idle()
    finally:
        torch.set_flush_denormal(False)
    assert svc.metrics.occupancy()[1] == 2
    for h, (plane, ref) in zip((hA, hB), repro_anchor[name]):
        res = h.result()
        assert h.bucket_key.execution == plane == "megakernel"
        assert res.snapshot_steps == ref.snapshot_steps and res.chunks == ref.chunks
        np.testing.assert_array_equal(bits(res.state), bits(ref.state))
        np.testing.assert_array_equal(bits(np.stack(res.snapshots)), bits(np.stack(ref.snapshots)))
        assert res.final_k == ref.final_k and res.adjustments == ref.adjustments
        for x, y in zip(res.tracker.state, ref.tracker.state):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_packed_joiner_stacks_with_running_packed_members():
    """A packed request that joins a running packed bucket stacks with its
    members' payloads (it is packed at admission) and equals its solo run
    where the bucket's chunks are its own snapshot intervals."""
    cfg = SWEConfig(nx=16, ny=16)
    sim = Simulation("swe2d", cfg, PRESETS["r2f2_16"], device="cpu")
    svc = service()
    kw = dict(steps=12, precision="r2f2_16", cfg=cfg, snapshot_every=4, storage="packed")
    hA = svc.submit(SimRequest("swe2d", **kw))
    assert svc.pump()
    hB = svc.submit(SimRequest("swe2d", state0=scaled(sim, 0.5), **kw))
    assert isinstance(hB._record.state, PackedArray)
    svc.run_until_idle()
    assert svc.metrics.occupancy()[1] == 2
    for h, s0 in ((hA, None), (hB, scaled(sim, 0.5))):
        solo = sim.run(12, snapshot_every=4, state0=s0, storage="packed", execution=h.bucket_key.execution)
        np.testing.assert_array_equal(h.result().state.payload, solo.state.payload.numpy())
        np.testing.assert_array_equal(h.result().state.k, solo.state.k.numpy())
        np.testing.assert_array_equal(bits(np.stack(h.snapshots)), bits(solo.snapshots.numpy()))
