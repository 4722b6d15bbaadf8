"""repro_torch.precision (engines, registry, sites, fusion) and
repro_torch.convert against repro.precision.

The reference engines run under ``jax.jit``, as the solver runs them: that
is where XLA:CPU drops the bf16 result rounding and fuses plain f32
products into the adds that follow them, and the port follows the reference
as it runs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jpol
from repro.precision import fold_evidence as j_fold
from repro.precision import get_engine as j_engine
from repro.precision import site_tracker_init as j_site_init
from repro_torch import convert
from repro_torch.core import policy as tpol
from repro_torch.precision import FUSED_FAMILIES, SiteTracker, fused_eligible, fused_family, register_engine, resolve_site
from repro_torch.precision import fold_evidence as t_fold
from repro_torch.precision import get_engine as t_engine
from repro_torch.precision import registry as t_registry
from repro_torch.precision import site_tracker_init as t_site_init
from repro_torch.precision.engine import PrecisionEngine

MODES = ("f32", "bf16", "fixed", "rr_tile", "rr_tracked", "deploy")
SITES = ("s.mul", "s.div")


@pytest.fixture(scope="module", autouse=True)
def torch_env():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def bits(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(np.uint32)


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def jprec(mode):
    return dataclasses.replace(jpol.PRESETS["r2f2_16"], mode=mode)


def tprec(mode):
    return dataclasses.replace(tpol.PRESETS["r2f2_16"], mode=mode)


def operands(seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((6, 10)) * 400).astype(np.float32)
    b = (rng.standard_normal((6, 10)) * 3 + 0.3).astype(np.float32)
    c = (rng.standard_normal((6, 10)) * 50).astype(np.float32)
    return a, b, c


def assert_tracker_equal(jtr, ttr):
    for f in jtr.state._fields:
        want, got = np.asarray(getattr(jtr.state, f)), getattr(ttr.state, f).numpy()
        if want.dtype == np.float32:
            np.testing.assert_array_equal(bits(want), bits(got))
        else:
            np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("mode", MODES)
def test_engine_ops_bit_exact_untracked(mode):
    """multiply / divide / add / store for every engine, no tracker."""
    a, b, _ = operands()
    je, te = j_engine(mode), t_engine(mode)
    jp, tp = jprec(mode), tprec(mode)
    jout = jax.jit(lambda a, b: (
        je.multiply(a, b, jp)[0], je.divide(a, b, jp)[0], je.add(a, b, jp)[0], je.store(a, jp)
    ))(a, b)
    tout = (te.multiply(t(a), t(b), tp)[0], te.divide(t(a), t(b), tp)[0], te.add(t(a), t(b), tp)[0], te.store(t(a), tp))
    for want, got in zip(jout, tout):
        np.testing.assert_array_equal(bits(want), bits(got.numpy()))


@pytest.mark.parametrize("mode", MODES)
def test_multiply_add_matches_compiled_reference(mode):
    """``c + policy(a*b)`` as the solver writes it: one rounding where XLA
    fuses the product (f32, bf16, deploy), two elsewhere."""
    a, b, c = operands(1)
    je, te = j_engine(mode), t_engine(mode)
    jp, tp = jprec(mode), tprec(mode)
    want = jax.jit(lambda a, b, c: c + je.multiply(a, b, jp)[0])(a, b, c)
    got = te.multiply_add(t(a), t(b), t(c), tp)[0]
    np.testing.assert_array_equal(bits(want), bits(got.numpy()))


@pytest.mark.parametrize("mode", ["rr_tracked", "deploy"])
@pytest.mark.parametrize("pinned", [False, True])
def test_tracked_engines_bit_exact(mode, pinned):
    """Tracked engines: outputs and every tracker field after a sequence of
    multiplies and divides at two named sites, started narrow (k0=0)."""
    jp = dataclasses.replace(jprec(mode), pinned=pinned)
    tp = dataclasses.replace(tprec(mode), pinned=pinned)
    je, te = j_engine(mode), t_engine(mode)
    seq = [operands(s) for s in range(4)]

    def jrun(tr, seq):
        outs = []
        for a, b, _ in seq:
            y, tr = je.multiply(a, b, jp, tracker=tr, site="s.mul")
            z, tr = je.divide(a, b, jp, tracker=tr, site="s.div")
            outs += [y, z]
        return outs, tr

    jouts, jtr = jax.jit(jrun)(j_site_init(SITES, jp.fmt, k0=0), seq)
    ttr = t_site_init(SITES, tp.fmt, k0=0, device="cpu")
    touts = []
    for a, b, _ in seq:
        y, ttr = te.multiply(t(a), t(b), tp, tracker=ttr, site="s.mul")
        z, ttr = te.divide(t(a), t(b), tp, tracker=ttr, site="s.div")
        touts += [y, z]
    for want, got in zip(jouts, touts):
        np.testing.assert_array_equal(bits(want), bits(got.numpy()))
    assert_tracker_equal(jtr, ttr)


def test_rsqrt_engines_close():
    """rsqrt is not correctly rounded in either library's f32 substrate; the
    f32 engine agrees to 3 ulps (the reference's own oracle bound)."""
    x = np.exp(np.random.default_rng(2).uniform(-8, 8, 500)).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: j_engine("f32").rsqrt(x, jprec("f32"))[0])(x))
    got = t_engine("f32").rsqrt(t(x), tprec("f32"))[0].numpy()
    assert np.max(np.abs(bits(want).astype(np.int64) - bits(got).astype(np.int64))) <= 3


def test_lm_path_raises_with_roadmap_item():
    """The parts of the LM path still to port raise, naming their ROADMAP
    item: lm_loss and training (every architecture, mixer, frontend,
    chunked attention and the einsum MoE dispatch serve, in
    tests/test_torch_lm_archs.py and tests/test_torch_lm_mixers.py)."""
    import repro_torch.models as models
    import repro_torch.train.step as step

    with pytest.raises(AttributeError, match="queue 1, the LM stack: model.py::lm_loss"):
        models.lm_loss
    for name in ("make_train_step", "init_train_state", "TrainConfig"):
        with pytest.raises(AttributeError, match="queue 1, the LM stack: training"):
            getattr(step, name)
    assert callable(step.make_serve_step)


def test_registry_and_known_modes():
    assert set(MODES) <= set(t_registry.known_modes())
    for mode in MODES:
        assert t_engine(mode).name == mode
        assert t_engine(tprec(mode)) is t_engine(mode)
    with pytest.raises(KeyError):
        t_engine("no_such_mode")
    with pytest.raises(ValueError):
        tpol.PrecisionConfig(mode="no_such_mode")

    class Probe(PrecisionEngine):
        pass

    try:
        register_engine("probe_mode", Probe)
        assert tpol.PrecisionConfig(mode="probe_mode").mode == "probe_mode"
        assert t_engine("probe_mode").name == "probe_mode"
        assert fused_family("probe_mode") is None
    finally:
        t_registry._REGISTRY.pop("probe_mode", None)
        tpol.KNOWN_MODES.discard("probe_mode")


def test_fused_families_match_reference():
    from repro.precision import FUSED_FAMILIES as J_FAMILIES

    assert FUSED_FAMILIES == J_FAMILIES
    from repro_torch.pde import get_stepper

    for name in ("heat1d", "swe2d"):
        st = get_stepper(name)
        for mode in MODES:
            assert fused_eligible(tprec(mode), st, st.default_config())


@pytest.mark.parametrize("ops", [("mul", "mul"), ("mul", "div"), ("add", "rsqrt")])
def test_fold_evidence_bit_exact(ops):
    """A chunk's evidence folded through the adjust law, as the fused plane
    does between chunks, against the reference's jitted fold."""
    rng = np.random.default_rng(3)
    ev = np.round(rng.normal(2, 10, (200, 2, 2))).astype(np.float32)
    ev[50:80, 0] = -127.0
    jp, tp = jprec("rr_tracked"), tprec("rr_tracked")
    jtr = jax.jit(lambda tr, ev: j_fold(tr, ev, jp, ops=ops))(j_site_init(SITES, jp.fmt, k0=1), jnp.asarray(ev))
    ttr = t_fold(t_site_init(SITES, tp.fmt, k0=1, device="cpu"), t(ev), tp, ops=ops)
    assert_tracker_equal(jtr, ttr)


def test_fold_evidence_pinned_and_shape_checks():
    tp = tprec("rr_tracked")
    tr = t_site_init(SITES, tp.fmt, k0=1, device="cpu")
    ev = t(np.zeros((5, 2, 2)))
    assert t_fold(tr, ev, dataclasses.replace(tp, pinned=True)) is tr
    assert t_fold(None, ev, tp) is None
    with pytest.raises(ValueError):
        t_fold(tr, t(np.zeros((5, 3, 2))), tp)
    with pytest.raises(ValueError):
        t_fold(tr, ev, tp, ops=("mul",))


def test_site_tracker_addressing():
    tp = tprec("rr_tracked")
    tr = t_site_init(SITES, tp.fmt, device="cpu")
    assert int(tr.k("s.div")) == tp.fmt.fx and len(tr) == 2
    assert resolve_site(tr, "s.div")[1] == 1
    assert resolve_site(None, "s.div") == (None, None)
    with pytest.raises(KeyError):
        tr.index("nope")
    with pytest.raises(TypeError):
        resolve_site(tr.state, "s.div")
    with pytest.raises(ValueError):
        SiteTracker(("a", "a"), tr.state)


@pytest.mark.parametrize("name", sorted(jpol.PRESETS))
def test_precision_from_dict_every_preset(name):
    assert convert.precision_from_dict(dataclasses.asdict(jpol.PRESETS[name])) == tpol.PRESETS[name]


def test_convert_state_and_tracker():
    jp = dataclasses.replace(jpol.PRESETS["r2f2_16"], k_bounds=((0, 2), (1, 3)))
    tp = convert.precision_from_dict(dataclasses.asdict(jp))
    assert tp.k_bounds == ((0, 2), (1, 3)) and tp.fmt == tpol.PRESETS["r2f2_16"].fmt
    x = np.array([1.0, np.nan, -0.0, 1e-40, np.inf], np.float32)
    np.testing.assert_array_equal(bits(convert.state_from_numpy(x).numpy()), bits(x))
    jtr = j_fold(j_site_init(SITES, jp.fmt, k0=0), jnp.full((3, 2, 2), 7.0), dataclasses.replace(jp, k_bounds=None))
    st = jtr.state
    ttr = convert.tracker_from_numpy(jtr.names, st.k, st.hi_ema, st.lo_ema, st.overflow_steps, st.shrink_steps)
    assert ttr.names == SITES
    assert_tracker_equal(jtr, ttr)
