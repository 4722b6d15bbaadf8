"""repro_torch.core and repro_torch.alu against repro.core and repro.alu.

The same numpy inputs go through both packages; f32 results compare as raw
bits and integers exactly. Split selection is checked exhaustively over
every exponent the evidence can reach (about -260..+260 once op envelopes
and headroom are applied)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.alu import flex_op as j_flex_op
from repro.core import flexformat as jff
from repro.core import policy as jpol
from repro.core import r2f2 as jr2
from repro_torch.alu import flex_op as t_flex_op
from repro_torch.core import flexformat as tff
from repro_torch.core import policy as tpol
from repro_torch.core import r2f2 as tr2
from repro_torch.core.fma import fma
from repro_torch.kernels import blockops as tbo
from repro.kernels import blockops as jbo

FMTS = [(3, 9, 3), (3, 8, 4), (3, 8, 3), (3, 7, 3), (5, 10, 0)]
EXPS = np.arange(-300, 301, dtype=np.int32)


@pytest.fixture(scope="module", autouse=True)
def torch_env():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def bits(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(np.uint32)


def t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, copy=True)).to(dtype)


def edge_values():
    f = np.finfo(np.float32)
    base = [0.0, -0.0, 1.0, -1.0, 1.5, 65504.0, 65520.0, 65536.0, 1e5, 2.5e5, 6.1e-5, 6e-8, 3e-8,
            1e-4, 1e-6, 1e-10, 1e-38, 1e-40, f.tiny, f.max, -f.max, np.inf, -np.inf, np.nan, 0.1, 1 / 3.0]
    rng = np.random.default_rng(0)
    rand = rng.standard_normal(4000) * np.exp(rng.uniform(-40, 40, 4000))
    return np.concatenate([np.array(base), -np.array(base), rand]).astype(np.float32)


# ---------------------------------------------------------------------------
# flexformat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", [(3, 9, 3), (3, 8, 4), (5, 10, 0)])
@pytest.mark.parametrize("tail", [False, True])
def test_quantize_bit_exact_every_split(fmt, tail):
    """quantize_em_with_flags at every split of the paper's formats: value
    and both flags, with and without the product tail truncation."""
    x = edge_values()
    eb, mb, fx = fmt
    for k in range(fx + 1):
        e, m = eb + k, mb + fx - k
        g = mb + 1 + k if tail else None
        jy, jo, ju = jax.jit(lambda v: jff.quantize_em_with_flags(v, e, m, g))(x)
        ty, to, tu = tff.quantize_em_with_flags(t(x), e, m, g)
        np.testing.assert_array_equal(bits(jy), bits(ty.numpy()))
        np.testing.assert_array_equal(np.asarray(jo), to.numpy())
        np.testing.assert_array_equal(np.asarray(ju), tu.numpy())


def test_quantize_per_element_formats():
    """Per-element (tensor) exponent and mantissa widths, as the tile-wise
    multiplier passes them."""
    x = edge_values()
    rng = np.random.default_rng(1)
    k = rng.integers(0, 4, x.shape).astype(np.int32)
    jy = jax.jit(lambda v, k: jff.quantize_em(v, 3 + k, 12 - k))(x, k)
    ty = tff.quantize_em(t(x), 3 + t(k, torch.int64), 12 - t(k, torch.int64))
    np.testing.assert_array_equal(bits(jy), bits(ty.numpy()))


def test_pow2_and_unbiased_exponent():
    n = np.arange(-200, 200, dtype=np.int32)
    np.testing.assert_array_equal(bits(jff._pow2(jnp.asarray(n))), bits(tff._pow2(t(n, torch.int64)).numpy()))
    x = edge_values()
    np.testing.assert_array_equal(np.asarray(jff.unbiased_exponent(jnp.asarray(x))), tff.unbiased_exponent(t(x)).numpy())


_j_quantize = jax.jit(jff.quantize_em, static_argnums=(1, 2))


@settings(deadline=None)
@given(x=st.floats(min_value=float(np.float32(-7e4)), max_value=float(np.float32(7e4)), width=32))
def test_prop_quantize_matches_reference(x):
    """Property: any f32 in E5M10's neighbourhood quantizes identically."""
    v = np.array([x], np.float32)
    for e, m in ((5, 10), (6, 9), (4, 11)):
        np.testing.assert_array_equal(bits(_j_quantize(v, e, m)), bits(tff.quantize_em(t(v), e, m).numpy()))


# ---------------------------------------------------------------------------
# r2f2: split selection in integer logic, exhaustively
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FMTS)
def test_needed_e_bits_exhaustive(fmt):
    """The reference takes ceil(log2(f32)); the port counts bits. They agree
    at every exponent the evidence can produce."""
    eb, _, fx = fmt
    np.testing.assert_array_equal(
        np.asarray(jr2._needed_e_bits(jnp.asarray(EXPS), eb, fx)), tr2._needed_e_bits(t(EXPS, torch.int64), eb, fx).numpy()
    )
    np.testing.assert_array_equal(
        np.asarray(jr2._needed_e_bits_lo(jnp.asarray(EXPS), eb, fx)), tr2._needed_e_bits_lo(t(EXPS, torch.int64), eb, fx).numpy()
    )


@pytest.mark.parametrize("op", ["mul", "add", "div", "rsqrt"])
def test_select_k_op_and_bounds_exhaustive(op):
    """Every (ae, be) pair in [-140, 140]^2, every op, two formats."""
    g = np.arange(-140, 141, dtype=np.int32)
    ae, be = (a.ravel() for a in np.meshgrid(g, g, indexing="ij"))
    if op == "rsqrt":
        be = ae
    jhi, jlo = jr2.op_bounds(jnp.asarray(ae), jnp.asarray(be), op)
    thi, tlo = tr2.op_bounds(t(ae, torch.int64), t(be, torch.int64), op)
    # by value: rsqrt's max(0, -0) keeps a different zero in each library,
    # and the bounds only ever feed an integer conversion
    np.testing.assert_array_equal(np.asarray(jhi), thi.numpy())
    np.testing.assert_array_equal(np.asarray(jlo), tlo.numpy())
    for fmt in (jff.FlexFormat(3, 9, 3), jff.FlexFormat(3, 8, 4)):
        tfmt = tff.FlexFormat(fmt.eb, fmt.mb, fmt.fx)
        want = np.asarray(jr2.select_k_op(jnp.asarray(ae), jnp.asarray(be), fmt, op))
        got = tr2.select_k_op(t(ae, torch.int64), t(be, torch.int64), tfmt, op).numpy()
        np.testing.assert_array_equal(want, got)
        if op == "mul":
            np.testing.assert_array_equal(np.asarray(jr2.select_k(jnp.asarray(ae), jnp.asarray(be), fmt)),
                                          tr2.select_k(t(ae, torch.int64), t(be, torch.int64), tfmt).numpy())


def test_select_k_operand_and_guard_bits():
    fmt, tfmt = jff.FlexFormat(3, 9, 3), tff.FlexFormat(3, 9, 3)
    np.testing.assert_array_equal(np.asarray(jr2.select_k_operand(jnp.asarray(EXPS), fmt)),
                                  tr2.select_k_operand(t(EXPS, torch.int64), tfmt).numpy())
    for k in range(4):
        assert int(jr2.product_guard_bits(fmt, k)) == tr2.product_guard_bits(tfmt, k)


@pytest.mark.parametrize("tile", [None, (4, 8)])
@pytest.mark.parametrize("tail", [True, False])
def test_r2f2_multiply_bit_exact(tile, tail):
    rng = np.random.default_rng(2)
    a = (rng.standard_normal((8, 16)) * np.exp(rng.uniform(-12, 12, (8, 16)))).astype(np.float32)
    b = (rng.standard_normal((8, 16)) * 300).astype(np.float32)
    a[0, :8] = 0.0  # one all-zero tile
    fmt, tfmt = jff.FlexFormat(3, 9, 3), tff.FlexFormat(3, 9, 3)
    jp, js = jax.jit(lambda a, b: jr2.r2f2_multiply(a, b, fmt, tile_shape=tile, tail_approx=tail))(a, b)
    tp, ts = tr2.r2f2_multiply(t(a), t(b), tfmt, tile_shape=tile, tail_approx=tail)
    np.testing.assert_array_equal(bits(jp), bits(tp.numpy()))
    np.testing.assert_array_equal(np.asarray(js.k), ts.k.numpy())
    assert int(js.overflow_count) == int(ts.overflow_count)
    assert int(js.underflow_count) == int(ts.underflow_count)


def test_block_max_exp_of_zeros_is_minus_127():
    """The 1e-38 floor is itself an f32 subnormal: a block of zeros (the
    heat boundary, a resting basin's momentum) gives -127 everywhere."""
    z = np.zeros((3, 5), np.float32)
    assert int(jbo.block_max_exp(jnp.asarray(z))) == -127
    assert int(tbo.block_max_exp(t(z))) == -127
    assert int(jr2._tile_max_exp(jnp.asarray(z), None)[0]) == int(tr2._tile_max_exp(t(z), None)[0]) == -127
    weird = np.array([0.0, np.nan, np.inf, 1e-40, -1e-39], np.float32)
    assert int(jbo.block_max_exp(jnp.asarray(weird))) == int(tbo.block_max_exp(t(weird))) == -127


# ---------------------------------------------------------------------------
# policy: the adjust law
# ---------------------------------------------------------------------------


def _jcfg(**kw):
    return dataclasses.replace(jpol.PRESETS["r2f2_16"], mode="rr_tracked", **kw)


def _tcfg(**kw):
    return dataclasses.replace(tpol.PRESETS["r2f2_16"], mode="rr_tracked", **kw)


@pytest.mark.parametrize("op", ["mul", "add", "div", "rsqrt"])
@pytest.mark.parametrize("k_bounds", [None, (1, 2)])
def test_adjust_step_sequence(op, k_bounds):
    """A jitted scan of adjust_step against the port's eager loop over a
    random evidence stream: k and both counters exactly, EMAs to a relative
    1e-6 plus 1e-5 absolute (a few ulps accumulated along the recursion). XLA fuses one of the EMA's two products into its add and picks
    which per program; the port follows the solver programs' choice, which
    the Simulation parity tests hold bit for bit."""
    rng = np.random.default_rng(3)
    ev = np.round(rng.normal(3, 12, (120, 2))).astype(np.float32)
    ev[40:60] = -127.0
    jc, tc = _jcfg(), _tcfg()

    def jstep(carry, e):
        out = jpol.adjust_step(*carry, e[0], e[1], jc, op, k_bounds=k_bounds)
        return out, out

    init = (jnp.int32(3), jnp.float32(0), jnp.float32(0), jnp.int32(0), jnp.int32(0))
    _, jseq = jax.jit(lambda ev: jax.lax.scan(jstep, init, ev))(jnp.asarray(ev))
    carry = (torch.tensor(3, dtype=torch.int32), torch.tensor(0.0), torch.tensor(0.0),
             torch.tensor(0, dtype=torch.int32), torch.tensor(0, dtype=torch.int32))
    seq = []
    for s in range(len(ev)):
        carry = tpol.adjust_step(*carry, torch.tensor(ev[s, 0]), torch.tensor(ev[s, 1]), tc, op, k_bounds=k_bounds)
        seq.append([c.numpy() for c in carry])
    for i in range(5):
        got = np.stack([step[i] for step in seq])
        want = np.asarray(jseq[i])
        if got.dtype == np.float32:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
        else:
            np.testing.assert_array_equal(want, got)


def test_evidence_k_need_and_tracker_update():
    rng = np.random.default_rng(4)
    ae = np.round(rng.normal(0, 60, 500)).astype(np.float32)
    be = np.round(rng.normal(0, 60, 500)).astype(np.float32)
    for op in ("mul", "div"):
        np.testing.assert_array_equal(np.asarray(jpol.evidence_k_need(jnp.asarray(ae), jnp.asarray(be), _jcfg(), op)),
                                      tpol.evidence_k_need(t(ae), t(be), _tcfg(), op).numpy())
    a = (rng.standard_normal((6, 7)) * 1e3).astype(np.float32)
    b = (rng.standard_normal((6, 7)) * 1e-3).astype(np.float32)
    js = jax.jit(lambda a, b: jpol.tracker_update(jpol.tracker_init(3, _jcfg().fmt, k0=0), 1, a, b, _jcfg(), "div"))(a, b)
    ts = tpol.tracker_update(tpol.tracker_init(3, _tcfg().fmt, k0=0, device="cpu"), 1, t(a), t(b), _tcfg(), "div")
    for f in js._fields:
        np.testing.assert_array_equal(np.asarray(getattr(js, f)), getattr(ts, f).numpy())


def test_fma_matches_compiled_reference():
    """The f64 emulation rounds exactly as XLA:CPU's fused multiply-add."""
    rng = np.random.default_rng(5)
    a, b, c = ((rng.standard_normal(20000) * np.exp(rng.uniform(-20, 20, 20000))).astype(np.float32) for _ in range(3))
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    np.testing.assert_array_equal(bits(want), bits(fma(t(a), t(b), t(c)).numpy()))


# ---------------------------------------------------------------------------
# alu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["add", "sub", "div"])
@pytest.mark.parametrize("k", [None, 0, 3])
def test_flex_op_bit_exact(op, k):
    rng = np.random.default_rng(6)
    a = (rng.standard_normal((8, 8)) * 100).astype(np.float32)
    b = (rng.standard_normal((8, 8)) * 3 + 0.5).astype(np.float32)
    fmt, tfmt = jff.FlexFormat(3, 9, 3), tff.FlexFormat(3, 9, 3)
    jy, js = jax.jit(lambda a, b: j_flex_op(a, b, fmt, op, k=k))(a, b)
    ty, ts = t_flex_op(t(a), t(b), tfmt, op, k=k)
    np.testing.assert_array_equal(bits(jy), bits(ty.numpy()))
    np.testing.assert_array_equal(np.asarray(js.k), ts.k.numpy())
    assert int(js.overflow_count) == int(ts.overflow_count)


def test_flex_rsqrt_within_one_target_ulp():
    """rsqrt's f32 substrate is not correctly rounded in either library; after
    rounding to E(EB+k)M(MB+FX-k) the results stay within one target ulp."""
    rng = np.random.default_rng(7)
    x = np.exp(rng.uniform(-6, 6, 2000)).astype(np.float32)
    fmt, tfmt = jff.FlexFormat(3, 9, 3), tff.FlexFormat(3, 9, 3)
    jy, js = jax.jit(lambda x: j_flex_op(x, None, fmt, "rsqrt"))(x)
    ty, ts = t_flex_op(t(x), None, tfmt, "rsqrt")
    k = int(ts.k)
    assert int(js.k) == k
    m = fmt.mb + fmt.fx - k
    jy = np.asarray(jy, np.float64)
    ulp = np.exp2(np.floor(np.log2(np.abs(jy))) - m)
    assert np.all(np.abs(jy - ty.numpy()) <= ulp)


@pytest.mark.parametrize("op", ["mul", "div", "rsqrt"])
@pytest.mark.parametrize("k_bounds", [None, ((1, 2), (0, 3))])
def test_adjust_sequence_equals_stepwise(op, k_bounds):
    """The host fold's vectorised law (adjust_sequence) against adjust_step
    applied substep by substep: every field bit for bit, signed zeros of the
    rsqrt envelope included."""
    rng = np.random.default_rng(8)
    ev = np.round(rng.normal(0, 15, (150, 2, 2))).astype(np.float32)
    ev[30:70] = -127.0
    cfg = _tcfg(k_bounds=k_bounds)
    state = tpol.tracker_init(2, cfg.fmt, k0=1, device="cpu")
    hi, lo = zip(*(tpol.evidence_bounds(t(ev[:, j, 0]), t(ev[:, j, 1]), op) for j in range(2)))
    got = tpol.adjust_sequence(state, torch.stack(hi, 1), torch.stack(lo, 1), cfg)
    want = state
    for s in range(len(ev)):
        for j in range(2):
            want = tpol.tracker_observe(want, j, t(ev[s, j, 0]), t(ev[s, j, 1]), cfg, op)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(want, f).numpy().view(np.int32), getattr(got, f).numpy().view(np.int32))
