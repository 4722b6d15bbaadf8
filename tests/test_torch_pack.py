"""repro_torch's packed storage and the rest of its core against repro's.

The same numpy inputs go through both packages: the format helpers
(``exponent_bias``, ``max_normal``, ``min_normal``, ``min_subnormal``,
``quantize_product``, ``exponent_redundant``, ``pack_r2f2``/``unpack_r2f2``
and ``FlexFormat``'s fields), the hardware-faithful sequential multiplier,
``repro.pack`` (``pack_array``/``unpack_array`` on blocked and padded
arrays, ``storage_quantize``, ``state_nbytes``), a packed carry handed from
repro to the port (``convert.packed_from_numpy``), the PDE shims and the
``precision_ops`` names. f32 results compare as raw bits, payloads and
splits exactly. PyTorch flushes subnormals here, as XLA:CPU does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flexformat as jff
from repro.core import policy as jpol
from repro.core import r2f2 as jr2
from repro.pack import packed as jpk
from repro.pde import Simulation as JSim
from repro.pde import heat_step as j_heat_step
from repro.pde import padd as j_padd
from repro.pde import pdiv as j_pdiv
from repro.pde import pmul as j_pmul
from repro.pde import pstore as j_pstore
from repro.pde import simulate_heat as j_simulate_heat
from repro.pde import simulate_swe as j_simulate_swe
from repro.pde import swe_step as j_swe_step
from repro.pde.heat1d import HeatConfig as JHeat
from repro.pde.swe2d import SWEConfig as JSWE
from repro.precision.engine import native_bf16 as j_native_bf16
from repro_torch import pde as tpde
from repro_torch.convert import packed_from_numpy, packed_to_numpy, state_from_numpy
from repro_torch.core import flexformat as tff
from repro_torch.core import policy as tpol
from repro_torch.core import r2f2 as tr2
from repro_torch.pack import packed as tpk
from repro_torch.pde import HeatConfig, Simulation, SWEConfig
from repro_torch.precision.engine import native_bf16

#: every preset's flexible format, the fixed baselines' (FX = 0), a 19-bit
#: format whose widest split is E8M10 (its below-normal values are f32
#: subnormals) and an 8-bit one (uint8 payloads)
FMTS = [(3, 9, 3), (3, 8, 4), (3, 8, 3), (3, 7, 3), (5, 10, 0), (5, 10, 3), (2, 3, 2)]


@pytest.fixture(scope="module", autouse=True)
def torch_env():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(prev)


def bits(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(np.uint32)


def t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, copy=True)).to(dtype)


def edge_values(fmt=None):
    """The reference's edge set, and for a format the ends of every split's
    range and its below-normal values."""
    f = np.finfo(np.float32)
    base = [0.0, -0.0, 1.0, -1.0, 1.5, 65504.0, 65520.0, 65536.0, 1e5, 2.5e5, 6.1e-5, 6e-8, 3e-8, 1e-4, 1e-6,
            1e-10, 1e-38, 1e-40, f.tiny, f.max, -f.max, np.inf, -np.inf, np.nan, 0.1, 1 / 3.0]
    if fmt is not None:
        eb, mb, fx = fmt
        for k in range(fx + 1):
            e, m = eb + k, mb + fx - k
            emax, emin = 2 ** (e - 1) - 1, 2 - 2 ** (e - 1)
            top, sub = 2.0**emax * (2 - 2.0**-m), 2.0 ** (emin - m)
            base += [top, top * 1.0001, 2.0**emin, sub, 2 * sub, 2.0**emin - sub, 0.5 * sub, 0.75 * sub, 1.5 * sub]
    rng = np.random.default_rng(0)
    rand = rng.standard_normal(2000) * np.exp(rng.uniform(-40, 40, 2000))
    return np.concatenate([np.array(base), -np.array(base), rand]).astype(np.float32)


def canon_payload(payload, total_bits, values):
    """Payload bits with a NaN's sign cleared (XLA's NaN sign depends on
    the operand order it picks)."""
    p = np.asarray(payload).astype(np.int64)
    return np.where(np.isnan(np.asarray(values)), p & ~(1 << (total_bits - 1)), p)


# ---------------------------------------------------------------------------
# core leftovers
# ---------------------------------------------------------------------------


def test_format_fields_and_limits():
    for eb, mb, fx in FMTS:
        jf, tf = jff.FlexFormat(eb, mb, fx), tff.FlexFormat(eb, mb, fx)
        assert (tf.total_bits, tf.k_range()) == (jf.total_bits, jf.k_range())
        assert all(tf.em(k) == jf.em(k) for k in range(fx + 1))
    for e in range(2, 9):
        assert int(tff.exponent_bias(e)) == int(jff.exponent_bias(e))
        assert bits(tff.min_normal(e)) == bits(jff.min_normal(e))
        for m in range(1, 24):
            assert bits(tff.max_normal(e, m)) == bits(jff.max_normal(e, m)), (e, m)
            assert bits(tff.min_subnormal(e, m)) == bits(jff.min_subnormal(e, m)), (e, m)
    assert float(tff.max_normal(5, 10)) == 65504.0
    assert (tff.E5M10, tff.E8M23) == (tff.FlexFormat(5, 10, 0), tff.FlexFormat(8, 23, 0))


@pytest.mark.parametrize("e", [2, 3, 5, 8])
def test_exponent_redundant_and_quantize_product(e):
    x = edge_values()
    np.testing.assert_array_equal(np.asarray(jff.exponent_redundant(jnp.asarray(x), e)),
                                  tff.exponent_redundant(t(x), e).numpy())
    for m, g in ((3, 2), (10, 5), (23 - e, 0)):
        want = jff.quantize_product(jnp.asarray(x), e, m, g)
        got = tff.quantize_product(t(x), e, m, g)
        for w, o in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w).view(np.uint8), o.numpy().view(np.uint8))


@pytest.mark.parametrize("fmt", FMTS)
def test_pack_unpack_r2f2_round_trip_every_split(fmt):
    x = edge_values(fmt)
    jf, tf = jff.FlexFormat(*fmt), tff.FlexFormat(*fmt)
    ks = jnp.arange(fmt[2] + 1, dtype=jnp.int32)[:, None]
    ref = jax.jit(lambda v: (jff.quantize_em(v, jf.eb + ks, jf.mb + jf.fx - ks), ))(jnp.asarray(x))[0]
    pays = jax.jit(lambda q: jff.pack_r2f2(q, jf, ks))(ref)
    backs = np.asarray(jax.jit(lambda p: jff.unpack_r2f2(p, jf, ks))(pays))
    for k in range(fmt[2] + 1):
        e, m = jf.em(k)
        q_j = np.asarray(ref[k])
        q_t = tff.quantize_em(t(x), e, m)
        np.testing.assert_array_equal(bits(q_j), bits(q_t.numpy()))
        pay_j = np.asarray(pays[k])
        pay_t = tff.pack_r2f2(q_t, tf, k).numpy()
        np.testing.assert_array_equal(canon_payload(pay_j, tf.total_bits, q_j), canon_payload(pay_t, tf.total_bits, q_j))
        back_j = backs[k]
        back_t = tff.unpack_r2f2(t(pay_j, torch.int64), tf, k).numpy()
        np.testing.assert_array_equal(bits(back_j), bits(back_t))
        # the round trip is quantize_em, NaNs made canonical with their sign
        finite = ~np.isnan(q_j)
        np.testing.assert_array_equal(bits(back_t[finite]), bits(q_j[finite]))
        assert np.isnan(back_t[~finite]).all()


@pytest.mark.parametrize("fmt", FMTS)
def test_every_payload_decodes_as_the_reference_under_flush(fmt):
    """Every payload pattern at every split (a sample of 2**16 for the
    19-bit format). Decoded values of a split whose below-normal values lie
    under 2**-126 are f32 subnormals before the flush: only the widest split
    of <5,10,3> (E8M10) has any, and both packages flush them to zero."""
    jf, tf = jff.FlexFormat(*fmt), tff.FlexFormat(*fmt)
    n = 1 << jf.total_bits
    pats = np.arange(n, dtype=np.int64) if n <= 1 << 16 else np.random.default_rng(1).integers(0, n, 1 << 16)
    ks = jnp.arange(fmt[2] + 1, dtype=jnp.int32)[:, None]
    wants = np.asarray(jax.jit(lambda p: jff.unpack_r2f2(p, jf, ks))(jnp.asarray(pats.astype(np.uint32))[None, :]))
    for k in range(fmt[2] + 1):
        want = wants[k]
        got = tff.unpack_r2f2(t(pats, torch.int64), tf, k).numpy()
        np.testing.assert_array_equal(bits(want), bits(got))
        e, m = jf.em(k)
        below = 2.0 ** (2 - 2 ** (e - 1) - m) < 2.0**-126
        assert below == (fmt == (5, 10, 3) and k == 3)
        assert not ((got != 0) & (np.abs(got) < 2.0**-126)).any()


def test_sequential_multiplier_at_k0_zero():
    """The §5.3 counters and every product against the reference on
    drifting streams, from the reference's own start (k0 = 0)."""
    rng = np.random.default_rng(0)
    drift = np.exp(np.linspace(-20, 25, 600))
    a = (rng.standard_normal(600) * drift).astype(np.float32)
    b = (rng.standard_normal(600) * drift[::-1]).astype(np.float32)
    a[::97] = 0.0
    for fmt, tail in [((3, 9, 3), True), ((3, 8, 4), False), ((5, 10, 0), True)]:
        p_j, s_j = jr2.r2f2_mul_sequential(jnp.asarray(a), jnp.asarray(b), jff.FlexFormat(*fmt), tail_approx=tail)
        p_t, s_t = tr2.r2f2_mul_sequential(t(a), t(b), tff.FlexFormat(*fmt), tail_approx=tail)
        np.testing.assert_array_equal(bits(p_j), bits(p_t.numpy()))
        assert (int(s_t.k), int(s_t.overflow_adjusts), int(s_t.redundancy_adjusts)) == (
            int(s_j.k), int(s_j.overflow_adjusts), int(s_j.redundancy_adjusts))
        assert int(s_t.overflow_adjusts) + int(s_t.redundancy_adjusts) > 0 or fmt[2] == 0


def test_sequential_multiplier_honours_k0():
    """The reference's r2f2_mul_sequential never uses k0 (it starts at 0,
    ROADMAP queue 3); the port starts at k0. A product of 1000 * 1000 at
    <3,9,3> needs the widest split: from k0 = 2 one adjustment, from 0
    three, as the reference counts whatever k0 it is given."""
    fmt_j, fmt_t = jff.FlexFormat(3, 9, 3), tff.FlexFormat(3, 9, 3)
    a = np.array([1000.0], np.float32)
    _, s_j = jr2.r2f2_mul_sequential(jnp.asarray(a), jnp.asarray(a), fmt_j, k0=2)
    _, s_t = tr2.r2f2_mul_sequential(t(a), t(a), fmt_t, k0=2)
    _, s_t0 = tr2.r2f2_mul_sequential(t(a), t(a), fmt_t, k0=0)
    assert (int(s_t.k), int(s_t.overflow_adjusts)) == (3, 1)
    assert (int(s_t0.k), int(s_t0.overflow_adjusts)) == (int(s_j.k), int(s_j.overflow_adjusts)) == (3, 3)
    assert int(tr2.sequential_init(fmt_t, k0=2).k) == 2


def test_precision_names():
    for name, prec in tpol.PRESETS.items():
        assert prec.is_emulated == jpol.PRESETS[name].is_emulated, name
    assert native_bf16() is False and j_native_bf16() is False  # both keep bf16-rounded operands as f32 here
    rng = np.random.default_rng(2)
    a, b = rng.standard_normal((2, 64)).astype(np.float32) * 300.0
    for name in ("r2f2_16", "e5m10", "bf16", "f32"):
        jp, tp = jpol.PRESETS[name], tpol.PRESETS[name]
        # the port follows the compiled reference (its bf16 result stays f32)
        for jfn, tfn in ((j_pmul, tpde.pmul), (j_pdiv, tpde.pdiv), (j_padd, tpde.padd)):
            want = jax.jit(lambda x, y, jfn=jfn: jfn(x, y, jp))(jnp.asarray(a), jnp.asarray(b))
            np.testing.assert_array_equal(bits(want), bits(tfn(t(a), t(b), tp).numpy()))
        want = jax.jit(lambda x: j_pstore(x, jp))(jnp.asarray(a))
        np.testing.assert_array_equal(bits(want), bits(tpde.pstore(t(a), tp).numpy()))


# ---------------------------------------------------------------------------
# pack/
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", [(3, 9, 3), (5, 10, 3), (2, 3, 2)])
def test_pack_array_blocked_and_padded(fmt):
    rng = np.random.default_rng(3)
    jf, tf = jff.FlexFormat(*fmt), tff.FlexFormat(*fmt)
    cases = [((5, 37), (2, 8)), ((3, 4, 9), (5, 4)), ((40,), None), ((), None)]
    for shape, block in cases:
        x = (rng.standard_normal(shape) * np.exp2(rng.integers(-30, 30, shape))).astype(np.float32)
        if x.size > 8:
            x.reshape(-1)[:4] = [0.0, np.inf, -np.nan, 1e-40]
        jpa = jax.jit(lambda v: jpk.pack_array(v, jf, block=block))(jnp.asarray(x))
        tpa = tpk.pack_array(t(x), tf, block=block)
        assert (tpa.shape, tpa.block, str(tpa.payload.numpy().dtype)) == (jpa.shape, jpa.block, str(np.asarray(jpa.payload).dtype))
        np.testing.assert_array_equal(np.asarray(jpa.k), tpa.k.numpy())
        vals = np.asarray(jax.jit(jpk.unpack_array)(jpa))
        rows, width = jpk._view2d(shape)
        assert tpa.payload.shape == jpa.payload.shape  # the padded payload
        back = tpk.unpack_array(tpa).numpy()
        np.testing.assert_array_equal(bits(vals), bits(back))
        pad = np.zeros(np.asarray(jpa.payload).shape, bool)
        pad[:rows, :width] = True
        crop_vals = np.zeros(pad.shape, np.float32)
        crop_vals[:rows, :width] = vals.reshape(rows, width)
        np.testing.assert_array_equal(canon_payload(jpa.payload, jf.total_bits, crop_vals),
                                      canon_payload(tpa.payload.numpy(), jf.total_bits, crop_vals))
        assert tpa.nbytes == jpa.nbytes
        assert tpk.block_storage_k(t(x), tf).item() == int(jax.jit(lambda v: jpk.block_storage_k(v, jf))(jnp.asarray(x)))


def test_payload_dtype_and_state_nbytes():
    for fmt in FMTS:
        assert str(tpk.payload_dtype(tff.FlexFormat(*fmt))).split(".")[-1] == np.dtype(jpk.payload_dtype(jff.FlexFormat(*fmt))).name
    # the main configurations' carried state, f32 and packed at r2f2_16
    want = {"heat1d": (512, 260), "swe2d": (196_608, 98_308), "heat2d": (16_384, 8196), "advection1d": (1024, 516),
            "burgers1d": (1024, 516)}
    fmt_j, fmt_t = jpol.PRESETS["r2f2_16"].fmt, tpol.PRESETS["r2f2_16"].fmt
    for name, (f32_bytes, packed_bytes) in want.items():
        sim = Simulation(name, None, tpol.PRESETS["f32"], device="cpu")
        x0 = sim.stepper.init_state(sim.cfg, device="cpu").numpy()
        packed = jax.jit(lambda v: jpk.pack_state(v, fmt_j))(jnp.asarray(x0))
        j_bytes = (jpk.state_nbytes(jnp.asarray(x0)), jpk.state_nbytes(packed))
        t_bytes = (tpk.state_nbytes(t(x0)), tpk.state_nbytes(tpk.pack_state(t(x0), fmt_t)))
        assert t_bytes == j_bytes == (f32_bytes, packed_bytes), name


def test_storage_quantize_is_idempotent_and_equals_reference():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((6, 50)) * np.exp2(rng.integers(-20, 20, (6, 50)))).astype(np.float32)
    x[0, :3] = [np.nan, -np.inf, 0.0]
    for fmt in [(3, 9, 3)]:
        tf, jf = tff.FlexFormat(*fmt), jff.FlexFormat(*fmt)
        for block in (None, (2, 16)):
            once = tpk.storage_quantize(t(x), tf, block=block)
            twice = tpk.storage_quantize(once, tf, block=block)
            np.testing.assert_array_equal(bits(once.numpy()), bits(twice.numpy()))
            want = jax.jit(lambda v: jpk.storage_quantize(v, jf, block=block))(jnp.asarray(x))
            np.testing.assert_array_equal(bits(once.numpy()), bits(want))
    assert tpk.is_packed(tpk.pack_state((t(x), {"a": t(x)}), tff.FlexFormat(3, 9, 3)))
    assert not tpk.is_packed((t(x),))


def test_packed_array_views_and_refusals():
    pa = tpk.pack_array(torch.arange(12.0).reshape(3, 4), tff.FlexFormat(3, 9, 3))
    v = pa.with_view((1, 12))
    assert (v.shape, v.block, tuple(v.payload.shape)) == ((1, 12), (1, 12), (1, 12))
    assert v.device == pa.to("cpu").device == torch.device("cpu")
    np.testing.assert_array_equal(tpk.unpack_array(v).numpy().reshape(3, 4), tpk.unpack_array(pa).numpy())
    with pytest.raises(ValueError, match="size differs"):
        pa.with_view((5,))
    with pytest.raises(ValueError, match="single-block"):
        tpk.pack_array(torch.ones(4, 4), tff.FlexFormat(3, 9, 3), block=(2, 2)).with_view((16,))


def test_packed_carry_from_repro_resumes_in_the_port():
    """A packed carry made by repro's run crosses with convert.packed_from_numpy
    (and back with packed_to_numpy) and resumes in the port on every plane,
    bit for bit as repro resumes it."""
    jc, tc = JHeat(nx=64), HeatConfig(nx=64)
    jp, tp = dataclasses.replace(jpol.PRESETS["r2f2_16"], mode="rr_tracked"), dataclasses.replace(tpol.PRESETS["r2f2_16"], mode="rr_tracked")
    jsim = JSim("heat1d", jc, jp)
    first = jsim.run(20, snapshot_every=10, storage="packed")
    carry = first.state
    fields = (np.asarray(carry.payload), np.asarray(carry.k), (carry.fmt.eb, carry.fmt.mb, carry.fmt.fx), carry.shape, carry.block)
    packed = packed_from_numpy(*fields)
    back = packed_to_numpy(packed)
    np.testing.assert_array_equal(back[0], fields[0])
    assert back[0].dtype == fields[0].dtype and back[2:] == fields[2:]
    want = jsim.run(18, snapshot_every=8, state0=carry, storage="packed")
    for execution in ("reference", "fused", "megakernel"):
        got = Simulation("heat1d", tc, tp, device="cpu").run(18, snapshot_every=8, state0=packed, storage="packed",
                                                              execution=execution)
        if execution == "reference":
            np.testing.assert_array_equal(np.asarray(want.state.payload), got.state.payload.numpy())
            np.testing.assert_array_equal(np.asarray(want.state.k), got.state.k.numpy())
            np.testing.assert_array_equal(bits(want.snapshots), bits(got.snapshots.numpy()))
        assert got.state.shape == (64,) and got.state.payload.dtype == torch.uint16
    # the quantized carry from the same packed state decodes first
    got = Simulation("heat1d", tc, tp, device="cpu").run(18, snapshot_every=8, state0=packed, storage="quantized")
    np.testing.assert_array_equal(bits(jax.jit(jpk.unpack_array)(want.state)), bits(got.state.numpy()))


# ---------------------------------------------------------------------------
# the shims (tests/test_solver.py's shim parity, against repro's shims)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prec", ["f32", "r2f2_16", "e5m10"])
def test_heat_shim_is_framework(prec):
    jc, tc = JHeat(nx=64), HeatConfig(nx=64)
    u0 = np.asarray(JSim("heat1d", jc, jpol.PRESETS["f32"]).stepper.init_state(jc))
    j_out, j_snaps = j_simulate_heat(jc, jpol.PRESETS[prec], 120, u0=u0)
    t_out, t_snaps = tpde.simulate_heat(tc, tpol.PRESETS[prec], 120, u0=state_from_numpy(u0), device="cpu")
    np.testing.assert_array_equal(bits(j_out), bits(t_out.numpy()))
    np.testing.assert_array_equal(bits(j_snaps), bits(t_snaps.numpy()))
    res = Simulation("heat1d", tc, tpol.PRESETS[prec], device="cpu").run(120, state0=state_from_numpy(u0))
    np.testing.assert_array_equal(bits(t_out.numpy()), bits(res.state.numpy()))
    one = tpde.heat_step(state_from_numpy(u0), tc, tpol.PRESETS[prec])
    want = jax.jit(lambda u: j_heat_step(u, jc, jpol.PRESETS[prec]))(jnp.asarray(u0))
    np.testing.assert_array_equal(bits(want), bits(one.numpy()))


def test_swe_shim_is_framework():
    jc, tc = JSWE(nx=32, ny=32), SWEConfig(nx=32, ny=32)
    U0 = np.asarray(JSim("swe2d", jc, jpol.PRESETS["f32"]).stepper.init_state(jc))
    j_out, j_snaps = j_simulate_swe(jc, jpol.PRESETS["r2f2_16"], 40, U0=U0)
    t_out, t_snaps = tpde.simulate_swe(tc, tpol.PRESETS["r2f2_16"], 40, U0=state_from_numpy(U0), device="cpu")
    np.testing.assert_array_equal(bits(j_out), bits(t_out.numpy()))
    np.testing.assert_array_equal(bits(j_snaps), bits(t_snaps.numpy()))
    assert t_snaps.shape[0] == 4
    one = tpde.swe_step(state_from_numpy(U0), tc, tpol.PRESETS["r2f2_16"])
    want = jax.jit(lambda U: j_swe_step(U, jc, jpol.PRESETS["r2f2_16"]))(jnp.asarray(U0))  # the compiled step's fusions
    np.testing.assert_array_equal(bits(want), bits(one.numpy()))
