"""Kernels K1-K3 of repro_torch: the plain PyTorch versions against repro's
Pallas kernels in interpret mode, bit for bit (outputs and evidence). The
CUDA kernels are held against the plain versions on a card in
test_torch_cuda.py.

K1 is the block math (kernels/blockops.py, csrc/r2f2_device.cuh); K2 is
heat1d_sweep, K3 swe_flux_fused. The reference's kernels run under jax.jit,
as its solver runs them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jpol
from repro.kernels import blockops as jbo
from repro.kernels import heat_stencil as jheat
from repro.kernels import swe_flux as jswe
from repro_torch.core import flexformat as tff
from repro_torch.core import policy as tpol
from repro_torch.kernels import blockops as tbo
from repro_torch.kernels import heat_stencil as theat
from repro_torch.kernels import swe_flux as tswe
from repro_torch.kernels.fused import fused_sweep

ALPHA, DTODX2 = 1e-5, 0.4 / 1e-5


@pytest.fixture(scope="module", autouse=True)
def torch_env():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)  # the reference's XLA:CPU flushes subnormal results
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(prev)


def bits(x):
    return np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(np.uint32)


def t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, copy=True)).to(dtype)


def precs(name, **kw):
    if name in ("rr_tracked", "deploy_pinned"):
        base = dict(mode="rr_tracked") if name == "rr_tracked" else dict(mode="deploy")
        return (dataclasses.replace(jpol.PRESETS["r2f2_16"], **base, **kw),
                dataclasses.replace(tpol.PRESETS["r2f2_16"], **base, **kw))
    return dataclasses.replace(jpol.PRESETS[name], **kw), dataclasses.replace(tpol.PRESETS[name], **kw)


def assert_same(want, got):
    np.testing.assert_array_equal(bits(want), bits(got.numpy()))


# ---------------------------------------------------------------------------
# K1: block math
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k_kw", [{}, {"k_min": 2}])
def test_blockops_bit_exact(k_kw):
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((4, 32)) * 3e3).astype(np.float32)
    b = (rng.standard_normal((4, 32)) * 2 + 0.1).astype(np.float32)
    fmt, tfmt = jpol.PRESETS["r2f2_16"].fmt, tpol.PRESETS["r2f2_16"].fmt
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), t(a), t(b)
    want = jax.jit(lambda a, b: (
        jbo.rr_mul_block(a, b, fmt, True, **k_kw), jbo.rr_mul_block(a, b, fmt, False, **k_kw),
        jbo.rr_add_block(a, b, fmt, **k_kw), jbo.rr_div_block(a, b, fmt, **k_kw),
        jbo.rr_rsqrt_block(jnp.abs(a), fmt, **k_kw),
    ))(ja, jb)
    got = (
        tbo.rr_mul_block(ta, tb, tfmt, True, **k_kw), tbo.rr_mul_block(ta, tb, tfmt, False, **k_kw),
        tbo.rr_add_block(ta, tb, tfmt, **k_kw), tbo.rr_div_block(ta, tb, tfmt, **k_kw),
    )
    for w, g in zip(want, got):
        assert_same(w, g)
    # rsqrt's f32 substrate is not correctly rounded: one target ulp (2**-9)
    np.testing.assert_allclose(np.asarray(want[4]), tbo.rr_rsqrt_block(ta.abs(), tfmt, **k_kw).numpy(), rtol=2e-3)


# ---------------------------------------------------------------------------
# K2: heat1d_sweep
# ---------------------------------------------------------------------------


def heat_input(rows, nx, seed=0):
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal((rows, nx)) * 300).astype(np.float32)
    u[:, 0] = u[:, -1] = 0.0
    if rows > 3:
        u[3] = 0.0  # a zero row: its block max exponent is -127
    return u


HEAT_CASES = [
    # (prec name, rows, block_rows, k_floor, pinned, evidence)
    ("f32", 1, 1, None, False, True),
    ("bf16", 1, 1, None, False, True),
    ("e5m10", 1, 1, None, False, True),
    ("r2f2_16", 1, 1, None, False, True),
    ("rr_tracked", 1, 1, (2, 1), False, True),
    ("rr_tracked", 1, 1, (3, 0), True, False),
    ("r2f2_16", 5, 2, None, False, True),
    ("deploy_pinned", 5, 2, (1, 1), True, True),
]


@pytest.mark.parametrize("case", HEAT_CASES, ids=lambda c: f"{c[0]}-r{c[1]}b{c[2]}-f{c[3]}-p{c[4]}-e{c[5]}")
def test_heat1d_sweep_plain_matches_interpret(case):
    name, rows, br, floor, pinned, ev = case
    jp, tp = precs(name, pinned=pinned)
    u = heat_input(rows, 64)
    kw = dict(alpha=ALPHA, dtodx2=DTODX2, steps=6, block_rows=br, collect_evidence=ev)
    jk = None if floor is None else jnp.asarray(floor, jnp.int32)
    tk = None if floor is None else torch.tensor(floor, dtype=torch.int32)
    jout, jev = jheat.heat1d_sweep(jnp.asarray(u), prec=jp, k_floor=jk, interpret=True, **kw)
    before = theat.HEAT1D_SWEEP.plain_calls
    tout, tev = theat.heat1d_sweep(t(u), prec=tp, k_floor=tk, **kw)
    assert theat.HEAT1D_SWEEP.plain_calls == before + 1  # CPU tensors take the plain version
    if name == "f32":
        # compiled on its own, the reference kernel fuses the f32 update
        # product into its add; inside the solver's program it does not, and
        # the port follows the solver (bit-exact in test_torch_pde.py)
        diff = np.abs(bits(jout).astype(np.int64) - bits(tout.numpy()).astype(np.int64))
        assert diff.max() <= 16
    else:
        assert_same(jout, tout)
    assert (jev is None) == (tev is None)
    if ev:
        assert tuple(tev.shape) == (6, 2, 2)
        assert_same(jev, tev)


def test_heat_stencil_legacy_wrapper():
    u = heat_input(3, 40, seed=1)
    fmt = jpol.PRESETS["r2f2_16"].fmt
    want = jheat.heat_stencil_pallas(jnp.asarray(u), ALPHA, DTODX2, fmt=fmt, steps=4, block_rows=2, interpret=True)
    got = theat.heat_stencil_pallas(t(u), ALPHA, DTODX2, fmt=tff.FlexFormat(fmt.eb, fmt.mb, fmt.fx), steps=4, block_rows=2)
    assert_same(want, got)


# ---------------------------------------------------------------------------
# K3: swe_flux_fused
# ---------------------------------------------------------------------------


def swe_input(shape, seed=0, zero_q1=False):
    rng = np.random.default_rng(seed)
    q3 = (500 + 100 * rng.random(shape)).astype(np.float32)
    q1 = np.zeros(shape, np.float32) if zero_q1 else (40 * rng.standard_normal(shape)).astype(np.float32)
    return q1, q3


SWE_CASES = [
    # (prec name, shape, kernel_blocks, k_floor, pinned, zero q1)
    ("f32", (31, 32), None, None, False, False),
    ("bf16", (31, 32), None, None, False, False),
    ("e5m10", (31, 32), None, None, False, False),
    ("r2f2_16", (31, 32), None, None, False, True),
    ("rr_tracked", (31, 32), None, (3, 2, 1, 3), False, False),
    ("rr_tracked", (31, 32), None, (3, 3, 3, 2), True, False),
    ("r2f2_16", (31, 32), (16, 128, 128), None, False, False),
    ("r2f2_16", (20, 24), (8, 16, 128), (1, 1, 1, 1), False, False),
]


@pytest.mark.parametrize("case", SWE_CASES, ids=lambda c: f"{c[0]}-{c[1]}-b{c[2]}-f{c[3]}-p{c[4]}-z{c[5]}")
def test_swe_flux_plain_matches_interpret(case):
    name, shape, blocks, floor, pinned, zero = case
    extra = {} if blocks is None else dict(kernel_blocks=blocks)
    jp, tp = precs(name, pinned=pinned, **extra)
    q1, q3 = swe_input(shape, zero_q1=zero)
    jk = None if floor is None else jnp.asarray(floor, jnp.int32)
    tk = None if floor is None else torch.tensor(floor, dtype=torch.int32)
    jout, jev = jax.jit(lambda a, b, k: jswe.swe_flux_fused(a, b, prec=jp, k_floor=k, collect_evidence=True, interpret=True))(
        jnp.asarray(q1), jnp.asarray(q3), jk
    )
    before = tswe.SWE_FLUX.plain_calls
    tout, tev = tswe.swe_flux_fused(t(q1), t(q3), prec=tp, k_floor=tk, collect_evidence=True)
    assert tswe.SWE_FLUX.plain_calls == before + 1
    assert_same(jout, tout)
    assert tuple(tev.shape) == (1, 4, 2)
    assert_same(jev, tev)


def test_swe_flux_legacy_wrapper():
    q1, q3 = swe_input((20, 24), seed=2)
    fmt = jpol.PRESETS["r2f2_16"].fmt
    want = jswe.swe_flux_pallas(jnp.asarray(q1), jnp.asarray(q3), fmt=fmt, block=(8, 16), interpret=True)
    got = tswe.swe_flux_pallas(t(q1), t(q3), fmt=tff.FlexFormat(fmt.eb, fmt.mb, fmt.fx), block=(8, 16))
    assert_same(want, got)


# ---------------------------------------------------------------------------
# fused_sweep's contracts
# ---------------------------------------------------------------------------


def test_fused_sweep_refusals():
    tp = tpol.PRESETS["r2f2_16"]
    u = t(heat_input(2, 16))
    with pytest.raises(NotImplementedError, match="queue 1 item 6"):
        theat.heat1d_sweep(u, alpha=ALPHA, dtodx2=DTODX2, prec=tp, storage="packed")
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        theat.heat1d_sweep(u, alpha=ALPHA, dtodx2=DTODX2, prec=tp, capture=True)
    with pytest.raises(ValueError):
        tswe.swe_flux_fused(u, u, prec=tp, site_ops=("mul",) * 4)
    with pytest.raises(ValueError):
        fused_sweep(lambda s, o: s, (u, u[:1]), prec=tp, sites=("a",), block=(1, 16))
    with pytest.raises(ValueError):
        fused_sweep(lambda s, o: s[:1], (u, u), prec=tp, sites=("a",), steps=2, n_out=1, block=(1, 16))
    with pytest.raises(ValueError):
        theat.heat1d_sweep(u, alpha=ALPHA, dtodx2=DTODX2, prec=tpol.PrecisionConfig(mode="f32"), sites=("x",), collect_evidence=True)
