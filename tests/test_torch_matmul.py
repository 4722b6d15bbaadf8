"""Kernels K6 (r2f2_quantize) and K7 (r2f2_matmul) of repro_torch: the plain
PyTorch versions against repro's Pallas kernels in interpret mode and its
jnp oracles (kernels/ref.py), on the same numpy inputs.

K6 is held bit for bit (y and the per-tile k). K7's quantized operands and
splits are fixed by the block semantics, but the reference's sums are
XLA:CPU's dot order, so the sums are held to the bound of two f32
summation orders, |got - want| <= K * 2**-23 * sum_k |aq||bq| (the bound's
sum is the plain version on |a|, |b|: quantization is sign-symmetric), and
bit for bit on dyadic operands whose every partial sum is exact, also when
the operands need rounding first. The CUDA
kernels are held against the plain versions on a card in
test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from repro.core.flexformat import FlexFormat as JFlexFormat
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.flexformat import FlexFormat
from repro_torch.kernels import ops as tops
from repro_torch.kernels.r2f2_matmul import R2F2_MATMUL, r2f2_matmul_plain
from repro_torch.kernels.r2f2_quantize import R2F2_QUANTIZE, r2f2_quantize_plain

FMTS = [(3, 9, 3), (3, 8, 4), (3, 7, 3), (5, 10, 0)]


@pytest.fixture(scope="module", autouse=True)
def torch_env():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)  # the reference's XLA:CPU flushes subnormal results
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(prev)


def _data(shape, scale_exp_range=(-3, 4), seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, shape) * 10.0 ** rng.integers(*scale_exp_range, shape)).astype(np.float32)


def _dyadic(shape, seed):
    """Multiples of 1/8 in [-1, 1]: every product is a multiple of 1/64 and
    every partial sum of a few hundred of them is exact in f32."""
    return (np.random.default_rng(seed).integers(-8, 9, shape) / 8.0).astype(np.float32)


def bits(x):
    """Raw f32 bits, every NaN made one pattern."""
    b = np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(np.uint32).copy()
    b[np.isnan(np.asarray(x, dtype=np.float32))] = 0x7FC00000
    return b


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def assert_within_sum_bound(a, b, want, got, fmt, **kw):
    """Non-finite entries equal (NaN canonical), finite ones within
    K * 2**-23 * sum|aq||bq|."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(bits(want[~fin]), bits(got[~fin]))
    mag = r2f2_matmul_plain(t(np.abs(a)), t(np.abs(b)), fmt=fmt, **kw).double().numpy()
    bound = a.shape[1] * 2.0**-23 * mag * 1.01
    err = np.abs(got[fin].astype(np.float64) - want[fin])
    assert np.all(err <= bound[fin]), float((err - bound[fin]).max())


# ---------------------------------------------------------------------------
# K6


@pytest.mark.parametrize(
    "shape,fmt",
    [((256, 256), f) for f in FMTS] + [((512, 256), FMTS[1]), ((256, 768), FMTS[2]), ((1024, 1024), FMTS[0])],
    ids=str,
)
def test_quantize_plain_matches_pallas(shape, fmt):
    x = _data(shape, seed=sum(shape) % 1000)
    yk, kk = jops.r2f2_quantize(x, JFlexFormat(*fmt))
    y, k = r2f2_quantize_plain(t(x), fmt=FlexFormat(*fmt))
    np.testing.assert_array_equal(bits(yk), bits(y.numpy()))
    np.testing.assert_array_equal(np.asarray(kk), k.numpy())
    assert k.dtype == torch.int32


@pytest.mark.parametrize("block", [(128, 128), (256, 128), (128, 256)])
def test_quantize_block_sweep_matches_pallas(block):
    x = _data((512, 512), seed=5)
    yr, kr = jops.r2f2_quantize(x, JFlexFormat(*FMTS[0]), block=block)
    y, k = tops.r2f2_quantize(t(x), FlexFormat(*FMTS[0]), block=block)
    np.testing.assert_array_equal(bits(yr), bits(y.numpy()))
    np.testing.assert_array_equal(np.asarray(kr), k.numpy())


def _special_tiles():
    """Four (256, 256) tiles side by side: zeros, f32 subnormals only, random
    values with +-inf and NaN (masked out of the max), and 1e6 (k must grow
    to 3)."""
    x = np.zeros((256, 1024), np.float32)
    x[:, 256:512] = np.float32(1e-40) * np.random.default_rng(1).integers(-9, 10, (256, 256))
    x[:, 512:768] = _data((256, 256), (-2, 2), seed=3)
    x[7, 600], x[9, 700], x[11, 514] = np.inf, -np.inf, np.nan
    x[:, 768:] = 1e6
    return x


def test_quantize_special_tiles():
    x = _special_tiles()
    yk, kk = jops.r2f2_quantize(x, JFlexFormat(*FMTS[0]))
    y, k = tops.r2f2_quantize(t(x), FlexFormat(*FMTS[0]))
    np.testing.assert_array_equal(bits(yk), bits(y.numpy()))
    np.testing.assert_array_equal(np.asarray(kk), k.numpy())
    assert k.tolist() == [[3, 3, np.asarray(kk)[0, 2], 3]]


def test_quantize_wrapper_counts_and_rejects():
    before = (R2F2_QUANTIZE.launches, R2F2_QUANTIZE.plain_calls)
    tops.r2f2_quantize(t(_data((256, 256))), FlexFormat(*FMTS[0]))
    assert (R2F2_QUANTIZE.launches, R2F2_QUANTIZE.plain_calls) == (before[0], before[1] + 1)
    with pytest.raises(ValueError, match="not divisible"):
        tops.r2f2_quantize(torch.zeros(300, 256), FlexFormat(*FMTS[0]))
    with pytest.raises(ValueError, match="not divisible"):
        jops.r2f2_quantize(np.zeros((300, 256), np.float32), JFlexFormat(*FMTS[0]))


# ---------------------------------------------------------------------------
# K7


@pytest.mark.parametrize("mnk", [(128, 128, 128), (256, 128, 384), (128, 256, 128), (384, 384, 256)], ids=str)
@pytest.mark.parametrize("fmt", FMTS[:2], ids=str)
def test_matmul_plain_within_sum_bound_of_pallas(mnk, fmt):
    m, n, k = mnk
    a = _data((m, k), (-2, 2), seed=m + n)
    b = _data((k, n), (-2, 2), seed=k)
    want = jops.r2f2_matmul(a, b, JFlexFormat(*fmt))
    got = r2f2_matmul_plain(t(a), t(b), fmt=FlexFormat(*fmt))
    assert_within_sum_bound(a, b, want, got.numpy(), FlexFormat(*fmt))


@pytest.mark.parametrize(
    "mnk,blocks",
    [((256, 128, 384), (128, 128, 128)), ((192, 192, 192), (128, 128, 128)), ((128, 96, 320), (64, 64, 64))],
    ids=str,
)
def test_matmul_dyadic_bit_exact(mnk, blocks):
    """Dyadic operands: every partial sum exact, so any order gives the
    reference's bits (non-divisible shapes pad and crop)."""
    m, n, k = mnk
    a, b = _dyadic((m, k), 1), _dyadic((k, n), 2)
    want = jops.r2f2_matmul(a, b, JFlexFormat(*FMTS[0]), blocks=blocks)
    got = tops.r2f2_matmul(t(a), t(b), FlexFormat(*FMTS[0]), blocks=blocks)
    np.testing.assert_array_equal(bits(want), bits(got.numpy()))


def _rounded_dyadic(shape, seed):
    """_dyadic's values moved by 2**-16 to 2**-15 of themselves, and the
    unmoved ones: every format rounds the moved values back."""
    rng = np.random.default_rng(seed)
    exact = (rng.integers(-8, 9, shape) / 8.0).astype(np.float32)
    move = rng.choice([-1.0, 1.0], shape) * (1 + rng.random(shape)) * 2.0**-16
    return (exact * (1 + move)).astype(np.float32), exact


@pytest.mark.parametrize(
    "mnk,kw", [((128, 128, 640), {}), ((192, 192, 192), dict(blocks=(64, 64, 64), round_products=True))], ids=str
)
def test_matmul_rounded_dyadic_bit_exact(mnk, kw):
    """Operands that need rounding but whose quantized products sum exactly:
    the reference's bits, which are those of the unmoved operands, and not
    those of the unquantized product."""
    m, n, k = mnk
    (a, a0), (b, b0) = _rounded_dyadic((m, k), 3), _rounded_dyadic((k, n), 4)
    fmt, jfmt = FlexFormat(*FMTS[0]), JFlexFormat(*FMTS[0])
    want = jops.r2f2_matmul(a, b, jfmt, **kw)
    got = tops.r2f2_matmul(t(a), t(b), fmt, **kw)
    np.testing.assert_array_equal(bits(want), bits(got.numpy()))
    np.testing.assert_array_equal(bits(got.numpy()), bits(r2f2_matmul_plain(t(a0), t(b0), fmt=fmt, **kw).numpy()))
    assert (got.numpy() != (a.astype(np.float64) @ b).astype(np.float32)).mean() > 0.9


def test_plain_matmul_is_one_switch_of_the_kernel_api():
    """ops.plain_matmul sends the kernel API, and the contraction engine's
    K7 dispatch through it, to the plain version (counted as plain calls)
    for the length of the block, nested or left by an exception."""
    import dataclasses

    from repro_torch.core.policy import PRESETS
    from repro_torch.precision import contract

    rng = np.random.default_rng(10)
    a, b = t(rng.normal(0, 1, (64, 96))), t(rng.normal(0, 1, (96, 32)))
    cfg = dataclasses.replace(PRESETS["r2f2_16"], use_kernels=True)
    outside = contract("ij,jk->ik", a, b, cfg)
    before = (R2F2_MATMUL.launches, R2F2_MATMUL.plain_calls)
    with tops.plain_matmul():
        with tops.plain_matmul():
            inside = contract("ij,jk->ik", a, b, cfg)
        assert tops._plain_matmul
        tops.r2f2_matmul(a, b, cfg.fmt)
    assert (R2F2_MATMUL.launches - before[0], R2F2_MATMUL.plain_calls - before[1]) == (0, 2)
    assert not tops._plain_matmul and torch.equal(inside, outside)
    with pytest.raises(ValueError, match="contraction mismatch"):
        with tops.plain_matmul():
            tops.r2f2_matmul(a, a, cfg.fmt)
    assert not tops._plain_matmul


@pytest.mark.parametrize("tail_approx", [True, False])
def test_matmul_round_products(tail_approx):
    a = _data((128, 128), (-1, 1), seed=1)
    b = _data((128, 128), (-1, 1), seed=2)
    kw = dict(blocks=(64, 64, 64), round_products=True, tail_approx=tail_approx)
    want = jops.r2f2_matmul(a, b, JFlexFormat(*FMTS[0]), **kw)
    got = tops.r2f2_matmul(t(a), t(b), FlexFormat(*FMTS[0]), **kw)
    assert_within_sum_bound(a, b, want, got.numpy(), FlexFormat(*FMTS[0]), **kw)


def test_matmul_non_divisible_and_kernel_blocks():
    """192 x 192 with the default blocks (pad to 256 and crop) and with
    (64, 64, 64) blocks; and one block pair against the jnp oracle."""
    a = _data((192, 192), (-2, 2), seed=7)
    b = _data((192, 192), (-2, 2), seed=8)
    fmt = FlexFormat(*FMTS[0])
    for blocks in ((128, 128, 128), (64, 64, 64)):
        got = tops.r2f2_matmul(t(a), t(b), fmt, blocks=blocks)
        want = jops.r2f2_matmul(a, b, JFlexFormat(*FMTS[0]), blocks=blocks)
        assert_within_sum_bound(a, b, want, got.numpy(), fmt, blocks=blocks)
    a, b = a[:128, :128], b[:128, :64]
    ref = jref.r2f2_matmul_ref(a, b, fmt=JFlexFormat(*FMTS[0]))
    assert_within_sum_bound(a, b, ref, tops.r2f2_matmul(t(a), t(b), fmt).numpy(), fmt)


def test_matmul_special_tiles():
    """A zero tile, a subnormal-only tile and a tile with +-inf and NaN in A;
    non-finite outputs equal the reference's, NaNs made canonical."""
    a = np.ascontiguousarray(_special_tiles()[:128, :768:2])  # (128, 384): zero, subnormal, inf/NaN K blocks
    b = _data((384, 128), (-2, 2), seed=4)
    want = jops.r2f2_matmul(a, b, JFlexFormat(*FMTS[0]))
    got = tops.r2f2_matmul(t(a), t(b), FlexFormat(*FMTS[0]))
    assert np.isnan(np.asarray(want)).any() and np.isinf(np.asarray(want)).any() and np.isfinite(np.asarray(want)).any()
    assert_within_sum_bound(a, b, want, got.numpy(), FlexFormat(*FMTS[0]))


def test_matmul_close_to_f32_and_counts():
    rng = np.random.default_rng(9)
    a = rng.normal(0, 1, (256, 256)).astype(np.float32)
    b = rng.normal(0, 0.05, (256, 256)).astype(np.float32)
    before = (R2F2_MATMUL.launches, R2F2_MATMUL.plain_calls)
    c = tops.r2f2_matmul(t(a), t(b), FlexFormat(*FMTS[0])).numpy()
    assert (R2F2_MATMUL.launches, R2F2_MATMUL.plain_calls) == (before[0], before[1] + 1)
    assert np.linalg.norm(c - a @ b) / np.linalg.norm(a @ b) < 1e-3
    with pytest.raises(ValueError, match="contraction mismatch"):
        tops.r2f2_matmul(torch.zeros(4, 5), torch.zeros(6, 4), FlexFormat(*FMTS[0]))
