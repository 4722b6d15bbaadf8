"""The contraction half of repro_torch.precision (prepare_operand, contract,
dot, the rr_dot shims) and its dispatch to kernel K7, against
repro.precision on the same numpy inputs.

prepare_operand is held bit for bit in every mode (the reference under
jax.jit). A contraction's operands are the prepared ones, but its sums are
the einsum's, whose order is the library's: they are held to
|got - want| <= K * 2**-23 * sum_k |aq||bq| (two f32 summation orders of K
terms), and bit for bit on dyadic operands whose every partial sum is exact.
The dispatch cases mirror tests/test_precision_engine.py, with a spy on the
port's kernels.ops.r2f2_matmul."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import policy as jpol
from repro.core.rr_dot import rr_dot as j_rr_dot
from repro.precision import contract as j_contract
from repro.precision import prepare_operand as j_prepare
from repro.precision import site_tracker_init as j_site_init
from repro_torch.core import policy as tpol
from repro_torch.core.rr_dot import rr_dot, rr_einsum, rr_operand
from repro_torch.precision import contract, dot, operand_dtype, prepare_operand
from repro_torch.precision import site_tracker_init as t_site_init
from repro_torch.precision.engine import ste

MODES = ("f32", "bf16", "e5m10", "r2f2_16", "rr_tracked", "deploy")


@pytest.fixture(scope="module", autouse=True)
def torch_env():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)  # the reference's XLA:CPU flushes subnormal results
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(prev)


def precs(name, **kw):
    if name == "rr_tracked":
        return (dataclasses.replace(jpol.PRESETS["r2f2_16"], mode="rr_tracked", **kw),
                dataclasses.replace(tpol.PRESETS["r2f2_16"], mode="rr_tracked", **kw))
    return dataclasses.replace(jpol.PRESETS[name], **kw), dataclasses.replace(tpol.PRESETS[name], **kw)


def bits(x):
    b = np.ascontiguousarray(np.asarray(x, dtype=np.float32)).view(np.uint32).copy()
    b[np.isnan(np.asarray(x, dtype=np.float32))] = 0x7FC00000
    return b


def t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _data(shape, seed, scale_exp_range=(-3, 3)):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, shape) * 10.0 ** rng.integers(*scale_exp_range, shape)).astype(np.float32)


def _dyadic(shape, seed):
    return (np.random.default_rng(seed).integers(-8, 9, shape) / 8.0).astype(np.float32)


def _specials(shape, seed):
    """Random data with +-inf, NaN, +-0, a tiny negative value (it quantizes
    to -0, and the STE gives +0) and an f32 subnormal."""
    x = _data(shape, seed).reshape(-1)
    x[:7] = [np.inf, -np.inf, np.nan, 0.0, -0.0, -1e-30, 1e-40]
    return x.reshape(shape)


def assert_sum_bound(want, got, aq, bq, spec, kdim):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    mag = torch.einsum(spec, aq.abs().double(), bq.abs().double()).numpy()
    bound = kdim * 2.0**-23 * mag
    fin = np.isfinite(want)
    np.testing.assert_array_equal(bits(want[~fin]), bits(got[~fin]))
    err = np.abs(got[fin].astype(np.float64) - want[fin])
    assert np.all(err <= bound[fin]), float((err - bound[fin]).max())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(256, 384), (2, 24, 96), (37,)], ids=str)
def test_prepare_operand_bit_exact(mode, shape):
    x = _specials(shape, sum(shape))
    jp, tp = precs(mode)
    want, wk = jax.jit(lambda x: j_prepare(x, jp))(x)
    got, gk = prepare_operand(t(x), tp)
    np.testing.assert_array_equal(bits(want), bits(got.numpy()))
    assert (wk is None) == (gk is None)
    if wk is not None:
        np.testing.assert_array_equal(np.asarray(wk), gk.numpy())
        assert gk.dtype == torch.int32
    np.testing.assert_array_equal(bits(want), bits(rr_operand(t(x), tp)[0].numpy()))


@pytest.mark.parametrize("k", [0, 2, "tiles"])
def test_prepare_operand_given_k(k):
    x = _specials((256, 384), 5)
    jp, tp = precs("r2f2_16")
    kk = np.array([[1, 3, 0], [2, 0, 3]], np.int32) if k == "tiles" else k
    want, _ = jax.jit(lambda x: j_prepare(x, jp, k=kk))(x)
    got, gk = prepare_operand(t(x), tp, k=torch.as_tensor(kk))
    np.testing.assert_array_equal(bits(want), bits(got.numpy()))
    np.testing.assert_array_equal(np.asarray(kk), gk.numpy())


def test_prepare_operand_in_row_slices_is_bit_identical(monkeypatch):
    """Large operands quantize in slices of whole tile rows: the same bits."""
    from repro_torch.precision import engines

    x = t(_specials((512, 200), 9))
    for mode in ("e5m10", "r2f2_16"):
        _, tp = precs(mode)
        whole = prepare_operand(x, tp)
        monkeypatch.setattr(engines, "_SLICE_ELEMS", 128 * 200)
        sliced = prepare_operand(x, tp)
        monkeypatch.undo()
        np.testing.assert_array_equal(bits(whole[0].numpy()), bits(sliced[0].numpy()))
        if whole[1] is not None:
            assert torch.equal(whole[1], sliced[1])


def test_ste_forward_as_written_and_identity_backward():
    x = torch.tensor([np.inf, 1e38, -1e-30, 1.5], requires_grad=True)
    xq = torch.tensor([np.inf, np.inf, -0.0, 1.5])
    y = ste(x, xq)
    assert torch.isnan(y[0]) and torch.isinf(y[1])
    assert y[2].item() == 0.0 and not torch.signbit(y[2])
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones(4))


def _contract_pair(mode, spec, a, b, **kw):
    jp, tp = precs(mode, **kw)
    if mode == "rr_tracked":
        jtr = j_site_init(("s",), jp.fmt, k0=1)
        ttr = t_site_init(("s",), tp.fmt, k0=1, device="cpu")
        want, jtr = jax.jit(lambda a, b, tr: j_contract(spec, a, b, jp, tracker=tr, site="s"))(a, b, jtr)
        got, ttr = contract(spec, t(a), t(b), tp, tracker=ttr, site="s")
        for f in ("k", "hi_ema", "lo_ema", "overflow_steps", "shrink_steps"):
            np.testing.assert_array_equal(np.asarray(getattr(jtr.state, f)), getattr(ttr.state, f).numpy())
        return want, got, tp
    want = jax.jit(lambda a, b: j_contract(spec, a, b, jp))(a, b)
    got = contract(spec, t(a), t(b), tp)
    return want, got, tp


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize(
    "spec,ashape,bshape",
    [("md,df->mf", (64, 256), (256, 48)), ("bshd,bthd->bhst", (2, 8, 4, 32), (2, 8, 4, 32)),
     ("ecd,edf->ecf", (4, 8, 64), (4, 64, 96))],
    ids=lambda v: v if isinstance(v, str) else None,
)
def test_contract_within_sum_bound(mode, spec, ashape, bshape):
    a, b = _data(ashape, 1, (-2, 2)), _data(bshape, 2, (-2, 2))
    want, got, tp = _contract_pair(mode, spec, a, b)
    if mode == "rr_tracked":  # the operands at the live split: the carried k=1 grown to the need
        from repro_torch.precision.engines import _shared_k

        k = torch.maximum(torch.tensor(1), _shared_k(t(a), t(b), tp))
        aq, bq = prepare_operand(t(a), tp, k=k)[0], prepare_operand(t(b), tp, k=k)[0]
    elif mode in ("bf16", "deploy"):
        aq, bq = t(a).bfloat16().float(), t(b).bfloat16().float()
    else:
        aq, bq = prepare_operand(t(a), tp)[0], prepare_operand(t(b), tp)[0]
    assert_sum_bound(want, got.numpy(), aq, bq, spec, ashape[-1])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("use_kernels", [False, True])
def test_contract_and_dot_dyadic_bit_exact(mode, use_kernels):
    a, b = _dyadic((96, 320), 3), _dyadic((320, 72), 4)
    kw = dict(use_kernels=use_kernels, kernel_blocks=(64, 64, 64))
    want, got, _ = _contract_pair(mode, "md,df->mf", a, b, **kw)
    np.testing.assert_array_equal(bits(want), bits(got.numpy()))
    if mode != "rr_tracked":
        jp, tp = precs(mode, **kw)
        x3 = _dyadic((2, 48, 320), 5)
        want3 = jax.jit(lambda x, w: j_rr_dot(x, w, jp))(x3, a.T)
        np.testing.assert_array_equal(bits(want3), bits(rr_dot(t(x3), t(a.T), tp).numpy()))
        np.testing.assert_array_equal(bits(want), bits(dot(t(a), t(b), tp).numpy()))
        np.testing.assert_array_equal(bits(want), bits(rr_einsum("md,df->mf", t(a), t(b), tp).numpy()))


def test_shared_k_contract():
    a, b = _data((64, 256), 6), _data((256, 32), 7)
    jp, tp = precs("r2f2_16")
    want = jax.jit(lambda a, b: j_contract("md,df->mf", a, b, jp, shared_k=True))(a, b)
    got = contract("md,df->mf", t(a), t(b), tp, shared_k=True)
    from repro_torch.precision.engines import _shared_k

    k = _shared_k(t(a), t(b), tp)
    assert_sum_bound(want, got.numpy(), prepare_operand(t(a), tp, k=k)[0], prepare_operand(t(b), tp, k=k)[0],
                     "md,df->mf", 256)


def test_operand_dtype():
    assert operand_dtype(tpol.PRESETS["bf16"]) == torch.bfloat16
    assert operand_dtype(tpol.PRESETS["deploy"]) == torch.bfloat16
    for name in ("f32", "e5m10", "r2f2_16"):
        assert operand_dtype(tpol.PRESETS[name]) == torch.float32


# ---------------------------------------------------------------------------
# dispatch to K7 (tests/test_precision_engine.py's cases)


@pytest.fixture
def spy(monkeypatch):
    from repro_torch.kernels import ops as kernel_ops

    calls = []
    real = kernel_ops.r2f2_matmul

    def fake(*args, **kw):
        calls.append((args[0].shape, args[1].shape, kw))
        return real(*args, **kw)

    monkeypatch.setattr(kernel_ops, "r2f2_matmul", fake)
    return calls


def test_contract_and_dot_reach_kernel(spy):
    from repro_torch.kernels import ops as kernel_ops

    cfg = dataclasses.replace(tpol.PRESETS["r2f2_16"], use_kernels=True)
    a, b = t(_data((256, 256), 1)), t(_data((256, 256), 2))
    out = contract("ij,jk->ik", a, b, cfg)
    assert len(spy) == 1
    assert torch.equal(out, kernel_ops.r2f2_matmul(a, b, cfg.fmt, tail_approx=cfg.tail_approx))
    dot(a, b, cfg)
    assert len(spy) == 3


def test_no_dispatch_without_knob_or_for_ineligible_specs(spy):
    a, b = t(_data((128, 128), 1)), t(_data((128, 128), 2))
    contract("ij,jk->ik", a, b, tpol.PRESETS["r2f2_16"])
    cfg = dataclasses.replace(tpol.PRESETS["r2f2_16"], use_kernels=True)
    contract("ij,kj->ik", a, b, cfg)  # transposed rhs
    contract("bij,bjk->bik", a[None], b[None], cfg)  # batched
    dot(a[None], b, cfg)  # 3-D activations: dense layers
    assert spy == []


def test_no_dispatch_for_non_rr_engines(spy):
    a, b = t(_data((128, 128), 1)), t(_data((128, 128), 2))
    for name in ("f32", "bf16", "e5m10", "deploy"):
        contract("ij,jk->ik", a, b, dataclasses.replace(tpol.PRESETS[name], use_kernels=True))
    assert spy == []


def test_non_divisible_shapes_dispatch_via_pad_and_crop(spy):
    """Odd shapes reach the kernel, which pads and crops; against repro's
    kernel path on the same inputs."""
    a, b = _data((200, 136), 1, (-2, 2)), _data((136, 72), 2, (-2, 2))
    jp, tp = precs("r2f2_16", use_kernels=True)
    got = contract("ij,jk->ik", t(a), t(b), tp)
    assert len(spy) == 1 and got.shape == (200, 72)
    want = j_contract("ij,jk->ik", a, b, jp)
    from repro_torch.kernels.r2f2_matmul import r2f2_matmul_plain

    mag = r2f2_matmul_plain(t(np.abs(a)), t(np.abs(b)), fmt=tp.fmt).double().numpy()
    assert np.all(np.abs(got.numpy().astype(np.float64) - np.asarray(want)) <= 136 * 2.0**-23 * mag * 1.01)


def test_kernel_blocks_is_a_policy_knob(spy):
    cfg = dataclasses.replace(tpol.PRESETS["r2f2_16"], use_kernels=True, kernel_blocks=(64, 64, 64))
    contract("ij,jk->ik", t(_data((128, 64), 1)), t(_data((64, 128), 2)), cfg)
    assert spy[0][2]["blocks"] == (64, 64, 64)
