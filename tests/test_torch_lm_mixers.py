"""The LM mixers of repro_torch against repro's, each alone at small shapes,
on the same numpy-seeded inputs and on parameters carried over by
convert.params_from_numpy: chunked attention (_chunked_attention, and
attn_apply over the chunked path), the mamba mixer (mamba_apply from zero
and from a carried state, over several chunks, and mamba_decode), the
xLSTM cells (mlstm_apply, slstm_apply and their decode steps) and the MoE
layer with the einsum dispatch at a capacity that drops tokens.

The chunk lengths are patched small in both packages (FLASH_THRESHOLD,
FLASH_CHUNK, SSM_CHUNK, LSTM_CHUNK), so every run crosses chunk
boundaries; one attn_apply runs at the real threshold (S = 5120, chunks of
1024). repro's runs are jitted.

f32 outputs and carried states are held to F32_BOUND * max|out| (the
bound of tests/test_torch_lm.py's prefill logits): the port sums in
another order than XLA and its exp, log1p and sigmoid differ from XLA's in
the last ulps. The port's in-chunk mamba scan is the odd/even recursion of
jax.lax.associative_scan, so its rounding tree is the reference's.

r2f2_16 outputs are held by relative L2 to RR_BOUND, set between two
readings taken on a CPU: the port against repro in r2f2_16 reads at
most 2.9e-5 over these mixers and their states (attn_apply 1.8e-5 to
2.9e-5, _chunked_attention 3.1e-6, mamba 1.5e-5, the xLSTM cells 4.2e-6,
the MoE 0), and the port run in f32 against the same repro outputs reads
at least 1.41e-4 (_chunked_attention, windowed). Each r2f2_16 test takes the
f32 reading too and requires it to fail the bound."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import policy as jpol
from repro.models import attention as j_attention
from repro.models import moe as j_moe
from repro.models import ssm as j_ssm
from repro.models import xlstm as j_xlstm
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.core import policy as tpol
from repro_torch.models import attention, moe, ssm, xlstm

F32_BOUND = 1e-5
#: rel-L2 bound of the r2f2_16 outputs (readings in the module docstring)
RR_BOUND = 6e-5
MODES = ("f32", "r2f2_16")


@pytest.fixture(scope="module", autouse=True)
def torch_env():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)  # the reference's XLA:CPU flushes subnormal results
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(prev)


def precs(mode):
    return jpol.PRESETS[mode], tpol.PRESETS[mode]


def cfgs(arch, **kw):
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), **kw)
    tcfg = dataclasses.replace(reduced(get_config(arch)), **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


def carry(tree):
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def rel_l2(want, got) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.double().numpy() - want) / np.linalg.norm(want))


def assert_close(want, got, mode, f32_got=None):
    """``got`` (a tensor) against ``want`` (repro's array) under the mode's
    bound; in r2f2_16 the port's f32 run ``f32_got`` must fail it."""
    want = np.asarray(want, np.float64)
    assert tuple(got.shape) == want.shape and bool(torch.isfinite(got).all())
    if mode == "f32":
        err = np.abs(got.double().numpy() - want).max()
        assert err <= F32_BOUND * np.abs(want).max(), (err, np.abs(want).max())
    else:
        assert rel_l2(want, got) <= RR_BOUND, rel_l2(want, got)
        if f32_got is not None:
            assert rel_l2(want, f32_got) > RR_BOUND, rel_l2(want, f32_got)


def assert_tree_close(want, got, mode, f32_got=None):
    wl, gl = jax.tree_util.tree_leaves(want), list(got)
    fl = [None] * len(gl) if f32_got is None else list(f32_got)
    assert len(wl) == len(gl)
    for w, g, f in zip(wl, gl, fl):
        assert_close(w, g, mode, f)


# --------------------------------------------------------------------------
# chunked attention
# --------------------------------------------------------------------------

B, S, H, HD, CHUNK = 2, 64, 4, 16, 16


@pytest.fixture(scope="module")
def qkv():
    return tuple(normal(seed, (B, S, H, HD)) for seed in (10, 11, 12))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("causal, window", [(True, None), (True, 20), (False, None), (False, 24)])
def test_chunked_attention(qkv, mode, causal, window):
    jp, tp = precs(mode)
    want = jax.jit(lambda q, k, v: j_attention._chunked_attention(q, k, v, causal, window, jp, cq=CHUNK, ck=CHUNK))(*qkv)
    t = [torch.from_numpy(a) for a in qkv]
    got = attention._chunked_attention(*t, causal, window, tp, cq=CHUNK, ck=CHUNK)
    f32_got = None if mode == "f32" else attention._chunked_attention(*t, causal, window, precs("f32")[1], cq=CHUNK, ck=CHUNK)
    assert_close(want, got, mode, f32_got)


def test_chunked_attention_equals_dense_where_it_fits(qkv):
    """The port's chunked path against its own dense path, both f32."""
    t = [torch.from_numpy(a) for a in qkv]
    prec = precs("f32")[1]
    for causal, window in ((True, None), (True, 20), (False, None)):
        dense = attention._dense_attention(*t, causal, window, prec)
        chunked = attention._chunked_attention(*t, causal, window, prec, cq=CHUNK, ck=CHUNK)
        assert (chunked - dense).abs().max() <= F32_BOUND * dense.abs().max()


def test_chunked_attention_needs_whole_chunks(qkv):
    q = qkv[0][:, :40]
    with pytest.raises(AssertionError):
        j_attention._chunked_attention(q, q, q, True, None, precs("f32")[0], cq=CHUNK, ck=CHUNK)
    t = torch.from_numpy(q)
    with pytest.raises(ValueError, match="S % cq == 0"):
        attention._chunked_attention(t, t, t, True, None, precs("f32")[1], cq=CHUNK, ck=CHUNK)


def attn_pair(arch, seed=0, **kw):
    jcfg, tcfg = cfgs(arch, **kw)
    jparams = j_attention.attn_init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jparams, carry(jparams)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("causal, window", [(True, None), (True, 20), (False, None)])
def test_attn_apply_takes_the_chunked_path(monkeypatch, mode, causal, window):
    """attn_apply at S = 64 over FLASH_THRESHOLD patched to 32 in both
    packages, chunks of 16: its output and KV cache."""
    jcfg, tcfg, jparams, tparams = attn_pair("mistral-nemo-12b", causal=causal)
    jp, tp = precs(mode)
    x = normal(20, (B, S, tcfg.d_model))
    monkeypatch.setattr(j_attention, "FLASH_THRESHOLD", 32)
    monkeypatch.setattr(j_attention._chunked_attention, "__defaults__", (CHUNK, CHUNK))
    monkeypatch.setattr(attention, "FLASH_THRESHOLD", 32)
    monkeypatch.setattr(attention, "FLASH_CHUNK", CHUNK)
    calls = []
    real = attention._chunked_attention
    monkeypatch.setattr(attention, "_chunked_attention", lambda *a, **k: calls.append(1) or real(*a, **k))
    want = jax.jit(lambda p, x: j_attention.attn_apply(p, x, jcfg, jp, window=window))(jparams, x)
    got = attention.attn_apply(tparams, torch.from_numpy(x), tcfg, tp, window=window)
    assert calls == [1]
    f32_got = None if mode == "f32" else attention.attn_apply(tparams, torch.from_numpy(x), tcfg, precs("f32")[1], window=window)
    assert_close(want[0], got[0], mode, None if f32_got is None else f32_got[0])
    assert_tree_close(want[1], got[1], "f32")  # k and v come before the attention core


def test_attn_apply_at_the_real_threshold():
    """S = 5120 > FLASH_THRESHOLD = 4096 at reduced widths, f32: 5 x 5 chunk
    pairs of 1024 in both packages, causal."""
    assert attention.FLASH_THRESHOLD == j_attention.FLASH_THRESHOLD == 4096
    assert attention.FLASH_CHUNK == j_attention.FLASH_CHUNK == 1024
    jcfg, tcfg, jparams, tparams = attn_pair("stablelm-12b", seed=3)
    x = normal(21, (1, 5120, tcfg.d_model))
    jp, tp = precs("f32")
    want = jax.jit(lambda p, x: j_attention.attn_apply(p, x, jcfg, jp))(jparams, x)
    got = attention.attn_apply(tparams, torch.from_numpy(x), tcfg, tp)
    assert_close(want[0], got[0], "f32")


# --------------------------------------------------------------------------
# mamba
# --------------------------------------------------------------------------

SEQ, SMALL_CHUNK = 32, 8


def mamba_state(tcfg, seed):
    return (normal(seed, (B, tcfg.d_inner, tcfg.ssm_state), 0.5), normal(seed + 1, (B, tcfg.ssm_conv - 1, tcfg.d_inner)))


@pytest.fixture(scope="module")
def mamba():
    jcfg, tcfg = cfgs("jamba-v0.1-52b")
    jparams = j_ssm.mamba_init(jax.random.PRNGKey(4), jcfg)
    return jcfg, tcfg, jparams, carry(jparams)


def test_mamba_init_is_the_reference_layout(mamba):
    jcfg, tcfg, jparams, _ = mamba
    params = ssm.mamba_init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams) == {k: tuple(v.shape) for k, v in params.items()}
    for name in ("dt_bias", "A_log", "D"):  # deterministic in both packages, up to the libraries' log
        np.testing.assert_array_max_ulp(np.asarray(jparams[name]), params[name].numpy(), maxulp=1)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("carried", [False, True])
def test_mamba_apply(monkeypatch, mamba, mode, carried):
    jcfg, tcfg, jparams, tparams = mamba
    monkeypatch.setattr(j_ssm, "SSM_CHUNK", SMALL_CHUNK)
    monkeypatch.setattr(ssm, "SSM_CHUNK", SMALL_CHUNK)
    jp, tp = precs(mode)
    x = normal(30, (B, SEQ, tcfg.d_model))
    st = mamba_state(tcfg, 31) if carried else None
    jst = None if st is None else j_ssm.MambaState(*map(jnp.asarray, st))
    tst = None if st is None else convert.mamba_state_from_numpy(*st)
    want = jax.jit(lambda p, x, s: j_ssm.mamba_apply(p, x, jcfg, jp, state=s))(jparams, x, jst)
    got = ssm.mamba_apply(tparams, torch.from_numpy(x), tcfg, tp, state=tst)
    f32_got = None if mode == "f32" else ssm.mamba_apply(tparams, torch.from_numpy(x), tcfg, precs("f32")[1], state=tst)
    assert_close(want[0], got[0], mode, None if f32_got is None else f32_got[0])
    assert isinstance(got[1], ssm.MambaState)
    assert_tree_close(want[1], got[1], mode if mode == "f32" else "r2f2_16")


@pytest.mark.parametrize("mode", MODES)
def test_mamba_decode(mamba, mode):
    jcfg, tcfg, jparams, tparams = mamba
    jp, tp = precs(mode)
    x = normal(32, (B, 1, tcfg.d_model))
    st = mamba_state(tcfg, 33)
    want = jax.jit(lambda p, x, s: j_ssm.mamba_decode(p, x, s, jcfg, jp))(jparams, x, j_ssm.MambaState(*st))
    got = ssm.mamba_decode(tparams, torch.from_numpy(x), convert.mamba_state_from_numpy(*st), tcfg, tp)
    f32_got = None if mode == "f32" else ssm.mamba_decode(tparams, torch.from_numpy(x), convert.mamba_state_from_numpy(*st), tcfg, precs("f32")[1])
    assert_close(want[0], got[0], mode, None if f32_got is None else f32_got[0])
    assert_tree_close(want[1], got[1], mode)


def test_scan_is_the_reference_recursion():
    """The in-chunk scan against jax.lax.associative_scan on the same
    (decay, drive) pairs, odd and even lengths. The recursion is the same;
    compiled XLA contracts ``xa * db + xb`` into one FMA where the port
    rounds twice, so an element may differ by an ulp of its larger addend:
    held to 1e-6 * max|drive scan| (read: 1.2e-7 at most)."""
    for n in (1, 2, 7, 8, 13):
        dec, drv = np.abs(normal(40 + n, (2, n, 3, 4))), normal(50 + n, (2, n, 3, 4))

        def combine(a, b):
            return a[0] * b[0], a[1] * b[0] + b[1]

        want = jax.jit(lambda d, x: jax.lax.associative_scan(combine, (d, x), axis=1))(dec, drv)
        got = ssm._scan(torch.from_numpy(dec), torch.from_numpy(drv))
        for w, g in zip(want, got):
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= 1e-6 * np.abs(w).max()


# --------------------------------------------------------------------------
# xLSTM
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lstm():
    jcfg, tcfg = cfgs("xlstm-1.3b")
    jm = j_xlstm.mlstm_init(jax.random.PRNGKey(5), jcfg)
    js = j_xlstm.slstm_init(jax.random.PRNGKey(6), jcfg)
    return jcfg, tcfg, jm, carry(jm), js, carry(js)


def lstm_states(tcfg, seed):
    H, dh, li = tcfg.n_heads, tcfg.lstm_inner // tcfg.n_heads, tcfg.lstm_inner
    m = (normal(seed, (B, H, dh, dh), 0.3), normal(seed + 1, (B, H, dh), 0.3))
    s = (normal(seed + 2, (B, li), 0.5), normal(seed + 3, (B, li), 0.5))
    return m, s


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
@pytest.mark.parametrize("carried", [False, True])
def test_lstm_apply(monkeypatch, lstm, mode, cell, carried):
    jcfg, tcfg, jm, tm, js, ts = lstm
    monkeypatch.setattr(j_xlstm, "LSTM_CHUNK", SMALL_CHUNK)
    monkeypatch.setattr(xlstm, "LSTM_CHUNK", SMALL_CHUNK)
    jp, tp = precs(mode)
    x = normal(60, (B, SEQ, tcfg.d_model))
    m, s = lstm_states(tcfg, 61)
    if cell == "mlstm":
        japply, tapply, jparams, tparams = j_xlstm.mlstm_apply, xlstm.mlstm_apply, jm, tm
        jst, tst = j_xlstm.MLSTMState(*m), convert.mlstm_state_from_numpy(*m)
    else:
        japply, tapply, jparams, tparams = j_xlstm.slstm_apply, xlstm.slstm_apply, js, ts
        jst, tst = j_xlstm.SLSTMState(*s), convert.slstm_state_from_numpy(*s)
    jst, tst = (jst, tst) if carried else (None, None)
    want = jax.jit(lambda p, x, st: japply(p, x, jcfg, jp, state=st))(jparams, x, jst)
    got = tapply(tparams, torch.from_numpy(x), tcfg, tp, state=tst)
    f32_got = None if mode == "f32" else tapply(tparams, torch.from_numpy(x), tcfg, precs("f32")[1], state=tst)
    assert_close(want[0], got[0], mode, None if f32_got is None else f32_got[0])
    assert type(got[1]).__name__ == type(want[1]).__name__
    assert_tree_close(want[1], got[1], mode)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_lstm_decode(lstm, mode, cell):
    jcfg, tcfg, jm, tm, js, ts = lstm
    jp, tp = precs(mode)
    x = normal(62, (B, 1, tcfg.d_model))
    m, s = lstm_states(tcfg, 63)
    if cell == "mlstm":
        jdec, tdec, jparams, tparams, jst, tst = j_xlstm.mlstm_decode, xlstm.mlstm_decode, jm, tm, j_xlstm.MLSTMState(*m), convert.mlstm_state_from_numpy(*m)
    else:
        jdec, tdec, jparams, tparams, jst, tst = j_xlstm.slstm_decode, xlstm.slstm_decode, js, ts, j_xlstm.SLSTMState(*s), convert.slstm_state_from_numpy(*s)
    want = jax.jit(lambda p, x, st: jdec(p, x, st, jcfg, jp))(jparams, x, jst)
    got = tdec(tparams, torch.from_numpy(x), tst, tcfg, tp)
    f32_got = None if mode == "f32" else tdec(tparams, torch.from_numpy(x), tst, tcfg, precs("f32")[1])
    assert_close(want[0], got[0], mode, None if f32_got is None else f32_got[0])
    assert_tree_close(want[1], got[1], mode)


def test_mlstm_chunks_need_whole_chunks(lstm):
    _, tcfg, *_ = lstm
    q = torch.zeros(1, 12, 1, 4)
    g = torch.zeros(1, 12, 1)
    with pytest.raises(ValueError, match="S % chunk == 0"):
        xlstm._mlstm_chunked(q, q, q, g, g, xlstm.MLSTMState(torch.zeros(1, 1, 4, 4), torch.zeros(1, 1, 4)), chunk=8)


# --------------------------------------------------------------------------
# MoE, einsum dispatch
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_moe_einsum_dispatch_drops_tokens(monkeypatch, mode):
    """qwen3's MoE (4 experts top-2 reduced) at capacity_factor 0.5: the
    capacity (4 slots an expert for 32 tokens) drops tokens. The einsum
    dispatch against repro's, and against the port's scatter dispatch."""
    jcfg, tcfg = cfgs("qwen3-moe-235b-a22b", capacity_factor=0.5)
    jparams = j_moe.moe_init(jax.random.PRNGKey(7), jcfg)
    tparams = carry(jparams)
    jp, tp = precs(mode)
    x = normal(70, (B, 16, tcfg.d_model))
    monkeypatch.setattr(j_moe, "DISPATCH_MODE", "einsum")
    monkeypatch.setattr(moe, "DISPATCH_MODE", "einsum")
    sites = []
    real = moe.contract
    monkeypatch.setattr(moe, "contract", lambda *a, **k: sites.append(k["site"]) or real(*a, **k))
    want, want_aux = jax.jit(lambda p, x: j_moe.moe_apply(p, x, jcfg, jp))(jparams, x)
    got, got_aux = moe.moe_apply(tparams, torch.from_numpy(x), tcfg, tp)
    assert sites == ["moe.router", "moe.dispatch", "moe.gate", "moe.up", "moe.down", "moe.combine"]
    f32_got = None if mode == "f32" else moe.moe_apply(tparams, torch.from_numpy(x), tcfg, precs("f32")[1])[0]
    assert_close(want, got, mode, f32_got)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)
    # tokens were dropped: some token's output misses one of its experts
    probs = torch.softmax(torch.from_numpy(x).reshape(-1, tcfg.d_model) @ tparams["router"], dim=-1)
    _, idx = moe.top_k(probs, tcfg.moe_top_k)
    capacity = max(1, int((idx.shape[0] // tcfg.moe_experts) * tcfg.capacity_factor * tcfg.moe_top_k))
    assert int(torch.bincount(idx.reshape(-1), minlength=tcfg.moe_experts).max()) > capacity
    if mode == "f32":  # the two dispatches agree
        monkeypatch.setattr(moe, "DISPATCH_MODE", "scatter")
        scatter, _ = moe.moe_apply(tparams, torch.from_numpy(x), tcfg, tp)
        assert (scatter - got).abs().max() <= F32_BOUND * got.abs().max()


def test_round_up_past_the_split_overflows_as_in_the_reference():
    """rr_tile picks a tile's split from its largest exponent alone, so a
    value within half an ulp of the top of E(eb+k)'s range rounds up to
    inf (seen at full width: xlstm-1.3b's xlstm.down, 15.99963 at k = 0).
    The port mirrors the reference bit for bit, inf included."""
    from repro.precision import prepare_operand as j_prepare
    from repro_torch.precision import prepare_operand

    x = np.linspace(1.0, 15.0, 128, dtype=np.float32).reshape(1, 1, 128)
    x[0, 0, 7] = 15.99963
    want_q, want_k = j_prepare(jnp.asarray(x), precs("r2f2_16")[0])
    got_q, got_k = prepare_operand(torch.from_numpy(x), precs("r2f2_16")[1])
    assert int(np.asarray(want_k).max()) == int(got_k.max()) == 0
    np.testing.assert_array_equal(np.asarray(want_q).view(np.uint32), got_q.numpy().view(np.uint32))
    assert got_q[0, 0, 7] == float("inf")
