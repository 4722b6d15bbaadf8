"""The LM serving path of repro_torch (models, serve.generate) on
reduced(llama4-scout-17b-a16e) with 2 layers, against repro on the same
parameters (repro.model_init, carried over bit for bit by
convert.params_from_numpy) and the same prompts.

Greedy tokens must be equal. Logits are compared by bounds: the einsum sums
and the transcendentals (rsqrt in rmsnorm, exp/sin/cos in rope, softmax,
sigmoid) differ between the libraries in the last ulps, and under the rr
and fixed policies a one-ulp change before a quantizer can flip a rounding
at 10-12 mantissa bits. f32, bf16 and deploy logits are held to
1e-5 * max|logit| after prefill and 1e-4 after a decode step (its KV cache
is bf16: a cache entry one f32 ulp away can round to the other bf16
neighbour). e5m10 and r2f2_16 (with and without kernel K7, whose CPU path
is its plain version) are held by relative L2 to RR_PREFILL and RR_DECODE,
set between two readings: the port reads at most 4.6e-5 after prefill and
2.0e-4 after a decode step, and the port run in f32 reads at least 5.5e-4
and 1.9e-3 against the same logits. The test takes the f32 reading too and
requires it to fail both bounds. Leaving the contractions of any one site
group (attention projections, attention core, experts, shared expert, head)
unquantized reads 1.5e-4 or more after prefill, which fails too; the
router's rounding moves no logit here (top-1 routing renormalizes the gate
to 1), so test_sites_take_the_policy holds every site to the reference's
calls instead. The port's forward logits equal its prefill logits bit for
bit, so forward is held through prefill.

The reference's logits come from inside its own generate (an eager
prefill and a jitted step, its Pallas kernel in interpret mode): a spy
records what its prefill returns, and its step, make_serve_step's body
(decode_step and argmax) as written there, hands each step's logits out
through jax.debug.callback. One generate per mode then gives the prefill
logits and caches, every decode step's logits and the tokens."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core import policy as jpol
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import model_init as j_model_init
from repro.serve import decode as j_serve
from repro.serve import generate as j_generate
from repro_torch import convert
from repro_torch.configs import get_config, reduced
from repro_torch.core import policy as tpol
from repro_torch.kernels.r2f2_matmul import R2F2_MATMUL
from repro_torch.models import decode_step, forward, init_decode_state, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.serve import generate

ARCH = "llama4-scout-17b-a16e"
MODES = ("f32", "bf16", "deploy", "e5m10", "r2f2_16", "r2f2_16+kernels")
TIGHT = ("f32", "bf16", "deploy")
B, S, NEW = 4, 8, 6
#: rel-L2 bounds of the rr and fixed logits (readings in the module docstring)
RR_PREFILL, RR_DECODE = 1e-4, 4e-4


@pytest.fixture(scope="module", autouse=True)
def torch_env():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)  # the reference's XLA:CPU flushes subnormal results
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(prev)


def precs(mode):
    name, _, kern = mode.partition("+")
    kw = dict(use_kernels=True) if kern else {}
    return dataclasses.replace(jpol.PRESETS[name], **kw), dataclasses.replace(tpol.PRESETS[name], **kw)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(j_reduced(j_get_config(ARCH)), n_layers=2)
    tcfg = dataclasses.replace(reduced(get_config(ARCH)), n_layers=2)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = j_model_init(jax.random.PRNGKey(0), jcfg)
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    prompts = np.random.default_rng(1).integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, prompts


def rel_l2(want, got) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.double().numpy() - want) / np.linalg.norm(want))


def assert_logits_close(want, got, mode, decode=False):
    want = np.asarray(want, np.float64)
    assert np.isfinite(got.numpy()).all() and tuple(got.shape) == want.shape
    if mode.partition("+")[0] in TIGHT:
        err = np.abs(got.double().numpy() - want).max() / np.abs(want).max()
        assert err <= (1e-4 if decode else 1e-5), err
    else:
        rel = rel_l2(want, got)
        assert rel <= (RR_DECODE if decode else RR_PREFILL), rel


def test_forward_aux_loss(model):
    jcfg, tcfg, jparams, tparams, prompts = model
    jp, tp = precs("f32")
    want, want_aux = jax.jit(lambda p, t: j_forward(p, jcfg, jp, tokens=t))(jparams, prompts)
    got, got_aux = forward(tparams, tcfg, tp, tokens=torch.from_numpy(prompts))
    assert_logits_close(want, got, "f32")
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)


def test_config_registry():
    cfg = get_config(ARCH)
    assert isinstance(cfg, ModelConfig) and cfg.d_model == 5120 and cfg.moe_shared_expert
    assert cfg.param_count() == j_get_config(ARCH).param_count()
    assert get_config("jamba-v0.1-52b").param_count() == j_get_config("jamba-v0.1-52b").param_count()
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_params_carry_over_bit_for_bit(model):
    _, _, jparams, tparams, _ = model
    jl = jax.tree_util.tree_leaves(jparams)
    tl = jax.tree_util.tree_leaves(tparams)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert b.dtype == torch.float32 and tuple(b.shape) == a.shape
        np.testing.assert_array_equal(np.asarray(a).view(np.uint32), b.numpy().view(np.uint32))


def test_model_init_draws_the_reference_layout():
    cfg = dataclasses.replace(reduced(get_config(ARCH)), n_layers=2)
    from repro_torch.models import model_init

    params = model_init(torch.Generator().manual_seed(0), cfg, "cpu")
    ref = j_model_init(jax.random.PRNGKey(0), dataclasses.replace(j_reduced(j_get_config(ARCH)), n_layers=2))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), ref)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params) == shapes
    for a, b in zip(jax.tree_util.tree_leaves(ref), jax.tree_util.tree_leaves(params)):
        np.testing.assert_allclose(float(b.std()), float(np.asarray(a).std()), rtol=0.2)


def reference_generate(monkeypatch, jparams, jcfg, jp, prompts):
    """repro.serve.generate with its prefill and decode logits recorded."""
    rec = {"decode": []}
    real_prefill = j_serve.prefill

    def prefill_spy(*args, **kw):
        rec["prefill"] = real_prefill(*args, **kw)
        return rec["prefill"]

    def make_serve_step(cfg, prec, window=None):
        def serve_step(params, caches, tokens, pos):
            logits, caches = j_decode_step(params, caches, tokens, pos, cfg, prec, window=window)
            jax.debug.callback(lambda x: rec["decode"].append(np.asarray(x)), logits, ordered=True)
            return jnp.argmax(logits[:, -1, :], axis=-1).astype(jnp.int32)[:, None], caches

        return serve_step

    monkeypatch.setattr(j_serve, "prefill", prefill_spy)
    monkeypatch.setattr(j_serve, "make_serve_step", make_serve_step)
    tokens = np.array(j_generate(jparams, jcfg, jp, prompts, max_new_tokens=NEW))
    monkeypatch.undo()
    return tokens, rec["prefill"], rec["decode"]


def port_logits(tparams, tcfg, tp, prompts, want_tokens):
    """The port's prefill logits and caches, then its logits of each decode
    step on the reference's tokens."""
    tl, tc = prefill(tparams, tcfg, tp, tokens=torch.from_numpy(prompts), max_len=S + NEW)
    caches, steps = tc, []
    for i in range(NEW - 1):
        td, nxt = decode_step(tparams, caches, torch.from_numpy(want_tokens[:, i : i + 1]), S + i, tcfg, tp)
        assert not torch.equal(nxt[0].k, caches[0].k)  # the step wrote its position into a new cache
        caches = nxt
        steps.append(td)
    return tl, tc, steps


@pytest.mark.parametrize("mode", MODES)
def test_forward_prefill_decode_generate(model, mode, monkeypatch):
    jcfg, tcfg, jparams, tparams, prompts = model
    jp, tp = precs(mode)
    tok = torch.from_numpy(prompts)
    want_tokens, (jl, jc), jd = reference_generate(monkeypatch, jparams, jcfg, jp, prompts)
    assert len(jd) == NEW - 1

    tl, tc, steps = port_logits(tparams, tcfg, tp, prompts, want_tokens)
    assert_logits_close(jl, tl, mode)
    got, _ = forward(tparams, tcfg, tp, tokens=tok)
    assert torch.equal(got.view(torch.int32), tl.view(torch.int32))
    assert tc[0].k.dtype == torch.bfloat16 and tuple(tc[0].k.shape) == jc[0].k.shape
    for a, b in ((jc[0].k, tc[0].k), (jc[0].v, tc[0].v)):
        a = np.asarray(a.astype(np.float32), np.float64)
        assert np.abs(b.double().numpy() - a).max() <= 2.0**-7 * np.abs(a).max()
    for want, td in zip(jd, steps):
        assert_logits_close(want, td, mode, decode=True)
    if mode not in TIGHT:  # the bounds must reject the port run in f32
        cl, _, csteps = port_logits(tparams, tcfg, precs("f32")[1], prompts, want_tokens)
        assert rel_l2(jl, cl) > RR_PREFILL
        assert min(rel_l2(w, c) for w, c in zip(jd, csteps)) > RR_DECODE

    launches, plain = R2F2_MATMUL.launches, R2F2_MATMUL.plain_calls
    got_tokens = generate(tparams, tcfg, tp, tok, max_new_tokens=NEW, device="cpu")
    np.testing.assert_array_equal(want_tokens, got_tokens.numpy())
    assert got_tokens.dtype == torch.int32
    # K7 runs at the router and the shared expert's three contractions of
    # each layer, once per forward: prefill and NEW - 1 decode steps
    want_k7 = 2 * 4 * NEW if mode.endswith("+kernels") else 0
    assert (R2F2_MATMUL.launches - launches, R2F2_MATMUL.plain_calls - plain) == (0, want_k7)


def call_sites(monkeypatch, modules, run):
    """Every contract and dot call the model layers make while ``run`` runs
    (or traces), as (site, spec, policy mode, kernel knob, operand shapes)."""
    calls = set()

    def spy(name, fn):
        def recorded(*args, **kw):
            spec, (a, b, prec) = ("dot", args[:3]) if name == "dot" else (args[0], args[1:4])
            calls.add((kw.get("site"), spec, prec.mode, prec.use_kernels, tuple(a.shape), tuple(b.shape)))
            return fn(*args, **kw)

        return recorded

    for mod in modules:
        for name in ("contract", "dot"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, spy(name, getattr(mod, name)))
    run()
    monkeypatch.undo()
    return calls


@pytest.mark.parametrize("mode", ("e5m10", "r2f2_16+kernels"))
def test_sites_take_the_policy(model, mode, monkeypatch):
    """Each layer sends the same contractions through the precision API as
    the reference, with the same spec, policy and operand shapes, the
    router included, in forward and in a decode step. The reference is
    traced, not run: its layer scan traces one layer, so calls are compared
    as sets."""
    from repro.models import attention as j_attention
    from repro.models import init_decode_state as j_init_decode_state
    from repro.models import layers as j_layers
    from repro.models import model as j_model
    from repro.models import moe as j_moe
    from repro_torch.models import attention, layers, moe
    from repro_torch.models import model as t_model

    jcfg, tcfg, jparams, tparams, prompts = model
    jp, tp = precs(mode)
    tok = torch.from_numpy(prompts)
    j_mods, t_mods = (j_attention, j_layers, j_model, j_moe), (attention, layers, t_model, moe)
    jcaches = j_init_decode_state(jcfg, B, S + NEW)
    tcaches = init_decode_state(tcfg, B, S + NEW, device="cpu")
    step_tok = prompts[:, :1]
    want = call_sites(monkeypatch, j_mods, lambda: jax.jit(lambda p, t: j_forward(p, jcfg, jp, tokens=t)).lower(jparams, prompts))
    got = call_sites(monkeypatch, t_mods, lambda: forward(tparams, tcfg, tp, tokens=tok))
    assert got == want
    assert {c[0] for c in got} >= {"moe.router", "moe.shared.gate", "moe.shared.up", "moe.shared.down", "lm.head"}
    want = call_sites(
        monkeypatch, j_mods,
        lambda: jax.jit(lambda p, c, t: j_decode_step(p, c, t, S, jcfg, jp)).lower(jparams, jcaches, step_tok),
    )
    got = call_sites(monkeypatch, t_mods, lambda: decode_step(tparams, tcaches, torch.from_numpy(step_tok), S, tcfg, tp))
    assert got == want and len(got) >= 13


def test_generate_defaults_to_cuda_and_checks_devices(model):
    _, tcfg, _, tparams, prompts = model
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="params live on cpu"):
            generate(tparams, tcfg, tpol.PRESETS["f32"], prompts, max_new_tokens=2)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            generate(tparams, tcfg, tpol.PRESETS["f32"], prompts, max_new_tokens=2)
    with pytest.raises(FileNotFoundError, match="artifact.json"):  # policy= loads the artifact first
        generate(tparams, tcfg, tpol.PRESETS["f32"], prompts, max_new_tokens=2, policy="artifact.json", device="cpu")
    caches = init_decode_state(tcfg, B, 16, device="cpu")
    assert tuple(caches[0].k.shape) == (tcfg.groups, B, 16, tcfg.n_kv_heads, tcfg.hd)


def test_eos_sink_matches_reference(model):
    """The unpatched repro.serve.generate, with an eos sink, in f32."""
    jcfg, tcfg, jparams, tparams, prompts = model
    jp, tp = precs("f32")
    first = np.asarray(j_generate(jparams, jcfg, jp, prompts, max_new_tokens=3))
    eos = int(first[0, 1])
    want = np.asarray(j_generate(jparams, jcfg, jp, prompts, max_new_tokens=NEW, eos_id=eos))
    got = generate(tparams, tcfg, tp, torch.from_numpy(prompts), max_new_tokens=NEW, eos_id=eos, device="cpu")
    np.testing.assert_array_equal(want, got.numpy())
