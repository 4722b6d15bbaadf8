"""Every LM architecture of repro_torch against repro's: the ten configs
and their reduced forms field by field, configs/shapes.py's applicability
and cell_window for every (arch, shape), and the reduced models on the
same parameters (repro.model_init, carried over bit for bit by
convert.params_from_numpy) and the same numpy-seeded prompts:

- f32 greedy generate of jamba (mamba, attention, MoE; once more with a
  sliding window), xlstm (mLSTM and sLSTM) and qwen3 (top-8 MoE, with the
  scatter and with the einsum dispatch): tokens equal, the prefill's and
  every decode step's logits within bounds;
- f32 prefill of pixtral with patch embeddings through its frontend, a
  forward of hubert (audio frames, encoder only, non-causal) and of
  stablelm, llama3-405b and yi;
- r2f2_16 with use_kernels (K7 at the MoE routers; its CPU path is its
  plain version): jamba's prefill and qwen3's generate.

The reference's logits of a generate come from inside its own generate,
as in tests/test_torch_lm.py: a spy records its prefill, and its decode
step (make_serve_step's body as written there) hands each step's logits
out through jax.debug.callback. The port's decode steps run on the
reference's tokens from the port's own prefill caches, and the first also
from repro's, carried over by convert.caches_from_numpy.

Bounds: f32 prefill and forward logits 1e-5 * max|logit| and f32 decode
logits 1e-4 * max|logit|, tests/test_torch_lm.py's (a decode step reads
a bf16 KV cache, where an entry one f32 ulp away can round to the other
bf16 neighbour); the recurrent states carried from the prefill are held to
1e-5 * max|state|. r2f2_16 logits are held by relative L2 to bounds set
between two readings taken on a CPU, the port's against repro's and the
port run in f32 against the same logits: jamba's prefill 1.81e-4 and
1.72e-3 (JAMBA_PREFILL; its blocks alone read 0 to 2.8e-5 each, a rounding
flip of a quantizer here and there after a last-ulp difference of exp or
softplus, compounded over 16 sublayers; repro eager and jitted read 0),
qwen3's prefill 3.2e-5 and 4.9e-4 (RR_PREFILL), its decode steps 0 and
at least 9.1e-4 (RR_DECODE). Each r2f2_16 test requires its f32 reading to
fail its bound."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.core import policy as jpol
from repro.models import decode_step as j_decode_step
from repro.models import forward as j_forward
from repro.models import model_init as j_model_init
from repro.models import moe as j_moe
from repro.models import prefill as j_prefill
from repro.serve import decode as j_serve
from repro.serve import generate as j_generate
from repro_torch import configs, convert
from repro_torch.core import policy as tpol
from repro_torch.kernels.r2f2_matmul import R2F2_MATMUL
from repro_torch.models import decode_step, forward, moe, prefill
from repro_torch.models.config import parse_entry
from repro_torch.serve import generate

B, S, NEW = 2, 16, 4
#: rel-L2 bounds of the r2f2_16 logits (readings in the module docstring)
JAMBA_PREFILL, RR_PREFILL, RR_DECODE = 5e-4, 1.5e-4, 3e-4


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


@pytest.mark.parametrize("arch", j_configs.ARCHS)
def test_config_equals_the_reference(arch):
    assert configs.ARCHS == j_configs.ARCHS and len(configs.ARCHS) == 10
    cfg, ref = configs.get_config(arch), j_configs.get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.param_count() == ref.param_count() and cfg.active_param_count() == ref.active_param_count()
    for mult in (1, 2):
        assert dataclasses.asdict(configs.reduced(cfg, mult)) == dataclasses.asdict(j_configs.reduced(ref, mult))


@pytest.mark.parametrize("arch", j_configs.ARCHS)
def test_shapes_agree(arch):
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in j_configs.SHAPES.items()
    }
    cfg, ref = configs.get_config(arch), j_configs.get_config(arch)
    for name in j_configs.SHAPES:
        assert configs.applicability(cfg, configs.SHAPES[name]) == j_configs.applicability(ref, j_configs.SHAPES[name])
        assert configs.cell_window(cfg, configs.SHAPES[name]) == j_configs.cell_window(ref, j_configs.SHAPES[name])
    from repro.configs import jamba_v0_1_52b as j_jamba, pixtral_12b as j_pixtral
    from repro_torch.configs import jamba_v0_1_52b, pixtral_12b

    assert (jamba_v0_1_52b.LONG_WINDOW, pixtral_12b.IMG_SEQ) == (j_jamba.LONG_WINDOW, j_pixtral.IMG_SEQ)


# --------------------------------------------------------------------------
# the reduced models
# --------------------------------------------------------------------------

_MODELS = {}


def model(arch):
    """(jcfg, tcfg, jparams, tparams, prompts) of reduced ``arch``, cached."""
    if arch not in _MODELS:
        jcfg = j_configs.reduced(j_configs.get_config(arch))
        tcfg = configs.reduced(configs.get_config(arch))
        jparams = j_model_init(jax.random.PRNGKey(0), jcfg)
        tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        prompts = np.random.default_rng(1).integers(0, tcfg.vocab, (B, S)).astype(np.int32)
        _MODELS[arch] = (jcfg, tcfg, jparams, tparams, prompts)
    return _MODELS[arch]


def rel_l2(want, got) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got.double().numpy() - want) / np.linalg.norm(want))


def assert_max_close(want, got, bound):
    want = np.asarray(want, np.float64)
    assert tuple(got.shape) == want.shape and bool(torch.isfinite(got).all())
    err = np.abs(got.double().numpy() - want).max()
    assert err <= bound * np.abs(want).max(), (err, np.abs(want).max())


def reference_generate(monkeypatch, jparams, jcfg, jp, prompts, window=None):
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
    tokens = np.array(j_generate(jparams, jcfg, jp, prompts, max_new_tokens=NEW, window=window))
    monkeypatch.setattr(j_serve, "prefill", real_prefill)
    return tokens, rec["prefill"], rec["decode"]


def port_logits(tparams, tcfg, tp, prompts, want_tokens, window=None):
    """The port's prefill logits and caches, then its logits of each decode
    step on the reference's tokens."""
    tl, tc = prefill(tparams, tcfg, tp, tokens=torch.from_numpy(prompts), max_len=S + NEW, window=window)
    caches, steps = tc, []
    for i in range(NEW - 1):
        td, caches = decode_step(tparams, caches, torch.from_numpy(want_tokens[:, i : i + 1]), S + i, tcfg, tp, window=window)
        steps.append(td)
    return tl, tc, steps


def assert_caches_close(tcfg, want, got):
    """The prefill's caches: KV caches (bf16) within a bf16 rounding, the
    recurrent states within 1e-5 * max|state|, each of the mixer's type."""
    assert len(want) == len(got) == len(tcfg.pattern)
    for entry, w, g in zip(tcfg.pattern, want, got):
        assert type(g).__name__ == type(w).__name__ and g._fields == w._fields
        for a, b in zip(w, g):
            a = np.asarray(np.asarray(a).astype(np.float32), np.float64)
            assert tuple(b.shape) == a.shape
            if parse_entry(entry)[0] == "attn":
                assert b.dtype == torch.bfloat16
                assert np.abs(b.double().numpy() - a).max() <= 2.0**-7 * np.abs(a).max()
            else:
                assert np.abs(b.double().numpy() - a).max() <= 1e-5 * np.abs(a).max()


GENERATE_F32 = [
    ("jamba-v0.1-52b", "scatter", None),
    ("jamba-v0.1-52b", "scatter", 6),  # the long-context mode's sliding window, at every attention position
    ("xlstm-1.3b", "scatter", None),
    ("qwen3-moe-235b-a22b", "scatter", None),
    ("qwen3-moe-235b-a22b", "einsum", None),
]


@pytest.mark.parametrize("arch, dispatch, window", GENERATE_F32)
def test_generate_f32(monkeypatch, arch, dispatch, window):
    jcfg, tcfg, jparams, tparams, prompts = model(arch)
    jp, tp = precs("f32")
    monkeypatch.setattr(j_moe, "DISPATCH_MODE", dispatch)
    monkeypatch.setattr(moe, "DISPATCH_MODE", dispatch)
    want_tokens, (jl, jc), jd = reference_generate(monkeypatch, jparams, jcfg, jp, prompts, window)
    assert len(jd) == NEW - 1
    tl, tc, steps = port_logits(tparams, tcfg, tp, prompts, want_tokens, window)
    assert_max_close(jl, tl, 1e-5)
    assert_caches_close(tcfg, jc, tc)
    for want, td in zip(jd, steps):
        assert_max_close(want, td, 1e-4)
    # a decode step from repro's own prefill caches, carried over (KV caches and recurrent states)
    carried = convert.caches_from_numpy(tcfg.pattern, jax.tree_util.tree_map(np.asarray, jc))
    td, _ = decode_step(tparams, carried, torch.from_numpy(want_tokens[:, :1]), S, tcfg, tp, window=window)
    assert_max_close(jd[0], td, 1e-4)
    got = generate(tparams, tcfg, tp, torch.from_numpy(prompts), max_new_tokens=NEW, window=window, device="cpu")
    np.testing.assert_array_equal(want_tokens, got.numpy())


def test_window_reaches_every_attention_position(monkeypatch):
    """generate's window= masks the KV cache at jamba's attention position:
    a window of 6 changes the decode logits, in both packages alike."""
    _, tcfg, _, tparams, prompts = model("jamba-v0.1-52b")
    seen = []
    from repro_torch.models import attention

    real = attention.attn_decode
    monkeypatch.setattr(attention, "attn_decode", lambda *a, **k: seen.append(k.get("window")) or real(*a, **k))
    generate(tparams, tcfg, precs("f32")[1], torch.from_numpy(prompts), max_new_tokens=3, window=6, device="cpu")
    n_attn = sum(parse_entry(e)[0] == "attn" for e in tcfg.pattern) * tcfg.groups
    assert seen == [6] * (2 * n_attn)


def test_pixtral_prefill_with_patch_embeddings():
    """Patch embeddings (frontend_dim wide) projected at lm.frontend, ahead
    of the tokens; f32 logits and KV caches."""
    jcfg, tcfg, jparams, tparams, prompts = model("pixtral-12b")
    embeds = np.random.default_rng(2).standard_normal((B, 8, tcfg.frontend_dim)).astype(np.float32)
    jp, tp = precs("f32")
    jl, jc = jax.jit(lambda p, t, e: j_prefill(p, jcfg, jp, tokens=t, embeds=e, max_len=S + 8 + NEW))(jparams, prompts, embeds)
    tl, tc = prefill(tparams, tcfg, tp, tokens=torch.from_numpy(prompts), embeds=torch.from_numpy(embeds), max_len=S + 8 + NEW)
    assert tl.shape == (B, 8 + S, tcfg.vocab)
    assert_max_close(jl, tl, 1e-5)
    assert_caches_close(tcfg, jc, tc)
    fl, _ = forward(tparams, tcfg, tp, tokens=torch.from_numpy(prompts), embeds=torch.from_numpy(embeds))
    assert torch.equal(fl, tl)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "stablelm-12b", "llama3-405b", "yi-34b"])
def test_forward_f32(arch):
    """hubert (encoder only, non-causal) over audio frame embeddings alone;
    the dense decoders over tokens."""
    jcfg, tcfg, jparams, tparams, prompts = model(arch)
    jp, tp = precs("f32")
    if tcfg.frontend:
        embeds = np.random.default_rng(3).standard_normal((B, S, tcfg.frontend_dim)).astype(np.float32)
        want, want_aux = jax.jit(lambda p, e: j_forward(p, jcfg, jp, embeds=e))(jparams, embeds)
        got, got_aux = forward(tparams, tcfg, tp, embeds=torch.from_numpy(embeds))
    else:
        want, want_aux = jax.jit(lambda p, t: j_forward(p, jcfg, jp, tokens=t))(jparams, prompts)
        got, got_aux = forward(tparams, tcfg, tp, tokens=torch.from_numpy(prompts))
    assert_max_close(want, got, 1e-5)
    assert float(got_aux) == float(want_aux) == 0.0


def test_jamba_prefill_r2f2_with_k7():
    """r2f2_16 with use_kernels: K7 (its plain version on the CPU) at the
    routers of jamba's 4 MoE layers, once each."""
    jcfg, tcfg, jparams, tparams, prompts = model("jamba-v0.1-52b")
    jp, tp = precs("r2f2_16+kernels")
    jl, _ = jax.jit(lambda p, t: j_prefill(p, jcfg, jp, tokens=t, max_len=S + NEW))(jparams, prompts)
    plain = R2F2_MATMUL.plain_calls
    tl, tc = prefill(tparams, tcfg, tp, tokens=torch.from_numpy(prompts), max_len=S + NEW)
    assert R2F2_MATMUL.plain_calls - plain == 4
    assert bool(torch.isfinite(tl).all()) and rel_l2(jl, tl) <= JAMBA_PREFILL, rel_l2(jl, tl)
    fl, _ = prefill(tparams, tcfg, precs("f32")[1], tokens=torch.from_numpy(prompts), max_len=S + NEW)
    assert rel_l2(jl, fl) > JAMBA_PREFILL


def test_qwen3_generate_r2f2_with_k7(monkeypatch):
    """r2f2_16 with use_kernels: qwen3's router on K7 once a forward (its
    plain version on the CPU), tokens equal to repro's generate."""
    jcfg, tcfg, jparams, tparams, prompts = model("qwen3-moe-235b-a22b")
    jp, tp = precs("r2f2_16+kernels")
    want_tokens, (jl, _), jd = reference_generate(monkeypatch, jparams, jcfg, jp, prompts)
    tl, _, steps = port_logits(tparams, tcfg, tp, prompts, want_tokens)
    assert rel_l2(jl, tl) <= RR_PREFILL, rel_l2(jl, tl)
    for want, td in zip(jd, steps):
        assert rel_l2(want, td) <= RR_DECODE, rel_l2(want, td)
    fl, _, fsteps = port_logits(tparams, tcfg, precs("f32")[1], prompts, want_tokens)
    assert rel_l2(jl, fl) > RR_PREFILL and min(rel_l2(w, f) for w, f in zip(jd, fsteps)) > RR_DECODE
    plain = R2F2_MATMUL.plain_calls
    got = generate(tparams, tcfg, tp, torch.from_numpy(prompts), max_new_tokens=NEW, device="cpu")
    assert R2F2_MATMUL.plain_calls - plain == NEW * tcfg.groups
    np.testing.assert_array_equal(want_tokens, got.numpy())
