"""Model assembly: embedding -> block groups -> norm -> head.

The cyclic ``cfg.pattern`` defines one *group*; each block parameter is
stacked over ``cfg.groups`` on a leading dim, and the groups run in a loop
(``repro`` scans them). Decode threads a per-group cache through the same
loop: KV caches at attention positions, recurrent states (``MambaState``,
``MLSTMState``, ``SLSTMState``) at mamba and xLSTM positions. A modality
frontend (``cfg.frontend``: audio frames, vision patches) enters as
precomputed embeddings projected at ``lm.frontend``, ahead of the tokens.

Three entry points:
  forward()     full-sequence
  prefill()     forward + per-layer cache collection
  decode_step() one token with cache (the serve_step body)

``lm_loss`` (training) is not ported yet (ROADMAP.md queue 1, the LM
stack: model.py::lm_loss).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention, moe, ssm, xlstm
from repro_torch.models.config import ModelConfig, parse_entry
from repro_torch.models.layers import embed_init, mlp_apply, mlp_init, normal, rmsnorm, rmsnorm_init
from repro_torch.precision import PrecisionConfig, dot

__all__ = ["model_init", "forward", "prefill", "decode_step", "init_decode_state"]


def _block_init(generator, entry: str, cfg: ModelConfig, *, lead, device):
    mixer, ffn = parse_entry(entry)
    kw = dict(lead=lead, device=device)
    p: dict = {"ln1": rmsnorm_init(cfg.d_model, **kw)}
    if mixer == "attn":
        p["attn"] = attention.attn_init(generator, cfg, **kw)
    elif mixer == "mamba":
        p["mamba"] = ssm.mamba_init(generator, cfg, **kw)
    elif mixer == "mlstm":
        p["mlstm"] = xlstm.mlstm_init(generator, cfg, **kw)
    elif mixer == "slstm":
        p["slstm"] = xlstm.slstm_init(generator, cfg, **kw)
    if ffn is not None:
        p["ln2"] = rmsnorm_init(cfg.d_model, **kw)
    if ffn == "mlp":
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act, **kw)
    elif ffn == "moe":
        p["moe"] = moe.moe_init(generator, cfg, **kw)
    return p


def model_init(generator, cfg: ModelConfig, device):
    """Random parameters from ``generator`` (a ``torch.Generator`` on
    ``device``), with ``repro``'s distributions and tree layout."""
    blocks = tuple(_block_init(generator, entry, cfg, lead=(cfg.groups,), device=device) for entry in cfg.pattern)
    params = {
        "embed": embed_init(generator, cfg.vocab, cfg.d_model, device=device),
        "blocks": blocks,
        "final_norm": rmsnorm_init(cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = normal(generator, (cfg.d_model, cfg.vocab), cfg.d_model**-0.5, device=device)
    if cfg.frontend is not None:
        params["frontend_proj"] = normal(generator, (cfg.frontend_dim, cfg.d_model), cfg.frontend_dim**-0.5, device=device)
    return params


def _index(tree, g: int):
    """One group's slice of a stacked parameter tree."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_index(v, g) for v in tree)
    return tree[g]


def _mixer_apply(entry, bp, x, cfg, prec, window, cache=None, pos=None):
    """Returns (residual_out, new_cache_or_state)."""
    mixer, _ = parse_entry(entry)
    h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
    if mixer == "attn":
        if cache is not None and pos is not None:
            return attention.attn_decode(bp["attn"], h, cache, pos, cfg, prec, window=window)
        return attention.attn_apply(bp["attn"], h, cfg, prec, window=window)
    if mixer == "mamba":
        return ssm.mamba_apply(bp["mamba"], h, cfg, prec, state=cache)
    if mixer == "mlstm":
        return xlstm.mlstm_apply(bp["mlstm"], h, cfg, prec, state=cache)
    return xlstm.slstm_apply(bp["slstm"], h, cfg, prec, state=cache)


def _group_apply(x, group_params, cfg, prec, window, caches=None, pos=None):
    """Apply one pattern period. caches: a tuple per position (or None).
    Returns (x, aux, new caches)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = []
    for i, entry in enumerate(cfg.pattern):
        _, ffn = parse_entry(entry)
        bp = group_params[i]
        out, new_cache = _mixer_apply(entry, bp, x, cfg, prec, window, None if caches is None else caches[i], pos)
        x = x + out
        if ffn is not None:
            h = rmsnorm(x, bp["ln2"], cfg.norm_eps)
            if ffn == "mlp":
                x = x + mlp_apply(bp["mlp"], h, cfg.act, prec)
            else:
                out, aux = moe.moe_apply(bp["moe"], h, cfg, prec)
                x = x + out
                aux_total = aux_total + aux
        new_caches.append(new_cache)
    return x, aux_total, tuple(new_caches)


def _embed_inputs(params, cfg: ModelConfig, tokens=None, embeds=None, prec=None):
    """tokens: (B, S) ints and/or embeds: (B, S_f, frontend_dim); the
    frontend's projections come first."""
    parts = []
    if embeds is not None:
        parts.append(dot(torch.as_tensor(embeds).to(torch.float32), params["frontend_proj"], prec, site="lm.frontend"))
    if tokens is not None:
        parts.append(params["embed"][tokens])
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _head(params, cfg, prec, x):
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return dot(x, head, prec, site="lm.head")


def forward(params, cfg: ModelConfig, prec: PrecisionConfig, tokens=None, embeds=None, window: Optional[int] = None):
    """Full-sequence forward. Returns (logits, aux_loss)."""
    x = _embed_inputs(params, cfg, tokens, embeds, prec)
    auxs = []
    for g in range(cfg.groups):
        x, aux, _ = _group_apply(x.to(torch.float32), _index(params["blocks"], g), cfg, prec, window)
        auxs.append(aux)
    return _head(params, cfg, prec, x.to(torch.float32)), torch.sum(torch.stack(auxs))


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, cache_dtype=torch.bfloat16, *, device):
    """Caches: a tuple over pattern positions, each stacked over groups: a
    KVCache at attention positions, the mixer's zero state elsewhere."""
    caches = []
    for entry in cfg.pattern:
        mixer, _ = parse_entry(entry)
        if mixer == "attn":
            c = attention.init_cache(cfg, batch, max_len, dtype=cache_dtype, device=device)
        elif mixer == "mamba":
            c = ssm.init_mamba_state(cfg, batch, device=device)
        elif mixer == "mlstm":
            c = xlstm.init_mlstm_state(cfg, batch, device=device)
        else:
            c = xlstm.init_slstm_state(cfg, batch, device=device)
        caches.append(type(c)(*(t.expand(cfg.groups, *t.shape).clone() for t in c)))
    return tuple(caches)


def _stack_caches(per_group):
    """Per-group tuples of caches (any NamedTuple of tensors) -> a tuple of
    the same NamedTuples stacked over groups."""
    return tuple(
        type(first)(*(torch.stack([g[i][j] for g in per_group]) for j in range(len(first))))
        for i, first in enumerate(per_group[0])
    )


def decode_step(params, caches, tokens, pos: int, cfg: ModelConfig, prec: PrecisionConfig, window: Optional[int] = None):
    """One decode step. tokens: (B, 1) ints; pos: the current index.
    Returns (logits (B, 1, vocab), new caches)."""
    x = params["embed"][tokens]
    new = []
    for g in range(cfg.groups):
        cache_g = tuple(type(c)(*(t[g] for t in c)) for c in caches)
        x, _, c = _group_apply(x, _index(params["blocks"], g), cfg, prec, window, caches=cache_g, pos=pos)
        new.append(c)
    return _head(params, cfg, prec, x), _stack_caches(new)


def prefill(params, cfg, prec, tokens=None, embeds=None, max_len=None, window=None, cache_dtype=torch.bfloat16):
    """Forward pass that also fills a decode cache: attention positions get
    their KV caches padded to ``max_len``, recurrent positions their
    boundary states. Returns (logits, caches)."""
    x = _embed_inputs(params, cfg, tokens, embeds, prec)
    S = x.shape[1]
    max_len = max_len or S
    pad = (0, 0, 0, 0, 0, max_len - S)
    per_group = []
    for g in range(cfg.groups):
        x, _, caches = _group_apply(x, _index(params["blocks"], g), cfg, prec, window)
        per_group.append(tuple(
            attention.KVCache(
                k=torch.nn.functional.pad(c.k, pad).to(cache_dtype), v=torch.nn.functional.pad(c.v, pad).to(cache_dtype)
            )
            if parse_entry(entry)[0] == "attn" else c
            for entry, c in zip(cfg.pattern, caches)
        ))
    return _head(params, cfg, prec, x), _stack_caches(per_group)
