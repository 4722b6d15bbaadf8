"""Model assembly: embedding -> block groups -> norm -> head.

The cyclic ``cfg.pattern`` defines one *group*; each block parameter is
stacked over ``cfg.groups`` on a leading dim, and the groups run in a loop
(``repro`` scans them). Decode threads a per-group KV cache through the
same loop. This slice runs the ``attn+mlp`` and ``attn+moe`` entries.

Three entry points:
  forward()     full-sequence
  prefill()     forward + per-layer cache collection
  decode_step() one token with cache (the serve_step body)
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import attention, moe
from repro_torch.models.config import ModelConfig, parse_entry
from repro_torch.models.layers import embed_init, mlp_apply, mlp_init, normal, rmsnorm, rmsnorm_init
from repro_torch.precision import PrecisionConfig, dot

__all__ = ["model_init", "forward", "prefill", "decode_step", "init_decode_state"]


def _check_entry(entry: str):
    mixer, ffn = parse_entry(entry)
    if mixer != "attn":
        raise NotImplementedError(
            f"pattern entry {entry!r}: the {mixer} mixer is not ported to repro_torch yet (ROADMAP.md queue 1, the LM stack: "
            "models/ssm.py and models/xlstm.py)"
        )
    return mixer, ffn


def _check_inputs(cfg: ModelConfig, embeds):
    if embeds is not None or cfg.frontend is not None:
        raise NotImplementedError("modality frontends are not ported to repro_torch yet (ROADMAP.md queue 1, the LM stack: frontends)")


def _block_init(generator, entry: str, cfg: ModelConfig, *, lead, device):
    _, ffn = _check_entry(entry)
    p: dict = {"ln1": rmsnorm_init(cfg.d_model, lead=lead, device=device)}
    p["attn"] = attention.attn_init(generator, cfg, lead=lead, device=device)
    if ffn is not None:
        p["ln2"] = rmsnorm_init(cfg.d_model, lead=lead, device=device)
    if ffn == "mlp":
        p["mlp"] = mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.act, lead=lead, device=device)
    elif ffn == "moe":
        p["moe"] = moe.moe_init(generator, cfg, lead=lead, device=device)
    return p


def model_init(generator, cfg: ModelConfig, device):
    """Random parameters from ``generator`` (a ``torch.Generator`` on
    ``device``), with ``repro``'s distributions and tree layout."""
    _check_inputs(cfg, None)
    blocks = tuple(_block_init(generator, entry, cfg, lead=(cfg.groups,), device=device) for entry in cfg.pattern)
    params = {
        "embed": embed_init(generator, cfg.vocab, cfg.d_model, device=device),
        "blocks": blocks,
        "final_norm": rmsnorm_init(cfg.d_model, device=device),
    }
    if not cfg.tie_embeddings:
        params["head"] = normal(generator, (cfg.d_model, cfg.vocab), cfg.d_model**-0.5, device=device)
    return params


def _index(tree, g: int):
    """One group's slice of a stacked parameter tree."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_index(v, g) for v in tree)
    return tree[g]


def _group_apply(x, group_params, cfg, prec, window, caches=None, pos=None):
    """Apply one pattern period. caches: a tuple per position (or None).
    Returns (x, aux, new caches)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = []
    for i, entry in enumerate(cfg.pattern):
        _, ffn = _check_entry(entry)
        bp = group_params[i]
        h = rmsnorm(x, bp["ln1"], cfg.norm_eps)
        if caches is not None and pos is not None:
            out, new_cache = attention.attn_decode(bp["attn"], h, caches[i], pos, cfg, prec, window=window)
        else:
            out, new_cache = attention.attn_apply(bp["attn"], h, cfg, prec, window=window)
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


def _head(params, cfg, prec, x):
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["head"]
    return dot(x, head, prec, site="lm.head")


def forward(params, cfg: ModelConfig, prec: PrecisionConfig, tokens=None, embeds=None, window: Optional[int] = None):
    """Full-sequence forward. Returns (logits, aux_loss)."""
    _check_inputs(cfg, embeds)
    x = params["embed"][tokens]
    auxs = []
    for g in range(cfg.groups):
        x, aux, _ = _group_apply(x.to(torch.float32), _index(params["blocks"], g), cfg, prec, window)
        auxs.append(aux)
    return _head(params, cfg, prec, x.to(torch.float32)), torch.sum(torch.stack(auxs))


def init_decode_state(cfg: ModelConfig, batch: int, max_len: int, cache_dtype=torch.bfloat16, *, device):
    """Caches: a tuple over pattern positions of KVCaches stacked over groups."""
    caches = []
    for entry in cfg.pattern:
        _check_entry(entry)
        c = attention.init_cache(cfg, batch, max_len, dtype=cache_dtype, device=device)
        caches.append(attention.KVCache(*(t.expand(cfg.groups, *t.shape).clone() for t in c)))
    return tuple(caches)


def _stack_caches(per_group):
    """Per-group tuples of KVCaches -> a tuple of KVCaches stacked over groups."""
    return tuple(
        attention.KVCache(k=torch.stack([g[i].k for g in per_group]), v=torch.stack([g[i].v for g in per_group]))
        for i in range(len(per_group[0]))
    )


def decode_step(params, caches, tokens, pos: int, cfg: ModelConfig, prec: PrecisionConfig, window: Optional[int] = None):
    """One decode step. tokens: (B, 1) ints; pos: the current index.
    Returns (logits (B, 1, vocab), new caches)."""
    x = params["embed"][tokens]
    new = []
    for g in range(cfg.groups):
        cache_g = tuple(attention.KVCache(k=c.k[g], v=c.v[g]) for c in caches)
        x, _, c = _group_apply(x, _index(params["blocks"], g), cfg, prec, window, caches=cache_g, pos=pos)
        new.append(c)
    return _head(params, cfg, prec, x), _stack_caches(new)


def prefill(params, cfg, prec, tokens=None, embeds=None, max_len=None, window=None, cache_dtype=torch.bfloat16):
    """Forward pass that also fills a decode cache, padded to ``max_len``.
    Returns (logits, caches)."""
    _check_inputs(cfg, embeds)
    x = params["embed"][tokens]
    S = x.shape[1]
    max_len = max_len or S
    per_group = []
    for g in range(cfg.groups):
        x, _, caches = _group_apply(x, _index(params["blocks"], g), cfg, prec, window)
        pad = (0, 0, 0, 0, 0, max_len - S)
        per_group.append(tuple(
            attention.KVCache(
                k=torch.nn.functional.pad(c.k, pad).to(cache_dtype), v=torch.nn.functional.pad(c.v, pad).to(cache_dtype)
            )
            for c in caches
        ))
    return _head(params, cfg, prec, x), _stack_caches(per_group)
