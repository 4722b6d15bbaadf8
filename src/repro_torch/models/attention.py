"""GQA attention: full-sequence (prefill) and decode against a KV cache.

KV heads are repeated to the full head count (``_expand_kv``, the flat-head
form). Sequences longer than ``FLASH_THRESHOLD`` take the chunked
(flash-style, online-softmax) path, whose live logits are one
``(B, H, FLASH_CHUNK, FLASH_CHUNK)`` block. Decode caches are bf16 at rest,
``(B, S_max, KV, hd)``; a decode step returns a new cache and leaves its
input as it was.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, rope
from repro_torch.precision import PrecisionConfig, contract, dot

__all__ = ["attn_init", "attn_apply", "attn_decode", "KVCache", "init_cache", "FLASH_THRESHOLD", "FLASH_CHUNK"]

_NEG = -1e30
#: sequences longer than this (S, not S*T) take the chunked (flash-style) path
FLASH_THRESHOLD = 4096
#: query and KV chunk length of the chunked path
FLASH_CHUNK = 1024


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, S_max, KV, hd)
    v: torch.Tensor  # (B, S_max, KV, hd)


def attn_init(generator, cfg: ModelConfig, *, lead=(), device):
    d, hd = cfg.d_model, cfg.hd
    return {
        "wq": dense_init(generator, d, cfg.n_heads * hd, lead=lead, device=device),
        "wk": dense_init(generator, d, cfg.n_kv_heads * hd, lead=lead, device=device),
        "wv": dense_init(generator, d, cfg.n_kv_heads * hd, lead=lead, device=device),
        "wo": dense_init(generator, cfg.n_heads * hd, d, lead=lead, device=device),
    }


def _qkv(p, x, cfg: ModelConfig, positions, prec: PrecisionConfig):
    """Returns q: (B,S,H,hd) flat heads; k, v: (B,S,KV,hd)."""
    B, S, _ = x.shape
    kv, hd = cfg.n_kv_heads, cfg.hd
    q = dot(x, p["wq"], prec, site="attn.q").reshape(B, S, cfg.n_heads, hd)
    k = dot(x, p["wk"], prec, site="attn.k").reshape(B, S, kv, hd)
    v = dot(x, p["wv"], prec, site="attn.v").reshape(B, S, kv, hd)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def _expand_kv(k, G):
    """Repeat each KV head ``G`` times in place order (``jnp.repeat``)."""
    return torch.repeat_interleave(k, G, dim=2)


def _dense_attention(q, k, v, causal, window, prec):
    """q: (B,S,H,hd); k,v: (B,T,H,hd) (already expanded). -> (B,S,H,hd)"""
    S = q.shape[1]
    logits = contract("bshd,bthd->bhst", q, k, prec, site="attn.qk")  # (B,H,S,T)
    ti = torch.arange(S, device=q.device)[None, :]
    si = torch.arange(S, device=q.device)[:, None]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device) if not causal else (ti <= si)
    if window is not None:
        mask = mask & (ti > si - window)
    logits = torch.where(mask[None, None], logits, _NEG)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    return contract("bhst,bthd->bshd", probs, v, prec, site="attn.pv")


def _chunked_attention(q, k, v, causal, window, prec, cq=None, ck=None):
    """Flash-style online-softmax attention: an outer loop over query
    chunks, an inner loop over KV chunks carrying the running max, sum and
    accumulator in f32; each chunk pair contracts at ``attn.qk`` and
    ``attn.pv``, so a policy quantizes per chunk. q: (B,S,H,hd); k,v:
    (B,T,H,hd) (already expanded). -> (B,S,H,hd)"""
    B, S, H, hd = q.shape
    T = k.shape[1]
    cq = min(FLASH_CHUNK if cq is None else cq, S)
    ck = min(FLASH_CHUNK if ck is None else ck, T)
    if S % cq or T % ck:
        raise ValueError(f"chunked attention needs S % cq == 0 and T % ck == 0, got {(S, T, cq, ck)}")
    qpos_base = torch.arange(cq, device=q.device)[:, None]
    kpos_base = torch.arange(ck, device=q.device)[None, :]
    outs = []
    for qi in range(S // cq):
        qblk = q[:, qi * cq : (qi + 1) * cq]
        m = torch.full((B, H, cq), _NEG, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, H, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, cq, H, hd), dtype=torch.float32, device=q.device)
        for kj in range(T // ck):
            kblk, vblk = k[:, kj * ck : (kj + 1) * ck], v[:, kj * ck : (kj + 1) * ck]
            logit = contract("bshd,bthd->bhst", qblk, kblk, prec, site="attn.qk")  # (B,H,cq,ck)
            qp, kp = qi * cq + qpos_base, kj * ck + kpos_base
            msk = torch.ones((cq, ck), dtype=torch.bool, device=q.device) if not causal else (kp <= qp)
            if window is not None:
                msk = msk & (kp > qp - window)
            logit = torch.where(msk[None, None], logit, _NEG)
            m_new = torch.maximum(m, torch.amax(logit, dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(logit - m_new[..., None])
            l = l * corr + torch.sum(p, dim=-1)
            pv = contract("bhst,bthd->bshd", p, vblk, prec, site="attn.pv")  # (B,cq,H,hd)
            acc = acc * corr.transpose(1, 2)[..., None] + pv
            m = m_new
        outs.append(acc / torch.clamp_min(l.transpose(1, 2), 1e-30)[..., None])
    return torch.cat(outs, dim=1)


def attn_apply(p, x, cfg: ModelConfig, prec: PrecisionConfig, positions=None, window: Optional[int] = None):
    """Full-sequence attention (prefill). Returns (out, KVCache)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device).expand(B, S)
    q, k, v = _qkv(p, x, cfg, positions, prec)
    G = cfg.n_heads // cfg.n_kv_heads
    qf = q * (cfg.hd ** -0.5)
    kf, vf = _expand_kv(k, G), _expand_kv(v, G)
    if S <= FLASH_THRESHOLD:
        out = _dense_attention(qf, kf, vf, cfg.causal, window, prec)
    else:
        out = _chunked_attention(qf, kf, vf, cfg.causal, window, prec)
    out = out.reshape(B, S, cfg.n_heads * cfg.hd)
    return dot(out, p["wo"], prec, site="attn.o"), KVCache(k=k, v=v)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16, *, device) -> KVCache:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device), v=torch.zeros(shape, dtype=dtype, device=device))


def attn_decode(p, x, cache: KVCache, pos: int, cfg: ModelConfig, prec: PrecisionConfig, window: Optional[int] = None):
    """One decode step. x: (B, 1, D); pos: the current index.
    Returns (out, updated cache)."""
    B = x.shape[0]
    g, hd = cfg.n_heads // cfg.n_kv_heads, cfg.hd
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _qkv(p, x, cfg, positions, prec)
    k_cache, v_cache = cache.k.clone(), cache.v.clone()
    k_cache[:, pos : pos + 1] = k_new.to(k_cache.dtype)
    v_cache[:, pos : pos + 1] = v_new.to(v_cache.dtype)
    kf = _expand_kv(k_cache.to(torch.float32), g)
    vf = _expand_kv(v_cache.to(torch.float32), g)
    logits = contract("bshd,bthd->bhst", q * (hd ** -0.5), kf, prec, site="attn.qk")  # (B,H,1,T)
    t = torch.arange(cache.k.shape[1], device=x.device)
    valid = t <= pos
    if window is not None:
        valid = valid & (t > pos - window)
    logits = torch.where(valid[None, None, None, :], logits, _NEG)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    out = contract("bhst,bthd->bshd", probs, vf, prec, site="attn.pv").reshape(B, 1, cfg.n_heads * hd)
    return dot(out, p["wo"], prec, site="attn.o"), KVCache(k=k_cache, v=v_cache)
