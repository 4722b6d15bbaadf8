"""Mamba (S6 selective SSM) mixer, used by jamba-v0.1 (1 attn : 7 mamba).

Chunked selective scan: the sequence is split into chunks of
``SSM_CHUNK``; within a chunk the linear recurrence runs as a log-depth
scan (the odd/even recursion of ``jax.lax.associative_scan``, so its
rounding tree is ``repro``'s), and chunks are stitched by a loop carrying
the (B, d_inner, state) boundary state. Peak intermediate memory is
(B, chunk, d_inner, state) instead of (B, S, d_inner, state).

Decode is the O(1)-state recurrent step (this is why jamba runs the
long_500k cell while pure-attention models cannot).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, normal, silu
from repro_torch.precision import PrecisionConfig, dot

__all__ = ["mamba_init", "mamba_apply", "mamba_decode", "MambaState", "init_mamba_state", "SSM_CHUNK"]

SSM_CHUNK = 256


class MambaState(NamedTuple):
    h: torch.Tensor  # (B, d_inner, state)
    conv: torch.Tensor  # (B, conv_k - 1, d_inner) rolling conv window


def mamba_init(generator, cfg: ModelConfig, *, lead=(), device):
    d, di, r, s = cfg.d_model, cfg.d_inner, cfg.dt_rank_, cfg.ssm_state
    dt_bias = torch.log(torch.expm1(torch.full((di,), 0.01, dtype=torch.float32, device=device)))
    a_log = torch.log(torch.arange(1, s + 1, dtype=torch.float32, device=device)).expand(di, s)
    return {
        "in_proj": dense_init(generator, d, 2 * di, lead=lead, device=device),
        "conv_w": normal(generator, (*lead, cfg.ssm_conv, di), 0.2, device=device),
        "x_proj": dense_init(generator, di, r + 2 * s, lead=lead, device=device),
        "dt_proj": dense_init(generator, r, di, scale=r**-0.5, lead=lead, device=device),
        "dt_bias": dt_bias.expand(*lead, di).clone(),
        "A_log": a_log.expand(*lead, di, s).clone(),
        "D": torch.ones((*lead, di), dtype=torch.float32, device=device),
        "out_proj": dense_init(generator, di, d, lead=lead, device=device),
    }


def _ssm_inputs(p, x, cfg: ModelConfig, prec):
    """Projections shared by prefill and decode: returns (dt, Bc, Cc)."""
    r, s = cfg.dt_rank_, cfg.ssm_state
    xbc = dot(x, p["x_proj"], prec, site="ssm.x_proj")  # (..., r + 2s)
    dt = torch.nn.functional.softplus(dot(xbc[..., :r], p["dt_proj"], prec, site="ssm.dt_proj") + p["dt_bias"])
    return dt, xbc[..., r : r + s], xbc[..., r + s :]


def _causal_conv(x, w, state=None):
    """Depthwise causal conv. x: (B, S, di), w: (K, di). If ``state``
    ((B, K-1, di)) is given, it prefixes x (decode/streaming)."""
    K = w.shape[0]
    pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device) if state is None else state
    xp = torch.cat([pad, x], dim=1)
    out = xp[:, 0 : x.shape[1]] * w[0]
    for i in range(1, K):
        out = out + xp[:, i : i + x.shape[1]] * w[i]
    return out, xp[:, -(K - 1) :]


def _combine(a, b):
    (da, xa), (db, xb) = a, b
    return da * db, xa * db + xb


def _interleave(even, odd):
    out = torch.empty((even.shape[0], even.shape[1] + odd.shape[1], *even.shape[2:]), dtype=even.dtype, device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _scan(dec, drv):
    """Inclusive scan of (decay, drive) pairs along dim 1 under
    ``(da, xa) . (db, xb) = (da db, xa db + xb)``, in the odd/even recursion
    of ``jax.lax.associative_scan``."""
    n = dec.shape[1]
    if n < 2:
        return dec, drv
    od, ox = _scan(*_combine((dec[:, 0:-1:2], drv[:, 0:-1:2]), (dec[:, 1::2], drv[:, 1::2])))
    head = (od, ox) if n % 2 else (od[:, :-1], ox[:, :-1])
    ed, ex = _combine(head, (dec[:, 2::2], drv[:, 2::2]))
    ed, ex = torch.cat([dec[:, :1], ed], dim=1), torch.cat([drv[:, :1], ex], dim=1)
    return _interleave(ed, od), _interleave(ex, ox)


def _selective_scan_chunked(u, dt, Bc, Cc, A, h0, chunk=None):
    """u, dt: (B, S, di); Bc, Cc: (B, S, s); A: (di, s); h0: (B, di, s).
    Returns (y (B, S, di), h_final).

    The (di x s) state expansion (decay/drive outer products) happens inside
    the chunk loop, so the peak intermediate is (B, chunk, di, s) rather than
    (B, S, di, s): at jamba's widths the full-S expansion would not fit."""
    S = u.shape[1]
    chunk = min(chunk or SSM_CHUNK, S)
    if S % chunk:
        raise ValueError(f"the selective scan needs S % chunk == 0, got S={S}, chunk={chunk}")
    h, ys = h0, []
    for c0 in range(0, S, chunk):
        u_b, dt_b = u[:, c0 : c0 + chunk], dt[:, c0 : c0 + chunk]
        B_b, C_b = Bc[:, c0 : c0 + chunk], Cc[:, c0 : c0 + chunk]
        dec = torch.exp(dt_b[..., None] * A)  # (B, c, di, s)
        drv = (dt_b * u_b)[..., None] * B_b[:, :, None, :]
        dec_c, drv_c = _scan(dec, drv)
        h_all = dec_c * h[:, None] + drv_c  # (B, c, di, s)
        ys.append(torch.einsum("bcds,bcs->bcd", h_all, C_b))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1), h


def mamba_apply(p, x, cfg: ModelConfig, prec: PrecisionConfig, state=None):
    """Full-sequence mixer. x: (B, S, d). Returns (out, MambaState)."""
    B = x.shape[0]
    di = cfg.d_inner
    xz = dot(x, p["in_proj"], prec, site="ssm.in_proj")
    xi, z = xz[..., :di], xz[..., di:]
    xi, new_conv = _causal_conv(xi, p["conv_w"], None if state is None else state.conv)
    xi = silu(xi)
    dt, Bc, Cc = _ssm_inputs(p, xi, cfg, prec)
    A = -torch.exp(p["A_log"])
    h0 = torch.zeros((B, di, cfg.ssm_state), dtype=torch.float32, device=x.device) if state is None else state.h
    y, h_fin = _selective_scan_chunked(xi, dt, Bc, Cc, A, h0)
    y = (y + xi * p["D"]) * silu(z)
    return dot(y, p["out_proj"], prec, site="ssm.out_proj"), MambaState(h=h_fin, conv=new_conv)


def init_mamba_state(cfg: ModelConfig, batch: int, *, device) -> MambaState:
    return MambaState(
        h=torch.zeros((batch, cfg.d_inner, cfg.ssm_state), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner), dtype=torch.float32, device=device),
    )


def mamba_decode(p, x, state: MambaState, cfg: ModelConfig, prec: PrecisionConfig):
    """One-token step. x: (B, 1, d). O(1) in context length."""
    return mamba_apply(p, x, cfg, prec, state=state)
