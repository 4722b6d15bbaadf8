"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, sequential); the xlstm-1.3b architecture is a
7:1 interleave of the two.

mLSTM is its chunkwise linear-attention form: per head, state
C in R^{dk x dv} evolves as  C_t = f_t C_{t-1} + i_t k_t v_t^T,
y_t = C_t^T q_t / max(|n_t^T q_t|, 1), with sigmoid input/forget gates in
log space (always stable), as ``repro`` writes it. Chunked: intra-chunk
attention-like compute plus a boundary state carried from chunk to chunk.
The chunk bodies' einsums are plain f32 einsums, as in ``repro``; the
projections go through the precision API.

Both cells decode with O(1) state: xlstm-1.3b runs the long_500k cell.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, normal, rmsnorm, rmsnorm_init, silu
from repro_torch.precision import PrecisionConfig, contract, dot

__all__ = [
    "mlstm_init",
    "mlstm_apply",
    "mlstm_decode",
    "MLSTMState",
    "init_mlstm_state",
    "slstm_init",
    "slstm_apply",
    "slstm_decode",
    "SLSTMState",
    "init_slstm_state",
    "QKV_BLOCK",
    "LSTM_CHUNK",
]

LSTM_CHUNK = 256
QKV_BLOCK = 4  # xLSTM qkv_proj_blocksize: block-diagonal q/k/v projections


class MLSTMState(NamedTuple):
    C: torch.Tensor  # (B, H, dk, dv)
    n: torch.Tensor  # (B, H, dk)


class SLSTMState(NamedTuple):
    c: torch.Tensor  # (B, li)
    h: torch.Tensor  # (B, li)


# --------------------------------------------------------------------------
# mLSTM
# --------------------------------------------------------------------------


def mlstm_init(generator, cfg: ModelConfig, *, lead=(), device):
    d, li = cfg.d_model, cfg.lstm_inner
    nb = li // QKV_BLOCK

    def blk():
        return normal(generator, (*lead, nb, QKV_BLOCK, QKV_BLOCK), QKV_BLOCK**-0.5, device=device)

    return {
        "up_x": dense_init(generator, d, li, lead=lead, device=device),
        "up_z": dense_init(generator, d, li, lead=lead, device=device),
        "wq": blk(),
        "wk": blk(),
        "wv": blk(),
        "w_if": dense_init(generator, li, 2 * cfg.n_heads, lead=lead, device=device),  # input & forget gates/head
        "norm": rmsnorm_init(li, lead=lead, device=device),
        "down": dense_init(generator, li, d, lead=lead, device=device),
    }


def _blockdiag_proj(x, w, prec):
    """x: (B, S, li) -> (B, S, li) through block-diagonal (nb, bs, bs) w."""
    B, S, li = x.shape
    nb, bs, _ = w.shape
    out = contract("bsng,ngh->bsnh", x.reshape(B, S, nb, bs), w, prec, site="xlstm.qkv")
    return out.reshape(B, S, li)


def _mlstm_chunked(q, k, v, log_i, log_f, state: MLSTMState, chunk=None):
    """q,k,v: (B, S, H, dh); log_i/log_f: (B, S, H) (log-sigmoid gates).
    Chunkwise gated linear attention. Returns (y, new_state)."""
    B, S, H, dh = q.shape
    chunk = min(chunk or LSTM_CHUNK, S)
    if S % chunk:
        raise ValueError(f"the mLSTM needs S % chunk == 0, got S={S}, chunk={chunk}")
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))
    C, n, ys = state.C, state.n, []
    for c0 in range(0, S, chunk):
        qb, kb, vb = q[:, c0 : c0 + chunk], k[:, c0 : c0 + chunk], v[:, c0 : c0 + chunk]
        li_b, lf_b = log_i[:, c0 : c0 + chunk], log_f[:, c0 : c0 + chunk]

        F = torch.cumsum(lf_b, dim=1)  # (B,c,H) log decay from chunk start (<=0)
        Ftot = F[:, -1]  # (B,H)

        # inter-chunk: contribution of the carried state, decayed (exp(F)<=1)
        q_dec = qb * torch.exp(F)[..., None]  # (B,c,H,dk)
        y_inter = torch.einsum("bchk,bhkv->bchv", q_dec, C)
        n_inter = torch.einsum("bchk,bhk->bch", q_dec, n)

        # intra-chunk: pairwise-stable decay D[t,s] = exp(F_t - F_s + li_s),
        # masked to s<=t so every exponent is <= 0 (never overflows)
        Ft = F.transpose(1, 2)  # (B,H,c)
        lit = li_b.transpose(1, 2)  # (B,H,c)
        rel = Ft[..., :, None] - Ft[..., None, :] + lit[..., None, :]
        D = torch.where(mask[None, None], torch.exp(torch.clamp_max(rel, 0.0)), 0.0)
        logits = torch.einsum("bchk,bshk->bhcs", qb, kb) * D
        y_intra = torch.einsum("bhcs,bshv->bchv", logits, vb)
        n_intra = torch.sum(logits, dim=-1).transpose(1, 2)  # (B,c,H)

        denom = torch.clamp_min(torch.abs(n_inter + n_intra), 1.0)[..., None]
        ys.append((y_inter + y_intra) / denom)

        # state update to chunk end: weights exp(Ftot - F_s + li_s) <= 1
        w_end = torch.exp(torch.clamp_max(Ftot[:, None] - F + li_b, 0.0))[..., None]
        kv = torch.einsum("bshk,bshv->bhkv", kb * w_end, vb)
        C = C * torch.exp(Ftot)[..., None, None] + kv
        n = n * torch.exp(Ftot)[..., None] + torch.sum(kb * w_end, dim=1)
    return torch.cat(ys, dim=1), MLSTMState(C=C, n=n)


def mlstm_apply(p, x, cfg: ModelConfig, prec: PrecisionConfig, state=None):
    B, S, _ = x.shape
    H, li = cfg.n_heads, cfg.lstm_inner
    dh = li // H
    xi = silu(dot(x, p["up_x"], prec, site="xlstm.up_x"))
    z = dot(x, p["up_z"], prec, site="xlstm.up_z")

    q = _blockdiag_proj(xi, p["wq"], prec).reshape(B, S, H, dh)
    k = _blockdiag_proj(xi, p["wk"], prec).reshape(B, S, H, dh) * (dh**-0.5)
    v = _blockdiag_proj(xi, p["wv"], prec).reshape(B, S, H, dh)
    gates = dot(xi, p["w_if"], prec, site="xlstm.gates").reshape(B, S, H, 2)
    log_i = torch.nn.functional.logsigmoid(gates[..., 0])
    log_f = torch.nn.functional.logsigmoid(gates[..., 1])

    if state is None:
        state = init_mlstm_state(cfg, B, device=x.device)
    y, new_state = _mlstm_chunked(q, k, v, log_i, log_f, state)
    y = rmsnorm(y.reshape(B, S, li), p["norm"], cfg.norm_eps) * silu(z)
    return dot(y, p["down"], prec, site="xlstm.down"), new_state


def init_mlstm_state(cfg: ModelConfig, batch: int, *, device) -> MLSTMState:
    H = cfg.n_heads
    dh = cfg.lstm_inner // H
    return MLSTMState(
        C=torch.zeros((batch, H, dh, dh), dtype=torch.float32, device=device),
        n=torch.zeros((batch, H, dh), dtype=torch.float32, device=device),
    )


def mlstm_decode(p, x, state: MLSTMState, cfg: ModelConfig, prec: PrecisionConfig):
    return mlstm_apply(p, x, cfg, prec, state=state)


# --------------------------------------------------------------------------
# sLSTM
# --------------------------------------------------------------------------


def slstm_init(generator, cfg: ModelConfig, *, lead=(), device):
    d, li, H = cfg.d_model, cfg.lstm_inner, cfg.n_heads
    dh = li // H
    return {
        "w_in": dense_init(generator, d, 4 * li, lead=lead, device=device),  # i, f, z, o pre-activations
        "r_blk": normal(generator, (*lead, 4, H, dh, dh), dh**-0.5, device=device),
        "norm": rmsnorm_init(li, lead=lead, device=device),
        "down": dense_init(generator, li, d, lead=lead, device=device),
    }


def _slstm_step(p, carry, wx, cfg: ModelConfig):
    c, h = carry  # (B, li) each
    B = c.shape[0]
    H = cfg.n_heads
    dh = cfg.lstm_inner // H
    rec = torch.einsum("ghkv,bhk->gbhv", p["r_blk"], h.reshape(B, H, dh)).reshape(4, B, H * dh)
    pre = wx.reshape(B, 4, -1).transpose(0, 1) + rec  # (4, B, li)
    i, f = torch.sigmoid(pre[0]), torch.sigmoid(pre[1])
    z, o = torch.tanh(pre[2]), torch.sigmoid(pre[3])
    c_new = f * c + i * z
    h_new = o * torch.tanh(c_new)
    return (c_new, h_new), h_new


def slstm_apply(p, x, cfg: ModelConfig, prec: PrecisionConfig, state=None):
    B = x.shape[0]
    wx = dot(x, p["w_in"], prec, site="slstm.w_in")  # (B, S, 4*li) gate pre-activations
    if state is None:
        state = init_slstm_state(cfg, B, device=x.device)
    carry, hs = (state.c, state.h), []
    for t in range(x.shape[1]):
        carry, h_t = _slstm_step(p, carry, wx[:, t], cfg)
        hs.append(h_t)
    y = rmsnorm(torch.stack(hs, dim=1), p["norm"], cfg.norm_eps)  # (B, S, li)
    return dot(y, p["down"], prec, site="slstm.down"), SLSTMState(c=carry[0], h=carry[1])


def init_slstm_state(cfg: ModelConfig, batch: int, *, device) -> SLSTMState:
    li = cfg.lstm_inner
    return SLSTMState(
        c=torch.zeros((batch, li), dtype=torch.float32, device=device),
        h=torch.zeros((batch, li), dtype=torch.float32, device=device),
    )


def slstm_decode(p, x, state: SLSTMState, cfg: ModelConfig, prec: PrecisionConfig):
    return slstm_apply(p, x, cfg, prec, state=state)
