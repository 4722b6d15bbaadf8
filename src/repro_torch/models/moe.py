"""Mixture-of-Experts FFN: top-k routing with capacity-based dispatch
(GShard/Switch), in ``repro``'s two forms: index scatter (the default) or
one-hot einsum (``REPRO_MOE_DISPATCH=einsum``).

Each token picks its top-k experts (ties to the lower index, as
``jax.lax.top_k``); tokens beyond an expert's capacity
``C = max(1, int((n // E) * capacity_factor * k))`` are dropped. Expert
compute is a ``(E, C, d) x (E, d, f)`` batched contraction; the optional
always-on shared expert is a plain 2-D FFN over all tokens. Under
``rr_tile`` with ``use_kernels`` the router and the shared expert's three
2-D contractions run on kernel K7.
"""

from __future__ import annotations

import os

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, normal, silu
from repro_torch.precision import PrecisionConfig, contract, operand_dtype

__all__ = ["moe_init", "moe_apply", "top_k", "DISPATCH_MODE"]

#: "scatter" (index dispatch) | "einsum" (one-hot dispatch and combine
#: tensors), chosen by REPRO_MOE_DISPATCH as in ``repro``
DISPATCH_MODE = os.environ.get("REPRO_MOE_DISPATCH", "scatter")


def moe_init(generator, cfg: ModelConfig, *, lead=(), device):
    d, f, e = cfg.d_model, cfg.moe_ff, cfg.moe_experts
    p = {
        "router": dense_init(generator, d, e, lead=lead, device=device),
        "gate": normal(generator, (*lead, e, d, f), d ** -0.5, device=device),
        "up": normal(generator, (*lead, e, d, f), d ** -0.5, device=device),
        "down": normal(generator, (*lead, e, f, d), f ** -0.5, device=device),
    }
    if cfg.moe_shared_expert:
        p["shared"] = {
            "gate": dense_init(generator, d, f, lead=lead, device=device),
            "up": dense_init(generator, d, f, lead=lead, device=device),
            "down": dense_init(generator, f, d, lead=lead, device=device),
        }
    return p


def top_k(x, k: int):
    """The ``k`` largest entries of the last dim, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p, x, cfg: ModelConfig, prec: PrecisionConfig):
    """x: (B, S, d) -> (out, aux_loss)."""
    B, S, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    n = B * S
    xt = x.reshape(n, d)

    logits = contract("nd,de->ne", xt, p["router"], prec, site="moe.router")
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    gate_vals, expert_idx = top_k(probs, k)  # (n, k)
    gate_vals = gate_vals / torch.clamp_min(gate_vals.sum(-1, keepdim=True), 1e-9)

    capacity = max(1, int((n // e) * cfg.capacity_factor * k))
    # position of each token within its chosen expert's queue (per k-slot)
    onehot = torch.nn.functional.one_hot(expert_idx, e).to(torch.int32)  # (n, k, e)
    flat = onehot.reshape(n * k, e)
    pos = (torch.cumsum(flat, dim=0) * flat - 1).amax(dim=-1).reshape(n, k)
    keep = (pos < capacity) & (pos >= 0)

    if DISPATCH_MODE == "einsum":
        # one-hot einsum dispatch (GShard form): (n, e, c) dispatch and
        # combine tensors, every move a contraction under the policy
        dt = xt.dtype
        pos_oh = torch.nn.functional.one_hot(torch.where(keep, pos, capacity).long(), capacity + 1)[..., :capacity].to(dt)
        disp = torch.einsum("nke,nkc->nec", onehot.to(dt), pos_oh)
        comb = torch.einsum("nk,nke,nkc->nec", gate_vals.to(dt), onehot.to(dt), pos_oh)
        xe = contract("nec,nd->ecd", disp, xt, prec, site="moe.dispatch")
        h = silu(contract("ecd,edf->ecf", xe, p["gate"], prec, site="moe.gate")) * contract(
            "ecd,edf->ecf", xe, p["up"], prec, site="moe.up"
        )
        ye = contract("ecf,efd->ecd", h, p["down"], prec, site="moe.down")
        out = contract("nec,ecd->nd", comb, ye, prec, site="moe.combine").reshape(B, S, d)
    else:
        # scatter dispatch; payloads move in the policy's operand dtype. Kept
        # tokens have distinct (expert, slot) pairs: only the drop slot
        # `capacity` collides, and it is cut off.
        payload = operand_dtype(prec)
        flat_e = expert_idx.reshape(-1)
        flat_pos = torch.where(keep, pos, capacity).reshape(-1)
        x_rep = xt.to(payload)[:, None, :].expand(n, k, d).reshape(n * k, d)
        xe = torch.zeros((e, capacity + 1, d), dtype=payload, device=x.device)
        xe = xe.index_put_((flat_e, flat_pos), x_rep, accumulate=True)[:, :capacity].to(torch.float32)
        h = silu(contract("ecd,edf->ecf", xe, p["gate"], prec, site="moe.gate")) * contract(
            "ecd,edf->ecf", xe, p["up"], prec, site="moe.up"
        )
        ye = contract("ecf,efd->ecd", h, p["down"], prec, site="moe.down")
        yk = ye.to(payload)[flat_e, torch.clamp_max(flat_pos, capacity - 1)]  # (n*k, d)
        yk = torch.where(keep.reshape(-1, 1), yk, torch.zeros((), dtype=payload, device=x.device)).reshape(n, k, d)
        out = torch.sum(yk.to(torch.float32) * gate_vals[..., None], dim=1).reshape(B, S, d)

    if cfg.moe_shared_expert:
        sp = p["shared"]
        hs = silu(contract("nd,df->nf", xt, sp["gate"], prec, site="moe.shared.gate")) * contract(
            "nd,df->nf", xt, sp["up"], prec, site="moe.shared.up"
        )
        out = out + contract("nf,fd->nd", hs, sp["down"], prec, site="moe.shared.down").reshape(B, S, d)

    # load-balancing aux loss (Switch): e * sum_e(fraction_tokens * mean_prob)
    frac = torch.mean(onehot[:, 0, :].to(torch.float32), dim=0)
    aux = e * torch.sum(frac * torch.mean(probs, dim=0))
    return out, aux
