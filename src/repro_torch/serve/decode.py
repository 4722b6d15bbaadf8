"""Batched serving loop: prefill once, then greedy decode, one
``serve_step`` per token. Requests are a static batch; finished sequences
keep decoding into the ``eos_id`` sink."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.models import prefill
from repro_torch.models.config import ModelConfig
from repro_torch.precision import PrecisionConfig
from repro_torch.train.step import make_serve_step

__all__ = ["generate"]


@torch.inference_mode()
def generate(
    params,
    cfg: ModelConfig,
    prec: PrecisionConfig,
    prompts,  # (B, S_prompt) ints
    max_new_tokens: int = 32,
    max_len: Optional[int] = None,
    window: Optional[int] = None,
    eos_id: Optional[int] = None,
    policy=None,
    device=None,
):
    """Greedy generation. Returns (B, max_new_tokens) int32 tokens.

    Runs on the CUDA card unless ``device`` names another (``"cpu"`` runs
    every kernel's plain version); ``params`` must live there."""
    if policy is not None:
        raise NotImplementedError(
            "policy= needs repro_torch.profile, which is not ported yet (ROADMAP.md queue 1 item 7)"
        )
    dev = resolve_device(device)
    at = params["embed"].device
    if at.type != dev.type or (dev.index is not None and at.index != dev.index):
        raise ValueError(f"params live on {at}, generate runs on {dev}")
    prompts = torch.as_tensor(prompts, device=dev)
    B, S = prompts.shape
    max_len = max_len or (S + max_new_tokens)

    logits, caches = prefill(params, cfg, prec, tokens=prompts, max_len=max_len, window=window)
    next_tok = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
    step_fn = make_serve_step(cfg, prec, window=window)
    out = [next_tok]
    done = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    for i in range(max_new_tokens - 1):
        tok = out[-1]
        nxt, caches = step_fn(params, caches, tok, S + i)
        if eos_id is not None:
            done = done | (tok == eos_id)
            nxt = torch.where(done, eos_id, nxt)
        out.append(nxt)
    return torch.cat(out, dim=1)
