"""Batched serving loop: prefill once, then greedy decode, one
``serve_step`` per token. Requests are a static batch; finished sequences
keep decoding into the ``eos_id`` sink.

Deploy serving takes the :class:`repro_torch.profile.PrecisionPolicy`
artifact the PDE steppers profile and validate: ``policy=`` (an object or a
JSON path) re-bases the serving precision on the artifact's ``<EB,MB,FX>``
format, once a validation accepted it. Its per-site hints are keyed by the
producer's site names and are not installed here: serving threads no
tracker."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch._device import resolve_device
from repro_torch.models import prefill
from repro_torch.models.config import ModelConfig
from repro_torch.precision import PrecisionConfig
from repro_torch.train.step import make_serve_step

__all__ = ["generate", "resolve_policy"]


def resolve_policy(prec: PrecisionConfig, policy, require_accepted: bool = True):
    """The serving precision from a PrecisionPolicy artifact: a shim over
    :func:`repro_torch.profile.artifact.resolve_policy`. Returns ``(prec,
    policy)``."""
    from repro_torch.profile.artifact import resolve_policy as _resolve

    return _resolve(prec, policy, require_accepted=require_accepted)


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
    every kernel's plain version); ``params`` must live there. ``policy``
    (a PrecisionPolicy or a path to its JSON) gives the serving format
    (:func:`resolve_policy`)."""
    if policy is not None:
        prec, _ = resolve_policy(prec, policy)
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
