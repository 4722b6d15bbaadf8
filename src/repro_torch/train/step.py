"""Step builders. This slice ports ``make_serve_step``; the train step, its
optimizer and its sharding rules are still to come (ROADMAP.md queue 1,
the LM stack: training)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import decode_step
from repro_torch.models.config import ModelConfig
from repro_torch.precision import PrecisionConfig

__all__ = ["make_serve_step"]

#: names of ``repro.train.step`` still to port -> their ROADMAP.md item
_PENDING = {
    n: "ROADMAP.md queue 1, the LM stack: training"
    for n in ("TrainConfig", "make_train_step", "init_train_state", "param_pspec", "params_pspec_tree",
              "state_pspec_tree", "batch_pspec")
}


def __getattr__(name):
    if name in _PENDING:
        raise AttributeError(f"repro_torch.train.step.{name} is not ported yet ({_PENDING[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def make_serve_step(cfg: ModelConfig, prec: PrecisionConfig, window: Optional[int] = None):
    """Returns serve_step(params, caches, tokens, pos) -> (next_tokens, caches):
    one greedy decode step against a filled KV cache."""

    def serve_step(params, caches, tokens, pos):
        logits, caches = decode_step(params, caches, tokens, pos, cfg, prec, window=window)
        nxt = torch.argmax(logits[:, -1, :], dim=-1).to(torch.int32)[:, None]
        return nxt, caches

    return serve_step
