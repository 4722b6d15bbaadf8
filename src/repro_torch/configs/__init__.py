"""Configurations: the paper's PDE workloads (one module each) and the LM
architecture registry, where ``get_config(<arch id>)`` resolves.

``ARCHS`` lists the ten architectures. ``reduced(cfg)`` shrinks any
architecture to a CPU test size of the same family, as ``repro``'s does;
``shapes`` holds the assigned input shapes and the (arch x shape) matrix.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

from .shapes import SHAPES, ShapeConfig, applicability, cell_window

__all__ = ["ARCHS", "get_config", "reduced", "SHAPES", "ShapeConfig", "applicability", "cell_window"]

_MODULES = {
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "hubert-xlarge": "hubert_xlarge",
    "stablelm-12b": "stablelm_12b",
    "llama3-405b": "llama3_405b",
    "yi-34b": "yi_34b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "pixtral-12b": "pixtral_12b",
    "xlstm-1.3b": "xlstm_1_3b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
}

ARCHS = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG


def reduced(cfg: ModelConfig, layers_mult: int = 1) -> ModelConfig:
    """Test-size config of the same family (pattern preserved)."""
    period = len(cfg.pattern)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=period * layers_mult,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=16,
        d_ff=96 if cfg.d_ff else 0,
        vocab=512,
        moe_experts=min(cfg.moe_experts, 4),
        moe_top_k=min(cfg.moe_top_k, 2),
        moe_d_ff=64 if cfg.moe_experts else None,
        frontend_dim=32 if cfg.frontend else 0,
        ssm_state=8,
        dt_rank=8,
    )
