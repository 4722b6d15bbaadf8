"""jamba-v0.1-52b [hybrid] — Mamba:attention 7:1 (attn at layer i%8==4),
MoE 16e top-2 on odd layers. [arXiv:2403.19887]

Hybrid: the single attention layer per period runs with a sliding window in
long-context mode, so the long_500k cell runs (DESIGN.md §5)."""

from repro_torch.models.config import ModelConfig

LONG_WINDOW = 4096  # attention window for the long_500k cell

_pattern = tuple(
    ("attn" if i % 8 == 4 else "mamba") + ("+moe" if i % 2 == 1 else "+mlp")
    for i in range(8)
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=65536,
    pattern=_pattern,
    moe_experts=16,
    moe_top_k=2,
    moe_d_ff=14336,
    ssm_state=16,
    ssm_expand=2,
)
