"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, per-expert d_ff=1536.
[hf:Qwen/Qwen3-30B-A3B family]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab=151936,
    pattern=("attn+moe",),
    moe_experts=128,
    moe_top_k=8,
    moe_d_ff=1536,
    rope_theta=1000000.0,
)
