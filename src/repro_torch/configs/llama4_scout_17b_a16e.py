"""llama4-scout-17b-a16e [moe]: MoE 16e top-1 with llama4-style shared
expert, early-fusion text backbone. [hf:meta-llama/Llama-4-Scout-17B-16E]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    pattern=("attn+moe",),
    moe_experts=16,
    moe_top_k=1,
    moe_d_ff=8192,
    moe_shared_expert=True,
    rope_theta=500000.0,
)
