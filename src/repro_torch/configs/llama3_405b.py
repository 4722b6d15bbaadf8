"""llama3-405b [dense] — GQA, 128k vocab. [arXiv:2407.21783]

Full quadratic attention: long_500k cell skipped (DESIGN.md §5)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    pattern=("attn+mlp",),
    rope_theta=500000.0,
)
