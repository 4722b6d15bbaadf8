"""stablelm-12b [dense] — llama-style GQA decoder. [hf:stabilityai]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=13824,
    vocab=100352,
    pattern=("attn+mlp",),
    rope_theta=10000.0,
)
