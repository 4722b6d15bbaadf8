"""pixtral-12b [vlm] — mistral-nemo backbone + pixtral-ViT frontend STUB
(input_specs provides patch embeddings, 1024-dim). [hf:mistralai/Pixtral-12B]"""

from repro_torch.models.config import ModelConfig

IMG_SEQ = 1024  # patch tokens prepended to the text sequence

CONFIG = ModelConfig(
    name="pixtral-12b",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    pattern=("attn+mlp",),
    head_dim=128,
    rope_theta=1000000.0,
    frontend="vision",
    frontend_dim=1024,
)
