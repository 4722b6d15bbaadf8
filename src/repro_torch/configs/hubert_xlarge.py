"""hubert-xlarge [audio] — encoder-only; conv frame frontend is a STUB
(input_specs provides precomputed frame embeddings). [arXiv:2106.07447]

No autoregressive step exists: decode_32k / long_500k cells are skipped
(DESIGN.md §5)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    pattern=("attn+mlp",),
    causal=False,
    encoder_only=True,
    act="gelu",
    frontend="audio",
    frontend_dim=512,
)
