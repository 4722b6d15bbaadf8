"""The LM stack: dense and MoE transformers (``attn+mlp``, ``attn+moe``)."""

from .config import ModelConfig
from .model import decode_step, forward, init_decode_state, model_init, prefill
