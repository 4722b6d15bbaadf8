"""Model configuration: one dataclass describes every architecture of the
pool (dense / MoE / SSM / xLSTM / hybrid / encoder-only / VLM-stub), field
for field as ``repro``'s, so a config converts by its fields.

A model is a cyclic ``pattern`` of block descriptors, repeated
``n_layers / len(pattern)`` times (the "groups"). Pattern entries:

    "attn+mlp"   — GQA attention + dense FFN
    "attn+moe"   — GQA attention + MoE FFN
    "mamba+mlp"  — Mamba (S6) mixer + dense FFN
    "mamba+moe"  — Mamba + MoE FFN
    "mlstm"      — xLSTM mLSTM block (self-contained up/down projection)
    "slstm"      — xLSTM sLSTM block (self-contained)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "MIXERS", "parse_entry"]

MIXERS = ("attn", "mamba", "mlstm", "slstm")


def parse_entry(entry: str) -> Tuple[str, Optional[str]]:
    """'attn+moe' -> ('attn', 'moe'); 'mlstm' -> ('mlstm', None)."""
    parts = entry.split("+")
    mixer = parts[0]
    if mixer not in MIXERS:
        raise ValueError(f"unknown mixer {mixer!r} in pattern entry {entry!r}")
    ffn = parts[1] if len(parts) > 1 else None
    if ffn not in (None, "mlp", "moe"):
        raise ValueError(f"unknown ffn {ffn!r} in pattern entry {entry!r}")
    return mixer, ffn


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    pattern: Tuple[str, ...] = ("attn+mlp",)
    head_dim: Optional[int] = None  # None -> d_model // n_heads

    # --- MoE ---
    moe_experts: int = 0
    moe_top_k: int = 1
    moe_d_ff: Optional[int] = None  # per-expert hidden; None -> d_ff
    moe_shared_expert: bool = False  # llama4-style always-on shared expert
    capacity_factor: float = 1.25

    # --- attention ---
    causal: bool = True
    encoder_only: bool = False
    rope_theta: float = 500000.0
    window: Optional[int] = None  # sliding-window size (long-context mode)

    # --- modality frontend (STUB: input_specs provides embeddings) ---
    frontend: Optional[str] = None  # None | "audio" | "vision"
    frontend_dim: int = 0

    # --- SSM (mamba) ---
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: Optional[int] = None  # None -> ceil(d_model / 16)

    # --- xLSTM ---
    lstm_expand: int = 2

    # --- misc ---
    act: str = "swiglu"  # "swiglu" | "gelu"
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    def __post_init__(self):
        if self.n_layers % len(self.pattern):
            raise ValueError(
                f"{self.name}: n_layers={self.n_layers} not a multiple of "
                f"pattern period {len(self.pattern)}"
            )
        for e in self.pattern:
            parse_entry(e)
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: heads {self.n_heads} % kv {self.n_kv_heads}")

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def groups(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def d_inner(self) -> int:  # mamba inner width
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank if self.dt_rank is not None else -(-self.d_model // 16)

    @property
    def lstm_inner(self) -> int:
        return self.lstm_expand * self.d_model

    @property
    def moe_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    @property
    def has_attn(self) -> bool:
        return any(parse_entry(e)[0] == "attn" for e in self.pattern)

    @property
    def is_recurrent_only(self) -> bool:
        return not self.has_attn

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND roofline math)."""
        d, v = self.d_model, self.vocab
        total = v * d  # embed
        if not self.tie_embeddings:
            total += d * v  # head
        total += d  # final norm
        for e in self.pattern:
            mixer, ffn = parse_entry(e)
            n = 0
            if mixer == "attn":
                n += d * self.n_heads * self.hd + d * self.n_kv_heads * self.hd * 2
                n += self.n_heads * self.hd * d
                n += d  # ln
            elif mixer == "mamba":
                di, r, s = self.d_inner, self.dt_rank_, self.ssm_state
                n += d * 2 * di + di * self.ssm_conv + di * (r + 2 * s) + r * di
                n += di * s + di  # A_log, D
                n += di * d + d  # out proj + ln
            elif mixer == "mlstm":
                li = self.lstm_inner
                n += d * 2 * li  # up (x and gate)
                n += 3 * li * 4 + li * 2 * self.n_heads  # block-diag qkv + gates
                n += li * d + d  # down + ln
            elif mixer == "slstm":
                li = self.lstm_inner
                n += 4 * d * li + 4 * li * (li // self.n_heads)  # in + block-diag rec
                n += li * d + d
            if ffn == "mlp":
                mult = 3 if self.act == "swiglu" else 2
                n += mult * d * self.d_ff + d
            elif ffn == "moe":
                mult = 3 if self.act == "swiglu" else 2
                n += self.moe_experts * mult * d * self.moe_ff + d * self.moe_experts + d
                if self.moe_shared_expert:
                    n += mult * d * self.moe_ff
            total += n * self.groups
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts) for 6*N_active*D."""
        if self.moe_experts == 0:
            return self.param_count()
        d = self.d_model
        mult = 3 if self.act == "swiglu" else 2
        per_expert = mult * d * self.moe_ff
        n_moe_layers = sum(
            1 for e in self.pattern if parse_entry(e)[1] == "moe"
        ) * self.groups
        inactive = per_expert * (self.moe_experts - self.moe_top_k) * n_moe_layers
        if self.moe_shared_expert:
            pass  # shared expert always active
        return self.param_count() - inactive
