"""xlstm-1.3b [ssm] — xLSTM[7:1]: 7 mLSTM : 1 sLSTM blocks, 4 heads.
O(1) recurrent state -> runs the long_500k cell. [arXiv:2405.04517]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    n_layers=48,
    d_model=2048,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    pattern=("mlstm",) * 7 + ("slstm",),
    lstm_expand=2,
)
