"""The LM stack: dense, MoE, SSM (mamba), xLSTM and hybrid transformers,
with modality frontends. ``lm_loss`` (training) is not ported yet."""

from . import ssm, xlstm
from .config import ModelConfig
from .model import decode_step, forward, init_decode_state, model_init, prefill

#: names of ``repro.models`` still to port -> their ROADMAP.md item
_PENDING = {"lm_loss": "ROADMAP.md queue 1, the LM stack: model.py::lm_loss"}


def __getattr__(name):
    if name in _PENDING:
        raise AttributeError(f"repro_torch.models.{name} is not ported yet ({_PENDING[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
