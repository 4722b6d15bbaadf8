"""repro_torch.ckpt: fault-tolerant checkpointing in repro's layout."""

from .checkpoint import available_steps, latest_step, restore, save
