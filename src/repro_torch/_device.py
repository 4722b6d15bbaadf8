"""Where the port's entry points run: CUDA unless the caller names a device."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "f32_scalar"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; a machine without one raises rather
    than running on the CPU unasked. Pass ``device="cpu"`` for the plain
    PyTorch versions."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is available; "
                "pass device='cpu' to run the plain PyTorch versions"
            )
        return torch.device("cuda")
    return torch.device(device)


def f32_scalar(v: float, device) -> torch.Tensor:
    """A Python float as a 0-dim f32 tensor on ``device``, rounded once, as
    the reference's weakly typed scalars are before they meet f32 arrays."""
    return torch.full((), v, dtype=torch.float32, device=device)
