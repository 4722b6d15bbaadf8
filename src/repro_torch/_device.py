"""Where the port's entry points run: CUDA unless the caller names a device."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "on_card", "f32_scalar", "linspace_from_zero"]


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


def on_card(device) -> bool:
    """Whether ``device`` (a name, a torch.device, or None for none given)
    is a CUDA device."""
    return device is not None and torch.device(device).type == "cuda"


def f32_scalar(v: float, device) -> torch.Tensor:
    """A Python float as a 0-dim f32 tensor on ``device``, rounded once, as
    the reference's weakly typed scalars are before they meet f32 arrays."""
    return torch.full((), v, dtype=torch.float32, device=device)


def linspace_from_zero(stop: float, num: int, *, endpoint: bool = True, device) -> torch.Tensor:
    """``num`` f32 points from 0 to ``stop`` as the compiled reference
    computes them: ``i * ((1 / div) * stop)`` with the constant folded in
    f32 (``div = num - 1`` with the endpoint, which is appended exactly),
    not ``torch.linspace``'s two-sided formula."""
    div = num - 1 if endpoint else num
    step = (f32_scalar(1.0, device) / f32_scalar(div, device)) * f32_scalar(stop, device)
    x = torch.arange(div, dtype=torch.float32, device=device) * step
    if endpoint:
        x = torch.cat([x, f32_scalar(stop, device).reshape(1)])
    return x
