"""Subnormal flushing for the port's PyTorch ops on a CUDA device.

XLA runs f32 arithmetic with subnormals flushed to zero, inputs and results,
on the CPU and on the TPU, so ``repro`` never carries an f32 subnormal (its
``quantize_em_with_flags`` zeroes subnormal inputs for that reason). The
port's CUDA kernels build with ``-ftz=true``
(``kernels/_cuda.py::NVCC_FLAGS``); PyTorch's own CUDA ops keep subnormals
and have no such switch. Under :func:`flush_subnormals` every subnormal f32
result of a PyTorch op on a CUDA tensor becomes a zero of its sign, as an
FTZ result does, ``out=`` targets and in-place results included.
``Simulation.run`` enters it through :func:`card_flush` where PyTorch does
the policy arithmetic on the card: the initial state, the reference plane's
steps, the observables and swe2d's Lax-Wendroff step around K3. The kernel
hooks run outside it. On the CPU ``torch.set_flush_denormal(True)`` flushes
instead (the parity tests set it); a mode for the CPU emulates it there,
which is how the tests hold the mode itself to the hardware's flush.

Left as they are, as the hardware's flush leaves them: bit reinterpretations
(``Tensor.view``), whose f32 patterns the port builds on purpose, ops that
only move or select values (``torch.where``, ``neg``, ``abs``) and ops that
make fresh tensors.

Limits: the mode flushes results, not inputs. A subnormal that reaches an
op from outside the mode's results (a bit view, a Python float operand, a
tensor made before the block) is not zeroed first, as DAZ would zero it, so
an op whose normal result depends on such an input (``normal + subnormal``
rounding differently, ``subnormal * 2**30``), or a zero's sign (``0 +
(-sub)`` flushes to ``-0`` where DAZ reads ``+0``), can differ from the
hardware's. The port's policy arithmetic feeds no such input: its
quantizers zero subnormal inputs themselves, as ``repro``'s do, and a run's
entry on the card zeroes the subnormals of a caller's state
(:func:`zero_subnormal_inputs`) but in the cells whose bits its stepper
uses as they are (``Stepper.raw_cells``: copies, and capture's bins). The tests
``tests/test_torch_card.py`` and the card's link to the CPU under flush
(``chip_smoke.py`` phase 4) are what hold the parity.
"""

from __future__ import annotations

import contextlib

import torch
from torch.overrides import TorchFunctionMode

from repro_torch._device import on_card

__all__ = ["flush", "flush_subnormals", "card_flush", "zero_subnormal_inputs"]

TINY = 2.0**-126  # the smallest normal f32

_T = torch.Tensor
#: ops whose f32 results are values of their inputs (or fresh tensors)
_KEEP = frozenset({
    _T.view, _T.__getitem__, _T.__setitem__, _T.reshape, torch.reshape, _T.contiguous, _T.clone, _T.flatten,
    _T.unsqueeze, _T.squeeze, _T.expand, _T.permute, _T.transpose, _T.split, torch.split, _T.unbind, torch.unbind,
    torch.cat, torch.stack, torch.roll, torch.broadcast_tensors, torch.meshgrid,
    torch.where, _T.where, torch.neg, _T.neg, _T.__neg__, torch.abs, _T.abs,
    torch.empty, torch.empty_like, torch.zeros, torch.zeros_like, torch.ones, torch.ones_like,
})


def flush(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every subnormal replaced by a zero of its sign (a product
    by 0 or 1: infinities keep, a NaN stays a NaN)."""
    return x * (x.abs() >= TINY)


_INPLACE_DUNDERS = frozenset({"__iadd__", "__isub__", "__imul__", "__itruediv__"})


class _FlushMode(TorchFunctionMode):
    def __init__(self, device_type: str):
        super().__init__()
        self.device_type = device_type

    def _flushed(self, out, inplace: bool):
        if isinstance(out, torch.Tensor):
            if out.dtype != torch.float32 or out.device.type != self.device_type:
                return out
            return out.copy_(flush(out)) if inplace else flush(out)
        if isinstance(out, (tuple, list)):
            return type(out)([self._flushed(o, inplace) for o in out])
        return out

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func in _KEEP:
            return out
        name = getattr(func, "__name__", "")
        inplace = (name.endswith("_") and not name.endswith("__")) or name in _INPLACE_DUNDERS
        if kwargs.get("out") is not None:  # the result lives in the caller's tensor
            inplace = True
        elif not inplace and any(out is a for a in args):  # a no-op such as .to() to its own dtype
            return out
        return self._flushed(out, inplace)


def flush_subnormals(device) -> contextlib.AbstractContextManager:
    """A block in which every subnormal f32 result of a PyTorch op on a
    tensor of ``device``'s type becomes a zero of its sign."""
    return _FlushMode(torch.device(device).type)


def zero_subnormal_inputs(x: torch.Tensor, keep=None) -> torch.Tensor:
    """``x`` (f32) with every subnormal set to a zero of its sign, as XLA's
    denormals-are-zero reads it, except where the bool mask ``keep`` is
    True. A run's entry on the card (``Simulation.run``, ``run_ensemble``)
    applies it to a caller's state, keeping the cells whose bits the
    stepper uses as they are (``Stepper.raw_cells``): the flush mode
    flushes results, not inputs, and a subnormal input otherwise reaches
    PyTorch's arithmetic, where ``0 + (-sub)`` flushes to ``-0`` where DAZ
    gives ``+0``. Built from the bits, so no flush mode changes it."""
    bits = x.contiguous().view(torch.int32)
    mag = bits & 0x7FFFFFFF
    sub = (mag != 0) & (mag < 0x00800000)
    if keep is not None:
        sub = sub & ~keep
    return torch.where(sub, bits & torch.iinfo(torch.int32).min, bits).view(torch.float32)


def card_flush(device) -> contextlib.AbstractContextManager:
    """:func:`flush_subnormals` on a CUDA device; elsewhere a block that
    changes nothing (the CPU runs flush through its own flags)."""
    return flush_subnormals(device) if on_card(device) else contextlib.nullcontext()
