"""Kernel K1's harness for packed storage: ``pack/packed.py``'s block helpers
over a 2-D array of storage blocks, one CTA a block
(``csrc/r2f2_storage.cu``).

The storage parts of the other kernels (the rod's and heat2d's packed
prologue and epilogue, and every megakernel's boundary rounding) call the
same device functions (``csrc/r2f2_device.cuh``: ``storage_k`` and
``Codec``) inside their own launches. This kernel packs and unpacks where a
state crosses the host: :func:`repro_torch.pack.pack_array` and
``unpack_array`` on CUDA tensors, so a run's first pack, swe2d's chunk
boundaries on the fused plane and its megakernel's final pack.

Replaces ``repro/pack/packed.py::pack_array``/``unpack_array``
(``block_storage_k``, ``pack_block``, ``unpack_block``), which the reference
runs in XLA around its Pallas kernels; the K1 row of PERF.md's table.
"""

from __future__ import annotations

import torch

from repro_torch.core.flexformat import FlexFormat
from repro_torch.kernels import _cuda

__all__ = ["STORAGE", "MODES", "pack_blocks", "unpack_blocks", "launch_storage"]

#: launches of the harness kernel
STORAGE = _cuda.KernelCounter("r2f2_storage")
#: the kernel's modes (csrc/r2f2_storage.cu)
MODES = {"pack": 0, "unpack": 1}


def _payload_dtype(fmt: FlexFormat) -> torch.dtype:
    from repro_torch.pack.packed import payload_dtype

    return payload_dtype(fmt)


def launch_storage(mode, fmt, br, bw, *, x=None, payload=None, k_in=None, k_out=None, y=None, k_min=0):
    """One launch on a ``(rows, width)`` array of ``(br, bw)`` blocks; the
    tensors are contiguous CUDA tensors (``payload`` of the format's payload
    dtype). Raises where the launch fails."""
    ref = x if x is not None else payload
    rows, width = ref.shape
    dtype = _payload_dtype(fmt)
    if payload is not None and payload.dtype != dtype:
        raise ValueError(f"payload dtype {payload.dtype} is not the format's {dtype}")
    lib = _cuda.library()
    with torch.cuda.device(ref.device):
        err = lib.r2f2_storage(
            MODES[mode], _cuda.ptr(x), _cuda.ptr(payload), _cuda.ptr(k_in), _cuda.ptr(k_out), _cuda.ptr(y), rows,
            width, br, bw, k_min, torch.empty((), dtype=dtype).element_size(), fmt.eb, fmt.mb, fmt.fx,
            _cuda.stream_of(ref),
        )
    _cuda.check(err, "r2f2_storage")
    STORAGE.count()


def _splits(rows, width, br, bw, device):
    return torch.empty((rows // br, width // bw), dtype=torch.int32, device=device)


def pack_blocks(x2, fmt: FlexFormat, br: int, bw: int, *, k_min: int = 0, k=None):
    """Pack a padded f32 ``(rows, width)`` CUDA array of ``(br, bw)``
    blocks: ``(payload, k)``, each block at its own split (or ``k``'s)."""
    x2 = x2.to(torch.float32).contiguous()
    payload = torch.empty(x2.shape, dtype=_payload_dtype(fmt), device=x2.device)
    k_out = _splits(*x2.shape, br, bw, x2.device)
    k_in = None if k is None else k.to(device=x2.device, dtype=torch.int32).contiguous()
    launch_storage("pack", fmt, br, bw, x=x2, payload=payload, k_in=k_in, k_out=k_out, k_min=k_min)
    return payload, k_out


def unpack_blocks(payload, k, fmt: FlexFormat, br: int, bw: int):
    """Decode a ``(rows, width)`` CUDA payload of ``(br, bw)`` blocks at the
    blocks' splits ``k`` to f32."""
    payload = payload.contiguous()
    y = torch.empty(payload.shape, dtype=torch.float32, device=payload.device)
    launch_storage("unpack", fmt, br, bw, payload=payload,
                   k_in=k.to(device=payload.device, dtype=torch.int32).contiguous(), y=y)
    return y

