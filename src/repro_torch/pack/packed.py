"""The packed R2F2 storage format (the reference's DESIGN.md §13).

A :class:`PackedArray` holds one array's storage form:

* ``payload``: the 2-D bit payload (``pack_r2f2`` fields: sign | exp |
  mantissa), ``torch.uint8``/``uint16``/``uint32`` by the format's
  ``total_bits`` (:func:`payload_dtype`), so its bytes are the reference's;
* ``k``: the flexible split of each storage block, ``(gi, gj)`` int32;
* ``fmt``, the logical ``shape`` and the storage ``block`` over the
  canonical 2-D view (leading axes collapse into rows).

Packing picks, per block, the minimal split whose format holds the block's
largest finite magnitude as a normal (``select_k_operand``; zeros and
non-finite values excluded), quantizes at it with the bit-exact RNE path and
encodes the bits. ``unpack(pack(x))`` is ``quantize_em`` at the chosen
splits, with NaNs made canonical (sign kept), which is what makes packed
and quantized runs bit-identical.

:func:`pack_array` and :func:`unpack_array` launch kernel K1's harness
(``kernels/storage.py``) on CUDA tensors and run the plain block helpers
(:func:`block_storage_k`, :func:`pack_block`, :func:`unpack_block`) on CPU
tensors, or anywhere with ``plain=True`` (counted in
``STORAGE.plain_calls``). Those helpers are also the plain
versions of the kernels' packed prologues and epilogues, so the two can
never disagree in the plain code.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.flexformat import FlexFormat, pack_r2f2, quantize_em, unpack_r2f2
from repro_torch.core.r2f2 import _finite_max_exp, select_k_operand
from repro_torch.kernels.storage import STORAGE

__all__ = [
    "PackedArray",
    "pack_array",
    "unpack_array",
    "pack_state",
    "unpack_state",
    "storage_quantize",
    "is_packed",
    "state_nbytes",
    "payload_dtype",
    "block_storage_k",
    "pack_block",
    "unpack_block",
    "pack_members",
    "unpack_members",
    "member_of",
    "stack_members",
]


def payload_dtype(fmt: FlexFormat) -> torch.dtype:
    """Narrowest unsigned dtype holding ``fmt.total_bits`` payload bits."""
    if fmt.total_bits <= 8:
        return torch.uint8
    return torch.uint16 if fmt.total_bits <= 16 else torch.uint32


def _k_of_max_exp(me: torch.Tensor, fmt: FlexFormat, k_min: int) -> torch.Tensor:
    return select_k_operand(me, fmt).clamp(k_min, fmt.fx).to(torch.int32)


def block_storage_k(x, fmt: FlexFormat, k_min: int = 0) -> torch.Tensor:
    """Storage split of one block: the minimal split holding the block's
    largest finite magnitude as a normal, clipped to ``[k_min, fx]`` (a
    block of zeros and non-finite values floors at exponent -127)."""
    return _k_of_max_exp(_finite_max_exp(torch.as_tensor(x).to(torch.float32)), fmt, k_min)


def pack_block(x, fmt: FlexFormat, k) -> torch.Tensor:
    """Quantize at split ``k`` (a scalar or a tensor broadcasting against
    ``x``) and encode: the payload bits as int64 (callers narrow them to
    :func:`payload_dtype`)."""
    x = torch.as_tensor(x).to(torch.float32)
    k = torch.as_tensor(k).to(device=x.device, dtype=torch.int64)
    q = quantize_em(x, fmt.eb + k, fmt.mb + fmt.fx - k)
    return pack_r2f2(q, fmt, k)


def unpack_block(payload, fmt: FlexFormat, k) -> torch.Tensor:
    """Decode a block's payload (any integer dtype) to f32 at split ``k``."""
    return unpack_r2f2(payload, fmt, k)


def _view2d(shape: Tuple[int, ...]) -> Tuple[int, int]:
    """Canonical 2-D view: the trailing axis stays, leading axes collapse."""
    if len(shape) == 0:
        return (1, 1)
    if len(shape) == 1:
        return (1, shape[0])
    rows = 1
    for d in shape[:-1]:
        rows *= d
    return (rows, shape[-1])


class PackedArray:
    """One array in packed R2F2 storage (see the module docstring)."""

    __slots__ = ("payload", "k", "fmt", "shape", "block")

    def __init__(self, payload, k, fmt: FlexFormat, shape: Tuple[int, ...], block: Tuple[int, int]):
        self.payload = payload
        self.k = k
        self.fmt = fmt
        self.shape = tuple(int(d) for d in shape)
        self.block = tuple(int(d) for d in block)

    @property
    def nbytes(self) -> int:
        """Storage footprint: payload plus split metadata."""
        return int(self.payload.nbytes) + int(self.k.nbytes)

    @property
    def device(self) -> torch.device:
        return self.payload.device

    def to(self, device) -> "PackedArray":
        return PackedArray(self.payload.to(device), self.k.to(device), self.fmt, self.shape, self.block)

    def with_view(self, shape: Tuple[int, ...]) -> "PackedArray":
        """The same single-block payload under another logical shape (one
        split covers every element either way, so the payload reshapes)."""
        shape = tuple(int(d) for d in shape)
        n_new = n_old = 1
        for d in shape:
            n_new *= d
        for d in self.shape:
            n_old *= d
        if n_new != n_old:
            raise ValueError(f"cannot view {self.shape} as {shape}: size differs")
        if tuple(self.k.shape[-2:]) != (1, 1):
            raise ValueError(f"with_view needs a single-block PackedArray; got k of shape {tuple(self.k.shape)}")
        view = _view2d(shape)
        return PackedArray(self.payload.reshape(tuple(self.payload.shape[:-2]) + view), self.k, self.fmt, shape, view)

    def __repr__(self) -> str:
        return (
            f"PackedArray({self.fmt}, shape={self.shape}, block={self.block}, "
            f"payload={self.payload.dtype}{tuple(self.payload.shape)})"
        )


def _geometry(shape, block):
    rows, width = _view2d(tuple(shape))
    if block is None:
        block = (rows, width)
    br, bw = min(block[0], rows), min(block[1], width)
    return rows, width, br, bw, -(-rows // br), -(-width // bw)


def pack_array(x, fmt: FlexFormat, *, block: Optional[Tuple[int, int]] = None, k_min: int = 0,
               plain: bool = False) -> PackedArray:
    """Pack one f32 array. ``block`` is the storage block over the canonical
    2-D view, one split each (default: one block, a split for the whole
    array). Blocks that do not divide are zero-padded; the pad is cropped
    on unpack and takes no part in a split (zeros carry no exponent). A CUDA
    tensor runs kernel K1's harness unless ``plain``."""
    x = torch.as_tensor(x).to(torch.float32)
    shape = tuple(x.shape)
    rows, width, br, bw, gi, gj = _geometry(shape, block)
    x2 = x.reshape(rows, width)
    pad_r, pad_w = gi * br - rows, gj * bw - width
    if pad_r or pad_w:
        x2 = F.pad(x2, (0, pad_w, 0, pad_r))
    if x2.is_cuda and not plain:
        from repro_torch.kernels.storage import pack_blocks

        payload, k = pack_blocks(x2.contiguous(), fmt, br, bw, k_min=k_min)
        return PackedArray(payload, k, fmt, shape, (br, bw))
    STORAGE.plain_calls += 1
    xt = x2.reshape(gi, br, gj, bw)
    k = _k_of_max_exp(_finite_max_exp(xt, dim=(1, 3)), fmt, k_min)
    payload = pack_block(xt, fmt, k[:, None, :, None]).reshape(gi * br, gj * bw)
    return PackedArray(payload.to(payload_dtype(fmt)), k, fmt, shape, (br, bw))


def unpack_array(pa: PackedArray, *, plain: bool = False) -> torch.Tensor:
    """Decode a PackedArray back to its logical-shape f32 array; a CUDA
    payload runs kernel K1's harness unless ``plain``."""
    rows, width, br, bw, gi, gj = _geometry(pa.shape, pa.block)
    if pa.payload.is_cuda and not plain:
        from repro_torch.kernels.storage import unpack_blocks

        x2 = unpack_blocks(pa.payload.reshape(gi * br, gj * bw).contiguous(), pa.k, pa.fmt, br, bw)
    else:
        STORAGE.plain_calls += 1
        pt = pa.payload.to(torch.int64).reshape(gi, br, gj, bw)
        x2 = unpack_block(pt, pa.fmt, pa.k.reshape(gi, 1, gj, 1)).reshape(gi * br, gj * bw)
    return x2[:rows, :width].reshape(pa.shape)


def pack_members(x, fmt: FlexFormat, *, k=None, plain: bool = False) -> PackedArray:
    """Pack ensemble members ``x`` ``(members, *shape)``, each as one storage
    block (one split a member, or ``k``'s ``(members,)`` splits), as
    :func:`pack_array` packs a member alone:
    a PackedArray whose payload ``(members, *view)`` and splits ``(members,
    1, 1)`` lead with the member, its shape and block the member's. A CUDA
    tensor runs kernel K1's harness (a storage block a member) unless
    ``plain``."""
    x = torch.as_tensor(x).to(torch.float32)
    members, shape = x.shape[0], tuple(x.shape[1:])
    rows, width = _view2d(shape)
    xt = x.reshape(members, rows, width)
    if xt.is_cuda and not plain:
        from repro_torch.kernels.storage import pack_blocks

        payload, k = pack_blocks(xt.reshape(members * rows, width).contiguous(), fmt, rows, width,
                                 k=None if k is None else k.reshape(members, 1))
    else:
        STORAGE.plain_calls += 1
        k = _k_of_max_exp(_finite_max_exp(xt, dim=(1, 2)), fmt, 0) if k is None else k.reshape(members).to(torch.int32)
        payload = pack_block(xt, fmt, k[:, None, None]).to(payload_dtype(fmt))
    return PackedArray(payload.reshape(members, rows, width), k.reshape(members, 1, 1), fmt, shape, (rows, width))


def unpack_members(pa: PackedArray, *, plain: bool = False) -> torch.Tensor:
    """Decode ensemble members packed one storage block each (a PackedArray
    whose payload and splits lead with the member) to ``(members, *shape)``
    f32; a CUDA payload runs kernel K1's harness unless ``plain``."""
    members = pa.payload.shape[0]
    rows, width = _view2d(pa.shape)
    if tuple(pa.block) != (rows, width):
        raise ValueError(f"unpack_members takes one storage block a member; got block {pa.block} of {(rows, width)}")
    if pa.payload.is_cuda and not plain:
        from repro_torch.kernels.storage import unpack_blocks

        x = unpack_blocks(pa.payload.reshape(members * rows, width).contiguous(), pa.k.reshape(members, 1), pa.fmt,
                          rows, width)
    else:
        STORAGE.plain_calls += 1
        x = unpack_block(pa.payload.to(torch.int64).reshape(members, rows, width), pa.fmt, pa.k.reshape(members, 1, 1))
    return x.reshape((members,) + pa.shape)


def member_of(tree, i: int):
    """Member ``i`` of an ensemble state tree: every tensor's row ``i`` and
    every PackedArray's payload and splits at ``i``."""
    def one(x):
        if isinstance(x, PackedArray):
            return PackedArray(x.payload[i], x.k[i], x.fmt, x.shape, x.block)
        return x[i]

    return _map(one, tree)


def stack_members(trees):
    """The inverse of :func:`member_of`: members' state trees stacked along a
    new leading member dim (PackedArrays' payloads and splits)."""
    first = trees[0]
    if isinstance(first, dict):
        return {key: stack_members([t[key] for t in trees]) for key in first}
    if isinstance(first, (tuple, list)):
        return type(first)(stack_members(list(col)) for col in zip(*trees))
    if isinstance(first, PackedArray):
        return PackedArray(torch.stack([t.payload for t in trees]), torch.stack([t.k for t in trees]), first.fmt,
                           first.shape, first.block)
    return torch.stack(list(trees))


def _map(fn, tree):
    """``fn`` over the leaves of a tree of tuples, lists and dicts (a
    PackedArray and a tensor are leaves)."""
    if isinstance(tree, dict):
        return {key: _map(fn, v) for key, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def pack_state(state, fmt: FlexFormat, *, block=None, k_min: int = 0, plain: bool = False):
    """Pack every leaf of a solver state."""
    return _map(lambda x: pack_array(x, fmt, block=block, k_min=k_min, plain=plain), state)


def unpack_state(packed, *, plain: bool = False):
    """Inverse of :func:`pack_state`: PackedArray leaves back to f32."""
    return _map(lambda x: unpack_array(x, plain=plain) if isinstance(x, PackedArray) else x, packed)


def storage_quantize(state, fmt: FlexFormat, *, block=None, k_min: int = 0, plain: bool = False):
    """The f32-carried storage rounding, ``unpack(pack(state))``: bit for bit
    the values a packed run carries at the same splits."""
    return unpack_state(pack_state(state, fmt, block=block, k_min=k_min, plain=plain), plain=plain)


def is_packed(tree) -> bool:
    """Does any leaf of ``tree`` carry packed storage?"""
    return any(isinstance(x, PackedArray) for x in _leaves(tree))


def state_nbytes(tree) -> int:
    """Carried-state bytes: payload plus metadata for packed leaves."""
    return sum(int(x.nbytes) for x in _leaves(tree))
