"""repro_torch.pack: packed R2F2 storage, solver state at its carried split.

Solver state is carried between chunk boundaries and snapshots as a
:class:`PackedArray`, the ``total_bits``-wide payload of
:func:`repro_torch.core.flexformat.pack_r2f2` (uint16 for every format of
at most 16 bits) plus one split per storage block, instead of f32.
"""

from .packed import (
    PackedArray,
    block_storage_k,
    is_packed,
    member_of,
    pack_array,
    pack_members,
    pack_block,
    pack_state,
    payload_dtype,
    state_nbytes,
    storage_quantize,
    stack_members,
    unpack_array,
    unpack_block,
    unpack_members,
    unpack_state,
)

__all__ = [
    "PackedArray",
    "pack_array",
    "unpack_array",
    "pack_state",
    "unpack_state",
    "storage_quantize",
    "is_packed",
    "state_nbytes",
    # block-level helpers shared with the plain versions of the kernels' prologues and epilogues
    "payload_dtype",
    "block_storage_k",
    "pack_block",
    "unpack_block",
    # ensembles: members packed one storage block each, and one member of a stacked state
    "pack_members",
    "unpack_members",
    "member_of",
    "stack_members",
]
