"""Block-level parsing (RFC 8878 §3.1.1.2; reference block.rs:29-72).

3-byte little-endian block header → ``last(1) | type(2) | size(21)``.
Compressed blocks are parsed into literals + sequences descriptors
immediately (the reference is likewise eager, frame.rs:208-217); the
descriptors hold views, not decoded data.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from ..utils.bits import ForwardByteCursor
from ..utils.errors import ReservedBlockType
from .literals import LiteralsDesc, parse_literals_section
from .sequences import SequencesDesc, parse_sequences_section

# A block's decoded size never exceeds min(window, 128 KiB) (RFC §3.1.1.2.3).
MAX_BLOCK_SIZE = 128 << 10


class BlockType(enum.IntEnum):
    RAW = 0
    RLE = 1
    COMPRESSED = 2
    RESERVED = 3


@dataclass
class BlockDesc:
    btype: BlockType
    # RAW: the verbatim bytes; RLE: unused; COMPRESSED: the compressed payload.
    data: memoryview | None
    # RLE only: (byte value, repeat count).
    rle_byte: int = 0
    rle_repeat: int = 0
    # COMPRESSED only:
    literals: LiteralsDesc | None = None
    sequences: SequencesDesc | None = None


def parse_block(cur: ForwardByteCursor) -> tuple[BlockDesc, bool]:
    """Parse one block header + body; returns (desc, is_last)."""
    header = int.from_bytes(cur.slice(3), "little")
    last = bool(header & 1)
    btype = BlockType((header >> 1) & 0b11)
    size = header >> 3

    if btype == BlockType.RAW:
        return BlockDesc(btype=btype, data=cur.slice(size)), last
    if btype == BlockType.RLE:
        return (
            BlockDesc(btype=btype, data=None, rle_byte=cur.u8(), rle_repeat=size),
            last,
        )
    if btype == BlockType.COMPRESSED:
        body = ForwardByteCursor(cur.slice(size))
        literals = parse_literals_section(body)
        sequences = parse_sequences_section(body)
        return (
            BlockDesc(
                btype=btype,
                data=body.data,
                literals=literals,
                sequences=sequences,
            ),
            last,
        )
    raise ReservedBlockType("reserved block type")
