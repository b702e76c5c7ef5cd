"""Sequences-section parsing (RFC 8878 §3.1.1.3.2; reference sequences.rs:50-143).

Parses the sequence count, the three compression modes (with any inline
FSE table descriptions) and captures the interleaved backward bitstream
as a view.  Entropy decoding itself lives in the runtime (host oracle)
and kernels (device path).

Deliberate deviations from the reference, both RFC-mandated:

* ``num_seq == 0`` is a valid literals-only block; the reference still
  builds a backward parser over the empty stream and errors
  (sequences.rs:211, block.rs:84-86).
* The 2-byte long form is ``le16(byte1, byte2) + 0x7F00``; the reference
  adds ``0x7F`` (sequences.rs:84), mis-decoding any block with ≥ 0x7F00
  sequences.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

from ..ops.fse import FseTable, parse_fse_table
from ..utils.bits import ForwardBitCursor, ForwardByteCursor
from ..utils.errors import ReservedModeBits


class SeqMode(enum.IntEnum):
    PREDEFINED = 0
    RLE = 1
    FSE = 2
    REPEAT = 3


@dataclass
class SeqModeDesc:
    mode: SeqMode
    rle_byte: int = 0
    fse_table: FseTable | None = None


@dataclass
class SequencesDesc:
    num_sequences: int
    ll: SeqModeDesc
    of: SeqModeDesc
    ml: SeqModeDesc
    bitstream: memoryview


_EMPTY = memoryview(b"")
_NO_MODE = SeqModeDesc(SeqMode.REPEAT)


def parse_num_sequences(cur: ForwardByteCursor) -> int:
    """Sequence-count varint (RFC 8878 §3.1.1.3.2.1; sequences.rs:77-87)."""
    b0 = cur.u8()
    if b0 == 0:
        return 0
    if b0 < 128:
        return b0
    if b0 < 255:
        return ((b0 - 128) << 8) + cur.u8()
    return cur.le_u16() + 0x7F00


def parse_sequences_section(cur: ForwardByteCursor) -> SequencesDesc:
    """Parse the whole sequences section of a compressed block."""
    num_seq = parse_num_sequences(cur)
    if num_seq == 0:
        return SequencesDesc(0, _NO_MODE, _NO_MODE, _NO_MODE, _EMPTY)

    modes_byte = cur.u8()
    if modes_byte & 0b11:
        raise ReservedModeBits("sequence compression-modes reserved bits set")
    ll_mode = SeqMode(modes_byte >> 6)
    of_mode = SeqMode((modes_byte >> 4) & 0b11)
    ml_mode = SeqMode((modes_byte >> 2) & 0b11)

    # Header payloads appear in LL, OF, ML order (RFC §3.1.1.3.2.1).
    descs = [
        _parse_mode_payload(m, cur) for m in (ll_mode, of_mode, ml_mode)
    ]
    bitstream = cur.slice(len(cur))
    return SequencesDesc(num_seq, descs[0], descs[1], descs[2], bitstream)


def _parse_mode_payload(mode: SeqMode, cur: ForwardByteCursor) -> SeqModeDesc:
    if mode == SeqMode.RLE:
        return SeqModeDesc(mode, rle_byte=cur.u8())
    if mode == SeqMode.FSE:
        # Inline FSE table description; the bit cursor's consumed-byte
        # count re-syncs the byte cursor (sequences.rs:128-137).
        bits = ForwardBitCursor(cur.data[cur.pos :])
        table = parse_fse_table(bits)
        cur.pos += bits.bytes_read()
        return SeqModeDesc(mode, fse_table=table)
    return SeqModeDesc(mode)
