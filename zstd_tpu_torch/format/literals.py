"""Literals-section parsing (RFC 8878 §3.1.1.3.1; reference literals.rs:88-207).

Produces a descriptor with per-stream byte views — the 4-stream jump
table is ZSTD's own ILP hook and becomes the finest-grain parallel axis
on device (4 backward Huffman streams per block × N blocks).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from ..utils.bits import ForwardByteCursor
from ..utils.errors import StreamSizesTooBig


class LiteralsType(enum.IntEnum):
    RAW = 0
    RLE = 1
    COMPRESSED = 2
    TREELESS = 3


@dataclass
class LiteralsDesc:
    ltype: LiteralsType
    regenerated_size: int
    # RAW: the literal bytes; RLE: unused.
    data: memoryview | None = None
    rle_byte: int = 0
    # COMPRESSED: weights payload (None for TREELESS).
    huffman_payload: memoryview | None = None
    # COMPRESSED/TREELESS: backward Huffman streams, in order.
    streams: list[memoryview] = field(default_factory=list)


def parse_literals_section(cur: ForwardByteCursor) -> LiteralsDesc:
    """Parse header + payload into a descriptor (literals.rs:88-206).

    Header bit layout (LSB-first): type(2), size_format(2), then sizes.
    Raw/RLE regenerated sizes use 5/12/20 bits; Compressed/Treeless pack
    (regenerated, compressed) as 10+10 / 14+14 / 18+18 bits over 3/4/5
    header bytes, with 1 stream for size_format 0 and 4 otherwise.
    """
    b0 = cur.u8()
    ltype = LiteralsType(b0 & 0b11)
    size_format = (b0 >> 2) & 0b11

    if ltype in (LiteralsType.RAW, LiteralsType.RLE):
        if size_format in (0, 2):
            regen = b0 >> 3  # 5 bits (size_format low bit is part of it)
        elif size_format == 1:
            regen = (b0 >> 4) | (cur.u8() << 4)  # 12 bits
        else:
            regen = (b0 >> 4) | (cur.u8() << 4) | (cur.u8() << 12)  # 20 bits
        if ltype == LiteralsType.RAW:
            return LiteralsDesc(ltype, regen, data=cur.slice(regen))
        return LiteralsDesc(ltype, regen, rle_byte=cur.u8())

    # Compressed / Treeless: sizes split across extra header bytes.
    if size_format == 0:
        ext = int.from_bytes(cur.slice(2), "little")
        packed = (b0 >> 4) | (ext << 4)  # 20 payload bits total
        regen, comp, n_streams = packed & 0x3FF, packed >> 10, 1
    elif size_format == 1:
        ext = int.from_bytes(cur.slice(2), "little")
        packed = (b0 >> 4) | (ext << 4)
        regen, comp, n_streams = packed & 0x3FF, packed >> 10, 4
    elif size_format == 2:
        ext = int.from_bytes(cur.slice(3), "little")
        packed = (b0 >> 4) | (ext << 4)  # 28 bits
        regen, comp, n_streams = packed & 0x3FFF, packed >> 14, 4
    else:
        ext = int.from_bytes(cur.slice(4), "little")
        packed = (b0 >> 4) | (ext << 4)  # 36 bits
        regen, comp, n_streams = packed & 0x3FFFF, packed >> 18, 4

    body = ForwardByteCursor(cur.slice(comp))
    huffman_payload = None
    if ltype == LiteralsType.COMPRESSED:
        huffman_payload = _slice_huffman_payload(body)

    streams: list[memoryview] = []
    if n_streams == 4:
        s1, s2, s3 = body.le_u16(), body.le_u16(), body.le_u16()
        total = len(body)
        if s1 + s2 + s3 > total:
            raise StreamSizesTooBig(
                f"jump table {s1}+{s2}+{s3} exceeds {total} stream bytes"
            )
        for size in (s1, s2, s3):
            streams.append(body.slice(size))
        streams.append(body.slice(len(body)))
    else:
        streams.append(body.slice(len(body)))

    return LiteralsDesc(
        ltype,
        regen,
        huffman_payload=huffman_payload,
        streams=streams,
    )


def _slice_huffman_payload(body: ForwardByteCursor) -> memoryview:
    """Split off the Huffman table payload (header byte + weights).

    The weights payload length is determined by the header byte alone
    (huffman.rs:80-106): < 128 → that many FSE-compressed bytes; ≥ 128 →
    ceil((header - 127) / 2) direct-weight bytes.
    """
    start = body.pos
    header = body.u8()
    if header < 128:
        body.slice(header)
    else:
        num = header - 127
        body.slice((num + 1) // 2)
    return body.data[start : body.pos]


def stream_regen_sizes(regen: int, n_streams: int) -> list[int]:
    """Per-stream regenerated sizes (RFC 8878 §3.1.1.3.1.6).

    Streams 1–3 regenerate ``(regen + 3) // 4`` bytes each; stream 4 the
    remainder.  The reference never checks these (literals.rs:70-81 just
    drains each stream); we use them to validate and to size device
    buffers.
    """
    if n_streams == 1:
        return [regen]
    per = (regen + 3) // 4
    return [per, per, per, regen - 3 * per]
