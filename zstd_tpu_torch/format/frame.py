"""Frame-level parsing: magic dispatch, headers, frame iteration.

Host-side prepass (RFC 8878 §3.1; reference
zstd-decompressor/src/frame.rs:41-230).  Parsing is
descriptor-only — it produces offset/size views into the input, never
decoded bytes — so the output of a scan is a flat table that can drive
batched device dispatch.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.bits import ForwardByteCursor
from ..utils.errors import ReservedBitSet, UnrecognizedMagic, WindowTooLarge
from .block import BlockDesc, parse_block

MAGIC_ZSTD = 0xFD2FB528
MAGIC_SKIPPABLE_BASE = 0x184D2A50  # low nibble is wild (frame.rs:66)

# Reference parity default (frame.rs:44); callers may raise it.
MAX_WINDOW_SIZE = 8 << 20


@dataclass(frozen=True)
class FrameHeader:
    """Parsed ZSTD frame header (frame.rs:102-177, RFC 8878 §3.1.1.1)."""

    checksum_flag: bool
    window_size: int
    dict_id: int | None
    content_size: int | None
    single_segment: bool


@dataclass
class ZstdFrame:
    header: FrameHeader
    blocks: list[BlockDesc] = field(default_factory=list)
    checksum: int | None = None
    # Absolute offsets of the whole frame within the input buffer.
    start: int = 0
    end: int = 0


@dataclass
class SkippableFrame:
    magic: int
    payload: memoryview
    start: int = 0
    end: int = 0


Frame = ZstdFrame | SkippableFrame


def parse_frame_header(cur: ForwardByteCursor) -> FrameHeader:
    """Parse the frame header after the magic (frame.rs:111-177).

    Descriptor byte, LSB-first: dict_id_flag(2), checksum(1), reserved(1),
    unused(1), single_segment(1), fcs_flag(2).
    """
    desc = cur.u8()
    dict_id_flag = desc & 0b11
    checksum_flag = (desc >> 2) & 1
    if (desc >> 3) & 1:
        raise ReservedBitSet("frame header reserved bit set")
    single_segment = (desc >> 5) & 1
    fcs_flag = desc >> 6

    window_size: int | None = None
    if not single_segment:
        wd = cur.u8()
        exponent = wd >> 3
        mantissa = wd & 0b111
        base = 1 << (10 + exponent)
        window_size = base + (base // 8) * mantissa

    dict_id = None
    if dict_id_flag:
        dict_id = int.from_bytes(cur.slice(1 << (dict_id_flag - 1)), "little")

    if fcs_flag == 0:
        fcs_size = 1 if single_segment else 0
    else:
        fcs_size = 1 << fcs_flag
    content_size = None
    if fcs_size:
        content_size = int.from_bytes(cur.slice(fcs_size), "little")
        if fcs_size == 2:
            content_size += 256

    if window_size is None:
        window_size = content_size
        if window_size is None:
            raise ReservedBitSet("no window descriptor and no content size")

    return FrameHeader(
        checksum_flag=bool(checksum_flag),
        window_size=window_size,
        dict_id=dict_id,
        content_size=content_size,
        single_segment=bool(single_segment),
    )


def parse_frame(
    cur: ForwardByteCursor, *, max_window_size: int = MAX_WINDOW_SIZE
) -> Frame:
    """Parse one frame at the cursor (frame.rs:61-77, 198-230)."""
    start = cur.pos
    magic = cur.le_u32()
    if magic == MAGIC_ZSTD:
        header = parse_frame_header(cur)
        if header.window_size > max_window_size:
            raise WindowTooLarge(header.window_size, max_window_size)
        frame = ZstdFrame(header=header, start=start)
        while True:
            block, last = parse_block(cur)
            frame.blocks.append(block)
            if last:
                break
        if header.checksum_flag:
            frame.checksum = cur.le_u32()
        frame.end = cur.pos
        return frame
    if (magic ^ MAGIC_SKIPPABLE_BASE) <= 0x0F:
        length = cur.le_u32()
        payload = cur.slice(length) if length else memoryview(b"")
        return SkippableFrame(magic=magic, payload=payload, start=start, end=cur.pos)
    raise UnrecognizedMagic(magic)


def iter_frames(
    data: bytes | memoryview, *, max_window_size: int = MAX_WINDOW_SIZE
):
    """Yield frames until the input is exhausted (frame.rs:87-100)."""
    cur = ForwardByteCursor(data)
    while not cur.is_empty:
        yield parse_frame(cur, max_window_size=max_window_size)
