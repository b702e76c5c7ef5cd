"""What the entropy stage of a ZSTD decoder has to move, counted from
the frames' own headers (RFC 8878 sections 3.1.1 and 3.1.1.3): the
yardstick of the ``entropy_roofline`` metric.

The count depends only on the input, never on how a kernel lays its
work out: the compressed literal sections (Compressed and Treeless
types: the Huffman-coded ones) and the sequence sections are read once,
the regenerated bytes of those literal sections are written once, and
each sequence's three values (literal length, match length, offset) are
written once as 4-byte integers.  Raw and RLE literals and Raw and RLE
blocks need no entropy decoding and are not counted.
"""

from __future__ import annotations

from dataclasses import dataclass

MAGIC = 0xFD2FB528
SKIPPABLE = 0x184D2A50  # low nibble free
SEQUENCE_VALUE_BYTES = 3 * 4


@dataclass
class EntropyWork:
    literal_in: int = 0  # compressed literal section bytes (Huffman-coded sections)
    literal_out: int = 0  # bytes those sections regenerate
    sequence_in: int = 0  # sequence section bytes (header, tables and bitstream)
    sequences: int = 0

    @property
    def bytes(self) -> int:
        return self.literal_in + self.literal_out + self.sequence_in + SEQUENCE_VALUE_BYTES * self.sequences

    def add(self, other: "EntropyWork") -> None:
        self.literal_in += other.literal_in
        self.literal_out += other.literal_out
        self.sequence_in += other.sequence_in
        self.sequences += other.sequences


def _le(b: bytes, pos: int, n: int) -> int:
    return int.from_bytes(b[pos : pos + n], "little")


def _literals(b: bytes, pos: int) -> tuple[int, int, int]:
    """(header bytes + content bytes of the literals section at ``pos``,
    its regenerated size, and its compressed size or 0 for Raw and RLE)."""
    b0 = b[pos]
    ltype, size_format = b0 & 3, (b0 >> 2) & 3
    if ltype < 2:  # Raw, RLE
        hdr = (1, 2, 1, 3)[size_format]
        regen = {1: b0 >> 3, 2: _le(b, pos, 2) >> 4, 3: _le(b, pos, 3) >> 4}[hdr]
        return hdr + (regen if ltype == 0 else 1), regen, 0
    hdr, bits = ((3, 10), (3, 10), (4, 14), (5, 18))[size_format]
    packed = _le(b, pos, hdr) >> 4
    regen, comp = packed & ((1 << bits) - 1), packed >> bits
    return hdr + comp, regen, comp


def _num_sequences(b: bytes, pos: int) -> int:
    b0 = b[pos]
    if b0 < 128:
        return b0
    if b0 < 255:
        return ((b0 - 128) << 8) + b[pos + 1]
    return _le(b, pos + 1, 2) + 0x7F00


def frame_work(data: bytes) -> EntropyWork:
    """The entropy work of every frame in ``data`` (skippable frames
    skipped)."""
    work, pos = EntropyWork(), 0
    while pos < len(data):
        magic = _le(data, pos, 4)
        if (magic ^ SKIPPABLE) <= 0x0F:
            pos += 8 + _le(data, pos + 4, 4)
            continue
        if magic != MAGIC:
            raise ValueError(f"no frame at byte {pos}")
        fhd = data[pos + 4]
        single, checksum, dict_flag, fcs_flag = (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3, fhd >> 6
        fcs = (1, 2, 4, 8)[fcs_flag] if fcs_flag or single else 0
        pos += 5 + (0 if single else 1) + (0, 1, 2, 4)[dict_flag] + fcs
        last = False
        while not last:
            bh = _le(data, pos, 3)
            last, btype, size = bh & 1, (bh >> 1) & 3, bh >> 3
            pos += 3
            if btype == 2:
                lit_len, regen, comp = _literals(data, pos)
                if comp:
                    work.literal_in += comp
                    work.literal_out += regen
                seq_len = size - lit_len
                work.sequence_in += seq_len
                work.sequences += _num_sequences(data, pos + lit_len)
            pos += 1 if btype == 1 else size
        pos += 4 * checksum
    return work
