"""LZ77 sequence execution (host reference path).

The reference copies matches one byte at a time
(zstd-decompressor/src/decoding_context.rs:95-98).  Here
match copies are chunked: a non-overlapping match is one slice copy; a
self-overlapping match (offset < length) is period replication —
semantically identical to the byte loop, but O(length) in memcpy units
instead of Python-level byte pushes.  The device equivalent is the
device LZ77 executor, still to be ported.
"""

from __future__ import annotations

from ..utils.errors import ImpossibleValue
from .sequence_codes import resolve_offset


def copy_match(out: bytearray, offset: int, length: int) -> None:
    """Append ``length`` bytes replicated from ``offset`` back, overlap-correct."""
    start = len(out) - offset
    if start < 0:
        raise ImpossibleValue(f"match offset {offset} exceeds output {len(out)}")
    if length <= 0:
        return
    if offset >= length:
        out += out[start : start + length]
    else:
        period = bytes(out[start:])  # `offset` bytes
        reps = -(-length // offset)
        out += (period * reps)[:length]


def execute_sequences(
    out: bytearray,
    sequences: list[tuple[int, int, int]],
    literals: bytes | memoryview,
    rep: list[int],
) -> int:
    """Execute ``(ll, offset_value, ml)`` triples (decoding_context.rs:78-107).

    Appends to ``out`` (the whole-frame output so far — matches may reach
    back across block boundaries), consuming ``literals`` and mutating the
    repeat-offset history ``rep`` in place.  Trailing literals after the
    last sequence are appended verbatim.  Returns the bytes of the matches
    whose source starts before ``out``'s length at entry (in an earlier
    block of the frame).
    """
    block_start = len(out)
    far = 0
    lit_pos = 0
    for ll, offset_value, ml in sequences:
        offset = resolve_offset(offset_value, ll, rep)
        if ll > len(literals) - lit_pos:
            raise ImpossibleValue(f"literal run {ll} exceeds remaining literals")
        if offset > len(out) + ll:
            raise ImpossibleValue(
                f"offset {offset} exceeds decoded length {len(out) + ll}"
            )
        if ll:
            out += literals[lit_pos : lit_pos + ll]
            lit_pos += ll
        if len(out) - offset < block_start:
            far += ml
        copy_match(out, offset, ml)
    if lit_pos < len(literals):
        out += literals[lit_pos:]
    return far
