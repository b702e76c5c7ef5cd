"""Sequence code → value tables and repeat-offset resolution.

RFC 8878 §3.1.1.3.2.1.1 code tables, matching the reference's
``LL_CODE_TO_VALUE`` / ``ML_CODE_TO_VALUE`` consts
(zstd-decompressor/src/decoders/sequence.rs:98-191) and
the three-slot repeat-offset history
(zstd-decompressor/src/decoding_context.rs:50-75).

Tables are NumPy arrays so the device kernels ship them as tiny VMEM
LUTs; the repeat-offset scan is the cheap per-block serial pass that
stays host-side (or on the scalar core) while byte-volume work runs wide.
"""

from __future__ import annotations

import numpy as np

from ..utils.errors import NullOffset, SymbolCodeTooLarge

MAX_LL_CODE = 35
MAX_ML_CODE = 52
MAX_OFFSET_CODE = 31  # sequence.rs:95; RFC allows up to 31 (window-capped)

# Literals-length codes: baseline and number of extra bits per code.
LL_BASELINE = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
     16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048,
     4096, 8192, 16384, 32768, 65536],
    dtype=np.int64,
)
LL_EXTRA_BITS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16],
    dtype=np.int64,
)

# Match-length codes.
ML_BASELINE = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
     22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41,
     43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195,
     16387, 32771, 65539],
    dtype=np.int64,
)
ML_EXTRA_BITS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9,
     10, 11, 12, 13, 14, 15, 16],
    dtype=np.int64,
)

assert len(LL_BASELINE) == MAX_LL_CODE + 1 and len(LL_EXTRA_BITS) == MAX_LL_CODE + 1
assert len(ML_BASELINE) == MAX_ML_CODE + 1 and len(ML_EXTRA_BITS) == MAX_ML_CODE + 1


def check_codes(ll_code: int, of_code: int, ml_code: int) -> None:
    """Bounds checks matching sequence.rs:46-48."""
    if ll_code > MAX_LL_CODE or ml_code > MAX_ML_CODE or of_code > MAX_OFFSET_CODE:
        raise SymbolCodeTooLarge(
            f"sequence codes out of range: ll={ll_code} of={of_code} ml={ml_code}"
        )


INITIAL_REPEAT_OFFSETS = (1, 4, 8)  # decoding_context.rs:40


def resolve_offset(
    offset_value: int, literals_length: int, rep: list[int]
) -> int:
    """Resolve an offset value against the 3-slot history, updating it.

    Implements RFC 8878 §3.1.1.5 repeat-offset semantics including the
    ``literals_length == 0`` shifted cases and the
    ``offset_value == 3, ll == 0`` → ``rep[0] - 1`` corner
    (decoding_context.rs:50-75).  ``rep`` is mutated in place.
    """
    if offset_value == 0:
        raise NullOffset("offset value 0")
    if offset_value > 3:
        off = offset_value - 3
        rep[2] = rep[1]
        rep[1] = rep[0]
        rep[0] = off
        return off
    # Repeat codes; ll == 0 shifts the index by one.
    idx = offset_value - 1 if literals_length != 0 else offset_value
    if idx == 0:
        return rep[0]
    if idx == 1:
        rep[0], rep[1] = rep[1], rep[0]
        return rep[0]
    if idx == 2:
        off = rep[2]
        rep[2] = rep[1]
        rep[1] = rep[0]
        rep[0] = off
        return off
    # idx == 3: offset_value == 3 with ll == 0 → rep[0] - 1.
    off = rep[0] - 1
    if off == 0:
        raise NullOffset("repeat offset underflow to 0")
    rep[2] = rep[1]
    rep[1] = rep[0]
    rep[0] = off
    return off
