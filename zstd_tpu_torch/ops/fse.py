"""FSE (tANS) table construction and distribution parsing.

Semantics match RFC 8878 §4.1 and the reference implementation
(zstd-decompressor/src/decoders/fse.rs:16-227), but the
table build uses the standard single-pass counter formulation (one
counter per symbol starting at its probability; cell ``nbits = AL -
highbit(counter)``, ``baseline = (counter << nbits) - size``) instead of
the reference's grouped two-pass reassignment (fse.rs:168-189) — the two
are equivalent, and the counter form vectorizes.

Tables are emitted as NumPy struct-of-arrays, device-ready: broadcast
``(symbol, baseline, nbits)`` to all chips and the tANS transition is a
pure gather ``state' = baseline[state] + take(nbits[state])``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.bits import ForwardBitCursor
from ..utils.errors import AccuracyLogTooLarge, CorruptedTable

# The reference applies a blanket cap of 9 (fse.rs:13); RFC 8878 per-use
# caps are tighter (6 for Huffman weights, 8 for offsets, 9 for LL/ML) so
# a blanket 9 accepts every RFC-valid stream.
MAX_ACCURACY_LOG = 9
MAX_SYMBOLS = 256


@dataclass(frozen=True)
class FseTable:
    """Decode table: per-state symbol / baseline / bits-to-read."""

    accuracy_log: int
    symbol: np.ndarray  # uint16[size]
    baseline: np.ndarray  # uint16[size]
    nbits: np.ndarray  # uint8[size]

    @property
    def size(self) -> int:
        return 1 << self.accuracy_log

    def as_packed(self) -> np.ndarray:
        """Pack as int32[size] = ``baseline << 16 | symbol << 4 | nbits``.

        Field widths: nbits ≤ 9 (4 bits), symbol ≤ 255 (12 bits),
        baseline ≤ 511 (upper bits).  One packed word per state means the
        device tANS transition needs a single gather per step.
        """
        return (
            self.baseline.astype(np.int32) << 16
            | self.symbol.astype(np.int32) << 4
            | self.nbits.astype(np.int32)
        )


def parse_fse_distribution(cur: ForwardBitCursor) -> tuple[int, list[int]]:
    """Parse an FSE table description header (RFC 8878 §4.1.1).

    Returns ``(accuracy_log, probabilities)`` where probabilities are in
    ``-1..=2^AL`` and sum (counting -1 as 1) to ``2^AL``.
    Reference: fse.rs:16-69.
    """
    al = cur.take(4) + 5
    if al > MAX_ACCURACY_LOG:
        raise AccuracyLogTooLarge(al, MAX_ACCURACY_LOG)

    dist: list[int] = []
    remaining = 1 << al

    while remaining > 0 and len(dist) < MAX_SYMBOLS:
        # Adaptive-width read with the small-value threshold trick.
        bits = (remaining + 1).bit_length()  # floor(log2(remaining+1)) + 1
        peeked = cur.peek(bits)
        lower_mask = (1 << (bits - 1)) - 1
        threshold = (1 << bits) - 1 - (remaining + 1)

        if (peeked & lower_mask) < threshold:
            value = cur.take(bits - 1)
        else:
            value = cur.take(bits)
            if value > lower_mask:
                value -= threshold

        proba = value - 1
        remaining -= -proba if proba < 0 else proba
        dist.append(proba)

        if proba == 0:
            # Zero-run escape: 2-bit repeat counts chained while == 3.
            while True:
                zeros = cur.take(2)
                dist.extend([0] * zeros)
                if zeros != 3:
                    break

    if remaining != 0 or len(dist) >= MAX_SYMBOLS:
        raise CorruptedTable(f"distribution sums to {(1 << al) - remaining}, want {1 << al}")
    return al, dist


def build_fse_table(accuracy_log: int, distribution: list[int] | np.ndarray) -> FseTable:
    """Build the decode table from a normalized distribution (RFC 8878 §4.1.1).

    Spread + counter assignment; equivalent to the reference's
    ``from_distribution`` (fse.rs:110-202) — verified against its golden
    unit tests (tests/decoders/fse.rs:19-58).
    """
    if accuracy_log > MAX_ACCURACY_LOG:
        raise AccuracyLogTooLarge(accuracy_log, MAX_ACCURACY_LOG)
    size = 1 << accuracy_log
    dist = np.asarray(distribution, dtype=np.int64)
    if dist.size > MAX_SYMBOLS:
        raise CorruptedTable("too many symbols")
    pos_total = int(dist[dist > 0].sum())
    n_m1 = int((dist == -1).sum())
    if pos_total + n_m1 != size or (dist < -1).any():
        raise CorruptedTable("distribution does not sum to table size")

    symbol = np.zeros(size, dtype=np.uint16)

    # Less-than-one symbols take single states at the table's tail, in
    # increasing symbol order from the last index downward.
    m1_syms = np.flatnonzero(dist == -1)
    high_threshold = size - n_m1
    if n_m1:
        symbol[high_threshold:] = m1_syms[::-1]

    # Spread positive-probability symbols, skipping the reserved tail.
    # The skip rule just advances to the next point of the fixed visit
    # sequence (k*step) & mask, so the occupied positions are the first
    # pos_total sequence values below the threshold — vectorizable.
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos_syms = np.flatnonzero(dist > 0)
    if pos_total:
        # step is odd and size a power of two, so the visit sequence is a
        # permutation of [0, size); exactly high_threshold == pos_total
        # of its values land below the threshold, and the post-spread
        # position provably wraps to 0 (the reference's explicit check).
        visit = (np.arange(size, dtype=np.int64) * step) & mask
        keep = visit[visit < high_threshold]
        symbol[keep] = np.repeat(pos_syms, dist[pos_syms].astype(np.int64))

    # Baseline/nbits: the k-th state of a symbol (in table order) has
    # counter c = prob + k; nbits = AL - floor(log2 c); baseline =
    # (c << nbits) - size.  Grouped computation via a stable argsort.
    order = np.argsort(symbol, kind="stable")
    sorted_syms = symbol[order]
    group_start = np.searchsorted(sorted_syms, sorted_syms)
    probs = np.where(dist > 0, dist, 1).astype(np.int64)
    counters = probs[sorted_syms] + (np.arange(size) - group_start)
    # floor(log2 c) == frexp exponent - 1, exact for c < 2^53.
    floor_log2 = np.frexp(counters.astype(np.float64))[1].astype(np.int64) - 1
    nb_sorted = accuracy_log - floor_log2
    base_sorted = (counters << nb_sorted) - size
    baseline = np.zeros(size, dtype=np.uint16)
    nbits = np.zeros(size, dtype=np.uint8)
    baseline[order] = base_sorted.astype(np.uint16)
    nbits[order] = nb_sorted.astype(np.uint8)

    return FseTable(
        accuracy_log=accuracy_log, symbol=symbol, baseline=baseline, nbits=nbits
    )


def parse_fse_table(cur: ForwardBitCursor) -> FseTable:
    """Parse header then build the decode table (fse.rs:204-208).

    Fast path: the native C parser+builder (csrc/host.c
    zt_fse_parse_build) when the cursor is fresh — this is the hottest
    prepass function (~150 us/call in Python, ~600 calls on the bench
    corpus).  Any corruption returns None and the Python path below
    re-parses to raise the precise typed error."""
    if cur.pos == 0:
        from .. import native

        res = native.fse_parse_build(cur.data) if native.available() else None
        if res is not None:
            al, symbol, baseline, nbits, bits = res
            cur.pos = bits
            return FseTable(
                accuracy_log=al, symbol=symbol, baseline=baseline, nbits=nbits
            )
    al, dist = parse_fse_distribution(cur)
    return build_fse_table(al, dist)


# --- Predefined sequence-code distributions (RFC 8878 §3.1.1.3.2.2) ---------
# Reference: sequences.rs:29-39.

LITERALS_LENGTH_DEFAULT_DIST = [
    4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
    2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1,
]
LITERALS_LENGTH_DEFAULT_AL = 6

OFFSET_DEFAULT_DIST = [
    1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    -1, -1, -1, -1, -1,
]
OFFSET_DEFAULT_AL = 5

MATCH_LENGTH_DEFAULT_DIST = [
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1,
    -1, -1, -1, -1, -1, -1,
]
MATCH_LENGTH_DEFAULT_AL = 6


def _predef(al: int, dist: list[int]) -> FseTable:
    return build_fse_table(al, dist)


PREDEFINED_LL_TABLE = _predef(LITERALS_LENGTH_DEFAULT_AL, LITERALS_LENGTH_DEFAULT_DIST)
PREDEFINED_OF_TABLE = _predef(OFFSET_DEFAULT_AL, OFFSET_DEFAULT_DIST)
PREDEFINED_ML_TABLE = _predef(MATCH_LENGTH_DEFAULT_AL, MATCH_LENGTH_DEFAULT_DIST)
