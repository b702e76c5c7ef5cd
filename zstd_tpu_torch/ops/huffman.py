"""Huffman weights parsing and flat-table literal decoding.

Replaces the reference's pointer-chasing binary tree walked one bit at a
time (zstd-decompressor/src/decoders/huffman.rs:132-218)
with the canonical flat lookup table: the next ``max_bits`` bits (MSB
first, ≤ 11 per RFC 8878 §4.2.1) index a ``2^max_bits``-entry table of
``(symbol, code_length)``.  One gather per literal, which is the form the
batched device kernels use (4 streams × N blocks wide).

Weights come either directly (4 bits each) or FSE-compressed with two
interleaved tANS states (huffman.rs:80-130, RFC 8878 §4.2.1.2).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.bits import BackwardBitCursor, ForwardBitCursor, ForwardByteCursor
from ..utils.errors import CorruptedHuffman, NotEnoughBits
from .fse import FseTable, parse_fse_table

# RFC 8878 §4.2.1: maximum Huffman code length.
MAX_CODE_LENGTH = 11


@dataclass(frozen=True)
class HuffmanTable:
    """Flat decode table: index by the next ``max_bits`` bits (MSB-first)."""

    max_bits: int
    symbol: np.ndarray  # uint8[2^max_bits]
    nbits: np.ndarray  # uint8[2^max_bits]
    weights: np.ndarray  # uint8[num_symbols] — kept for round-trip/debug

    @property
    def size(self) -> int:
        return 1 << self.max_bits

    def as_packed(self) -> np.ndarray:
        """int16[size] = ``symbol << 4 | nbits`` (nbits ≤ 11)."""
        return (
            self.symbol.astype(np.int16) << 4 | self.nbits.astype(np.int16)
        )


def decode_fse_weights(data: memoryview | bytes) -> list[int]:
    """Decode FSE-compressed Huffman weights (RFC 8878 §4.2.1.2).

    ``data`` is the full compressed-weights payload: an FSE table
    description followed by a backward bitstream driving two interleaved
    tANS states.  Symbols alternate state1/state2; updates stop when the
    next state's bit requirement exceeds the remaining bits, then each
    state's pending symbol is flushed (huffman.rs:108-130,
    alternating.rs:28-62).
    """
    from .. import native

    if native.available():
        res = native.fse_weights(data)
        if res is not None:
            return res
        # Corrupt by the C path's checks: fall through so the Python
        # path raises the precise typed error.
    fwd = ForwardBitCursor(data)
    table = parse_fse_table(fwd)
    bwd = BackwardBitCursor(memoryview(data)[fwd.bytes_read() :])

    al = table.accuracy_log
    states = [bwd.take(al), bwd.take(al)]
    sym = table.symbol
    base = table.baseline
    nb = table.nbits

    weights: list[int] = []
    turn = 0
    # RFC 8878 §4.2.1.2: at most 255 explicit weights (symbol 255 max,
    # last weight implied).  Without this bound a crafted table whose
    # every state has nbits == 0 (one symbol with probability 2^AL)
    # loops forever: the `nb <= len(bwd)` guard is always true at 0.
    while int(nb[states[turn]]) <= len(bwd):
        if len(weights) >= 253:  # +2 flushed below → 255 total max
            raise CorruptedHuffman("more than 255 huffman weights")
        s = states[turn]
        weights.append(int(sym[s]))
        states[turn] = int(base[s]) + bwd.take(int(nb[s]))
        turn ^= 1
    # Flush both pending symbols, keeping alternation order.
    weights.append(int(sym[states[turn]]))
    weights.append(int(sym[states[turn ^ 1]]))
    return weights


def parse_huffman_weights(cur: ForwardByteCursor) -> list[int]:
    """Parse the weights header + payload (huffman.rs:80-106).

    Header byte < 128: that many bytes of FSE-compressed weights.
    Header byte ≥ 128: ``header - 127`` direct 4-bit weights, high nibble
    first, zero-padded to a whole byte.
    """
    header = cur.u8()
    if header < 128:
        return decode_fse_weights(cur.slice(header))
    num = header - 127
    data = cur.slice((num + 1) // 2)
    weights = []
    for b in data:
        weights.append(b >> 4)
        weights.append(b & 0x0F)
    return weights[:num]


def complete_huffman_weights(weights: list[int]) -> tuple[int, np.ndarray]:
    """Complete explicit weights with the implied last one and check them
    (RFC 8878 §4.2.1): ``(max_bits, all_weights uint8[len(weights) + 1])``.

    ``weights`` excludes the last symbol's weight, which is implied: the
    weight-sum ``Σ 2^(w-1)`` is completed to the next power of two
    (huffman.rs:177-203).  Unlike the reference — which truncates the
    completion delta to u8 (huffman.rs:190), corrupting tables whose
    missing weight exceeds 8 — we compute it exactly and validate it is a
    power of two.
    """
    weights = [int(w) for w in weights]
    wsum = sum((1 << (w - 1)) for w in weights if w > 0)
    if wsum == 0:
        raise CorruptedHuffman("all-zero huffman weights")
    # Max_Number_of_Bits = floor(log2(wsum)) + 1 — *strictly* above wsum,
    # even when wsum is an exact power of two (then the implied last
    # symbol carries half the total weight).  The reference rounds up
    # non-strictly (huffman.rs:184-188) and mis-handles that case.
    max_bits = wsum.bit_length()
    rest = (1 << max_bits) - wsum
    if rest == 0 or rest & (rest - 1):
        raise CorruptedHuffman(f"weights leave non-power-of-two remainder {rest}")
    last_weight = rest.bit_length()  # log2(rest) + 1
    all_weights = np.asarray(list(weights) + [last_weight], dtype=np.uint8)
    if all_weights.max() > max_bits or max_bits > MAX_CODE_LENGTH:
        raise CorruptedHuffman(
            f"max code length {max_bits} exceeds {MAX_CODE_LENGTH}"
        )
    return max_bits, all_weights


def build_huffman_table(weights: list[int]) -> HuffmanTable:
    """Build the flat decode table from explicit weights (RFC 8878 §4.2.1),
    completed and checked by :func:`complete_huffman_weights`."""
    max_bits, all_weights = complete_huffman_weights(weights)

    size = 1 << max_bits
    symbol = np.zeros(size, dtype=np.uint8)
    nbits = np.zeros(size, dtype=np.uint8)

    # Canonical layout: symbols sorted by weight ascending (longest codes
    # first), ties by symbol index; a weight-w symbol spans 2^(w-1) cells.
    idx = 0
    for w in range(1, int(all_weights.max()) + 1):
        span = 1 << (w - 1)
        for s in np.flatnonzero(all_weights == w):
            symbol[idx : idx + span] = s
            nbits[idx : idx + span] = max_bits + 1 - w
            idx += span
    if idx != size:
        raise CorruptedHuffman("weights do not tile the code space")

    return HuffmanTable(
        max_bits=max_bits, symbol=symbol, nbits=nbits, weights=all_weights
    )


def parse_huffman_table(cur: ForwardByteCursor) -> HuffmanTable:
    """Parse header + weights and build the flat table (huffman.rs:80-90)."""
    return build_huffman_table(parse_huffman_weights(cur))


def decode_literals_stream(
    table: HuffmanTable, data: memoryview | bytes, out: bytearray
) -> None:
    """Decode one backward Huffman stream to exhaustion (literals.rs:70-81).

    Host reference path; the device path is the batched Pallas kernel.
    Near the stream end the table index is formed from the remaining bits
    left-aligned (zero-padded), matching bit-by-bit tree descent.
    """
    bwd = BackwardBitCursor(data)
    mb = table.max_bits
    sym = table.symbol
    nb = table.nbits
    while not bwd.is_empty:
        idx = bwd.peek_padded(mb)
        n = int(nb[idx])
        if n > len(bwd):
            raise NotEnoughBits(n, len(bwd))
        bwd.pos -= n
        out.append(int(sym[idx]))
