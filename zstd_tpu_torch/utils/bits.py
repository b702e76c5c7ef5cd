"""Bit-level cursors over byte buffers (host side).

TPU-first reformulation of the reference's three parsers
(zstd-decompressor/src/parsing.rs:29-259):

* :class:`ForwardByteCursor` — forward byte cursor (parsing.rs:29-112)
* :class:`ForwardBitCursor`  — LSB-first little-endian bit reader
  (parsing.rs:114-189)
* :class:`BackwardBitCursor` — ZSTD backward-stream reader
  (parsing.rs:191-259)

Unlike the reference, the backward cursor performs **no** O(n) reverse
copy (the reference reverses the whole buffer, parsing.rs:208).  A
backward stream over bytes ``b[0..L)`` is modelled as the little-endian
integer ``I = sum(b[i] << 8*i)`` with a bit position ``P`` that starts at
the sentinel (the highest set bit of the last byte, parsing.rs:211-219).
Reading ``n`` bits MSB-first going backwards is then simply::

    P -= n
    value = (I >> P) & ((1 << n) - 1)

computed from at most 9 bytes around ``P``.  The identical shift
formulation is what the vectorized decode paths use on device, with
per-lane ``P`` cursors (see zstd_tpu_torch/kernels/bitbuf.py).
"""

from __future__ import annotations

from .errors import EmptyInput, MissingSentinel, NotEnoughBits, NotEnoughBytes

__all__ = [
    "ForwardByteCursor",
    "ForwardBitCursor",
    "BackwardBitCursor",
    "backward_start_bitpos",
]


class ForwardByteCursor:
    """Forward cursor over a ``bytes``/``memoryview`` buffer.

    Semantics match the reference's ``ForwardByteParser``
    (parsing.rs:29-112), except that ``slice(0)`` returns an empty view
    instead of erroring (the reference's ``EmptySliceError``,
    parsing.rs:65-67, is an implementation quirk its own callers work
    around).
    """

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes | memoryview, pos: int = 0):
        self.data = memoryview(data)
        self.pos = pos

    def __len__(self) -> int:
        return len(self.data) - self.pos

    @property
    def is_empty(self) -> bool:
        return self.pos >= len(self.data)

    def u8(self) -> int:
        if self.pos >= len(self.data):
            raise NotEnoughBytes(1, 0)
        b = self.data[self.pos]
        self.pos += 1
        return b

    def slice(self, n: int) -> memoryview:
        if len(self) < n:
            raise NotEnoughBytes(n, len(self))
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def le_u16(self) -> int:
        return int.from_bytes(self.slice(2), "little")

    def le_u32(self) -> int:
        return int.from_bytes(self.slice(4), "little")


class ForwardBitCursor:
    """LSB-first little-endian bit reader (parsing.rs:114-189).

    Bit ``i`` of the stream is ``(data[i >> 3] >> (i & 7)) & 1``; ``take(n)``
    returns those bits as an integer with the first-read bit least
    significant.  Equivalently, with ``I`` the little-endian integer over
    the buffer: ``take(n) = (I >> pos) & ((1 << n) - 1)``.
    """

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes | memoryview):
        if len(data) == 0:
            raise EmptyInput("forward bitstream over empty buffer")
        self.data = memoryview(data)
        self.pos = 0
        self.nbits = 8 * len(data)

    def __len__(self) -> int:
        return self.nbits - self.pos

    @property
    def is_empty(self) -> bool:
        return self.pos >= self.nbits

    def bytes_read(self) -> int:
        """Bytes consumed, counting a partially-read byte (parsing.rs:121-127)."""
        return (self.pos + 7) >> 3

    def peek(self, n: int) -> int:
        if len(self) < n:
            raise NotEnoughBits(n, len(self))
        lo = self.pos
        word = int.from_bytes(self.data[lo >> 3 : (lo + n + 7) >> 3], "little")
        return (word >> (lo & 7)) & ((1 << n) - 1)

    def take(self, n: int) -> int:
        out = self.peek(n)
        self.pos += n
        return out


def backward_start_bitpos(data: bytes | memoryview) -> int:
    """Bit position of the sentinel in a backward stream.

    The stream's last byte carries a 1-sentinel at its highest set bit;
    everything above is padding (parsing.rs:211-219).  Returns the
    absolute bit index of the sentinel, which is also the number of
    readable payload bits below it.
    """
    if len(data) == 0:
        raise EmptyInput("backward bitstream over empty buffer")
    last = data[-1]
    if last == 0:
        raise MissingSentinel("backward bitstream last byte is zero")
    return 8 * (len(data) - 1) + last.bit_length() - 1


class BackwardBitCursor:
    """ZSTD backward-stream reader (parsing.rs:191-259), copy-free.

    ``take(n)`` reads ``n`` bits MSB-first moving backwards from the
    sentinel: ``pos -= n; value = (I >> pos) & ((1 << n) - 1)`` with ``I``
    the little-endian integer over the buffer.
    """

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes | memoryview):
        self.data = memoryview(data)
        self.pos = backward_start_bitpos(self.data)

    def __len__(self) -> int:
        return self.pos

    @property
    def is_empty(self) -> bool:
        return self.pos <= 0

    def peek(self, n: int) -> int:
        if n > self.pos:
            raise NotEnoughBits(n, self.pos)
        if n == 0:
            return 0
        lo = self.pos - n
        word = int.from_bytes(self.data[lo >> 3 : (lo + n + 7) >> 3], "little")
        return (word >> (lo & 7)) & ((1 << n) - 1)

    def peek_padded(self, n: int) -> int:
        """Peek up to ``n`` bits; if fewer remain, pad with zeros on the right.

        Used by the flat-table Huffman decode near stream end, where the
        table index is formed from the remaining bits left-aligned.
        """
        avail = min(n, self.pos)
        return self.peek(avail) << (n - avail)

    def take(self, n: int) -> int:
        out = self.peek(n)
        self.pos -= n
        return out
