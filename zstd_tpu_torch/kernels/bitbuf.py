"""Backward-bitstream reads for the plain PyTorch kernel forms.

Each lane of a kernel call decodes one entropy stream that lives in
place in the raw input's little-endian u32 words (absolute indexing,
``format/block_table._StreamLocator``): ``base`` is the stream's first
word and bit positions count from bit 0 of that word.  A backward
stream is read from its sentinel bit ``p0`` downward; ``pos`` is the
bit position just above the next unread bit.

The JAX reference carries a 96- or 192-bit MSB-first buffer per lane
and appends one word per refill (``zstd_tpu/kernels/bitbuf.py``).  That
buffer always holds exactly the bits ``[pos - nbits, pos)`` of the
stream, and its reads never outrun it (the never-stall invariants of
``entropy2``), so a read of the top ``n`` bits equals a random-access
read of bits ``[pos - n, pos)``.  These forms, and the CUDA kernels,
read that way: two words around the read position, one funnel shift.
The two contracts of the reference reader hold word by word:

* words below the stream's base word (``wi < 0``) read as zero — the
  phantom zero padding past the stream start;
* every other word index is clamped into the buffer, as the JAX
  gathers clamp.

CPU PyTorch has no shift, add or compare for ``torch.uint32``, so u32
values are held in int64 and masked explicitly; shifts by 32 or more
(or by a negative count, which a u32 subtraction would wrap into one)
give 0, as the reference's ``_shl``/``_shr`` do.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def _out_of_range(n: torch.Tensor) -> torch.Tensor:
    return (n < 0) | (n >= 32)


def _shl(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """(v << n) & M32 for u32 ``v`` held in int64; 0 when n is outside
    [0, 32)."""
    n = torch.as_tensor(n, dtype=torch.int64, device=v.device)
    return torch.where(
        _out_of_range(n), torch.zeros_like(v), (v << n.clamp(0, 31)) & M32
    )


def _shr(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """v >> n for u32 ``v`` held in int64; 0 when n is outside [0, 32)."""
    n = torch.as_tensor(n, dtype=torch.int64, device=v.device)
    return torch.where(_out_of_range(n), torch.zeros_like(v), v >> n.clamp(0, 31))


def as_u32(t: torch.Tensor) -> torch.Tensor:
    """Any integer tensor holding u32 bit patterns (int32 storage on the
    device, int64 here) as int64 values in [0, 2^32)."""
    return t.to(torch.int64) & M32


def to_i32(t: torch.Tensor) -> torch.Tensor:
    """u32 values held in int64 as the int32 tensor with the same bits."""
    return torch.where(t >= 1 << 31, t - (1 << 32), t).to(torch.int32)


def read_word(words: torch.Tensor, base: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """Word ``wi`` of each lane's stream: ``words[base + wi]`` clamped
    into the buffer, and 0 for ``wi < 0``."""
    idx = (base + wi).clamp(0, words.numel() - 1)
    v = as_u32(words[idx])
    return torch.where(wi >= 0, v, torch.zeros_like(v))


def read_bits(
    words: torch.Tensor, base: torch.Tensor, pos: torch.Tensor, n
) -> torch.Tensor:
    """The ``n`` (0..32) bits just below bit ``pos`` of each lane's
    stream, MSB first — the reference's peek/take of the buffer top."""
    mask = (1 << n) - 1 if isinstance(n, int) else (torch.ones_like(n) << n) - 1
    lo_bit = pos - n
    wi = lo_bit >> 5  # arithmetic shift: floor for negative positions
    sh = lo_bit & 31
    lo = read_word(words, base, wi)
    hi = read_word(words, base, wi + 1)
    # hi's bit 31 would land at bit 63 - sh >= 32 >= n of the result, so
    # dropping it loses nothing and keeps the int64 shift from wrapping.
    v = (lo | ((hi & 0x7FFFFFFF) << 32)) >> sh
    return v & mask
