"""XXH64 content checksum.

The reference delegates to the ``twox-hash`` crate
(zstd-decompressor/src/frame.rs:240); we implement XXH64
from its public specification.  ZSTD stores the low 32 bits of
XXH64(content, seed=0) as the frame content checksum (RFC 8878 §3.1.1).

A native C implementation is loaded from ``zstd_tpu_torch/native`` when built
(csrc/host.c); this pure-Python version is the fallback and the
oracle for tests.
"""

from __future__ import annotations

_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5
_M = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M


def _round(acc: int, inp: int) -> int:
    acc = (acc + inp * _P2) & _M
    return (_rotl(acc, 31) * _P1) & _M


def _merge_round(h: int, v: int) -> int:
    h ^= _round(0, v)
    return (h * _P1 + _P4) & _M


def xxh64_py(data: bytes | memoryview, seed: int = 0) -> int:
    data = memoryview(data)
    n = len(data)
    pos = 0

    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M
        v2 = (seed + _P2) & _M
        v3 = seed & _M
        v4 = (seed - _P1) & _M
        limit = n - 32
        u64 = int.from_bytes
        while pos <= limit:
            v1 = _round(v1, u64(data[pos : pos + 8], "little"))
            v2 = _round(v2, u64(data[pos + 8 : pos + 16], "little"))
            v3 = _round(v3, u64(data[pos + 16 : pos + 24], "little"))
            v4 = _round(v4, u64(data[pos + 24 : pos + 32], "little"))
            pos += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M
        h = _merge_round(h, v1)
        h = _merge_round(h, v2)
        h = _merge_round(h, v3)
        h = _merge_round(h, v4)
    else:
        h = (seed + _P5) & _M

    h = (h + n) & _M

    while pos + 8 <= n:
        h ^= _round(0, int.from_bytes(data[pos : pos + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M
        pos += 8
    if pos + 4 <= n:
        h ^= (int.from_bytes(data[pos : pos + 4], "little") * _P1) & _M
        h = (_rotl(h, 23) * _P2 + _P3) & _M
        pos += 4
    while pos < n:
        h ^= (data[pos] * _P5) & _M
        h = (_rotl(h, 11) * _P1) & _M
        pos += 1

    h ^= h >> 33
    h = (h * _P2) & _M
    h ^= h >> 29
    h = (h * _P3) & _M
    h ^= h >> 32
    return h


def _load_native():
    try:
        from .. import native

        if native.available():
            return native.xxh64
    except Exception:
        pass
    return None


_native_xxh64 = _load_native()


def xxh64(data, seed: int = 0) -> int:
    """XXH64 digest; uses the native C implementation when available."""
    if _native_xxh64 is not None:
        return _native_xxh64(data, seed)
    return xxh64_py(data, seed)
