"""The comparison that decides ``correct``.

A lossless decoder's reference answer for a request is the raw bytes
the benchmark cut from its content before compressing them: decoding has to give them
back byte for byte.  ``wrong_bytes`` counts the bytes that differ, and
every byte of a length difference, so one flipped bit, a lost frame or
a stale answer each read at least 1.  The limits are 0: the
configuration states bit-exact output, and that every frame is decoded
by the kernels, so no frame may come from the host oracle fallback and
no request may be replanned.
"""

from __future__ import annotations

import numpy as np

LIMITS = {
    "wrong_bytes": 0,
    "fallback_frames": 0,
    "fallback_reasons": 0,
}


def wrong_bytes(out: bytes, expected: bytes) -> int:
    a = np.frombuffer(out, dtype=np.uint8)
    b = np.frombuffer(expected, dtype=np.uint8)
    n = min(a.size, b.size)
    return int(np.count_nonzero(a[:n] != b[:n])) + abs(a.size - b.size)


def checks(readings: dict) -> dict:
    """{name: {"value": reading, "limit": limit}} for each reading taken."""
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in readings.items()}


def passed(checked: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checked.values())
