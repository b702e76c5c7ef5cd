"""The repository's batch-decode corpus (``bench.build_corpus``).

Silesia-like and deterministic: natural-language-like text, structured
records, low-entropy ACGT noise and repetitive binary with long matches,
repeated to the target size.  The text part is the bench's generated
word text; the bench uses a bundled text file instead where one is
present, so byte counts can differ from the bench's on such hosts.
"""

from __future__ import annotations

import numpy as np


def build_corpus(target_mb: float = 24.0) -> bytes:
    """Deterministic Silesia-like mixed corpus (decompressed form)."""
    rng = np.random.default_rng(0xC0DEC)
    parts: list[bytes] = []

    words = [bytes(rng.integers(97, 123, int(n))) for n in rng.integers(2, 12, 512)]
    parts.append(b" ".join(words[int(i)] for i in rng.integers(0, 512, 400_000)))

    # Structured records (database-ish).
    rec = b"".join(
        b"id=%08d|name=user%04d|score=%05d;" % (i, i % 7919, (i * 2654435761) % 99999)
        for i in range(60_000)
    )
    parts.append(rec)
    # Low-entropy noise (sampled small alphabet).
    parts.append(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), 2_000_000).tobytes())
    # Repetitive binary with long matches.
    block = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    parts.append(b"".join(block[: int(k)] for k in rng.integers(512, 4096, 2_000)))

    blob = b"".join(parts)
    reps = max(1, int(target_mb * 1e6) // len(blob))
    return (blob * (reps + 1))[: int(target_mb * 1e6)]


def compress_chunks(raw: bytes, level: int, chunk: int = 4 << 20) -> bytes:
    """libzstd frames of ``chunk`` raw bytes each, with checksums — the
    bench's batch-decode input (one frame per 4 MiB at level 3)."""
    from . import libzstd

    return b"".join(
        libzstd.compress(raw[i : i + chunk], level, checksum=True)
        for i in range(0, len(raw), chunk)
    )
