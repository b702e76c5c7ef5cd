"""Shared inputs for the PyTorch port's tests (``test_torch_*.py``).

The corpora of ``tests/test_pallas.py`` — level-3 text, level-19 repeat
streams, the stall-heavy frame and the packed-overflow lane — and the
JAX engine's lane inputs for one plan, so the port's plain kernel forms
and the JAX functions see identical arrays.
"""

from __future__ import annotations

import numpy as np

from test_pallas import _stall_heavy_frame_small
from zstd_tpu.testing import libzstd


def level3_text() -> tuple[bytes, bytes]:
    payload = (b"the quick brown fox %04d jumps over the lazy dog " * 250) % (
        tuple(range(250))
    )
    data = b"".join(libzstd.compress(payload[i::3], 3, checksum=True) for i in range(3))
    return data, b"".join(payload[i::3] for i in range(3))


def level3_small() -> tuple[bytes, bytes]:
    """Three small level-3 frames (5-7 sequences a lane, two with
    Huffman literals): level3_text's shape at a size whose lanes the JAX
    engine decodes op by op in a few steps."""
    rng = np.random.default_rng(5)
    words = [b"alpha", b"beta", b"gamma", b"delta", b"omega", b"kappa", b"sigma", b"theta"]
    parts, payload = [], b""
    for i in range(3):
        p = b" ".join(words[k] for k in rng.integers(0, 8, 10))
        p += b" %d the quick brown fox jumps over the lazy dog" % i
        parts.append(libzstd.compress(p, 3, checksum=True))
        payload += p
    return b"".join(parts), payload


def overflow_match() -> tuple[bytes, bytes]:
    """One small block of 8 sequences whose 5th copies a 70 000-byte
    match: it overflows the narrow ml field, so its lane goes to the wide
    retry, at a size the JAX engine decodes op by op in a few steps.  Its
    few literals are stored raw, so it adds no literal lane."""
    from zstd_tpu.encode import (
        MAGIC_ZSTD,
        _frame_header,
        encode_literals_section,
        encode_sequences_section,
        offsets_to_values,
    )

    rng = np.random.default_rng(9)
    lls = rng.integers(1, 4, 8).astype(np.int64)
    lits = rng.integers(97, 123, int(lls.sum()), dtype=np.uint8)
    mls = rng.integers(3, 12, 8).astype(np.int64)
    mls[4] = 70_000
    payload, offs, pos = bytearray(), [], 0
    for ll, ml in zip(lls, mls):
        payload += bytes(lits[pos : pos + ll])
        pos += ll
        offs.append(int(rng.integers(1, len(payload) + 1)))
        for _ in range(ml):
            payload.append(payload[-offs[-1]])
    ofv = offsets_to_values(lls, np.asarray(offs), [1, 4, 8])
    body = encode_literals_section(lits) + encode_sequences_section(lls, ofv, mls)
    data = bytes(
        MAGIC_ZSTD.to_bytes(4, "little")
        + _frame_header(len(payload), False, False, 20)
        + (1 | (2 << 1) | (len(body) << 3)).to_bytes(3, "little")
        + bytes(body)
    )
    return data, bytes(payload)


def many_lanes(n_frames: int = 48) -> tuple[bytes, bytes]:
    """Many small level-3 frames, each with Huffman literal streams and a
    sequence stream: enough lanes to split over processes and meshes."""
    rng = np.random.default_rng(11)
    parts, payload = [], b""
    for _ in range(n_frames):
        text = rng.integers(97, 123, int(rng.integers(1_500, 4_000)), dtype=np.uint8).tobytes()
        page = rng.integers(0, 256, 256, dtype=np.uint8)
        reps = b"".join((page + np.uint8(k)).tobytes() for k in rng.integers(0, 3, 8))
        parts.append(libzstd.compress(text + reps, 3, checksum=True))
        payload += text + reps
    return b"".join(parts), payload


def level19_repeat() -> tuple[bytes, bytes]:
    rng = np.random.default_rng(7)
    page = rng.bytes(2048)
    payload = b"".join(
        bytes(bytearray(page)[: 2000 + int(rng.integers(0, 48))]) for _ in range(12)
    )
    return libzstd.compress(payload, 19, checksum=True), payload


def stall_heavy() -> tuple[bytes, bytes]:
    return _stall_heavy_frame_small()


def overflow_lane() -> tuple[bytes, bytes]:
    """One block whose first sequence has a 70 000-byte literal run: it
    overflows the narrow 16-bit ll field, so the lane is flagged and
    re-decoded by the wide retry (test_pallas.test_pallas_overflow_lane_flag_parity)."""
    from zstd_tpu.encode import (
        MAGIC_ZSTD,
        _frame_header,
        encode_literals_section,
        encode_sequences_section,
        offsets_to_values,
    )

    rng = np.random.default_rng(3)
    lits = rng.integers(0, 256, 72_000, dtype=np.uint8)
    lls = np.asarray([70_000, 1_500], dtype=np.int64)
    offs = np.asarray([1_000, 40_000])
    mls = np.asarray([500, 700], dtype=np.int64)
    payload = bytearray(bytes(lits[:70_000]))
    for _ in range(500):
        payload.append(payload[-1_000])
    payload += bytes(lits[70_000:71_500])
    for _ in range(700):
        payload.append(payload[-40_000])
    payload += bytes(lits[71_500:])
    ofv = offsets_to_values(lls, offs, [1, 4, 8])
    body = encode_literals_section(lits) + encode_sequences_section(lls, ofv, mls)
    data = bytes(
        MAGIC_ZSTD.to_bytes(4, "little")
        + _frame_header(len(payload), False, False, 20)
        + (1 | (2 << 1) | (len(body) << 3)).to_bytes(3, "little")
        + bytes(body)
    )
    return data, bytes(payload)


def encoder_frame() -> tuple[bytes, bytes]:
    """One frame of the port's encoder at level 3 with 256-byte blocks
    (its blocks are ``MAX_BLOCK`` long; the format allows any length up
    to it): four blocks of word text from a vocabulary that grows, the
    first with a Huffman table, two after it with treeless literals that
    reuse it, two with an FSE Repeat table.  Its lanes (162-202 literals,
    7-14 sequences) fall in the step tiers and output sizes of the
    combined corpus's lanes in the JAX engine's op-by-op run, so adding
    it there adds no call and no array shape."""
    from zstd_tpu_torch import encode

    rng = np.random.default_rng(24)
    words = [rng.integers(97, 123, int(k), dtype=np.uint8).tobytes() for k in rng.integers(2, 9, 256)]
    picks = [int(rng.integers(0, min(256, 8 + 2 * i))) for i in range(150)]
    payload = b" ".join(words[i] for i in picks)
    block = encode.MAX_BLOCK
    encode.MAX_BLOCK = 256
    try:
        data = encode.compress(payload, 3, checksum=True)
    finally:
        encode.MAX_BLOCK = block
    return data, payload


CORPORA = {
    "level3_text": level3_text,
    "level19_repeat": level19_repeat,
    "stall_heavy": stall_heavy,
    "overflow_lane": overflow_lane,
}


def combined() -> tuple[bytes, bytes]:
    """Every corpus of CORPORA as consecutive frames of one input, so one
    plan (and one set of JAX compilations) covers them all."""
    parts = [build() for build in CORPORA.values()]
    return b"".join(d for d, _ in parts), b"".join(p for _, p in parts)


def jax_reference(data: bytes) -> dict:
    """Run the JAX engine's lax.scan path (``use_pallas=False``, the form
    its CPU tests run) over one plan of ``data`` and record what the port
    is held to: every entropy2 call's arguments and output, and the
    per-lane outputs and ok flags before and after the wide retry.

    The JAX functions run op by op (``jax.disable_jit``): the same
    integer operations as the jitted run, without ~25 s of XLA
    compilation per call shape, which kept the test suite inside its
    time limit."""
    import jax

    import zstd_tpu.kernels.entropy2 as e2
    from zstd_tpu.format.block_table import build_batch_plan
    from zstd_tpu.runtime.engine import DeviceEngine

    plan = build_batch_plan(data)
    calls: list[tuple] = []
    names = ("decode_literals_dense", "decode_sequences_dense", "decode_sequences_v2")
    originals = {n: getattr(e2, n) for n in names}

    def spy(name):
        def call(*args, **kw):
            out = originals[name](*args, **kw)
            host = tuple(np.asarray(a) for a in out) if isinstance(out, tuple) else np.asarray(out)
            calls.append((name, [np.asarray(a) for a in args], dict(kw), host))
            return out

        return call

    eng = DeviceEngine(use_pallas=False)
    pre = {}
    retry = eng._retry_sequences

    def record_pre_retry(plan_, outs, ok):
        pre["seq_outs"], pre["seq_ok"] = list(outs), ok.copy()
        return retry(plan_, outs, ok)

    eng._retry_sequences = record_pre_retry
    for n in names:
        setattr(e2, n, spy(n))
    try:
        with jax.disable_jit():
            (lit_outs, lit_ok), (seq_outs, seq_ok) = eng._run_both(plan)
    finally:
        eng.close()
        for n, f in originals.items():
            setattr(e2, n, f)
    return {
        "plan": plan,
        "calls": calls,
        "pre": pre,
        "lit_outs": lit_outs,
        "lit_ok": lit_ok,
        "seq_outs": seq_outs,
        "seq_ok": seq_ok,
    }


def skippable_groups() -> tuple[bytes, bytes, bytes]:
    """Multi-frame input with skippable frames between frames: (data,
    payload without skippables, payload with skippable contents)."""
    rng = np.random.default_rng(21)
    skip = b"\x53\x2a\x4d\x18" + (4).to_bytes(4, "little") + b"SKIP"
    parts, plain, with_skip = [], bytearray(), bytearray()
    for i in range(6):
        blob = rng.integers(97, 123, 6_000, dtype=np.uint8).tobytes()
        parts.append(libzstd.compress(blob, 1 + 2 * (i % 2), checksum=True))
        plain += blob
        with_skip += blob
        if i % 2 == 0:
            parts.append(skip)
            with_skip += b"SKIP"
    return b"".join(parts), bytes(plain), bytes(with_skip)
