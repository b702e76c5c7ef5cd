"""The port's encoder (``zstd_tpu_torch.encode``, ``compress`` and the
native hash-chain and optimal parses in ``csrc/host.c``) against the JAX
package's (``zstd_tpu.encode``, ``native/zstd_tpu_native.c``).

Five payloads of 8 KiB made from a numpy seed (word text, records,
zeros, random bytes, a repetitive binary) go through both encoders at
levels 0, 1, 3, 6 and 19, with checksums on and off: the frames must be
equal byte for byte.  Every test first asserts that the native library
is built: without it ``encode.compress`` writes raw blocks, which still
round-trip, so a broken build would pass every round trip.  Every frame
then round-trips through libzstd and through the port's engine on the
CPU (the kernels' plain forms) with no oracle fallback.  The port-made
frame with treeless literals and FSE Repeat mode is held lane by lane
to the JAX engine in ``test_torch_entropy.py``, inside its one op-by-op
JAX run."""

from __future__ import annotations

import numpy as np
import pytest

import zstd_tpu.encode as jax_encode
import zstd_tpu.native as jax_native
from zstd_tpu.testing import libzstd
from zstd_tpu_torch import DeviceEngine, compress, native

LEVELS = (0, 1, 3, 6, 19)
SIZE = 8 << 10


def _payloads() -> dict[str, bytes]:
    rng = np.random.default_rng(2024)
    words = [rng.integers(97, 123, int(k), dtype=np.uint8).tobytes() for k in rng.integers(2, 12, 256)]
    text = b" ".join(words[int(i)] for i in rng.integers(0, 256, SIZE // 4))[:SIZE]
    records = b"".join(
        b"id=%08d|name=user%04d|score=%05d;" % (i, i % 7919, (i * 2654435761) % 99999)
        for i in range(SIZE // 36 + 1)
    )[:SIZE]
    page = rng.integers(0, 256, 2048, dtype=np.uint8).tobytes()
    binary = b"".join(page[: int(k)] for k in rng.integers(256, 2048, SIZE // 256))[:SIZE]
    return {
        "text": text,
        "records": records,
        "zeros": bytes(SIZE),
        "random": rng.integers(0, 256, SIZE, dtype=np.uint8).tobytes(),
        "binary": binary,
    }


PAYLOADS = _payloads()


def _native_built() -> None:
    assert native.available(), "the port's native library did not build"
    assert jax_native.available(), "the JAX package's native library did not build"


@pytest.fixture(scope="module")
def frames() -> dict:
    """(payload name, level, checksum) -> the port's frame."""
    _native_built()
    return {
        (name, level, checksum): compress(raw, level, checksum=checksum)
        for name, raw in PAYLOADS.items()
        for level in LEVELS
        for checksum in (False, True)
    }


@pytest.mark.parametrize("checksum", [False, True], ids=["nochecksum", "checksum"])
@pytest.mark.parametrize("level", LEVELS)
def test_compress_equals_jax_byte_for_byte(frames, level, checksum):
    _native_built()
    for name, raw in PAYLOADS.items():
        got = frames[name, level, checksum]
        assert got == jax_encode.compress(raw, level, checksum=checksum), (name, level, checksum)


def test_levels_compress(frames):
    # A compressing level leaves raw blocks behind on compressible input:
    # it is the native parse at work, not the raw-block fallback.
    _native_built()
    for level in LEVELS[1:]:
        for name in ("text", "records", "zeros", "binary"):
            assert len(frames[name, level, False]) < SIZE // 2, (name, level)
    assert len(frames["random", 3, False]) >= SIZE  # incompressible stays raw


@pytest.mark.parametrize("parse", ["lazy", "greedy", "optimal"])
def test_native_parse_equals_jax_on_one_block(parse):
    _native_built()
    src = np.frombuffer(PAYLOADS["text"] + PAYLOADS["binary"], dtype=np.uint8)
    start, end, window = 4096, len(src), 1 << 17
    got, want = [], []
    for mod, out in ((native, got), (jax_native, want)):
        state = mod.new_match_state(chain_log=16)
        # The block sees the bytes before it through the persisted chains,
        # as the encoder's later blocks do.
        mod.lz77_lazy(src, 0, start, window, state, [1, 4, 8], 8, True)
        if parse == "optimal":
            out.extend(mod.lz77_optimal(src, start, end, window, state, [1, 4, 8], 32))
        else:
            out.extend(mod.lz77_lazy(src, start, end, window, state, [1, 4, 8], 8, parse == "lazy"))
    assert len(got[0]) > 100  # sequences were found
    for g, w, field in zip(got, want, ("ll", "off", "ml", "literals")):
        assert g.dtype == w.dtype and np.array_equal(g, w), (parse, field)


@pytest.mark.parametrize("level", LEVELS)
def test_frames_round_trip_through_libzstd(frames, level):
    _native_built()
    for (name, lvl, checksum), comp in frames.items():
        if lvl == level:
            # Room for the payload alone: the default is a 64 MiB buffer.
            got = libzstd.decompress(comp, max_output=len(PAYLOADS[name]))
            assert got == PAYLOADS[name], (name, level, checksum)


def test_frames_round_trip_through_the_engine(frames):
    # Every frame, one after the other in one input: one plan on the CPU.
    _native_built()
    eng = DeviceEngine(device="cpu")
    assert eng.decompress(b"".join(frames.values())) == b"".join(PAYLOADS[k[0]] for k in frames)
    assert eng.stats.fallback_frames == 0, eng.stats.fallback_reasons
    assert eng.stats.frames == len(frames) and eng.stats.kernel_calls > 0
    assert eng.stats.lit_lanes > 0 and eng.stats.seq_lanes > 0
