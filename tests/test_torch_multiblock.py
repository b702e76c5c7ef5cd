"""Multi-block frames through the port's engine (``device="cpu"``):
frames whose blocks pass repeat offsets and history to each other, with
a window descriptor and a raw block between compressed ones, as 1 MiB
Parquet pages at level 1 are.  The output is held to the raw bytes and
to libzstd; the engine's ``multiblock_frames`` and ``far_match_bytes``
counters to hand counts and to each other on the frame-group pipeline,
the one-plan route (``measure_phases``) and the device LZ77 route; the
``execute`` span to ``assembly``.
With a CUDA card (marked ``cuda``), the same frames on ``cuda:0`` give
the CPU engine's lanes and bytes."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from zstd_tpu_torch import native
from zstd_tpu_torch.format.block import BlockType
from zstd_tpu_torch.format.block_table import build_batch_plan
from zstd_tpu_torch.format.frame import iter_frames
from zstd_tpu_torch.ops.lz77 import execute_sequences
from zstd_tpu_torch.runtime.engine import DeviceEngine
from zstd_tpu_torch.testing import libzstd
from zstd_tpu_torch.testing.lanes import assert_lanes_equal, engine_lanes

BLOCK = 1 << 15  # libzstd's block size at window_log 15


def _text(rng: np.random.Generator, n: int) -> bytes:
    """Seeded text with repeats: lines drawn from a small seeded set, so
    that matches reach back over whole lines and across blocks."""
    words = [bytes(rng.integers(97, 123, int(k), dtype=np.uint8)) for k in rng.integers(2, 9, 64)]
    lines = [b" ".join(words[j] for j in rng.integers(0, 64, 8)) + b"\n" for _ in range(96)]
    out = bytearray()
    while len(out) < n:
        out += lines[int(rng.integers(0, 96))]
        out += b"%d\n" % int(rng.integers(0, 1000))
    return bytes(out[:n])


@functools.cache
def _frames() -> tuple[bytes, list[bytes]]:
    """Two level-1 frames at window_log 15: seeded text, then an
    incompressible seeded run that covers the third block whole (a raw
    block mid-frame), then text again."""
    rng = np.random.default_rng(14)
    raws = [
        _text(rng, 50_000) + rng.integers(0, 256, 60_000, dtype=np.uint8).tobytes() + _text(rng, 30_000)
        for _ in range(2)
    ]
    return b"".join(libzstd.compress(r, 1, window_log=15) for r in raws), raws


@functools.cache
def _decoded(route: str):
    """The frames decoded on one route: (output, stats)."""
    data, _raws = _frames()
    eng = DeviceEngine(device="cpu", device_execute=route == "device_lz77")
    eng.measure_phases = route == "one_plan"
    out = eng.decompress(data)
    return out, eng.stats


def test_frames_are_multiblock_with_a_window_descriptor():
    data, raws = _frames()
    frames = list(iter_frames(data))
    assert len(frames) == len(raws) == 2
    for f, raw in zip(frames, raws):
        kinds = [b.btype for b in f.blocks]
        assert len(kinds) == -(-len(raw) // BLOCK) >= 3
        assert not f.header.single_segment and f.header.window_size == BLOCK
        assert BlockType.RAW in kinds[1:-1] and kinds[0] == BlockType.COMPRESSED
        assert not f.header.checksum_flag


def test_multiblock_frames_decode_bit_exact():
    data, raws = _frames()
    out, st = _decoded("pipelined")
    assert out == b"".join(raws) == libzstd.decompress(data)
    assert st.fallback_frames == 0 and not st.fallback_reasons
    assert st.multiblock_frames == st.frames == 2
    assert st.far_match_bytes > 0
    d = st.as_dict()
    assert (d["multiblock_frames"], d["far_match_bytes"]) == (st.multiblock_frames, st.far_match_bytes)


@pytest.mark.parametrize("route", ["one_plan", "device_lz77"])
def test_every_route_counts_the_same_far_matches(route):
    out, st = _decoded("pipelined")
    got, gst = _decoded(route)
    assert got == out
    assert gst.fallback_frames == 0
    assert (gst.multiblock_frames, gst.far_match_bytes) == (st.multiblock_frames, st.far_match_bytes)


@pytest.mark.parametrize("route", ["pipelined", "one_plan", "device_lz77"])
def test_execute_span_lies_inside_assembly(route):
    _out, st = _decoded(route)
    w = st.wall_s
    assert 0 < w["execute"] <= w["assembly"]


def test_one_block_frames_count_no_far_matches():
    rng = np.random.default_rng(15)
    raw = _text(rng, 1 << 17)
    chunks = [raw[i : i + 65536] for i in range(0, len(raw), 65536)]
    data = b"".join(libzstd.compress(c, 1) for c in chunks)
    assert all(len(f.blocks) == 1 for f in iter_frames(data))
    eng = DeviceEngine(device="cpu")
    assert eng.decompress(data) == raw
    st = eng.stats
    assert (st.frames, st.fallback_frames, st.multiblock_frames, st.far_match_bytes) == (2, 0, 0, 0)


def test_far_match_bytes_counted_by_hand():
    # 10 bytes of earlier blocks, then one block: a match of 4 from offset
    # 5 (source at 8, before the block), one of 3 from offset 2 (inside
    # it), one of 5 from offset 12 (source at 8 again): 9 far bytes.
    prior = b"0123456789"
    lits = b"abc"
    ll = np.array([3, 0, 0], np.int32)
    ofv = np.array([5 + 3, 2 + 3, 12 + 3], np.uint32)
    ml = np.array([4, 3, 5], np.int32)
    py_out = bytearray(prior)
    assert execute_sequences(py_out, list(zip(ll, ofv, ml)), lits, [1, 4, 8]) == 9
    assert len(py_out) == 25
    out = np.zeros(32, np.uint8)
    out[:10] = np.frombuffer(prior, np.uint8)
    rep = np.array([1, 4, 8], np.uint64)
    n, far = native.execute_sequences(out, 10, lits, ll, ofv, ml, rep)
    assert (n, far) == (25, 9) and bytes(out[:n]) == bytes(py_out)


def test_a_fallback_frame_adds_nothing(monkeypatch):
    """A frame whose assembly fails is decoded by the oracle and adds
    nothing to the counters; the other frame still counts."""
    data, raws = _frames()
    _out, good = _decoded("pipelined")  # before the patch
    assemble, calls = native.assemble_group, []

    def fail_first(out, frames, *rest):
        # The group call runs both frames; the first then reads as failed
        # with the executor's null-offset status.
        res, exact = assemble(out, frames, *rest)
        calls.append(len(frames))
        res[0, native.R_STATUS] = 1
        return res, exact

    monkeypatch.setattr(native, "assemble_group", fail_first)
    eng = DeviceEngine(device="cpu")
    assert eng.decompress(data) == b"".join(raws)
    st = eng.stats
    assert st.fallback_frames == 1 and calls == [2]
    assert st.fallback_reasons == ["assembly: ImpossibleValue('sequence execution failed: null offset')"]
    assert st.multiblock_frames == 1
    assert 0 < st.far_match_bytes < good.far_match_bytes


def test_parquet_page_shape_decodes_bit_exact():
    """One frame at the pages-1mib configuration's shape: 1 MiB at level
    1, 8 blocks of 128 KiB and a 512 KiB window."""
    rng = np.random.default_rng(16)
    raw = bytearray(_text(rng, 1 << 20))
    for _ in range(8):  # binary runs between the text, as in a tar of modules
        at = int(rng.integers(0, (1 << 20) - 4096))
        raw[at : at + 4096] = rng.integers(0, 64, 4096, dtype=np.uint8).tobytes()
    raw = bytes(raw)
    data = libzstd.compress(raw, 1)
    (frame,) = iter_frames(data)
    assert len(frame.blocks) == 8 and not frame.header.single_segment
    assert frame.header.window_size == 1 << 19
    eng = DeviceEngine(device="cpu")
    assert eng.decompress(data) == raw
    st = eng.stats
    assert (st.fallback_frames, st.multiblock_frames) == (0, 1) and st.far_match_bytes > 0


@pytest.mark.cuda
def test_card_matches_the_cpu_engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU form)")
    data, raws = _frames()
    plan = build_batch_plan(data)
    card = DeviceEngine(device="cuda:0")
    cpu = DeviceEngine(device="cpu")
    got, want = engine_lanes(card, plan), engine_lanes(cpu, plan)
    for g, w, what in zip(got, want, ("literals", "sequences before the retry", "sequences")):
        assert_lanes_equal(g[0], g[1], w[0], w[1], what)
    assert card.decompress(data) == b"".join(raws)
    _out, st = _decoded("pipelined")
    assert (card.stats.fallback_frames, card.stats.multiblock_frames) == (0, st.multiblock_frames)
    assert card.stats.far_match_bytes == st.far_match_bytes
