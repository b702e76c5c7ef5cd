"""Frame groups through ``DeviceEngine(device="cpu")``'s host assembly, one
``csrc/host.c`` call a group (``native.assemble_group``): frames built
block by block with the port's encoder so that one group holds raw and
RLE blocks, literals-only blocks, raw / RLE / one-stream / four-stream
literals, multi-block frames whose matches reach into earlier blocks, a
frame without a content size, a lane that goes to the wide retry, a
skippable frame and checksum frames.  Bytes are held to libzstd's; the
counters to those kept while each frame was made; a frame that fails,
in the middle of a group, to the oracle fallback at its place."""

from __future__ import annotations

import tracemalloc

import numpy as np
import pytest

from zstd_tpu_torch import native
from zstd_tpu_torch.encode import (
    MAGIC_ZSTD,
    encode_literals_section,
    encode_sequences_section,
    offsets_to_values,
)
from zstd_tpu_torch.runtime import engine as t_engine
from zstd_tpu_torch.runtime.engine import DeviceEngine
from zstd_tpu_torch.testing import libzstd
from zstd_tpu_torch.utils.errors import ChecksumMismatch, ImpossibleValue, ZstdError
from zstd_tpu_torch.utils.xxh64 import xxh64

WILD = native.SLACK
SKIPPABLE = b"\x50\x2a\x4d\x18" + (6).to_bytes(4, "little") + b"inside"


class Built:
    """One frame and what the engine should count for it."""

    def __init__(self, data: bytes, raw: bytes, blocks: int, far: int, exact: int):
        self.data, self.raw, self.blocks, self.far, self.exact = data, raw, blocks, far, exact


def _text(rng, n: int) -> np.ndarray:
    """Letters, so that Huffman literals pay."""
    return rng.integers(97, 123, n, dtype=np.uint8)


def _literals(rng, kind: str, n: int) -> np.ndarray:
    """Literals that ``encode_literals_section`` writes as ``kind``: one
    byte (RLE), fewer than 64 (raw), below 1024 (one stream), else four."""
    if kind == "rle":
        return np.full(n, 0x41, dtype=np.uint8)
    assert (kind == "raw") == (n < 64) and (kind == "one") == (64 <= n < 1024)
    return _text(rng, n)


def frame(rng, specs, *, checksum=False, content_size=True, size_delta=0, header_size=None) -> Built:
    """A frame of ``specs``: ("raw", n), ("rle", n), or ("seq", literal
    kind, literals, sequences, long) with matches drawn over the frame's
    output so far (``long``: some reach before their block) and the
    repeat history carried across blocks; one match of a sequence block
    with ``long`` == "wide" is 70 000 bytes (the narrow kernel's overflow).
    Counts the far-match bytes as the executor defines them and the
    sequences whose literals end within 32 bytes of their block's
    literals read in place (raw or one stream).  ``header_size`` puts
    that content size in an 8-byte field instead of the frame's own."""
    out, body, rep = bytearray(), bytearray(), [1, 4, 8]
    far = exact = 0
    for k, spec in enumerate(specs):
        last = int(k == len(specs) - 1)
        if spec[0] == "raw":
            data = rng.integers(0, 256, spec[1], dtype=np.uint8).tobytes()
            body += (last | (0 << 1) | (len(data) << 3)).to_bytes(3, "little") + data
            out += data
            continue
        if spec[0] == "rle":
            body += (last | (1 << 1) | (spec[1] << 3)).to_bytes(3, "little") + b"z"
            out += b"z" * spec[1]
            continue
        _, kind, n_lit, nseq, reach = spec
        lits = _literals(rng, kind, n_lit)
        cuts = np.sort(rng.choice(n_lit + 1, nseq, replace=True))
        if not out:
            cuts = np.maximum(cuts, 1)  # the frame's first match needs a byte before it
        lls = np.diff(np.concatenate([[0], cuts])).astype(np.int64)
        mls = rng.integers(3, 40, nseq).astype(np.int64)
        if reach == "wide":
            mls[nseq // 2] = 70_000
        block0, lit_pos, offs = len(out), 0, []
        for i in range(nseq):
            out += lits[lit_pos : lit_pos + lls[i]].tobytes()
            lit_pos += int(lls[i])
            pos = len(out) - block0
            if reach and block0 and rng.random() < 0.3:
                o = int(rng.integers(pos + 1, len(out) + 1))  # before the block
            elif rng.random() < 0.3:
                o = int(rng.integers(1, 16))  # an overlapping short offset
            else:
                o = int(rng.integers(1, len(out) + 1))
            o = min(o, len(out))
            offs.append(o)
            if o > pos and block0:
                far += int(mls[i])
            for _ in range(int(mls[i])):
                out.append(out[-o])
        out += lits[lit_pos:].tobytes()
        if kind in ("raw", "one"):
            ends = np.cumsum(lls)
            exact += int((ends + WILD > n_lit).sum())
        ofv = offsets_to_values(lls, np.asarray(offs, dtype=np.int64), rep)
        section = encode_literals_section(lits) + encode_sequences_section(lls, ofv, mls)
        body += (last | (2 << 1) | (len(section) << 3)).to_bytes(3, "little") + section
    size, fcs = len(out) + size_delta, 4
    if header_size is not None:
        size, fcs = header_size, 8
    desc = ((fcs.bit_length() - 1) << 6 if content_size else 0) | (int(checksum) << 2)
    head = MAGIC_ZSTD.to_bytes(4, "little") + bytes([desc, (17 - 10) << 3])
    if content_size:
        head += size.to_bytes(fcs, "little")
    tail = (xxh64(bytes(out)) & 0xFFFFFFFF).to_bytes(4, "little") if checksum else b""
    return Built(head + bytes(body) + tail, bytes(out), len(specs), far, exact)


def _group(seed: int) -> list:
    """The mixed group: a multi-block frame with a checksum, a skippable
    frame, a one-block frame, a frame without a content size, a frame
    whose lane takes the wide retry."""
    rng = np.random.default_rng(seed)
    return [
        frame(rng, [
            ("raw", 3000), ("rle", 5000), ("seq", "rle", 40, 6, False),
            ("seq", "four", 3000, 200, True), ("seq", "one", 500, 50, True),
            ("seq", "raw", 40, 8, True), ("seq", "four", 2000, 0, False),
        ], checksum=True),
        None,
        frame(rng, [("seq", "one", 700, 90, False)]),
        frame(rng, [("seq", "four", 1500, 120, False), ("raw", 200), ("seq", "raw", 50, 20, True)],
              content_size=False),
        frame(rng, [("seq", "four", 1200, 40, False), ("seq", "one", 300, 11, "wide")]),
    ]


def _join(built) -> bytes:
    return b"".join(SKIPPABLE if b is None else b.data for b in built)


def _expect(built, fallback=()) -> dict:
    """The counters of a decode of ``built``, the frames at ``fallback``
    going to the oracle."""
    run = [b for i, b in enumerate(built) if b is not None and i not in fallback]
    return {
        "frames": len(built),
        "blocks": sum(b.blocks for b in built if b is not None),
        "fallback_frames": len(fallback),
        "multiblock_frames": sum(b.blocks > 1 for b in run),
        "far_match_bytes": sum(b.far for b in run),
        "exact_tail_sequences": sum(b.exact for b in run),
    }


def _counters(eng) -> dict:
    d = eng.stats.as_dict()
    return {k: d[k] for k in _expect([])}


@pytest.mark.parametrize("route", ["pipelined", "one_plan", "frame_a_group"])
@pytest.mark.parametrize("include_skippable", [False, True])
def test_mixed_group_decodes_as_libzstd(monkeypatch, route, include_skippable):
    built = _group(40)
    data = _join(built)
    want = b"".join(
        (b"inside" if include_skippable else b"") if b is None else b.raw for b in built
    )
    if route == "frame_a_group":
        monkeypatch.setattr(t_engine, "GROUP_BYTES", 1)
    eng = DeviceEngine(device="cpu")
    eng.measure_phases = route == "one_plan"
    got = eng.decompress(data, include_skippable=include_skippable)
    assert got == want
    if not include_skippable:
        assert got == libzstd.decompress(data)
    assert _counters(eng) == _expect(built)
    st = eng.stats
    assert not st.fallback_reasons and st.retry_lanes == 1
    assert st.far_match_bytes > 0 and st.exact_tail_sequences > 0
    assert 0 < st.wall_s["execute"] <= st.wall_s["assembly"]


def test_one_call_a_group(monkeypatch):
    """The host route makes one ``native.assemble_group`` call a frame
    group, and on this group no frame is spliced again."""
    calls, spliced = [], []
    assemble = native.assemble_group
    monkeypatch.setattr(native, "assemble_group", lambda *a: calls.append(len(a[1])) or assemble(*a))
    monkeypatch.setattr(DeviceEngine, "_splice_frames", lambda *a: spliced.append(1))
    built = _group(41)
    eng = DeviceEngine(device="cpu")
    assert eng.decompress(_join(built)) == libzstd.decompress(_join(built))
    assert calls == [len(built)] and not spliced


def test_checksum_frames_good_and_corrupted():
    rng = np.random.default_rng(42)
    good = [frame(rng, [("seq", "four", 2000, 60, False)], checksum=True) for _ in range(3)]
    data = _join(good)
    eng = DeviceEngine(device="cpu")
    assert eng.decompress(data) == b"".join(b.raw for b in good)
    assert _counters(eng) == _expect(good)
    # The middle frame's stored checksum corrupted: the group call finds
    # it, the oracle re-raises it.
    stored = int.from_bytes(good[1].data[-4:], "little") ^ 0x5A5A
    bad = good[1].data[:-4] + stored.to_bytes(4, "little")
    data = good[0].data + bad + good[2].data
    with pytest.raises(ChecksumMismatch):
        eng.decompress(data)
    computed = xxh64(good[1].raw) & 0xFFFFFFFF
    assert eng.stats.fallback_reasons[0] == f"assembly: {ChecksumMismatch(computed, stored)!r}"
    assert eng.decompress(data, verify_checksum=False) == b"".join(b.raw for b in good)
    assert eng.stats.fallback_frames == 0


@pytest.mark.parametrize("delta", [1, -1])
def test_a_content_size_mismatch(delta):
    """A header whose content size is one byte off: the frame falls back
    with today's message, and the oracle raises the typed error.  At -1
    the frame outgrows the group's estimate first."""
    rng = np.random.default_rng(43)
    a = frame(rng, [("seq", "four", 1500, 50, False)])
    b = frame(rng, [("seq", "one", 600, 30, False), ("rle", 100)], size_delta=delta)
    eng = DeviceEngine(device="cpu")
    with pytest.raises(ZstdError):
        eng.decompress(a.data + b.data)
    n = len(b.raw)
    assert eng.stats.fallback_reasons[0] == f"assembly: {ImpossibleValue(f'frame decoded {n}, header says {n + delta}')!r}"


@pytest.mark.parametrize("size", [1 << 40, (1 << 63) - 1, 1 << 63, (1 << 64) - 1])
def test_a_content_size_past_any_bound(size):
    """A header that claims far more than the frame's blocks can hold
    (an 8-byte field, with a window descriptor): the group's buffer grows
    by the blocks' bound and not by the claim, the frame falls back with
    today's message, and the oracle raises the typed error."""
    rng = np.random.default_rng(45)
    a = frame(rng, [("seq", "four", 1500, 50, False)])
    b = frame(rng, [("seq", "one", 600, 30, False), ("rle", 100)], header_size=size)
    eng = DeviceEngine(device="cpu")
    tracemalloc.start()
    try:
        with pytest.raises(ZstdError):
            eng.decompress(a.data + b.data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 64 << 20
    n = len(b.raw)
    assert eng.stats.fallback_reasons[0] == f"assembly: {ImpossibleValue(f'frame decoded {n}, header says {size}')!r}"


def test_frames_failing_in_the_middle_of_a_group(monkeypatch):
    """Two frames in the middle of the group read as failed after the
    call, one with a lane not ok, one with an executor status: both go to
    the oracle at their place, the rest keep their bytes and counts."""
    built = _group(44)
    data = _join(built)
    assemble = native.assemble_group

    def fail_two(out, frames, *rest):
        res, exact = assemble(out, frames, *rest)
        res[2, native.R_STATUS] = native.LANES
        res[3, native.R_STATUS] = 3
        return res, exact

    monkeypatch.setattr(native, "assemble_group", fail_two)
    eng = DeviceEngine(device="cpu")
    assert eng.decompress(data) == libzstd.decompress(data)
    want = _expect(built, fallback=(2, 3))
    # The call ran every frame; the count is the call's.
    want["exact_tail_sequences"] = _expect(built)["exact_tail_sequences"]
    assert _counters(eng) == want
    assert eng.stats.fallback_reasons == [
        "assembly: ImpossibleValue('sequence execution failed: offset exceeds decoded length')"
    ]
