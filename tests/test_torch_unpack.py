"""The sequence unpack of the port's engine: ``native.unpack_sequences``
(``csrc/host.c``'s ``zt_unpack_sequences``) held to the numpy unpack
that ``_finish_sequences`` keeps for a host without the library, array
for array and dtype for dtype, on random lanes; its bounds check; and
one small multi-frame input decoded with and without the library, lane
by lane (``testing/lanes.engine_lanes``), byte for byte, with the
``seq_unpack_native`` / ``seq_unpack_python`` counters.  No JAX."""

from __future__ import annotations

import functools

import numpy as np
import pytest

from zstd_tpu_torch import native
from zstd_tpu_torch.format.block_table import build_batch_plan
from zstd_tpu_torch.format.frame import iter_frames
from zstd_tpu_torch.runtime.engine import DeviceEngine, sequence_lanes, unpack_sequences_numpy
from zstd_tpu_torch.testing import libzstd
from zstd_tpu_torch.testing.lanes import assert_lanes_equal, engine_lanes


def _lanes(seed: int):
    """Random lanes as ``_seq_pack_meta`` lays them out: nseq, the three
    field widths (w_of clamped so a sequence fits 63 bits), cumw, and a
    word buffer that the last lane's last word ends.  Lane 0 has no
    sequences, lane 1 packs 63 bits (its w_of clamped), lane 2 fits one
    word exactly; the rest mix one- and two-word lanes and empty ones."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(8, 24))
    nseq = rng.integers(0, 3000, n).astype(np.int32)
    nseq[rng.random(n) < 0.2] = 0
    w_ll = rng.integers(0, 18, n).astype(np.int32)
    w_ml = rng.integers(0, 18, n).astype(np.int32)
    w_of = rng.integers(1, 33, n).astype(np.int32)
    nseq[0] = 0
    w_ll[1], w_ml[1], w_of[1], nseq[1] = 17, 17, 32, 500
    w_ll[2], w_ml[2], w_of[2], nseq[2] = 9, 9, 14, 400
    w_of = np.minimum(w_of, 63 - w_ll - w_ml)
    nseq[-1] = max(int(nseq[-1]), 1)
    g = 1 + (w_ll + w_ml + w_of > 32)
    cumw = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(nseq.astype(np.int64) * g, out=cumw[1:])
    words = rng.integers(0, 1 << 32, int(cumw[-1]), dtype=np.uint64).astype(np.uint32)
    return words, cumw, nseq, w_ll, w_ml, w_of


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 2147483725])
def test_native_unpack_matches_numpy(seed):
    words, cumw, nseq, w_ll, w_ml, w_of = _lanes(seed)
    g = 1 + (w_ll + w_ml + w_of > 32)
    assert set(g[nseq > 0].tolist()) == {1, 2}
    assert (w_ll + w_ml + w_of).max() == 63 and (nseq == 0).any()
    got = native.unpack_sequences(words, cumw, nseq, w_ll, w_ml, w_of)
    want = unpack_sequences_numpy(words, cumw, nseq, w_ll, w_ml, w_of)
    for name, a, b in zip(("ll", "ofv", "ml"), got, want):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(got[0]) == int(nseq.sum())
    # The last lane's last word is the buffer's: one word less is refused.
    with pytest.raises(ValueError, match="outside the fetched buffer"):
        native.unpack_sequences(words[:-1], cumw, nseq, w_ll, w_ml, w_of)


def _moved(cumw: np.ndarray, case: str) -> np.ndarray:
    cumw = cumw.copy()
    if case == "past_end":
        cumw[-2] += 1
    elif case == "beyond":
        cumw[-2] = cumw[-1] + 1000
    else:
        cumw[3] = -1
    return cumw


@pytest.mark.parametrize("case", ["past_end", "beyond", "negative"])
def test_out_of_range_cumw_is_refused(case):
    words, cumw, nseq, w_ll, w_ml, w_of = _lanes(7)
    assert nseq[3] > 0 and nseq[-1] > 0
    # A view into a longer buffer: words past the view exist, so only the
    # check keeps the unpack from reading them.
    backing = np.concatenate([words, np.full(4096, 0xFFFFFFFF, np.uint32)])
    with pytest.raises(ValueError, match="outside the fetched buffer"):
        native.unpack_sequences(backing[: words.size], _moved(cumw, case), nseq, w_ll, w_ml, w_of)


def test_bad_widths_and_lengths_are_refused():
    words, cumw, nseq, w_ll, w_ml, w_of = _lanes(8)
    wide = w_of.copy()
    wide[1] += 1  # 64 bits
    with pytest.raises(ValueError, match="widths"):
        native.unpack_sequences(words, cumw, nseq, w_ll, w_ml, wide)
    with pytest.raises(ValueError, match="length"):
        native.unpack_sequences(words, cumw[:3], nseq, w_ll, w_ml, w_of)


def _text(rng: np.random.Generator, n: int) -> bytes:
    words = [bytes(rng.integers(97, 123, int(k), dtype=np.uint8)) for k in rng.integers(2, 9, 64)]
    lines = [b" ".join(words[j] for j in rng.integers(0, 64, 8)) + b"\n" for _ in range(96)]
    out = bytearray()
    while len(out) < n:
        out += lines[int(rng.integers(0, 96))]
        out += b"%d\n" % int(rng.integers(0, 100000))
    return bytes(out[:n])


def _runs(rng: np.random.Generator, n: int) -> bytes:
    """Text, a 1500-byte random run (a long literal run), more text, then
    the run again (a long match from far back): a block whose field
    widths sum past 32, so its lane packs two words a sequence."""
    run = rng.integers(0, 256, 1500, dtype=np.uint8).tobytes()
    return (_text(rng, 1000) + run + _text(rng, n - 4000) + run)[:n]


@functools.cache
def _input(level: int) -> tuple[bytes, bytes]:
    """Two one-block frames and one frame of three 4 KiB blocks
    (window_log 12) at ``level``: (compressed, raw)."""
    rng = np.random.default_rng(level)
    parts = [_runs(rng, 7000), _text(rng, 4000), _text(rng, 4000) + _runs(rng, 6000)]
    data = b"".join(
        [libzstd.compress(parts[0], level), libzstd.compress(parts[1], level),
         libzstd.compress(parts[2], level, window_log=12)]
    )
    return data, b"".join(parts)


@functools.cache
def _decoded(level: int, use_native: bool):
    """(lanes, output, stats) of one engine on the input, with the native
    library or without it."""
    data, _raw = _input(level)
    plan = build_batch_plan(data)
    with pytest.MonkeyPatch.context() as mp:
        if not use_native:
            mp.setattr(native, "available", lambda: False)
        lanes = engine_lanes(DeviceEngine(device="cpu"), plan)
        eng = DeviceEngine(device="cpu")
        out = eng.decompress(data)
    return lanes, out, eng.stats


@pytest.mark.parametrize("level", [3, 19])
def test_engine_unpacks_alike_with_and_without_native(level):
    data, raw = _input(level)
    assert [len(f.blocks) for f in iter_frames(data)] == [1, 1, 3]
    plan = build_batch_plan(data)
    total = int(plan.seq_nseq.sum())
    _idx, lane_mat, _cumw = sequence_lanes(plan)
    # Lanes of one word a sequence and of two.
    assert set((lane_mat[:, 4:7].sum(axis=1) > 32).tolist()) == {False, True}
    (nat_lit, nat_pre, nat_seq), nat_out, nat = _decoded(level, True)
    (py_lit, py_pre, py_seq), py_out, py = _decoded(level, False)
    assert_lanes_equal(nat_lit[0], nat_lit[1], py_lit[0], py_lit[1], "literals")
    assert_lanes_equal(nat_pre[0], nat_pre[1], py_pre[0], py_pre[1], "sequences before the retry")
    assert_lanes_equal(nat_seq[0], nat_seq[1], py_seq[0], py_seq[1], "sequences")
    for a, b in zip(nat_pre[0], py_pre[0]):
        assert (a is None) == (b is None)
        if a is not None:
            assert [x.dtype for x in a] == [y.dtype for y in b] == [np.int32, np.uint32, np.int32]
    assert nat_out == py_out == raw
    assert nat.fallback_frames == py.fallback_frames == 0
    assert (nat.seq_unpack_native, nat.seq_unpack_python) == (total, 0)
    assert (py.seq_unpack_native, py.seq_unpack_python) == (0, total)
    d = nat.as_dict()
    assert (d["seq_unpack_native"], d["seq_unpack_python"]) == (total, 0)
