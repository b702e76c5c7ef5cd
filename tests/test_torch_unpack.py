"""The sequence unpack of the port's engine: ``native.unpack_sequences``
(``csrc/host.c``'s ``zt_unpack_sequences``) held to a numpy reference
(``unpack_numpy``, here), array for array and dtype for dtype, on random
lanes; its bounds check; and inside the engine, on one small multi-frame
input, the lanes ``_finish_sequences`` leaves before the retry held to
the reference applied to the same fetched words, and the output byte
for byte.  No JAX."""

from __future__ import annotations

import functools

import numpy as np
import pytest

from zstd_tpu_torch import native
from zstd_tpu_torch.format.block_table import build_batch_plan
from zstd_tpu_torch.format.frame import iter_frames
from zstd_tpu_torch.runtime.engine import DeviceEngine, sequence_lanes
from zstd_tpu_torch.testing import libzstd
from zstd_tpu_torch.testing.lanes import engine_lanes


def unpack_numpy(words, cumw, nseq, w_ll, w_ml, w_of):
    """``native.unpack_sequences`` in numpy: the fetched words (uint32) of
    lanes with ``nseq`` sequences from word ``cumw[j]`` on, split into flat
    (ll int32, ofv uint32, ml int32), lane after lane."""
    one = np.uint64(1)
    packed = np.concatenate([words, np.zeros(2, np.uint32)]).astype(np.uint64)
    ns = np.asarray(nseq, dtype=np.int64)
    tot = int(ns.sum())
    w_ll, w_ml, w_of = (np.asarray(a, dtype=np.int64) for a in (w_ll, w_ml, w_of))
    w = w_ll + w_ml + w_of
    g = 1 + (w > 32).astype(np.int64)
    starts = np.zeros(len(ns) + 1, dtype=np.int64)
    np.cumsum(ns, out=starts[1:])
    lane_rep = np.repeat(np.arange(len(ns)), ns)
    i_local = np.arange(tot, dtype=np.int64) - starts[lane_rep]
    wi = np.asarray(cumw[: len(ns)], dtype=np.int64)[lane_rep] + i_local * g[lane_rep]
    v = packed[wi] | np.where(g[lane_rep] == 2, packed[wi + 1], np.uint64(0)) << np.uint64(32)
    wr = w[lane_rep].astype(np.uint64)
    v &= (one << wr) - one
    wllr = w_ll[lane_rep].astype(np.uint64)
    wmlr = w_ml[lane_rep].astype(np.uint64)
    vll = (v & ((one << wllr) - one)).astype(np.int32)
    vof = (v >> (wllr + wmlr)).astype(np.uint32)
    vml = ((v >> wllr) & ((one << wmlr) - one)).astype(np.int32)
    return vll, vof, vml


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
    want = unpack_numpy(words, cumw, nseq, w_ll, w_ml, w_of)
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


@pytest.mark.parametrize("level", [3, 19])
def test_engine_unpack_equals_the_numpy_reference(level):
    data, raw = _input(level)
    assert [len(f.blocks) for f in iter_frames(data)] == [1, 1, 3]
    plan = build_batch_plan(data)
    _idx, lane_mat, _cumw = sequence_lanes(plan)
    # Lanes of one word a sequence and of two.
    assert set((lane_mat[:, 4:7].sum(axis=1) > 32).tolist()) == {False, True}
    eng = DeviceEngine(device="cpu")
    fetched = []

    def capture(pending):
        out = DeviceEngine._fetch_pending(eng, pending)
        fetched.extend(out)
        return out

    eng._fetch_pending = capture
    _lit, (pre_outs, _pre_ok), _seq = engine_lanes(eng, plan)
    seq_entries = [e for e in fetched if len(e) == 4]  # a sequences launch's entry holds its widths
    assert len(seq_entries) == 1
    seen = 0
    for idx, cumw, (dense, _ok), cols in seq_entries:
        want = unpack_numpy(dense.numpy().view(np.uint32), cumw, *cols)
        starts = np.concatenate([[0], np.cumsum(cols[0], dtype=np.int64)])
        for j, lane in enumerate(idx):
            got = pre_outs[lane]
            assert [x.dtype for x in got] == [np.int32, np.uint32, np.int32]
            for name, a, b in zip(("ll", "ofv", "ml"), got, want):
                np.testing.assert_array_equal(a, b[starts[j] : starts[j + 1]], err_msg=f"lane {lane} {name}")
            seen += 1
    assert seen == int((plan.seq_nseq > 0).sum()) > 0
    del eng._fetch_pending
    assert eng.decompress(data) == raw
    assert eng.stats.fallback_frames == 0
