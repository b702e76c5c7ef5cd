"""The port's CUDA kernels against their plain PyTorch forms, on the card.

Marked ``cuda``: each test skips (with the reason) where no CUDA device
is present, as on a CPU-only host.  On the card:

    python -m pytest tests/test_torch_cuda.py -q

builds the kernels at first use and holds each one, exactly, to its
plain form on the lanes of the level-3 text and combined test corpora
(the literals and sequences kernels also at every frame group of the
combined corpus and on the edge lanes of ``testing.edge_lanes``), and
the compaction kernel at every frame group and at edge shapes, the LZ77
copy-program kernel on the spike's program, on the combined corpus's
frame programs, on the adversarial programs of ``testing.copy_program``
and at positions just below 2^31; then checks the engine end to end, default and
device-LZ77 routes, with every kernel launched.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_inputs import combined, level3_text
from zstd_tpu_torch.format.block_table import build_batch_plan
from zstd_tpu_torch.kernels import compact, literals, lz77, sequences
from zstd_tpu_torch.kernels.bitbuf import to_i32
from zstd_tpu_torch.kernels.entropy2 import _pack_words, _seq_word_plane
from zstd_tpu_torch.runtime import engine
from zstd_tpu_torch.testing import edge_lanes
from zstd_tpu_torch.testing.copy_program import ADVERSARIAL, adversarial_programs, batch_programs, place_high

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU form)")
    return torch.device("cuda", 0)


def _group(data, dev):
    plan = build_batch_plan(data)
    banks = engine.plan_to_device(plan, dev)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)  # noqa: E731
    return plan, banks, up


@pytest.mark.parametrize("build", [level3_text, combined], ids=["level3_text", "combined"])
def test_literals_kernel_matches_plain(dev, build):
    plan, banks, up = _group(build()[0], dev)
    _idx, lane_mat, cum = engine.literal_lanes(plan)
    args = (banks["words"], up(lane_mat), up(cum), banks["limits"], banks["prevs"],
            banks["lengths"], banks["rankb"], banks["ranked"])
    n = int(cum[-1])
    before = literals.decode_literals.launches
    kd, kok = literals.decode_literals(*args, n_dense=n)
    assert literals.decode_literals.launches == before + 1
    pd, pok = literals.literals_plain(*args, n_dense=n)
    assert torch.equal(kd, pd) and torch.equal(kok, pok)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_sequences_and_compact_kernels_match_plain(dev, wide):
    plan, banks, up = _group(combined()[0], dev)
    _idx, lane_mat, cumw = engine.sequence_lanes(plan)
    rows = int(lane_mat[:, 3].max())
    args = (banks["words"], up(lane_mat), banks["fse_flat0"], banks["fse_flat1"], banks["fse_off"])
    k = sequences.decode_sequences(*args, rows=rows, wide=wide)
    p = sequences.sequences_plain(*args, rows=rows, wide=wide)
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    if not wide:
        n = int(cumw[-1])
        dense, over = sequences.pack_dense(k[0], k[1], up(lane_mat), up(cumw), n_dense_w=n)
        ws = [up(lane_mat[:, c]) for c in (4, 5, 6)]
        lo, hi, over_p = _pack_words(k[0], k[1], *ws)
        plane = to_i32(_seq_word_plane(lo, hi, *ws))
        assert torch.equal(over, over_p)
        assert torch.equal(dense, compact.compact_plain(plane, up(cumw), n_dense=n))


def _literals_match_plain(words, lane_mat, cum, huff):
    n = int(cum[-1])
    k = literals.decode_literals(words, lane_mat, cum, *huff, n_dense=n)
    p = literals.literals_plain(words, lane_mat, cum, *huff, n_dense=n)
    assert all(torch.equal(a, b) for a, b in zip(k, p))


def _sequences_match_plain(words, lane_mat, fse, rows):
    for wide in (False, True):
        k = sequences.decode_sequences(words, lane_mat, *fse, rows=rows, wide=wide)
        p = sequences.sequences_plain(words, lane_mat, *fse, rows=rows, wide=wide)
        assert all(torch.equal(a, b) for a, b in zip(k, p))


def _compact_matches_plain(banks, lane_mat, cumw):
    da, db, _ok = sequences.decode_sequences(banks["words"], lane_mat, *(banks[k] for k in edge_lanes.FSE_BANKS),
                                             rows=int(lane_mat[:, 3].max()))
    ws = [lane_mat[:, c].contiguous() for c in (4, 5, 6)]
    lo, hi, _over = _pack_words(da, db, *ws)
    plane = to_i32(_seq_word_plane(lo, hi, *ws))
    n = int(cumw[-1])
    assert torch.equal(compact.compact_lanes(plane, cumw, n_dense=n), compact.compact_plain(plane, cumw, n_dense=n))


def test_lane_kernels_match_plain_on_every_frame_group(dev):
    data = combined()[0]
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)  # noqa: E731
    launches = (literals.decode_literals.launches, sequences.decode_sequences.launches)
    groups = list(engine.frame_groups(data))
    for frames in groups:
        plan = build_batch_plan(data, frames=frames)
        banks = engine.plan_to_device(plan, dev)
        _idx, lit_mat, cum = engine.literal_lanes(plan)
        if len(lit_mat):
            _literals_match_plain(banks["words"], up(lit_mat), up(cum),
                                  [banks[k] for k in edge_lanes.HUFF_BANKS])
        _idx, seq_mat, cumw = engine.sequence_lanes(plan)
        if len(seq_mat):
            _sequences_match_plain(banks["words"], up(seq_mat),
                                   [banks[k] for k in edge_lanes.FSE_BANKS], int(seq_mat[:, 3].max()))
            _compact_matches_plain(banks, up(seq_mat), up(cumw))
    assert len(groups) > 1
    assert literals.decode_literals.launches > launches[0]
    assert sequences.decode_sequences.launches == launches[1] + 3 * len(groups)


@pytest.mark.parametrize("cap", [1, 40, 127, 300])
def test_lane_kernels_match_plain_on_edge_lanes(dev, cap):
    plan = build_batch_plan(combined()[0])
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)  # noqa: E731
    words = up(plan.words)
    lit = edge_lanes.literal_edges(plan, np.random.default_rng(cap), cap=cap)
    _literals_match_plain(words, up(lit.lane_mat), up(lit.cum),
                          [up(lit.banks[k]) for k in edge_lanes.HUFF_BANKS])
    seq = edge_lanes.sequence_edges(plan, np.random.default_rng(cap), cap=cap)
    _sequences_match_plain(words, up(seq.lane_mat), [up(seq.banks[k]) for k in edge_lanes.FSE_BANKS],
                           seq.rows)


def test_engine_on_card_bit_exact_with_every_kernel(dev):
    data, payload = combined()
    fns = (literals.decode_literals, sequences.decode_sequences, compact.compact_lanes)
    for f in fns:
        f.launches = 0
    eng = engine.DeviceEngine()
    assert eng.device.type == "cuda"
    assert eng.decompress(data) == payload
    assert eng.stats.fallback_frames == 0, eng.stats.fallback_reasons
    assert eng.stats.retry_lanes >= 1  # the overflow lane ran the wide kernel
    assert all(f.launches > 0 for f in fns)


def _lz77_inputs(which, dev):
    if which == "spike":
        ops, op_off, buf, _outs = batch_programs([0], out_kb=96)
        return ops.to(dev), op_off.to(dev), buf.to(dev)
    if which in ADVERSARIAL:
        return (t.to(dev) for t in adversarial_programs()[which])
    eng = engine.DeviceEngine(device_execute=True)
    plan = build_batch_plan(combined()[0])
    (lo, lok), (so, sok) = eng._run_both(plan)
    gp, idx, errors = engine.group_program(plan, lo, lok, so, sok)
    assert len(idx) == len(plan.frames) and not errors
    return (torch.from_numpy(a).to(dev) for a in (gp.ops, gp.op_off, gp.buf))


@pytest.mark.parametrize("which", ["spike", "combined", *ADVERSARIAL])
def test_lz77_kernel_matches_plain(dev, which):
    ops, op_off, buf = _lz77_inputs(which, dev)
    before = lz77.exec_ops.launches, lz77.exec_ops.cuda_launches
    got = lz77.exec_ops(ops, op_off, buf.clone())
    rounds, budget, resolved = lz77.last_rounds()
    assert lz77.exec_ops.launches == before[0] + 1
    assert lz77.exec_ops.cuda_launches == before[1] + budget + 3
    assert resolved and 1 <= rounds <= budget
    assert torch.equal(got, lz77.exec_ops_plain(ops, op_off, buf))


def test_lz77_kernel_near_2_31(dev):
    # Positions just below 2^31: the largest buffer the wrapper takes.
    ops, op_off, buf = adversarial_programs()["offset_below_len"]
    want = lz77.exec_ops_plain(ops, op_off, buf)
    hops, big, base = place_high(ops.to(dev), buf.to(dev), (1 << 31) - 1)
    lz77.exec_ops(hops, op_off.to(dev), big)
    assert torch.equal(big[base:].cpu(), want)
    assert not bool(big[:base].any())
    del big
    torch.cuda.empty_cache()


@pytest.mark.parametrize(
    "lanes, rows, counts",
    [(1, 300, "full"), (1, 5, "zero"), (33, 257, "random"), (33, 129, "zero_and_full"),
     (64, 1000, "random"), (40, 128, "full")],
)
def test_compact_kernel_matches_plain_at_edge_shapes(dev, lanes, rows, counts):
    rng = np.random.default_rng(lanes * 1000 + rows)
    plane = torch.from_numpy(rng.integers(-(2**31), 2**31, (rows, lanes)).astype(np.int32)).to(dev)
    n = {"full": np.full(lanes, rows), "zero": np.zeros(lanes, np.int64),
         "random": rng.integers(0, rows + 1, lanes),
         "zero_and_full": np.where(np.arange(lanes) % 2, rows, 0)}[counts]
    cum = torch.from_numpy(np.concatenate([[0], np.cumsum(n)]).astype(np.int32)).to(dev)
    before = compact.compact_lanes.launches
    got = compact.compact_lanes(plane, cum, n_dense=int(n.sum()))
    assert compact.compact_lanes.launches == before + 1
    assert torch.equal(got, compact.compact_plain(plane, cum, n_dense=int(n.sum())))


def test_lz77_empty_programs_launch_nothing(dev):
    # A frame group of raw and RLE blocks only gives programs with no ops.
    buf = torch.arange(16, dtype=torch.uint8, device=dev)
    ops = torch.zeros((3, 0), dtype=torch.int64, device=dev)
    before = lz77.exec_ops.launches
    got = lz77.exec_ops(ops, torch.zeros(3, dtype=torch.int64, device=dev), buf)
    assert got is buf and lz77.exec_ops.launches == before
    assert torch.equal(buf.cpu(), torch.arange(16, dtype=torch.uint8))


def test_device_lz77_route_on_card(dev):
    data, payload = combined()
    lz77.exec_ops.launches = 0
    eng = engine.DeviceEngine(device_execute=True)
    assert eng.decompress(data) == payload
    assert eng.stats.fallback_frames == 0, eng.stats.fallback_reasons
    assert lz77.exec_ops.launches > 0
