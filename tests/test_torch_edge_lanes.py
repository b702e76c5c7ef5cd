"""The port's plain entropy forms against the JAX lax.scan forms on lanes
at the edges of the bit reader (``zstd_tpu_torch.testing.edge_lanes``):
a shifted start bit, a base word at the end of the input (clamped
reads), reads below the base word (phantom zeros), one symbol, the class
past a Huffman table, FSE states past the 512 rows a lane addresses, and
a sequence that overflows the narrow field.

The lanes are derived with a numpy seed from the plan of
``torch_inputs.combined()``; the same numpy inputs go through the JAX
functions (op by op under ``jax.disable_jit``: no XLA compilation) and
the port's functions of the same names, and through the kernel wrappers'
plain forms, which ``chip_smoke.py`` and ``test_torch_cuda.py`` hold the
CUDA kernels to.  Whole returned arrays and ok flags, tolerance 0.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zstd_tpu.kernels.entropy2 as jax_e2
from torch_inputs import combined
from zstd_tpu_torch.format.block_table import build_batch_plan
from zstd_tpu_torch.kernels import entropy2 as t_e2
from zstd_tpu_torch.kernels import literals, sequences
from zstd_tpu_torch.testing import edge_lanes

SEED = 3
LIT_CAP, SEQ_CAP = 32, 8  # one step of each JAX scan


def _u32(a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype == np.int32:
        a = a.view(np.uint32)
    return a.astype(np.int64) & 0xFFFFFFFF


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32) if a.dtype == np.uint32 else np.array(a))


def _j(*arrays):
    # JAX arrays: their gathers clamp out-of-range indices, as the engine's do.
    return [jnp.asarray(a) for a in arrays]


@pytest.fixture(scope="module")
def plan():
    return build_batch_plan(combined()[0])


@pytest.fixture(scope="module")
def lit(plan):
    return edge_lanes.literal_edges(plan, np.random.default_rng(SEED), cap=LIT_CAP)


@pytest.fixture(scope="module")
def seq(plan):
    e = edge_lanes.sequence_edges(plan, np.random.default_rng(SEED), cap=SEQ_CAP)
    keep = [i for i, n in enumerate(e.names) if n not in edge_lanes.BEYOND_REFERENCE]
    lane_mat = e.lane_mat[keep]
    counts = np.diff(e.cum.astype(np.int64))[keep]
    cum = np.zeros(len(keep) + 1, dtype=np.int32)
    np.cumsum(counts, out=cum[1:])
    return edge_lanes.EdgeLanes([e.names[i] for i in keep], lane_mat, e.banks, cum, e.rows)


def test_literals_match_jax(plan, lit):
    steps = -(-lit.rows // t_e2.LIT_SYMS_PER_STEP)
    m = lit.lane_mat
    cols = [m[:, c] for c in range(4)]  # base, p0, pend, regen
    tables = [lit.banks[k][m[:, 4]] for k in edge_lanes.HUFF_BANKS]
    with jax.disable_jit():
        want = jax_e2.decode_literals_v2(*_j(plan.words, *cols, *tables), max_steps=steps)
    ys, ok = t_e2._literals_scan(_t(plan.words), *map(_t, cols), *map(_t, tables), steps)
    np.testing.assert_array_equal(ys.numpy(), _u32(want[0]))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want[1]))
    n = int(lit.cum[-1])
    dense, ok = literals.literals_plain(
        _t(plan.words), _t(m), _t(lit.cum), *(_t(lit.banks[k]) for k in edge_lanes.HUFF_BANKS),
        n_dense=n)
    words = t_e2._compact(torch.from_numpy(_u32(want[0])), _t(lit.cum), n).numpy()
    np.testing.assert_array_equal(dense.numpy(), words.astype("<u4").view(np.uint8))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want[1]).astype(np.int32))


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_sequences_match_jax(plan, seq, wide):
    steps = -(-seq.rows // t_e2.SEQ_SLOTS_PER_STEP)
    rows = steps * t_e2.SEQ_SLOTS_PER_STEP
    m = seq.lane_mat
    flat0, flat1, off = (_t(seq.banks[k]) for k in edge_lanes.FSE_BANKS)
    tables = [
        t_e2.fse_bank_rows(flat, off, _t(m[:, c])).to(torch.int32).numpy()
        for c in (7, 8, 9) for flat in (flat0, flat1)
    ]  # ll_p0, ll_p1, of_p0, of_p1, ml_p0, ml_p1
    lanes = [m[:, c] for c in (0, 1, 2, 3)]  # base, p0, pend, nseq
    als = [m[:, c] for c in (10, 11, 12)]
    with jax.disable_jit():
        want = jax_e2.decode_sequences_v2(
            *_j(plan.words, *lanes, *tables, *als), max_steps=steps, wide=wide)
    got = t_e2.decode_sequences_v2(
        _t(plan.words), *map(_t, lanes), *map(_t, tables), *map(_t, als),
        max_steps=steps, wide=wide)
    plain = sequences.sequences_plain(_t(plan.words), _t(m), flat0, flat1, off, rows=rows, wide=wide)
    for g, p, w in zip(got[:-1], plain[:-1], want[:-1]):
        np.testing.assert_array_equal(g.numpy(), _u32(w))
        np.testing.assert_array_equal(_u32(p.numpy()), _u32(np.asarray(w).reshape(rows, -1)))
    np.testing.assert_array_equal(got[-1].numpy(), np.asarray(want[-1]))
    np.testing.assert_array_equal(plain[-1].numpy(), np.asarray(want[-1]).astype(np.int32))


def _lane(e, name) -> int:
    return e.names.index(name)


def test_edge_lanes_reach_their_edges(plan):
    # Longer lanes than the JAX comparisons': the plain forms alone are fast.
    rng = np.random.default_rng(SEED)
    lit = edge_lanes.literal_edges(plan, rng, cap=4 * LIT_CAP)
    seq = edge_lanes.sequence_edges(plan, rng, cap=4 * SEQ_CAP)
    n_words = len(plan.words)
    assert lit.lane_mat[_lane(lit, "clamped_base"), 0] > n_words - 4
    assert seq.lane_mat[_lane(seq, "clamped_base"), 0] > n_words - 4
    assert lit.lane_mat[_lane(lit, "one"), 3] == 1 and seq.lane_mat[_lane(seq, "one"), 3] == 1
    for e, cap in ((lit, 4 * LIT_CAP), (seq, 4 * SEQ_CAP)):
        p0, n = e.lane_mat[_lane(e, "below_base"), 1], e.lane_mat[_lane(e, "below_base"), 3]
        assert p0 < 128 and n == cap  # cap symbols of >= 1 bit (9+ bits a sequence) pass bit 0

    words = _t(plan.words)
    # Past the table: a peek >= 1024 has code length 0, so the position
    # freezes and every later symbol repeats.
    dense, ok = literals.literals_plain(
        words, _t(lit.lane_mat), _t(lit.cum), *(_t(lit.banks[k]) for k in edge_lanes.HUFF_BANKS),
        n_dense=int(lit.cum[-1]))
    j = _lane(lit, "past_table")
    syms = dense[4 * int(lit.cum[j]) : 4 * int(lit.cum[j]) + int(lit.lane_mat[j, 3])]
    assert (syms[-8:] == syms[-1]).all() and not ok[j]

    banks = [_t(seq.banks[k]) for k in edge_lanes.FSE_BANKS]
    pa, ll, _ml, wide_ok = sequences.sequences_plain(words, _t(seq.lane_mat), *banks, rows=seq.rows, wide=True)
    _pa, _db, narrow_ok = sequences.sequences_plain(words, _t(seq.lane_mat), *banks, rows=seq.rows)
    j = _lane(seq, "overflow")
    assert ll[0, j] >= 65536 and not narrow_ok[j]
    # Past the rows: the OF state's zero entry (code 0) gives ofv 1, where
    # the table's code 3 gives 8..15.
    assert ((pa[:, _lane(seq, "past_rows")] & 0x7FFFFFFF) == 1).any()
    # The stall lane: an invalid slot before a valid one (not a prefix).
    valid = (pa[:, _lane(seq, "stall")] < 0).numpy()
    assert valid.any() and not valid.all() and valid[np.argmin(valid):].any()
    assert not wide_ok[_lane(seq, "stall")]
