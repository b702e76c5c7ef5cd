"""The PyTorch port's plain kernel forms against the JAX reference.

The corpora of ``tests/test_pallas.py`` (level-3 text, level-19 repeat
streams, the stall-heavy frame, the packed-overflow lane) and one frame
of the port's encoder with treeless literals and FSE Repeat mode
(``torch_inputs.encoder_frame``) are planned once as one input, and the
JAX engine's lax.scan path — the form
``tests/test_pallas.py`` holds the Pallas kernels to — decodes that plan
with every ``zstd_tpu.kernels.entropy2`` call recorded
(``torch_inputs.jax_reference``).  The same numpy inputs then go through
the port's counterparts:

* ``zstd_tpu_torch.kernels.entropy2``: ``decode_literals_dense``,
  ``decode_sequences_dense`` and ``decode_sequences_v2(wide=True)`` —
  whole returned arrays, padding lanes and ok flags included;
* the kernel wrappers on CPU tensors (``literals.decode_literals``,
  ``sequences.decode_sequences`` + ``pack_dense``,
  ``compact.compact_lanes``), i.e. the plain forms ``chip_smoke.py``
  holds the CUDA kernels to on the card;
* the port's engine (``device="cpu"``) on the same plan: per-lane
  outputs and ok flags before and after the wide retry, from the JAX plan
  and from its own; and its device LZ77 route frame by frame against the
  JAX engine's ``_assemble_frame_device``.

One module holds every test of that JAX run, so the run (the suite's
largest single cost, ~30-45 s op by op) happens once.  Integer codec:
every comparison is exact (tolerance 0).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import zstd_tpu.kernels.entropy2 as jax_e2
from torch_inputs import combined, encoder_frame, jax_reference
from zstd_tpu_torch.format.block_table import build_batch_plan
from zstd_tpu_torch.kernels import compact, literals, sequences
from zstd_tpu_torch.kernels import entropy2 as t_e2
from zstd_tpu_torch.runtime.engine import DeviceEngine
from zstd_tpu_torch.testing.lanes import assert_lanes_equal


def _t(a) -> torch.Tensor:
    a = np.array(a)  # a writable copy
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _u32(a) -> np.ndarray:
    """An integer array of u32 bit patterns as int64 values."""
    a = np.asarray(a)
    if a.dtype == np.int32:
        a = a.view(np.uint32)
    return a.astype(np.int64) & 0xFFFFFFFF


def _ref_input() -> bytes:
    return combined()[0] + encoder_frame()[0]


@pytest.fixture(scope="module")
def ref():
    return jax_reference(_ref_input())


def _calls(ref, name, **match):
    out = [
        c for c in ref["calls"]
        if c[0] == name and all(c[2].get(k) == v for k, v in match.items())
    ]
    assert out, f"the JAX engine made no {name} call {match}"
    return out


def test_plan_covers_every_corpus(ref):
    plan = ref["plan"]
    assert (plan.lit_regen > 0).sum() >= 3  # level-3 text's Huffman lanes
    assert plan.n_seq_lanes >= 4
    assert not ref["pre"]["seq_ok"].all()  # the overflow lane, pre-retry
    assert ref["seq_ok"].all() and ref["lit_ok"].all()


@pytest.mark.parametrize(
    "name", ["decode_literals_dense", "decode_sequences_dense", "decode_sequences_v2"]
)
def test_plain_form_matches_jax_whole_array(ref, name):
    # decode_sequences_v2 is the wide retry's call (wide=True).
    for _name, args, kw, want in _calls(ref, name):
        got = getattr(t_e2, name)(*map(_t, args), **kw)
        if isinstance(want, tuple):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), _u32(w))
        else:
            np.testing.assert_array_equal(got.numpy(), _u32(want))


def test_literals_wrapper_plain_matches_jax(ref):
    for _n, args, kw, want in _calls(ref, "decode_literals_dense"):
        words, lane_mat, cum, *banks = args
        n_real = int((lane_mat[:, 3] > 0).sum())  # pad lanes (regen 0) last
        assert n_real and (lane_mat[:n_real, 3] > 0).all()
        n_dense = int(cum[n_real])
        dense, ok = literals.decode_literals(
            _t(words), _t(lane_mat[:n_real]), _t(cum[: n_real + 1]), *map(_t, banks),
            n_dense=n_dense,
        )
        assert dense.dtype == torch.uint8 and ok.dtype == torch.int32
        np.testing.assert_array_equal(
            dense.numpy(), want[:n_dense].astype("<u4").view(np.uint8)
        )
        n_out = len(want) - (len(cum) - 1)
        np.testing.assert_array_equal(ok.numpy(), want[n_out : n_out + n_real])


def test_sequences_wrapper_and_pack_match_jax(ref):
    for _n, args, kw, want in _calls(ref, "decode_sequences_dense"):
        words, lane_mat, cumw, flat0, flat1, off = args
        rows = kw["max_steps"] * t_e2.SEQ_SLOTS_PER_STEP
        da, db, ok = sequences.decode_sequences(
            _t(words), _t(lane_mat), _t(flat0), _t(flat1), _t(off), rows=rows
        )
        assert da.dtype == db.dtype == ok.dtype == torch.int32
        n = int(cumw[-1])
        dense, over = sequences.pack_dense(da, db, _t(lane_mat), _t(cumw), n_dense_w=n)
        np.testing.assert_array_equal(_u32(dense.numpy()), _u32(want[:n]))
        lane_ok = (ok != 0) & ~over
        np.testing.assert_array_equal(lane_ok.numpy(), want[kw["n_dense_w"] :].astype(bool))


def test_sequences_wrapper_wide_matches_jax(ref):
    plan = ref["plan"]
    for _n, args, kw, want in _calls(ref, "decode_sequences_v2", wide=True):
        # Rebuild the wrapper's lane columns for the retried lanes from
        # the call's own per-lane arrays (base, p0, pend, nseq) and the
        # plan's table slots, found by matching base and p0.
        base, p0, pend, nseq = args[1:5]
        lanes = [
            int(np.flatnonzero((plan.seq_base == b) & (plan.seq_p0 == p))[0])
            for b, p in zip(base, p0)
        ]
        z = np.zeros(len(lanes), dtype=np.int32)
        lane_mat = np.stack(
            [base, p0, pend, nseq, z, z, z,
             plan.seq_ll_slot[lanes], plan.seq_of_slot[lanes], plan.seq_ml_slot[lanes],
             plan.seq_ll_al[lanes], plan.seq_of_al[lanes], plan.seq_ml_al[lanes]],
            axis=1,
        ).astype(np.int32)
        rows = kw["max_steps"] * t_e2.SEQ_SLOTS_PER_STEP
        got = sequences.decode_sequences(
            _t(plan.words), _t(lane_mat), _t(plan.fse_flat0), _t(plan.fse_flat1),
            _t(plan.fse_off), rows=rows, wide=True,
        )
        L = len(lanes)
        for g, w in zip(got[:-1], want[:-1]):
            np.testing.assert_array_equal(_u32(g.numpy()), _u32(w.reshape(rows, L)))
        np.testing.assert_array_equal(got[-1].numpy(), want[-1].astype(np.int32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compact_wrapper_plain_matches_jax(seed):
    rng = np.random.default_rng(seed)
    rows, L = int(rng.integers(1, 40)), int(rng.integers(1, 12))
    plane = rng.integers(-(2**31), 2**31, (rows, L), dtype=np.int64).astype(np.int32)
    counts = rng.integers(0, rows + 1, L)
    cum = np.zeros(L + 1, dtype=np.int32)
    np.cumsum(counts, out=cum[1:])
    n = int(cum[-1])
    got = compact.compact_lanes(_t(plane), _t(cum), n_dense=n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_e2._compact(plane, cum, n)))
    # Padding past cum[L] follows the reference's clipped gather too.
    got = t_e2._compact(_t(plane), _t(cum), n + 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_e2._compact(plane, cum, n + 7)))


@pytest.mark.parametrize("seed", [0, 1])
def test_pack_words_and_word_plane_match_jax(seed):
    rng = np.random.default_rng(seed)
    R, L = 16, 9
    ofv = rng.integers(1, 1 << 24, (R, L), dtype=np.uint32)
    valid = rng.integers(0, 2, (R, L), dtype=np.uint32)
    pa = (valid << np.uint32(31)) | ofv
    pb = rng.integers(0, 1 << 32, (R, L), dtype=np.uint64).astype(np.uint32)
    w_ll = rng.integers(1, 18, L).astype(np.int32)
    w_ml = rng.integers(1, 18, L).astype(np.int32)
    w_of = np.minimum(rng.integers(1, 30, L), 63 - w_ll - w_ml).astype(np.int32)
    ws = (w_ll, w_ml, w_of)
    jlo, jhi, jover = jax_e2._pack_words(pa, pb, *ws)
    jplane = jax_e2._seq_word_plane(jlo, jhi, *ws)
    lo, hi, over = t_e2._pack_words(_t(pa), _t(pb), *map(_t, ws))
    plane = t_e2._seq_word_plane(lo, hi, *map(_t, ws))
    np.testing.assert_array_equal(lo.numpy(), _u32(jlo))
    np.testing.assert_array_equal(hi.numpy(), _u32(jhi))
    np.testing.assert_array_equal(plane.numpy(), _u32(jplane))
    np.testing.assert_array_equal(over.numpy(), np.asarray(jover))


# -- the port's engine lane by lane against the JAX engine (one shared run
# of the JAX engine, the ``ref`` fixture) ------------------------------------


def test_lanes_match_jax_engine_before_and_after_retry(ref):
    # The JAX plan goes to the port's engine as it is (plan_to_device is
    # duck-typed on the plan's numpy fields).
    plan = ref["plan"]
    eng = DeviceEngine(device="cpu")
    lit_outs, lit_ok, lp = eng._dispatch_literals(plan)
    seq_outs, seq_ok, sp = eng._dispatch_sequences(plan)
    eng._finish_literals(plan, lp, lit_outs, lit_ok)
    eng._finish_sequences(plan, sp, seq_outs, seq_ok)
    assert_lanes_equal(lit_outs, lit_ok, ref["lit_outs"], ref["lit_ok"], "literals")
    assert_lanes_equal(
        seq_outs, seq_ok, ref["pre"]["seq_outs"], ref["pre"]["seq_ok"], "pre-retry sequences"
    )
    assert not seq_ok.all()  # the overflow lane goes to the wide retry
    eng._retry_sequences(plan, seq_outs, seq_ok)
    assert eng.stats.retry_lanes == int((~ref["pre"]["seq_ok"]).sum())
    assert_lanes_equal(seq_outs, seq_ok, ref["seq_outs"], ref["seq_ok"], "sequences")


def test_own_plan_drives_same_lanes(ref):
    # The port's own prepass gives the same lanes as the JAX plan.
    data = _ref_input()
    eng = DeviceEngine(device="cpu")
    (lit_outs, lit_ok), (seq_outs, seq_ok) = eng._run_both(build_batch_plan(data))
    assert_lanes_equal(lit_outs, lit_ok, ref["lit_outs"], ref["lit_ok"], "literals")
    assert_lanes_equal(seq_outs, seq_ok, ref["seq_outs"], ref["seq_ok"], "sequences")


def test_encoder_frame_lanes_match_jax_engine(ref, monkeypatch):
    # The port-made frame (the plan's last) is the JAX encoder's frame
    # byte for byte, holds treeless literals and an FSE Repeat table, and
    # its lanes on the port's engine equal the JAX engine's, all ok.
    import zstd_tpu.encode as jax_encode

    data, payload = encoder_frame()
    monkeypatch.setattr(jax_encode, "MAX_BLOCK", 256)
    assert jax_encode.compress(payload, 3, checksum=True) == data
    plan = ref["plan"]
    fp = plan.frames[-1]
    blocks = [b for b in fp.frame.blocks if b.btype.name == "COMPRESSED"]
    assert any(b.literals.ltype.name == "TREELESS" for b in blocks)
    assert any(m.mode.name == "REPEAT" for b in blocks if b.sequences.num_sequences
               for m in (b.sequences.ll, b.sequences.of, b.sequences.ml))
    lit_lanes = [r.lane for bp in fp.blocks for r in bp.lit_streams]
    seq_lanes = [bp.seq_lane for bp in fp.blocks if bp.seq_lane >= 0]
    assert lit_lanes and len(seq_lanes) == len(blocks)
    (lit_outs, lit_ok), (seq_outs, seq_ok) = DeviceEngine(device="cpu")._run_both(plan)
    for lanes, got, want in (
        (lit_lanes, (lit_outs, lit_ok), (ref["lit_outs"], ref["lit_ok"])),
        (seq_lanes, (seq_outs, seq_ok), (ref["seq_outs"], ref["seq_ok"])),
    ):
        assert all(want[1][lanes])
        assert_lanes_equal([got[0][i] for i in lanes], got[1][lanes],
                           [want[0][i] for i in lanes], want[1][lanes], "encoder frame")


def test_device_lz77_assembly_matches_jax_frame_by_frame(ref):
    # The JAX plan and the JAX engine's lane outputs go to both routes;
    # JAX's pointer doubling runs op by op (no XLA compilation).
    import jax

    from zstd_tpu.runtime.engine import DeviceEngine as JaxEngine

    plan = ref["plan"]
    lanes = (ref["lit_outs"], ref["lit_ok"], ref["seq_outs"], ref["seq_ok"])
    got = DeviceEngine(device="cpu", device_execute=True)._device_frames(plan, *lanes)
    assert sorted(got) == list(range(len(plan.frames)))
    jeng = JaxEngine(device_execute=True)
    try:
        with jax.disable_jit():
            for i, fp in enumerate(plan.frames):
                want = jeng._assemble_frame_device(fp, ref["lit_outs"], ref["seq_outs"])
                assert bytes(got[i][0]) == want, f"frame {i}"
    finally:
        jeng.close()
