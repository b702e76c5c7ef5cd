"""The port's device LZ77 route against the JAX package, on the CPU.

Tolerance 0 throughout: the codec is integer-exact.  The port's
per-block source map and pointer doubling are held to JAX's functions
(the latter run op by op under ``jax.disable_jit``), its copy of the LZ77
spike's program to ``tools/lz77_pallas_spike.build_program``, the plain
form of the copy-program kernel to a byte-serial executor, and
``DeviceEngine(device="cpu", device_execute=True)`` to the inputs' bytes
and to the JAX oracle's errors.
"""

from __future__ import annotations

import pathlib
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_inputs import CORPORA, combined
from zstd_tpu.runtime.oracle import decompress as jax_oracle_decompress
from zstd_tpu.testing import libzstd
from zstd_tpu.utils.errors import ZstdError as JaxZstdError
from zstd_tpu_torch.format.block import BlockType
from zstd_tpu_torch.format.literals import LiteralsType
from zstd_tpu_torch.kernels import lz77, lz77_device
from zstd_tpu_torch.ops.sequence_codes import INITIAL_REPEAT_OFFSETS
from zstd_tpu_torch.runtime.engine import DeviceEngine
from zstd_tpu_torch.testing.copy_program import batch_programs, build_program
from zstd_tpu_torch.utils.errors import ImpossibleValue, ZstdError

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"


def _source_map_trials():
    """The 20 random blocks of ``tests/test_kernels.py``'s source-map
    test, drawn in the same order: (seqs, prior output length, literals)."""
    rng = np.random.default_rng(4)
    trials = []
    for _ in range(20):
        nseq = int(rng.integers(1, 20))
        seqs = []
        out_len = int(rng.integers(1, 30))
        rng.integers(0, 256, out_len, dtype=np.uint8)  # the prior output
        lits = rng.integers(0, 256, 400, dtype=np.uint8)
        consumed = 0
        cur_len = out_len
        for _ in range(nseq):
            ll = int(rng.integers(0, 20))
            ml = int(rng.integers(3, 20))
            off = int(rng.integers(1, cur_len + ll + 1))
            seqs.append((ll, off + 3, ml))
            consumed += ll
            cur_len += ll + ml
        trials.append((seqs, out_len, lits[: consumed + int(rng.integers(0, 10))]))
    return trials


TRIALS = _source_map_trials()


@pytest.mark.parametrize("trial", range(len(TRIALS)))
def test_source_map_matches_jax(trial):
    from zstd_tpu.kernels import lz77_device as jax_lz77

    seqs, out_len, lits = TRIALS[trial]
    ll = np.array([s[0] for s in seqs], dtype=np.int64)
    ofv = np.array([s[1] for s in seqs], dtype=np.uint32)
    ml = np.array([s[2] for s in seqs], dtype=np.int64)
    rep_t, rep_j = list(INITIAL_REPEAT_OFFSETS), list(INITIAL_REPEAT_OFFSETS)
    src_t, total_t = lz77_device.build_source_map(ll, ofv, ml, len(lits), rep_t, out_len)
    src_j, total_j = jax_lz77.build_source_map(ll, ofv, ml, len(lits), rep_j, out_len)
    np.testing.assert_array_equal(src_t, src_j)
    assert total_t == total_j and rep_t == rep_j


def _deep_chain() -> tuple[np.ndarray, np.ndarray]:
    # An offset-1 run 4 KiB long: byte j copies byte j - 1 back to one literal.
    src = np.arange(-1, 4096 - 1, dtype=np.int64)
    return src, np.array([0x5A], dtype=np.uint8)


def _random_map() -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(12)
    n, n_lit = 3000, 200
    src = np.array([int(rng.integers(-n_lit, j)) if j else -1 for j in range(n)], dtype=np.int64)
    return src, rng.integers(0, 256, n_lit, dtype=np.uint8)


def _trial_map() -> tuple[np.ndarray, np.ndarray]:
    seqs, _out_len, lits = TRIALS[7]
    ll = np.array([s[0] for s in seqs])
    ofv = np.array([s[1] for s in seqs], dtype=np.uint32)
    ml = np.array([s[2] for s in seqs])
    src, _ = lz77_device.build_source_map(ll, ofv, ml, len(lits), list(INITIAL_REPEAT_OFFSETS), 0)
    return src, lits


@pytest.mark.parametrize("make", [_deep_chain, _random_map, _trial_map], ids=["deep_chain", "random", "block"])
def test_resolve_and_materialize_matches_jax(make):
    import jax
    import jax.numpy as jnp

    from zstd_tpu.kernels import lz77_device as jax_lz77

    src, lits = make()
    rounds = lz77_device.doubling_rounds(len(src))
    got = lz77_device.resolve_and_materialize(torch.from_numpy(src), torch.from_numpy(lits), rounds=rounds)
    with jax.disable_jit():
        want = jax_lz77.resolve_and_materialize(
            jnp.asarray(src.astype(np.int32)), jnp.asarray(lits), rounds=rounds
        )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if make is _deep_chain:
        assert (got.numpy() == 0x5A).all()


def _run_serial(ops: np.ndarray, buf: np.ndarray) -> np.ndarray:
    """Byte-serial executor: each op's bytes in order (the reference)."""
    b = bytearray(buf.tobytes())
    for s, d, n in ops.T.tolist():
        for k in range(n):
            b[d + k] = b[s + k]
    return np.frombuffer(bytes(b), dtype=np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spike_program_copy_and_plain_form(seed):
    sys.path.insert(0, str(TOOLS))
    import lz77_pallas_spike as spike

    got = build_program(out_kb=8, seed=seed)
    want = spike.build_program(out_kb=8, seed=seed)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
        else:
            assert g == w
    ops, op_off, flat, [(out_base, expect)] = batch_programs([seed], out_kb=8)
    assert expect == want[4]
    out = lz77.exec_ops_plain(ops, op_off, flat)
    assert bytes(out[out_base : out_base + len(expect)].numpy()) == expect
    np.testing.assert_array_equal(out.numpy(), _run_serial(ops.numpy(), flat.numpy()))


def test_exec_ops_batch_in_place_equals_serial():
    ops, op_off, buf, outs = batch_programs([3, 4, 5])
    want = _run_serial(ops.numpy(), buf.numpy())
    before = lz77.exec_ops.launches
    got = lz77.exec_ops(ops, op_off, buf)
    assert got is buf and lz77.exec_ops.launches == before  # CPU: plain form, no launch
    np.testing.assert_array_equal(buf.numpy(), want)
    for start, expect in outs:
        assert bytes(buf[start : start + len(expect)].numpy()) == expect


@pytest.mark.parametrize(
    "op, reason", [((5, 5, 1), "src == dst"), ((6, 5, 1), "src > dst"), ((-1, 5, 1), "src < 0"),
                   ((0, 60, 8), "past the buffer"), ((0, 5, -1), "negative length")],
)
def test_exec_ops_rejects_bad_programs(op, reason):
    ops = torch.tensor([[op[0]], [op[1]], [op[2]]], dtype=torch.int64)
    with pytest.raises(ValueError):
        lz77.exec_ops(ops, torch.tensor([0, 1]), torch.zeros(64, dtype=torch.uint8))
    good = torch.tensor([[0], [5], [1]], dtype=torch.int64)
    with pytest.raises(ValueError):  # op ranges must cover the ops
        lz77.exec_ops(good, torch.tensor([0, 2]), torch.zeros(64, dtype=torch.uint8))
    with pytest.raises(ValueError):  # dtype
        lz77.exec_ops(good.int(), torch.tensor([0, 1]), torch.zeros(64, dtype=torch.uint8))


def _seq_block(lits: bytes, ll, ofv, ml):
    bp = SimpleNamespace(kind=BlockType.COMPRESSED, lit_kind=LiteralsType.RAW, lit_raw=lits,
                         lit_regen=len(lits), seq_lane=0)
    seq = (np.asarray(ll, np.int32), np.asarray(ofv, np.uint32), np.asarray(ml, np.int32))
    return SimpleNamespace(blocks=[bp]), [seq]


@pytest.mark.parametrize(
    "ll, ofv, ml, message",
    [([9], [4], [3], "literal runs exceed"), ([2], [0], [3], "null offset"),
     ([2], [3 + 5], [3], "pre-frame")],
    ids=["literal_overrun", "null_offset", "pre_frame"],
)
def test_copy_program_corruption_is_typed(ll, ofv, ml, message):
    fp, seq_outs = _seq_block(b"abcd", ll, ofv, ml)
    with pytest.raises(ImpossibleValue, match=message):
        lz77_device.build_copy_program(fp, [], seq_outs)


def test_copy_program_of_one_block():
    # Literals "abcd"; (ll 2, offset 2, ml 5) then trailing "cd": ab abab a cd
    fp, seq_outs = _seq_block(b"abcd", [2], [2 + 3], [5])
    gp = lz77_device.pack_programs([lz77_device.build_copy_program(fp, [], seq_outs)])
    np.testing.assert_array_equal(gp.ops, [[0, 4, 2], [4, 6, 11], [2, 5, 2]])
    buf = torch.from_numpy(gp.buf)
    lz77.exec_ops(torch.from_numpy(gp.ops), torch.from_numpy(gp.op_off), buf)
    (start, n), = gp.outs
    assert bytes(buf[start : start + n].numpy()) == b"abababacd"


@pytest.mark.parametrize("name", [*CORPORA, "combined"])
def test_device_execute_decodes_exactly_without_launch(name):
    data, payload = combined() if name == "combined" else CORPORA[name]()
    before = lz77.exec_ops.launches
    eng = DeviceEngine(device="cpu", device_execute=True)
    assert eng.decompress(data) == payload
    assert eng.stats.fallback_frames == 0, eng.stats.fallback_reasons
    assert lz77.exec_ops.launches == before


def _outcome(fn, data, err_base):
    try:
        return fn(data)
    except err_base as e:
        return type(e).__name__


def test_device_execute_corrupt_input_raises_like_jax_oracle():
    payload = b"corrupt me " * 2000
    base = libzstd.compress(payload, 6, checksum=True)
    eng = DeviceEngine(device="cpu", device_execute=True)
    errors = 0
    for pos in range(20, len(base), max(1, len(base) // 12)):
        comp = bytearray(base)
        comp[pos] ^= 0x55
        comp = bytes(comp)
        want = _outcome(jax_oracle_decompress, comp, JaxZstdError)
        got = _outcome(eng.decompress, comp, ZstdError)
        assert got == want, pos
        errors += isinstance(want, str)
    assert errors > 0
