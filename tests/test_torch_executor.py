"""The host sequence executor of ``csrc/host.c`` on the CPU: its strided
fast path and its bounds-exact path, held byte for byte (and in status,
far-match bytes and repeat history) to the port's Python executor
``zstd_tpu_torch.ops.lz77.execute_sequences``, through its one-block
entry ``native.execute_sequences`` and through ``native.assemble_group``
with a one-block frame.  Every output buffer here sits inside a larger
one whose bytes past the output's end are checked untouched."""

from __future__ import annotations

import numpy as np
import pytest

from zstd_tpu_torch import native
from zstd_tpu_torch.ops.lz77 import execute_sequences as py_execute
from zstd_tpu_torch.ops.sequence_codes import INITIAL_REPEAT_OFFSETS, resolve_offset
from zstd_tpu_torch.utils.errors import ZstdError

CANARY = 0xA5
GUARD = 64  # bytes after an output that the executor must leave as they are
WILD = native.SLACK

NULL_OFFSET, LITERALS_OVERRUN, OFFSET_TOO_FAR, OUTPUT_OVERFLOW = 1, 2, 3, 4


def _expected_status(prior: int, n_lit: int, seqs, cap: int, rep: list) -> tuple[int, int]:
    """The executor's order of checks over ``seqs`` (each sequence's
    offset resolved first, then its literals, its output, its offset):
    (status, index of the failing sequence or -1).  Mutates ``rep`` as
    the executor does up to the failure."""
    out_len, lit_pos = prior, 0
    for i, (ll, ofv, ml) in enumerate(seqs):
        try:
            offset = resolve_offset(ofv, ll, rep)
        except ZstdError:
            return NULL_OFFSET, i
        if ll > n_lit - lit_pos:
            return LITERALS_OVERRUN, i
        if out_len + ll + ml > cap:
            return OUTPUT_OVERFLOW, i
        if offset > out_len + ll:
            return OFFSET_TOO_FAR, i
        out_len += ll + ml
        lit_pos += ll
    if out_len + n_lit - lit_pos > cap:
        return OUTPUT_OVERFLOW, len(seqs)
    return 0, -1


def _run_c(prior: bytes, lits: bytes, seqs, cap: int, rep=INITIAL_REPEAT_OFFSETS):
    """``native.execute_sequences`` into an output of ``cap`` bytes that
    holds ``prior``, cut from a larger canary-filled buffer: (status,
    output bytes, far bytes, rep after).  Asserts nothing past ``cap``
    was written."""
    big = np.full(cap + GUARD, CANARY, dtype=np.uint8)
    big[: len(prior)] = np.frombuffer(prior, np.uint8)
    out = big[:cap]
    # The literals likewise end where the executor's input ends.
    lit_big = np.frombuffer(lits + bytes(GUARD), np.uint8)
    lit = lit_big[: len(lits)]
    ll, ofv, ml = (np.asarray([s[k] for s in seqs], dt) for k, dt in enumerate((np.int32, np.uint32, np.int32)))
    r = np.asarray(rep, dtype=np.uint64)
    try:
        n, far = native.execute_sequences(out, len(prior), lit, ll, ofv, ml, r)
        status = 0
    except ValueError as e:
        n, far = -1, -1
        status = next(k for k in range(1, 5) if str(e) == native.execute_status(k))
    assert (big[cap:] == CANARY).all(), "a write past the output's end"
    return status, bytes(out[:n]) if n >= 0 else None, far, r.tolist()


def _run_py(prior: bytes, lits: bytes, seqs, rep=INITIAL_REPEAT_OFFSETS):
    out = bytearray(prior)
    rep = list(rep)
    far = py_execute(out, seqs, lits, rep)
    return bytes(out), far, rep


def _needed(prior: bytes, lits: bytes, seqs) -> int:
    return len(prior) + len(lits) + sum(s[2] for s in seqs)


@pytest.mark.parametrize("slack", [0, WILD])
def test_every_offset_match_and_literal_length(slack):
    """Offsets 1-40 x match lengths 1-70 x literal runs 0-40: one block an
    (offset, run), its 70 sequences of match lengths 1..70 after 64 bytes
    of earlier output, into an output of exactly the bytes needed or with
    32 bytes of slack."""
    rng = np.random.default_rng(170)
    prior = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    for offset in range(1, 41):
        for ll in range(41):
            seqs = [(ll, offset + 3, ml) for ml in range(1, 71)]
            lits = rng.integers(0, 256, 70 * ll + 5, dtype=np.uint8).tobytes()
            cap = _needed(prior, lits, seqs) + slack
            status, got, far, rep = _run_c(prior, lits, seqs, cap)
            want, want_far, want_rep = _run_py(prior, lits, seqs)
            assert status == 0 and got == want, (offset, ll)
            assert (far, rep) == (want_far, want_rep), (offset, ll)


def test_sequences_ending_at_the_output_and_literals_end():
    """Blocks whose last sequences end exactly at the output's last byte
    and take the last literal: byte-equal, no byte written past the end,
    whatever the offset class (1-7, 8-15, 16 and up)."""
    rng = np.random.default_rng(171)
    prior = rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
    for offset in (1, 2, 3, 5, 7, 8, 12, 15, 16, 17, 31, 32, 33, 100, 250):
        for mid_ml in (1, 17, 33, 40):  # strides that overrun their end by 15-31 bytes
            for last_ml in (1, 3, 8, 16, 31, 32, 33, 64):
                seqs = [(7, 250 + 3, 20), (3, offset + 3, mid_ml), (5, offset + 3, last_ml)]
                lits = rng.integers(0, 256, 15, dtype=np.uint8).tobytes()  # no trailing literals
                cap = _needed(prior, lits, seqs)
                status, got, far, rep = _run_c(prior, lits, seqs, cap)
                assert status == 0 and (got, far, rep) == _run_py(prior, lits, seqs)


def test_an_output_short_of_the_trailing_literals():
    """An output 1-40 bytes short of the block: the sequences run, the
    trailing literals overflow, and no stride of the sequences before
    writes past the output's end."""
    rng = np.random.default_rng(176)
    prior = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    for mid_ml in (17, 33, 40):
        seqs = [(3, 20 + 3, mid_ml), (2, 17 + 3, mid_ml), (0, 1, mid_ml)]
        lits = rng.integers(0, 256, 5 + 40, dtype=np.uint8).tobytes()
        for short in range(1, 41):
            cap = _needed(prior, lits, seqs) - short
            assert _run_c(prior, lits, seqs, cap)[0] == OUTPUT_OVERFLOW


def _one_block_group(prior: bytes, lits: bytes, seqs, lit_kind: int, est: int | None = None):
    """``native.assemble_group`` over one frame holding a raw block of
    ``prior`` and a compressed block whose literals are ``lits`` in place
    (``lit_kind`` 0, raw) or one lane's output (2, one Huffman stream),
    its size estimated at ``est`` (default: exact): (status, frame bytes,
    far, exact-path sequences)."""
    keep = [np.frombuffer(prior, np.uint8), np.frombuffer(lits, np.uint8)]
    ll, ofv, ml = (np.asarray([s[k] for s in seqs], dt) for k, dt in enumerate((np.int32, np.uint32, np.int32)))
    addr = lambda a: a.__array_interface__["data"][0]  # noqa: E731
    total = _needed(prior, lits, seqs)
    frames = np.array([[0, 2, 0, total, 0, total if est is None else est]], np.int64)
    lit_row = (addr(keep[1]), len(lits), 0, 0, -1, -1, -1, -1) if lit_kind == 0 else (0, len(lits), 0, 2, 0, -1, -1, -1)
    blocks = np.array([[0, addr(keep[0]), len(prior), 0, 0, -1, -1, -1, -1, -1], [2, *lit_row, 0]], np.int64)
    lit_ptr, lit_len = np.array([addr(keep[1])], np.int64), np.array([len(lits)], np.int64)
    out = bytearray()
    res, exact = native.assemble_group(
        out, frames, blocks, lit_ptr, lit_len, np.ones(1, bool),
        np.array([[addr(ll), addr(ofv), addr(ml)]], np.int64), np.array([len(ll)], np.int64), np.ones(1, bool),
    )
    status, start, n, far, _ = res[0].tolist()
    assert start == 0 and len(out) == (n if status == 0 else 0)
    return status, bytes(out), far, exact


@pytest.mark.parametrize("lit_kind", [0, 2])
def test_exact_path_count_at_the_literals_end(lit_kind):
    """Literals read in place have no slack: a sequence whose literals end
    within 32 bytes of their end takes the bounds-exact path and is
    counted; the group's output has slack, so none is counted for the
    output's end.  Bytes as the Python executor's."""
    rng = np.random.default_rng(172)
    prior = rng.integers(0, 256, 200, dtype=np.uint8).tobytes()
    lls = [int(x) for x in rng.integers(0, 9, 60)]
    seqs = [(ll, int(rng.integers(1, 150)) + 3, int(rng.integers(3, 30))) for ll in lls]
    lits = rng.integers(0, 256, sum(lls) + 3, dtype=np.uint8).tobytes()
    status, got, far, exact = _one_block_group(prior, lits, seqs, lit_kind)
    want, want_far, _rep = _run_py(prior, lits, seqs)
    ends = np.cumsum(lls)
    assert status == 0 and got == want and far == want_far
    assert exact == int((ends + WILD > len(lits)).sum()) > 0


def test_a_frame_past_its_estimate_runs_again_once_it_fits():
    """An estimate below the frame's size stops the call at that frame;
    the buffer grows by what the frame needs and the frame runs again,
    its exact-path sequences counted once."""
    rng = np.random.default_rng(175)
    prior = rng.integers(0, 256, 120, dtype=np.uint8).tobytes()
    lls = [int(x) for x in rng.integers(0, 9, 40)]
    seqs = [(ll, int(rng.integers(1, 100)) + 3, int(rng.integers(3, 30))) for ll in lls]
    lits = rng.integers(0, 256, sum(lls), dtype=np.uint8).tobytes()
    want = _one_block_group(prior, lits, seqs, 0)
    assert want[0] == 0 and want[3] > 0
    for est in (0, 1, 150, len(want[1]) - 1):
        assert _one_block_group(prior, lits, seqs, 0, est=est) == want, est


REPEAT_CASES = [
    # (ll, offset value): ll > 0 takes rep[ofv - 1]; ll == 0 shifts by one,
    # and (0, 3) is rep[0] - 1.
    (5, 1), (5, 2), (5, 3), (0, 1), (0, 2), (0, 3),
]


@pytest.mark.parametrize("ll, ofv", REPEAT_CASES)
def test_each_repeat_offset_case(ll, ofv):
    rng = np.random.default_rng(173)
    prior = rng.integers(0, 256, 100, dtype=np.uint8).tobytes()
    # Fresh offsets 20, 37, 9 fill the history, then the repeat case.
    seqs = [(2, 20 + 3, 5), (1, 37 + 3, 6), (4, 9 + 3, 7), (ll, ofv, 12)]
    lits = rng.integers(0, 256, 7 + ll + 4, dtype=np.uint8).tobytes()
    status, got, far, rep = _run_c(prior, lits, seqs, _needed(prior, lits, seqs))
    assert status == 0 and (got, far, rep) == _run_py(prior, lits, seqs)


def test_rep0_minus_one_reaching_zero_is_a_null_offset():
    seqs = [(2, 1 + 3, 4), (0, 3, 5)]  # rep0 = 1, then ll == 0 and ofv == 3: offset 0
    lits, prior = b"abcd", b"xyz"
    rep = list(INITIAL_REPEAT_OFFSETS)
    assert _expected_status(3, 4, seqs, 100, rep) == (NULL_OFFSET, 1)
    status, got, _far, c_rep = _run_c(prior, lits, seqs, 100)
    assert (status, got, c_rep) == (NULL_OFFSET, None, rep)
    with pytest.raises(ZstdError):
        _run_py(prior, lits, seqs)


@pytest.mark.parametrize(
    "status, seqs, cap",
    [
        (NULL_OFFSET, [(2, 10, 4), (1, 4, 3), (3, 0, 4)], 100),
        (LITERALS_OVERRUN, [(2, 10, 4), (1, 4, 3), (30, 12, 4)], 100),
        (OFFSET_TOO_FAR, [(2, 10, 4), (1, 4, 3), (1, 80, 4)], 100),
        (OUTPUT_OVERFLOW, [(2, 10, 4), (1, 4, 3), (2, 12, 40)], 40),
        (OUTPUT_OVERFLOW, [(2, 10, 4), (1, 4, 3)], 22),  # the trailing literals
    ],
)
def test_each_error_at_its_sequence(status, seqs, cap):
    """Each status at the sequence the order of checks names, with the
    repeat history as it stood there."""
    prior, lits = bytes(range(10)), bytes(range(100, 112))
    rep = list(INITIAL_REPEAT_OFFSETS)
    want_status, _at = _expected_status(len(prior), len(lits), seqs, cap, rep)
    assert want_status == status
    got_status, got, _far, c_rep = _run_c(prior, lits, seqs, cap)
    assert (got_status, got, c_rep) == (status, None, rep)
    if status != OUTPUT_OVERFLOW:  # the Python executor has no capacity
        with pytest.raises(ZstdError):
            _run_py(prior, lits, seqs)


def test_a_frame_of_the_group_fails_with_the_executor_status():
    """Through the group call: the frame's status is the executor's and
    it leaves no bytes."""
    prior, lits = bytes(range(10)), bytes(range(100, 112))
    seqs = [(2, 10, 4), (1, 4, 3), (1, 80, 4)]
    status, got, _far, _exact = _one_block_group(prior, lits, seqs, 0)
    assert (status, got) == (OFFSET_TOO_FAR, b"")


def test_seeded_fuzz_of_short_blocks():
    """A few thousand short random blocks, some invalid: the status the
    order of checks gives; when valid, the Python executor's bytes, far
    bytes and history; never a byte written past the output's end."""
    rng = np.random.default_rng(174)
    counts = np.zeros(5, dtype=int)
    for _ in range(3000):
        prior = rng.integers(0, 256, int(rng.integers(0, 80)), dtype=np.uint8).tobytes()
        nseq = int(rng.integers(0, 12))
        seqs, pos = [], len(prior)
        for _ in range(nseq):
            ll = int(rng.integers(0, 20))
            ml = int(rng.integers(0, 48))
            if rng.random() < 0.35:
                ofv = int(rng.integers(1, 4))  # a repeat code
            else:
                ofv = int(rng.integers(1, max(2, pos + ll + 4))) + 3
            if rng.random() < 0.02:
                ofv = 0
            seqs.append((ll, ofv, ml))
            pos += ll + ml
        n_lit = sum(s[0] for s in seqs) + int(rng.integers(-3, 6))
        lits = rng.integers(0, 256, max(n_lit, 0), dtype=np.uint8).tobytes()
        need = len(prior) + len(lits) + sum(s[2] for s in seqs)
        cap = need + int(rng.choice([0, 0, WILD, 5, -4]))
        cap = max(cap, len(prior))
        rep = list(INITIAL_REPEAT_OFFSETS)
        want_status, _at = _expected_status(len(prior), len(lits), seqs, cap, rep)
        status, got, far, c_rep = _run_c(prior, lits, seqs, cap)
        assert (status, c_rep) == (want_status, rep)
        counts[status] += 1
        if status == 0:
            assert (got, far, c_rep) == _run_py(prior, lits, seqs)
    assert (counts > 0).all(), counts  # every status came up
