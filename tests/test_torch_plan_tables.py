"""The batch plan's entropy tables, packed by the host C library
(``zt_huffman_canonical``, ``zt_fse_pack``) and by the Python packers
that run where it refuses a table, equal the JAX package's packs of its
flat decode tables; a plan whose every table host.c refuses is the same
plan, corrupt inputs included; and valid tables never reach the Python
packers.

Huffman tables are packed straight from their weights: no flat
``2^max_bits`` table is built on the plan route.  The JAX package's
``pack_huffman_canonical(build_huffman_table(...))`` is the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import torch_inputs
from zstd_tpu.format import block_table as jax_bt
from zstd_tpu.ops.huffman import build_huffman_table as jax_build_huffman
from zstd_tpu.ops.huffman import parse_huffman_table as jax_parse_huffman
from zstd_tpu.testing import libzstd
from zstd_tpu.utils.bits import ForwardByteCursor as JaxCursor
from zstd_tpu.utils.errors import ZstdError as JaxZstdError
from zstd_tpu_torch import native
from zstd_tpu_torch.format import block_table as bt
from zstd_tpu_torch.format.frame import SkippableFrame, iter_frames
from zstd_tpu_torch.format.literals import LiteralsType
from zstd_tpu_torch.format.sequences import SeqMode
from zstd_tpu_torch.ops import fse as fse_ops
from zstd_tpu_torch.ops.huffman import complete_huffman_weights
from zstd_tpu_torch.ops.sequence_codes import MAX_LL_CODE, MAX_ML_CODE, MAX_OFFSET_CODE
from zstd_tpu_torch.runtime.engine import DeviceEngine
from zstd_tpu_torch.utils.errors import ZstdError

pytestmark = pytest.mark.skipif(not native.available(), reason="host C library did not build")

KINDS = ("ll", "of", "ml")
MAX_CODE = {"ll": MAX_LL_CODE, "of": MAX_OFFSET_CODE, "ml": MAX_ML_CODE}


def varied_tables() -> bytes:
    """Frames over skewed alphabets of 2 to 256 symbols at levels 1, 3 and
    19 (FSE-compressed weights, many code lengths), and over the byte
    values 0 to k - 1 for k <= 16 (direct 4-bit weights: libzstd writes
    the direct form when the largest symbol is small)."""
    rng = np.random.default_rng(13)
    parts = []
    for k in (2, 3, 4, 6, 8, 12, 16, 24, 40, 64, 100, 160, 256):
        p = rng.dirichlet(np.full(k, 0.5))
        alphabet = rng.choice(256, size=k, replace=False).astype(np.uint8)
        for level in (1, 3, 19):
            text = alphabet[rng.choice(k, size=6000, p=p)].tobytes()
            parts.append(libzstd.compress(text, level, checksum=False))
        if k <= 16:
            text = rng.choice(k, size=3000, p=p).astype(np.uint8).tobytes()
            parts.append(libzstd.compress(text, 3, checksum=False))
    return b"".join(parts)


CORPORA = {
    **{name: (lambda build=build: build()[0]) for name, build in torch_inputs.CORPORA.items()},
    "many_lanes": lambda: torch_inputs.many_lanes()[0],
    "encoder_frame": lambda: torch_inputs.encoder_frame()[0],
    "skippables": lambda: torch_inputs.skippable_groups()[0],
    "varied_tables": varied_tables,
}


def _blocks(data):
    for frame in iter_frames(data):
        if not isinstance(frame, SkippableFrame):
            yield from frame.blocks


def huffman_payloads(data) -> list[bytes]:
    return [
        bytes(b.literals.huffman_payload)
        for b in _blocks(data)
        if getattr(b, "literals", None) is not None
        and b.literals.ltype == LiteralsType.COMPRESSED
    ]


def fse_tables(data) -> list[tuple[str, fse_ops.FseTable]]:
    out = []
    for b in _blocks(data):
        seq = getattr(b, "sequences", None)
        if seq is None or seq.num_sequences == 0:
            continue
        for kind, desc in zip(KINDS, (seq.ll, seq.of, seq.ml)):
            if desc.mode == SeqMode.FSE:
                out.append((kind, desc.fse_table))
    return out


@pytest.fixture(scope="module")
def corpora() -> dict[str, bytes]:
    return {name: build() for name, build in CORPORA.items()}


def direct_payload(weights: list[int]) -> bytes:
    """A Huffman table payload in the direct form: header 127 + n, then
    4-bit weights, high nibble first."""
    nib = list(weights) + [0] * (len(weights) & 1)
    return bytes([127 + len(weights)]) + bytes(a << 4 | b for a, b in zip(nib[::2], nib[1::2]))


def reference_canon(payload: bytes) -> tuple[np.ndarray, np.ndarray]:
    """The JAX package's pack of its flat table, as one canon row."""
    table = jax_parse_huffman(JaxCursor(payload))
    packed = jax_bt.pack_huffman_canonical(table)
    return np.concatenate([packed[name] for name, _ in bt.CANON_FIELDS]), table.weights


def assert_canon_paths_agree(payload: bytes) -> None:
    want, want_w = reference_canon(payload)
    got, got_w = native.huffman_canonical(payload)
    py, py_w = bt.huffman_canonical_python(payload)
    for arr, w in ((got, got_w), (py, py_w)):
        assert arr.dtype == np.int32 and w.dtype == np.uint8
        np.testing.assert_array_equal(arr, want)
        np.testing.assert_array_equal(w, want_w)
        assert w.tobytes() == want_w.tobytes()
    split = bt.split_canon(got)
    table = jax_build_huffman(list(want_w[:-1]))
    for name, arr in jax_bt.pack_huffman_canonical(table).items():
        np.testing.assert_array_equal(split[name], arr, err_msg=name)


def test_corpora_cover_both_weight_forms(corpora):
    payloads = [p for data in corpora.values() for p in huffman_payloads(data)]
    assert sum(p[0] < 128 for p in payloads) >= 90
    assert sum(p[0] >= 128 for p in payloads) >= 6
    max_bits = {int(jax_parse_huffman(JaxCursor(p)).max_bits) for p in payloads}
    assert max_bits == set(range(1, 12))
    assert sum(len(fse_tables(data)) for data in corpora.values()) >= 90


@pytest.mark.parametrize("name", list(CORPORA))
def test_huffman_canon_equals_flat_table_pack(corpora, name):
    for payload in huffman_payloads(corpora[name]):
        assert_canon_paths_agree(payload)


@pytest.mark.parametrize(
    "weights",
    [
        [1],  # one explicit symbol: two 1-bit codes
        [0, 0, 4],  # one symbol, the implied one its twin
        [1, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10],  # 11-bit codes: sum 1024 -> max_bits 11
        [11],  # the largest weight: a remainder of 1024
        [1, 1],  # an exact power-of-two sum
        [2, 1, 0, 1, 3],  # direct weights with a zero
        [1] * 127,  # the most direct weights: 128 7-bit codes
        [0] * 20 + [2] * 60 + [1] * 8,  # a remainder of half the code space
        [0, 0, 0, 1, 1],  # leading zero weights
    ],
)
def test_huffman_canon_hand_made_weights(weights):
    assert_canon_paths_agree(direct_payload(weights))


def _refuse(*args):
    """host.c's answer to a table it refuses (a corrupt one)."""
    return None


def _raised(fn, *args) -> tuple[str, str]:
    """The name and message of the typed error ``fn`` raises (the port's
    and the JAX package's error classes are distinct, alike by name)."""
    try:
        fn(*args)
    except (ZstdError, JaxZstdError) as e:
        return type(e).__name__, str(e)
    raise AssertionError("no error raised")


@pytest.mark.parametrize(
    "payload",
    [
        direct_payload([0, 0, 0]),  # all-zero weights
        direct_payload([2, 2, 1]),  # remainder 3, not a power of two
        direct_payload([12]),  # a weight above 11
        direct_payload([15, 15]),  # max_bits 16
        direct_payload([11, 11, 11]),  # max_bits 12 on a power-of-two remainder
        bytes([0x04, 0xF0, 0x03, 0xFF, 0x07]),  # FSE weights that never stop
        bytes([0x85, 0x11]),  # direct weights cut short
        bytes([0x05, 0x30]),  # FSE weights cut short
        bytes([0x02, 0x30, 0x00]),  # FSE weights without a sentinel
    ],
)
def test_huffman_rejected_weights_same_error_both_paths(payload, monkeypatch):
    assert native.huffman_canonical(payload) is None
    want = _raised(jax_parse_huffman, JaxCursor(payload))
    got_native = _raised(bt._Builder(payload).add_huffman, payload)
    monkeypatch.setattr(native, "huffman_canonical", _refuse)
    assert _raised(bt._Builder(payload).add_huffman, payload) == got_native == want


def test_huffman_all_zero_weights_message():
    want = _raised(jax_build_huffman, [])
    assert _raised(complete_huffman_weights, []) == want
    assert want[1] == "all-zero huffman weights"


def _jax_bank_slot(bank, slot):
    return bank.p0s[slot], bank.p1s[slot], bank.wbits[slot]


def _assert_pack(res, want):
    p0, p1, w = res
    assert p0.dtype == p1.dtype == np.int32
    np.testing.assert_array_equal(p0, want[0])
    np.testing.assert_array_equal(p1, want[1])
    assert p0.tobytes() == want[0].tobytes() and p1.tobytes() == want[1].tobytes()
    assert w == want[2]


@pytest.mark.parametrize("kind", KINDS)
def test_fse_pack_predefined(kind):
    table = {"ll": fse_ops.PREDEFINED_LL_TABLE, "of": fse_ops.PREDEFINED_OF_TABLE,
             "ml": fse_ops.PREDEFINED_ML_TABLE}[kind]
    jax_bank = jax_bt._FseBank()
    want = _jax_bank_slot(jax_bank, jax_bank.predefined(kind))
    _assert_pack(native.fse_pack(table.symbol, table.baseline, table.nbits, kind), want)
    p0, p1 = bt.pack_fse_planes(table.symbol, table.baseline, table.nbits, kind)
    _assert_pack((p0, p1, bt.value_bits(p1, kind)), want)


@pytest.mark.parametrize("kind", KINDS)
def test_fse_pack_every_rle_byte(kind, monkeypatch):
    one = np.zeros(1, dtype=np.uint16)
    for byte in range(256):
        symbol = np.asarray([byte], dtype=np.uint16)
        res = native.fse_pack(symbol, one, one.astype(np.uint8), kind)
        if byte > MAX_CODE[kind]:
            assert res is None
            want = _raised(jax_bt.pack_rle_dual, byte, kind)
            assert want == ("SymbolCodeTooLarge", f"{kind if kind != 'of' else 'offset'} code {byte} out of range")
            assert _raised(bt._FseBank().rle, byte, kind) == want
            with monkeypatch.context() as m:
                m.setattr(native, "fse_pack", _refuse)
                assert _raised(bt._FseBank().rle, byte, kind) == want
            continue
        jax_bank = jax_bt._FseBank()
        want = _jax_bank_slot(jax_bank, jax_bank.rle(byte, kind))
        _assert_pack(res, want)
        p0, p1 = bt.pack_fse_planes(symbol, one, one.astype(np.uint8), kind)
        _assert_pack((p0, p1, bt.value_bits(p1, kind)), want)


def test_fse_pack_out_of_range_table():
    """A whole FSE table with one code past the kind's range: native
    reports it, the bank raises the Python path's message."""
    table = fse_ops.PREDEFINED_ML_TABLE  # codes up to 52
    for kind in ("ll", "of"):
        assert native.fse_pack(table.symbol, table.baseline, table.nbits, kind) is None
        want = _raised(jax_bt.pack_fse_dual, table, kind)
        assert _raised(bt._FseBank().add, table, kind) == want


@pytest.mark.parametrize("name", list(CORPORA))
def test_fse_pack_corpus_tables(corpora, name):
    for kind, table in fse_tables(corpora[name]):
        jax_bank = jax_bt._FseBank()
        want = _jax_bank_slot(jax_bank, jax_bank.add(table, kind))
        _assert_pack(native.fse_pack(table.symbol, table.baseline, table.nbits, kind), want)


def _plans_equal(a, b) -> None:
    for f in dataclasses.fields(a):
        if f.name == "frames":
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        assert x.tobytes() == y.tobytes(), f.name
    assert len(a.frames) == len(b.frames)
    for fa, fb in zip(a.frames, b.frames):
        assert (fa.fallback, fa.fallback_reason) == (fb.fallback, fb.fallback_reason)
        assert len(fa.blocks) == len(fb.blocks)
        for ba, bb in zip(fa.blocks, fb.blocks):
            assert ba.seq_lane == bb.seq_lane and ba.num_seq == bb.num_seq
            assert [(r.lane, r.regen) for r in ba.lit_streams] == [
                (r.lane, r.regen) for r in bb.lit_streams
            ]


PACKERS = ((native, "huffman_canonical", "native"), (native, "fse_pack", "native"),
           (bt, "huffman_canonical_python", "python"), (bt, "pack_fse_planes", "python"))


def _plan(data, monkeypatch, *, refused: bool):
    """``data``'s plan and its table packs by path: host.c's calls (each
    refused with ``refused``, as a corrupt table is) and the Python
    packers' calls."""
    calls = {"native": 0, "python": 0}

    def counted(fn, path):
        def call(*args):
            calls[path] += 1
            return None if refused and path == "native" else fn(*args)
        return call

    with monkeypatch.context() as m:
        for module, name, path in PACKERS:
            m.setattr(module, name, counted(getattr(module, name), path))
        plan = bt.build_batch_plan(data)
    return plan, calls


def _plan_both_ways(data, monkeypatch):
    return (_plan(data, monkeypatch, refused=False)[0], _plan(data, monkeypatch, refused=True)[0])


@pytest.mark.parametrize("name", list(CORPORA))
def test_plan_native_equals_python(corpora, name, monkeypatch):
    data = corpora[name]
    on, on_calls = _plan(data, monkeypatch, refused=False)
    off, off_calls = _plan(data, monkeypatch, refused=True)
    _plans_equal(on, off)
    assert on_calls["python"] == 0
    assert on_calls["native"] == off_calls["native"] == off_calls["python"] > 0
    # One pack a compressed-literals block, a FSE-mode table, and the
    # first use of each predefined and RLE table.
    n_huff = len(huffman_payloads(data))
    assert on_calls["native"] >= n_huff + len(fse_tables(data))


def _huffman_offsets(data) -> list[tuple[int, int]]:
    """(offset, length) of each Huffman payload inside ``data``."""
    base = np.frombuffer(data, dtype=np.uint8).__array_interface__["data"][0]
    out = []
    for b in _blocks(data):
        lit = getattr(b, "literals", None)
        if lit is not None and lit.ltype == LiteralsType.COMPRESSED:
            view = np.frombuffer(lit.huffman_payload, dtype=np.uint8)
            out.append((view.__array_interface__["data"][0] - base, len(view)))
    return out


def test_plan_corrupt_huffman_same_fallback(monkeypatch):
    """Every byte of a frame's Huffman weights (after the header byte,
    which sizes the payload) set to 0x00 and to 0xFF in turn: the plan is
    the same whether host.c packs its tables or refuses them all,
    fallback reasons word for word, and some corruptions fall back with a
    ``huffman:`` reason."""
    data = libzstd.compress(torch_inputs.level3_text()[1][:20_000], 3, checksum=False)
    (off, n), *_ = _huffman_offsets(data)
    huffman_fallbacks = 0
    for i in range(off + 1, off + n):
        for value in (0x00, 0xFF):
            bad = bytearray(data)
            bad[i] = value
            try:
                on = bt.build_batch_plan(bytes(bad))
            except ZstdError as e:  # the frame itself no longer parses
                with monkeypatch.context() as m:
                    m.setattr(native, "huffman_canonical", _refuse)
                    m.setattr(native, "fse_pack", _refuse)
                    assert _raised(bt.build_batch_plan, bytes(bad)) == (type(e).__name__, str(e))
                continue
            on, off_plan = _plan_both_ways(bytes(bad), monkeypatch)
            _plans_equal(on, off_plan)
            reason = on.frames[0].fallback_reason
            huffman_fallbacks += reason.startswith("huffman: ")
    assert huffman_fallbacks >= 3


def test_valid_tables_never_reach_the_python_packers(monkeypatch):
    def reached(*args):
        raise AssertionError("a valid table reached a Python packer")

    monkeypatch.setattr(bt, "huffman_canonical_python", reached)
    monkeypatch.setattr(bt, "pack_fse_planes", reached)
    data, raw = torch_inputs.combined()
    assert huffman_payloads(data) and fse_tables(data)
    eng = DeviceEngine(device="cpu")
    assert eng.decompress(data) == raw
    assert eng.stats.fallback_frames == 0 and not eng.stats.fallback_reasons
