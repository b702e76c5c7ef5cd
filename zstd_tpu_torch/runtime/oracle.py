"""Host-side reference decoder — the bit-exactness oracle.

Serial, NumPy-table-driven implementation of the full decode path
(mirrors the reference call stack ``Frame::decode`` →
``Block::decode`` → literals/sequences → execute, SURVEY.md §3.1).  Every
device kernel lands behind a differential test against this decoder and
against libzstd; it also handles odd blocks the batched path punts on.

Deliberate fixes over the reference, all RFC-mandated (SURVEY.md §7):

* ``num_seq == 0`` blocks are literals-only (the reference errors,
  block.rs:84-86).
* checksum mismatch raises by default (the reference warns on stderr,
  frame.rs:251-254).
* output is raw bytes (the CLI never routes through UTF-8; the
  reference panics on non-UTF-8 output, src/main.rs:55-57).
"""

from __future__ import annotations

from ..format.block import BlockDesc, BlockType
from ..format.frame import (
    MAX_WINDOW_SIZE,
    Frame,
    SkippableFrame,
    ZstdFrame,
    iter_frames,
)
from ..format.literals import LiteralsDesc, LiteralsType
from ..format.sequences import SeqMode, SeqModeDesc, SequencesDesc
from ..ops import fse as fse_ops
from ..ops.huffman import decode_literals_stream, parse_huffman_table
from ..ops.lz77 import execute_sequences
from ..ops.sequence_codes import (
    LL_BASELINE,
    LL_EXTRA_BITS,
    ML_BASELINE,
    ML_EXTRA_BITS,
    check_codes,
)
from ..utils.bits import BackwardBitCursor, ForwardByteCursor
from ..utils.errors import (
    ChecksumMismatch,
    ImpossibleValue,
    MissingHuffmanTable,
    NoPreviousTable,
)
from ..utils.xxh64 import xxh64
from .context import DecodingContext, TableSpec

_PREDEFINED = {
    "ll": fse_ops.PREDEFINED_LL_TABLE,
    "of": fse_ops.PREDEFINED_OF_TABLE,
    "ml": fse_ops.PREDEFINED_ML_TABLE,
}


def decode_literals(desc: LiteralsDesc, ctx: DecodingContext) -> bytes:
    """Decode a literals section, maintaining the cached Huffman table."""
    if desc.ltype == LiteralsType.RAW:
        return bytes(desc.data)
    if desc.ltype == LiteralsType.RLE:
        return bytes([desc.rle_byte]) * desc.regenerated_size

    if desc.ltype == LiteralsType.COMPRESSED:
        ctx.huffman = parse_huffman_table(ForwardByteCursor(desc.huffman_payload))
    if ctx.huffman is None:
        raise MissingHuffmanTable("treeless literals with no previous table")

    out = bytearray()
    for stream in desc.streams:
        decode_literals_stream(ctx.huffman, stream, out)
    if len(out) != desc.regenerated_size:
        raise ImpossibleValue(
            f"literals regenerated {len(out)} bytes, header says {desc.regenerated_size}"
        )
    return bytes(out)


class _FseState:
    __slots__ = ("symbol", "baseline", "nbits", "al", "state")

    def __init__(self, table: fse_ops.FseTable):
        self.symbol = table.symbol.tolist()
        self.baseline = table.baseline.tolist()
        self.nbits = table.nbits.tolist()
        self.al = table.accuracy_log
        self.state = 0

    def init(self, bwd: BackwardBitCursor) -> None:
        self.state = bwd.take(self.al)

    def code(self) -> int:
        return self.symbol[self.state]

    def update(self, bwd: BackwardBitCursor) -> None:
        s = self.state
        self.state = self.baseline[s] + bwd.take(self.nbits[s])


class _RleState:
    __slots__ = ("byte",)

    def __init__(self, byte: int):
        self.byte = byte

    def init(self, bwd: BackwardBitCursor) -> None:
        pass

    def code(self) -> int:
        return self.byte

    def update(self, bwd: BackwardBitCursor) -> None:
        pass


def _resolve_spec(
    kind: str, desc: SeqModeDesc, prev: TableSpec | None
) -> TableSpec:
    """Resolve a mode descriptor to a concrete table spec.

    REPEAT reuses the context's previous spec (sequences.rs:165-171);
    stored specs are never REPEAT, so recursion cannot loop.
    """
    if desc.mode == SeqMode.PREDEFINED:
        return TableSpec(SeqMode.PREDEFINED, fse_table=_PREDEFINED[kind])
    if desc.mode == SeqMode.RLE:
        return TableSpec(SeqMode.RLE, rle_byte=desc.rle_byte)
    if desc.mode == SeqMode.FSE:
        return TableSpec(SeqMode.FSE, fse_table=desc.fse_table)
    if prev is None:
        raise NoPreviousTable(f"repeat {kind} mode with no previous table")
    return prev


def _make_state(spec: TableSpec) -> _FseState | _RleState:
    if spec.kind == SeqMode.RLE:
        return _RleState(spec.rle_byte)
    return _FseState(spec.fse_table)


def decode_sequences(
    desc: SequencesDesc, ctx: DecodingContext
) -> list[tuple[int, int, int]]:
    """Decode the interleaved sequence bitstream to (ll, offset_value, ml).

    Stream discipline (RFC 8878 §3.1.1.3.2.1.1; sequence.rs:41-88):
    state init order LL, OF, ML; per sequence extra-bits read order OF,
    ML, LL; state update order LL, ML, OF, skipped after the last
    sequence.  Updates the context's cached table specs.
    """
    if desc.num_sequences == 0:
        # Literals-only block: no modes byte was present; the cached
        # table specs and repeat offsets are left untouched.
        return []

    ll_spec = _resolve_spec("ll", desc.ll, ctx.ll_spec)
    of_spec = _resolve_spec("of", desc.of, ctx.of_spec)
    ml_spec = _resolve_spec("ml", desc.ml, ctx.ml_spec)

    ll_st = _make_state(ll_spec)
    of_st = _make_state(of_spec)
    ml_st = _make_state(ml_spec)

    bwd = BackwardBitCursor(desc.bitstream)
    ll_st.init(bwd)
    of_st.init(bwd)
    ml_st.init(bwd)

    ll_base = LL_BASELINE.tolist()
    ll_extra = LL_EXTRA_BITS.tolist()
    ml_base = ML_BASELINE.tolist()
    ml_extra = ML_EXTRA_BITS.tolist()

    out: list[tuple[int, int, int]] = []
    last = desc.num_sequences - 1
    for i in range(desc.num_sequences):
        of_code = of_st.code()
        ll_code = ll_st.code()
        ml_code = ml_st.code()
        check_codes(ll_code, of_code, ml_code)

        offset_value = (1 << of_code) + bwd.take(of_code)
        ml = ml_base[ml_code] + bwd.take(ml_extra[ml_code])
        ll = ll_base[ll_code] + bwd.take(ll_extra[ll_code])
        out.append((ll, offset_value, ml))

        if i != last:
            ll_st.update(bwd)
            ml_st.update(bwd)
            of_st.update(bwd)

    ctx.ll_spec = ll_spec
    ctx.of_spec = of_spec
    ctx.ml_spec = ml_spec
    return out


def decode_block(desc: BlockDesc, ctx: DecodingContext) -> None:
    """Decode one block into the context (block.rs:74-99)."""
    if desc.btype == BlockType.RAW:
        ctx.output += desc.data
    elif desc.btype == BlockType.RLE:
        ctx.output += bytes([desc.rle_byte]) * desc.rle_repeat
    else:
        literals = decode_literals(desc.literals, ctx)
        sequences = decode_sequences(desc.sequences, ctx)
        if sequences:
            execute_sequences(ctx.output, sequences, literals, ctx.rep)
        else:
            # num_seq == 0: literals-only block (RFC; reference bug
            # block.rs:84-86 errors here).
            ctx.output += literals


def decode_frame(frame: ZstdFrame, *, verify_checksum: bool = True) -> bytes:
    """Decode a parsed ZSTD frame (frame.rs:232-260)."""
    ctx = DecodingContext(window_size=frame.header.window_size)
    for block in frame.blocks:
        decode_block(block, ctx)
    out = bytes(ctx.output)
    if frame.header.checksum_flag and verify_checksum:
        computed = xxh64(out) & 0xFFFFFFFF
        if computed != frame.checksum:
            raise ChecksumMismatch(computed, frame.checksum)
    if (
        frame.header.content_size is not None
        and len(out) != frame.header.content_size
    ):
        raise ImpossibleValue(
            f"frame decoded {len(out)} bytes, header says {frame.header.content_size}"
        )
    return out


def decompress(
    data: bytes | memoryview,
    *,
    max_window_size: int = MAX_WINDOW_SIZE,
    verify_checksum: bool = True,
    include_skippable: bool = False,
) -> bytes:
    """Decode a complete multi-frame input (src/main.rs:43-53).

    Skippable frames contribute nothing unless ``include_skippable``
    (the CLI's ``--print-skippable``, src/main.rs:20-22).
    """
    out = bytearray()
    for frame in iter_frames(data, max_window_size=max_window_size):
        if isinstance(frame, SkippableFrame):
            if include_skippable:
                out += frame.payload
        else:
            out += decode_frame(frame, verify_checksum=verify_checksum)
    return bytes(out)
