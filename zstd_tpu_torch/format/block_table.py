"""Host prepass: flatten parsed frames into a device-ready batch plan.

This is the host/device cut (SURVEY.md §3.1): everything above block
*decoding* — frame/block/section headers, tiny FSE/Huffman table packs
(one ``csrc/host.c`` call a table), repeat-mode resolution — happens here, serially and cheaply; everything
byte-volume — Huffman literals, tANS sequence triples — becomes lanes of
the batched device kernels (zstd_tpu_torch/kernels/).

The plan carries per-block *assembly* metadata so the runtime can stitch
frame outputs in order, and per-frame fallback flags: any stream that
fails prepass validation (or later a kernel status check) routes its
whole frame to the host oracle — bit-exactness is never sacrificed for
the fast path (SURVEY.md §5 failure detection).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import native
from ..ops import fse as fse_ops
from ..ops.huffman import complete_huffman_weights, parse_huffman_weights
from ..utils.bits import ForwardByteCursor
from ..utils.errors import ZstdError
from .block import BlockType
from .frame import MAX_WINDOW_SIZE, SkippableFrame, ZstdFrame, iter_frames
from .literals import LiteralsType, stream_regen_sizes
from .sequences import SeqMode, SeqModeDesc

FSE_SLOT_SIZE = 512  # AL <= 9
MAX_BLOCK_SIZE = 128 << 10  # RFC 8878 §3.1.1.2.3
# Smallest sequence regenerates 3 bytes (ml >= 3, ll >= 0).
MAX_SEQUENCES_PER_BLOCK = MAX_BLOCK_SIZE // 3 + 1


# A packed Huffman table is one int32 row of these fields, back to back
# (zt_huffman_canonical writes the same row).
CANON_FIELDS = (("limits", 12), ("prevs", 12), ("lengths", 12), ("rankb", 12), ("ranked", 256))
CANON_WORDS = sum(n for _, n in CANON_FIELDS)


def _empty_canon() -> np.ndarray:
    row = np.zeros(CANON_WORDS, dtype=np.int32)
    row[:12] = 1 << 12  # limits: unreachable pad
    row[24:36] = 1  # lengths
    return row


def canonical_from_weights(weights: np.ndarray, max_bits: int) -> np.ndarray:
    """Pack completed Huffman weights for the v2 arithmetic-canonical
    kernel, as one ``CANON_WORDS`` row.

    Code-length classes laid out in the 11-bit window space (longest
    codes first, canonical): per class k — ``limits[k]`` (end boundary),
    ``prevs[k]`` (start), ``lengths[k]``, ``rankb[k]`` (first symbol
    rank); plus ``ranked[256]`` mapping rank → symbol.  The kernel finds
    the class with 12 compares and selects the symbol by rank — no LUT.
    Symbols rank by weight ascending, ties by symbol (a stable sort); a
    class of ``count`` weight-``w`` symbols spans ``count << (w - 1)``
    units of the ``2^max_bits`` code space."""
    row = _empty_canon()
    weights = np.asarray(weights, dtype=np.int64)
    counts = np.bincount(weights, minlength=max_bits + 1)[1 : max_bits + 1]
    ws = np.flatnonzero(counts) + 1  # the weights present, ascending
    n = counts[ws - 1]
    span = n << (ws - 1)
    end = np.cumsum(span)
    scale = 11 - max_bits
    k = len(ws)
    row[0:k] = end << scale
    row[12 : 12 + k] = (end - span) << scale
    row[24 : 24 + k] = max_bits + 1 - ws
    row[36 : 36 + k] = np.cumsum(n) - n
    order = np.argsort(weights, kind="stable")
    ranked = order[weights[order] > 0]
    row[48 : 48 + len(ranked)] = ranked
    return row


def split_canon(rows: np.ndarray) -> dict[str, np.ndarray]:
    """The named fields of packed rows (``(..., CANON_WORDS)``), each a
    contiguous array."""
    out, at = {}, 0
    for name, n in CANON_FIELDS:
        out[name] = np.ascontiguousarray(rows[..., at : at + n])
        at += n
    return out


def huffman_canonical_python(payload) -> tuple[np.ndarray, np.ndarray]:
    """``native.huffman_canonical`` in Python, run where host.c refuses a
    payload: ``(canon row, completed weights)`` of a block's Huffman table
    payload; raises the typed ``ZstdError`` on a truncated payload or
    corrupt weights (for a valid payload it equals host.c's pack)."""
    weights = parse_huffman_weights(ForwardByteCursor(payload))
    max_bits, all_weights = complete_huffman_weights(weights)
    return canonical_from_weights(all_weights, max_bits), all_weights


def _fse_value_plane(symbols: np.ndarray, kind: str) -> np.ndarray:
    """plane1 entries for a sequence-code table: value base/extra folded in.

    LL/ML: ``value_base << 5 | extra_bits`` (RFC code tables,
    sequence.rs:98-191).  OF: the code itself (value = (1 << code) +
    extra, sequence.rs:50).  Raises on out-of-range codes so corrupt
    tables fall back to the oracle at prepass time — the kernel then
    needs no bounds checks.
    """
    from ..ops.sequence_codes import (
        LL_BASELINE,
        LL_EXTRA_BITS,
        MAX_LL_CODE,
        MAX_ML_CODE,
        MAX_OFFSET_CODE,
        ML_BASELINE,
        ML_EXTRA_BITS,
    )
    from ..utils.errors import SymbolCodeTooLarge

    s = symbols.astype(np.int64)
    if kind == "of":
        if s.max(initial=0) > MAX_OFFSET_CODE:
            raise SymbolCodeTooLarge(f"offset code {s.max()} out of range")
        return s.astype(np.int32)
    if kind == "ll":
        if s.max(initial=0) > MAX_LL_CODE:
            raise SymbolCodeTooLarge(f"ll code {s.max()} out of range")
        return (LL_BASELINE[s] << 5 | LL_EXTRA_BITS[s]).astype(np.int32)
    if s.max(initial=0) > MAX_ML_CODE:
        raise SymbolCodeTooLarge(f"ml code {s.max()} out of range")
    return (ML_BASELINE[s] << 5 | ML_EXTRA_BITS[s]).astype(np.int32)


def pack_fse_planes(symbol, baseline, nbits, kind: str) -> tuple[np.ndarray, np.ndarray]:
    """``native.fse_pack`` in Python, run where host.c refuses a table: a
    table's v2 dual planes (state-transition, value); raises on
    out-of-range codes.

    Compact form: exactly ``len(symbol)`` (= 2^al) entries per plane —
    the device bank stores tables back to back (variable-size slots)
    because a blanket 512-row slot made the bank upload ~3x the real
    table volume on the bench corpus, and the upload rides the slow
    relay (BASELINE.md)."""
    p0 = (np.asarray(baseline).astype(np.int32) << 16) | np.asarray(nbits).astype(np.int32)
    p1 = _fse_value_plane(np.asarray(symbol), kind)
    return p0.astype(np.int32), p1


# RLE mode as a single-state FSE table: baseline 0, 0 bits.
_RLE_ZERO16 = np.zeros(1, dtype=np.uint16)
_RLE_ZERO8 = np.zeros(1, dtype=np.uint8)


def value_bits(p1: np.ndarray, kind: str) -> int:
    """Bits bounding any value a packed table decodes (a bank slot's
    ``wbits``, at least 1)."""
    if kind == "of":
        # value = (1 << code) + extra < 2^(code + 1)
        w = int(p1.max()) + 1
    else:
        # value = value_base + take(extra_bits)
        w = int(((p1 >> 5) + (1 << (p1 & 31)) - 1).max()).bit_length()
    return max(w, 1)


class _FseBank:
    """Slot allocator for FSE/RLE sequence tables shipped to the device.

    Slots are kind-specific ('ll'/'of'/'ml') because the v2 value plane
    folds the kind's code→value table into each state entry.  Packing
    validates symbol ranges; out-of-range codes raise and the frame
    falls back to the oracle.  Each table is packed by one native call
    (``zt_fse_pack``); where it reports a code out of range, the Python
    packer raises ``SymbolCodeTooLarge`` with the reference's message.

    Storage is a flat variable-size bank: slot ``i`` occupies rows
    ``off[i] .. off[i] + 2^al_i`` of the concatenated planes, and
    identical tables (same kind + packed bytes — common across frames
    of similar data) share one slot.  Kernels gather 512 rows from
    ``off[slot]`` regardless of table size; rows past a table's end
    belong to the next table but are never selected because FSE states
    stay < 2^al by the table tiling invariant.
    """

    def __init__(self) -> None:
        self.p0s: list[np.ndarray] = []  # transition plane chunks
        self.p1s: list[np.ndarray] = []  # value plane chunks
        self.offs: list[int] = []  # first row of each slot
        self.als: list[int] = []  # accuracy log per slot
        self.wbits: list[int] = []  # bits bounding any decoded value
        self._total = 0
        self._dedup: dict[tuple, int] = {}
        self._predef: dict[str, int] = {}
        self._rle: dict[tuple[str, int], int] = {}

    def _pack(self, symbol, baseline, nbits, kind: str) -> tuple[np.ndarray, np.ndarray, int]:
        res = native.fse_pack(symbol, baseline, nbits, kind)
        if res is not None:
            return res
        p0, p1 = pack_fse_planes(symbol, baseline, nbits, kind)  # may raise
        return p0, p1, value_bits(p1, kind)

    def _push(self, p0: np.ndarray, p1: np.ndarray, al: int, key: tuple, wbits: int) -> int:
        slot = self._dedup.get(key)
        if slot is not None:
            return slot
        self.p0s.append(p0)
        self.p1s.append(p1)
        self.offs.append(self._total)
        self.als.append(al)
        self.wbits.append(wbits)
        self._total += len(p0)
        slot = len(self.offs) - 1
        self._dedup[key] = slot
        return slot

    def add(self, table: fse_ops.FseTable, kind: str) -> int:
        p0, p1, w = self._pack(table.symbol, table.baseline, table.nbits, kind)
        return self._push(p0, p1, table.accuracy_log, (kind, p0.tobytes(), p1.tobytes()), w)

    def predefined(self, kind: str) -> int:
        if kind not in self._predef:
            table = {
                "ll": fse_ops.PREDEFINED_LL_TABLE,
                "of": fse_ops.PREDEFINED_OF_TABLE,
                "ml": fse_ops.PREDEFINED_ML_TABLE,
            }[kind]
            self._predef[kind] = self.add(table, kind)
        return self._predef[kind]

    def rle(self, byte: int, kind: str) -> int:
        key = (kind, byte)
        if key not in self._rle:
            symbol = np.asarray([byte], dtype=np.uint16)
            p0, p1, w = self._pack(symbol, _RLE_ZERO16, _RLE_ZERO8, kind)  # may raise
            self._rle[key] = self._push(p0, p1, 0, ("rle",) + key, w)
        return self._rle[key]

    def stack(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        if not self.p0s:
            z = np.zeros(1, dtype=np.int32)
            return z, z.copy(), np.zeros(1, dtype=np.int32), np.ones(1, np.int32)
        return (
            np.concatenate(self.p0s),
            np.concatenate(self.p1s),
            np.asarray(self.offs, dtype=np.int32),
            np.asarray(self.wbits, dtype=np.int32),
        )


def input_words(data: bytes | memoryview) -> np.ndarray:
    """The raw input as the kernels' little-endian u32 words buffer.

    Absolute indexing: entropy streams are NOT repacked — each lane
    addresses its payload in place via (base_word, p0, pend) from
    ``_StreamLocator``.  This keeps the prepass copy-free and lets the
    engine start the words upload before parsing finishes (the relay
    upload then overlaps the host prepass, BASELINE.md)."""
    n = len(data)
    main = n >> 2
    out = np.zeros(main + 1, dtype="<u4")
    if main:
        out[:main] = np.frombuffer(data, dtype="<u4", count=main)
    rem = n & 3
    if rem:
        tail = np.zeros(4, dtype=np.uint8)
        tail[:rem] = np.frombuffer(data, dtype=np.uint8)[4 * main :]
        out[main] = tail.view("<u4")[0]
    return out


class _StreamLocator:
    """Locate entropy-stream payloads inside the raw input buffer.

    Streams are arbitrary byte ranges of the input; a lane addresses
    one as (base_word, p0, pend) with base = offset >> 2 and bit
    positions relative to that word, so the backward cursor ends at
    ``pend = 8 * (offset & 3)`` instead of 0.  Bits below ``pend`` in
    the base word belong to the PREVIOUS stream: the buffered reader
    may peek them (Huffman pads are don't-cares — an L-bit code's
    whole 2^(11-L) suffix span maps to the same symbol) but a valid
    stream never consumes them, and over-consumption fails the exact
    ``pos == pend`` end check, routing the lane to the oracle.
    """

    def __init__(self, data: bytes | memoryview) -> None:
        flat = np.frombuffer(data, dtype=np.uint8)
        self._addr = flat.__array_interface__["data"][0]
        self._len = len(flat)

    def locate(self, payload: memoryview | bytes) -> tuple[int, int, int]:
        """Returns (base_word, p0, pend) or (-1, -1, -1) if invalid."""
        n = len(payload)
        if n == 0 or payload[-1] == 0:
            return -1, -1, -1
        v = np.frombuffer(payload, dtype=np.uint8)
        off = v.__array_interface__["data"][0] - self._addr
        if not (0 <= off and off + n <= self._len):
            # Not a view of the input buffer (defensive; never expected
            # from the parser) — route the frame to the oracle.
            return -1, -1, -1
        shift = 8 * (off & 3)
        p0 = shift + 8 * (n - 1) + int(payload[-1]).bit_length() - 1
        return off >> 2, p0, shift


@dataclass
class LitStreamRef:
    lane: int
    regen: int


@dataclass
class BlockPlan:
    kind: BlockType
    raw: memoryview | None = None
    rle_byte: int = 0
    rle_repeat: int = 0
    # Compressed-block literals:
    lit_kind: LiteralsType | None = None
    lit_raw: memoryview | None = None
    lit_rle_byte: int = 0
    lit_regen: int = 0
    lit_streams: list[LitStreamRef] = field(default_factory=list)
    # Compressed-block sequences:
    seq_lane: int = -1
    num_seq: int = 0


@dataclass
class FramePlan:
    frame: ZstdFrame | SkippableFrame
    blocks: list[BlockPlan] = field(default_factory=list)
    fallback: bool = False
    fallback_reason: str = ""


@dataclass
class BatchPlan:
    frames: list[FramePlan]
    words: np.ndarray
    # Literal-stream lanes:
    lit_base: np.ndarray
    lit_p0: np.ndarray
    lit_pend: np.ndarray  # end bit position (8 * (byte_offset & 3))
    lit_regen: np.ndarray
    lit_slot: np.ndarray
    # Sequence lanes:
    seq_base: np.ndarray
    seq_p0: np.ndarray
    seq_pend: np.ndarray
    seq_nseq: np.ndarray
    seq_ll_slot: np.ndarray
    seq_of_slot: np.ndarray
    seq_ml_slot: np.ndarray
    seq_ll_al: np.ndarray
    seq_of_al: np.ndarray
    seq_ml_al: np.ndarray
    fse_flat0: np.ndarray  # int32[N] flat transition plane (variable slots)
    fse_flat1: np.ndarray  # int32[N] flat value plane
    fse_off: np.ndarray  # int32[n_slots] first row of each slot
    fse_wbits: np.ndarray  # int32[n_slots] bits bounding any decoded value
    huff_limits: np.ndarray  # (n_tables, 12) int32
    huff_prevs: np.ndarray
    huff_lengths: np.ndarray
    huff_rankb: np.ndarray
    huff_ranked: np.ndarray  # (n_tables, 256) int32

    @property
    def n_lit_lanes(self) -> int:
        return len(self.lit_base)

    @property
    def n_seq_lanes(self) -> int:
        return len(self.seq_base)

    def fse_rows(self, slots: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Host-gathered (len(slots), 512) plane rows for the wide-retry
        kernel (the dense kernels gather from the flat bank on-device).  Rows past a table's 2^al end are neighboring-table
        garbage, never selected (states stay < 2^al)."""
        idx = self.fse_off[slots][:, None] + np.arange(FSE_SLOT_SIZE)
        idx = np.minimum(idx, len(self.fse_flat0) - 1)
        return self.fse_flat0[idx], self.fse_flat1[idx]


class _Builder:
    def __init__(self, data) -> None:
        self.loc = _StreamLocator(data)
        self.fse = _FseBank()
        self.huff_canon: list[np.ndarray] = []  # CANON_WORDS rows
        self._huff_dedup: dict[bytes, int] = {}
        self.lit = {k: [] for k in ("base", "p0", "pend", "regen", "slot")}
        self.seq = {
            k: []
            for k in (
                "base",
                "p0",
                "pend",
                "nseq",
                "ll_slot",
                "of_slot",
                "ml_slot",
                "ll_al",
                "of_al",
                "ml_al",
            )
        }

    def add_lit_lane(self, payload, regen: int, slot: int) -> int:
        base, p0, pend = self.loc.locate(payload)
        if base < 0:
            return -1
        lane = len(self.lit["base"])
        self.lit["base"].append(base)
        self.lit["p0"].append(p0)
        self.lit["pend"].append(pend)
        self.lit["regen"].append(regen)
        self.lit["slot"].append(slot)
        return lane

    def add_huffman(self, payload) -> int:
        """Pack a block's Huffman table (its payload: header byte +
        weights) and register it, deduplicated by completed weights
        (identical tables are common across similar frames).  Raises the
        typed ``ZstdError`` on corrupt weights."""
        res = native.huffman_canonical(payload)
        canon, weights = huffman_canonical_python(payload) if res is None else res
        key = weights.tobytes()
        slot = self._huff_dedup.get(key)
        if slot is None:
            self.huff_canon.append(canon)
            slot = len(self.huff_canon) - 1
            self._huff_dedup[key] = slot
        return slot

    def add_seq_lane(self, payload, nseq: int, specs) -> int:
        base, p0, pend = self.loc.locate(payload)
        if base < 0:
            return -1
        (ll_slot, ll_al), (of_slot, of_al), (ml_slot, ml_al) = specs
        lane = len(self.seq["base"])
        self.seq["base"].append(base)
        self.seq["p0"].append(p0)
        self.seq["pend"].append(pend)
        self.seq["nseq"].append(nseq)
        self.seq["ll_slot"].append(ll_slot)
        self.seq["of_slot"].append(of_slot)
        self.seq["ml_slot"].append(ml_slot)
        self.seq["ll_al"].append(ll_al)
        self.seq["of_al"].append(of_al)
        self.seq["ml_al"].append(ml_al)
        return lane


def _resolve_seq_slot(
    builder: _Builder,
    kind: str,
    desc: SeqModeDesc,
    current: tuple[int, int] | None,
) -> tuple[int, int] | None:
    """Resolve a mode descriptor to (slot, accuracy_log); None → fallback."""
    if desc.mode == SeqMode.PREDEFINED:
        slot = builder.fse.predefined(kind)
        return slot, builder.fse.als[slot]
    if desc.mode == SeqMode.RLE:
        return builder.fse.rle(desc.rle_byte, kind), 0
    if desc.mode == SeqMode.FSE:
        t = desc.fse_table
        return builder.fse.add(t, kind), t.accuracy_log
    return current  # REPEAT (None when there is no previous table)


def build_batch_plan(
    data: bytes | memoryview,
    *,
    max_window_size: int = MAX_WINDOW_SIZE,
    words: np.ndarray | None = None,
    frames: list | None = None,
) -> BatchPlan:
    """Parse ``data`` and lay out every entropy stream as a kernel lane.

    ``words``: a pre-built :func:`input_words` array (the engine builds
    and uploads it before calling here so the relay transfer overlaps
    this prepass); built on demand otherwise.

    ``frames``: pre-parsed frames (a slice of the input's frame list)
    — the engine's frame-pipelined path plans and dispatches GROUPS of
    frames so the parse of group k overlaps the device execution of
    groups < k; lane word indices stay absolute into ``data`` either
    way, so every group shares the one uploaded words buffer."""
    builder = _Builder(data)
    frames_out: list[FramePlan] = []

    frame_src = (
        frames
        if frames is not None
        else iter_frames(data, max_window_size=max_window_size)
    )
    for frame in frame_src:
        fp = FramePlan(frame=frame)
        frames_out.append(fp)
        if isinstance(frame, SkippableFrame):
            continue
        huff_slot: int | None = None
        cur = {"ll": None, "of": None, "ml": None}
        for block in frame.blocks:
            if fp.fallback:
                break
            bp = BlockPlan(kind=block.btype)
            fp.blocks.append(bp)
            if block.btype == BlockType.RAW:
                bp.raw = block.data
                continue
            if block.btype == BlockType.RLE:
                bp.rle_byte, bp.rle_repeat = block.rle_byte, block.rle_repeat
                continue

            lit = block.literals
            bp.lit_kind = lit.ltype
            bp.lit_regen = lit.regenerated_size
            # RFC 8878 §3.1.1.2.3: a block decodes to at most 128 KiB, so
            # any larger header value is corruption — route to the oracle
            # rather than sizing kernels off attacker-controlled fields.
            if (
                lit.regenerated_size > MAX_BLOCK_SIZE
                or block.sequences.num_sequences > MAX_SEQUENCES_PER_BLOCK
            ):
                fp.fallback, fp.fallback_reason = True, "block size bound"
                continue
            if lit.ltype == LiteralsType.RAW:
                bp.lit_raw = lit.data
            elif lit.ltype == LiteralsType.RLE:
                bp.lit_rle_byte = lit.rle_byte
            else:
                if lit.ltype == LiteralsType.COMPRESSED:
                    try:
                        huff_slot = builder.add_huffman(lit.huffman_payload)
                    except ZstdError as e:
                        fp.fallback, fp.fallback_reason = True, f"huffman: {e}"
                        continue
                if huff_slot is None:
                    fp.fallback, fp.fallback_reason = True, "treeless w/o table"
                    continue
                regens = stream_regen_sizes(lit.regenerated_size, len(lit.streams))
                if min(regens) < 0:
                    fp.fallback, fp.fallback_reason = True, "bad stream split"
                    continue
                for payload, regen in zip(lit.streams, regens):
                    lane = builder.add_lit_lane(payload, regen, huff_slot)
                    if lane < 0:
                        fp.fallback, fp.fallback_reason = True, "bad lit stream"
                        break
                    bp.lit_streams.append(LitStreamRef(lane, regen))
                if fp.fallback:
                    continue

            seq = block.sequences
            bp.num_seq = seq.num_sequences
            if seq.num_sequences == 0:
                continue
            specs = []
            for kind, desc in (("ll", seq.ll), ("of", seq.of), ("ml", seq.ml)):
                try:
                    spec = _resolve_seq_slot(builder, kind, desc, cur[kind])
                except ZstdError as e:
                    fp.fallback, fp.fallback_reason = True, f"{kind} table: {e}"
                    break
                if spec is None:
                    fp.fallback, fp.fallback_reason = True, f"repeat {kind} w/o table"
                    break
                specs.append(spec)
            if fp.fallback:
                continue
            lane = builder.add_seq_lane(seq.bitstream, seq.num_sequences, specs)
            if lane < 0:
                fp.fallback, fp.fallback_reason = True, "bad seq stream"
                continue
            bp.seq_lane = lane
            cur["ll"], cur["of"], cur["ml"] = specs

    fse_flat0, fse_flat1, fse_off, fse_wbits = builder.fse.stack()
    canon = split_canon(np.stack(builder.huff_canon or [_empty_canon()]))
    i32 = lambda xs: np.asarray(xs, dtype=np.int32)  # noqa: E731
    return BatchPlan(
        frames=frames_out,
        words=input_words(data) if words is None else words,
        lit_base=i32(builder.lit["base"]),
        lit_p0=i32(builder.lit["p0"]),
        lit_pend=i32(builder.lit["pend"]),
        lit_regen=i32(builder.lit["regen"]),
        lit_slot=i32(builder.lit["slot"]),
        seq_base=i32(builder.seq["base"]),
        seq_p0=i32(builder.seq["p0"]),
        seq_pend=i32(builder.seq["pend"]),
        seq_nseq=i32(builder.seq["nseq"]),
        seq_ll_slot=i32(builder.seq["ll_slot"]),
        seq_of_slot=i32(builder.seq["of_slot"]),
        seq_ml_slot=i32(builder.seq["ml_slot"]),
        seq_ll_al=i32(builder.seq["ll_al"]),
        seq_of_al=i32(builder.seq["of_al"]),
        seq_ml_al=i32(builder.seq["ml_al"]),
        fse_flat0=fse_flat0,
        fse_flat1=fse_flat1,
        fse_off=fse_off,
        fse_wbits=fse_wbits,
        huff_limits=canon["limits"],
        huff_prevs=canon["prevs"],
        huff_lengths=canon["lengths"],
        huff_rankb=canon["rankb"],
        huff_ranked=canon["ranked"],
    )
