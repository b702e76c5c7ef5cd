"""Device-side LZ77 sequence execution: the ``DeviceEngine(device_execute=
True)`` route.

The reference executes sequences one byte at a time
(decoding_context.rs:95-98).  This module turns a frame's decoded blocks
into a **copy program** — (src, dst, len) byte copies over one buffer
that holds the frame's literal pool followed by its output region — which
the CUDA kernel ``csrc/lz77.cu`` runs (``kernels/lz77.py``), one frame
group per launch.

It also keeps the JAX package's pointer-doubling form of the same
function: the host builds a per-byte source map (every output byte's
origin is a literal or ``position - offset``), and O(log chain-depth)
rounds of whole-buffer gathers resolve self-referential match chains
(overlaps, matches of matches); one final gather materializes every byte.
That form is the kernel's plain PyTorch version (``lz77.exec_ops_plain``):
an independent algorithm for the same bytes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..format.block import BlockType
from ..format.literals import LiteralsType
from ..ops.sequence_codes import INITIAL_REPEAT_OFFSETS
from ..utils.errors import ImpossibleValue


def _resolve_offsets(ll, ofv, rep: list[int]) -> np.ndarray:
    rep_arr = np.asarray(rep, dtype=np.uint64)
    offs = native.resolve_offsets(ll, ofv, rep_arr)  # ValueError on corrupt
    rep[:] = [int(r) for r in rep_arr]
    return offs


def _segments(ll, ofv, ml, n_literals: int, rep: list[int]):
    """One block's execution segments, shared by the source map and the
    copy program: (ll, ml int64, resolved offsets, segment lengths —
    literal run, match, ..., trailing literals — and their starts, one
    more than the segments).  Mutates ``rep``; raises ``ValueError`` on
    a corrupt block."""
    ll = np.asarray(ll, dtype=np.int64)
    ml = np.asarray(ml, dtype=np.int64)
    # The repeat-offset scan is the cheap intrinsically-serial pass
    # (SURVEY.md §7 hard part #4); it stays host-side, in C (1.5M-sequence
    # frames cost seconds as a Python loop).
    offs = _resolve_offsets(ll, ofv, rep)
    trailing = n_literals - int(ll.sum())
    if trailing < 0:
        raise ValueError("literal runs exceed available literals")

    n = len(ll)
    seg_lens = np.empty(2 * n + 1, dtype=np.int64)
    seg_lens[0:-1:2] = ll
    seg_lens[1::2] = ml
    seg_lens[-1] = trailing
    starts = np.concatenate([[0], np.cumsum(seg_lens)])
    return ll, ml, offs, seg_lens, starts


def build_source_map(
    ll,
    ofv,
    ml,
    n_literals: int,
    rep: list[int],
    out_base: int,
):
    """Per-byte source map for one block's execution.

    ``ll``/``ofv``/``ml`` are the block's decoded sequence arrays;
    ``out_base`` is the frame-output length before this block.  Returns
    (src int64[block_out], total) where ``src[j] < 0`` encodes literal
    ``-src[j] - 1`` and ``src[j] >= 0`` is an absolute frame-output
    position.  Mutates ``rep`` (the repeat-offset history).
    """
    if len(ll) == 0:
        src = -np.arange(1, n_literals + 1, dtype=np.int64)
        return src, n_literals

    ll, ml, offs, seg_lens, starts = _segments(ll, ofv, ml, n_literals, rep)
    n = len(ll)
    trailing = int(seg_lens[-1])
    total = int(starts[-1])
    src = np.empty(total, dtype=np.int64)

    # Literal bytes (vectorized): byte k of the literal pool lands at
    # (its segment's start) + (k - literals consumed before the segment).
    lit_lens = np.concatenate([ll, [trailing]])
    lit_seg_starts = starts[0::2]
    lit_before = np.concatenate([[0], np.cumsum(ll)])
    delta = np.repeat(lit_seg_starts - lit_before, lit_lens)
    lit_pos = delta + np.arange(n_literals, dtype=np.int64)
    src[lit_pos] = -np.arange(n_literals, dtype=np.int64) - 1

    # Match bytes (vectorized): src = absolute position - offset.
    match_starts = starts[1 : 2 * n : 2]
    ml_before = np.concatenate([[0], np.cumsum(ml)])[:-1]
    mpos = np.repeat(match_starts - ml_before, ml) + np.arange(
        int(ml.sum()), dtype=np.int64
    )
    src[mpos] = out_base + mpos - np.repeat(offs, ml)
    return src, total


def doubling_rounds(n: int) -> int:
    """Doubling rounds that resolve any chain in an ``n``-byte map: every
    source lies strictly before its byte, so chains are shorter than n
    (the JAX route's rule, ``zstd_tpu/kernels/lz77_device.py:181``)."""
    return max(1, int(math.ceil(math.log2(max(2, n)))) + 1)


def resolve_and_materialize(src: torch.Tensor, literals: torch.Tensor, *, rounds: int = 25):
    """Pointer-double ``src`` to literal origins, then materialize.

    ``src`` int[T]: negative = literal index encoding (``-i - 1``), else
    a position strictly less than its own.  Doubling stops as soon as
    every byte has resolved to a literal, or after ``rounds`` rounds.
    Returns ``literals``' dtype [T]; indices clip as the JAX gathers do.
    """
    s = src
    i = 0
    while i < rounds and bool((s >= 0).any()):
        nxt = s[s.clamp(min=0)]
        s = torch.where(s >= 0, nxt, s)
        i += 1
    return literals[(-s - 1).clamp(0, max(literals.numel() - 1, 0))]


# -- copy programs ---------------------------------------------------------------


@dataclass
class CopyProgram:
    """One frame's copy program over the frame's own buffer: ``buf``
    uint8 holds the frame's literal pool (its blocks' literals in order)
    then its ``out_len``-byte output region, from ``out_start``, with raw
    and RLE blocks already in place.  ``ops`` int64[3, n] are (src, dst,
    len) in order, positions in ``buf``: a literal op copies from the
    pool, a match op from the output (``src = dst - offset``).
    ``far_match_bytes``: the bytes of the match ops whose source starts
    before their block's first output byte."""

    buf: np.ndarray
    out_start: int
    ops: np.ndarray
    far_match_bytes: int = 0


@dataclass
class GroupProgram:
    """The copy programs of a frame group laid end to end: ``buf`` uint8
    holds the frames' buffers in turn; ``ops`` int64[3, n] at absolute
    positions; program p's ops are ``op_off[p]:op_off[p+1]``; frame p's
    output is ``buf[outs[p][0] : outs[p][0] + outs[p][1]]`` and its
    program's far-match bytes ``far[p]``.  The three arrays are views of
    one byte array, ``blob`` (one upload)."""

    blob: np.ndarray
    ops: np.ndarray
    op_off: np.ndarray
    buf: np.ndarray
    outs: list
    far: list

    def split(self, blob: torch.Tensor):
        """(ops, op_off, buf) as views of ``blob``, a uint8 tensor holding
        this program's ``blob`` (on any device)."""
        return _views(blob, self.ops.shape[1], self.op_off.size - 1, torch.int64)


def _views(blob, n_ops: int, n_progs: int, int64):
    """The blob layout, for a numpy array or a torch tensor: (ops
    [3, n_ops], op_off [n_progs + 1], buf)."""
    a = 24 * n_ops
    b = a + 8 * (n_progs + 1)
    return blob[:a].view(int64).reshape(3, n_ops), blob[a:b].view(int64), blob[b:]


def block_literals(bp, lit_outs) -> np.ndarray:
    """A compressed block's literals: raw, RLE, or its Huffman streams'
    decoded bytes from ``lit_outs`` (``ImpossibleValue`` when they do not
    add up to the regenerated size)."""
    if bp.lit_kind == LiteralsType.RAW:
        return np.frombuffer(bp.lit_raw, dtype=np.uint8)
    if bp.lit_kind == LiteralsType.RLE:
        return np.full(bp.lit_regen, bp.lit_rle_byte, dtype=np.uint8)
    parts = [lit_outs[r.lane] for r in bp.lit_streams if r.regen]
    literals = np.concatenate(parts) if parts else np.empty(0, np.uint8)
    if literals.size != bp.lit_regen:
        raise ImpossibleValue("literal stream size mismatch")
    return literals


def _sequence_ops(ll, ofv, ml, n_lit: int, rep: list[int], pool_pos: int, out_pos: int):
    """One sequences block's ops, interleaved as executed: per sequence a
    literal op then a match op, then the trailing literals; (src, dst,
    len, block output length, bytes of the matches whose source starts
    before ``out_pos``), literal srcs in the pool and the rest in output
    coordinates.  Mutates ``rep``."""
    try:
        ll, _ml, offs, seg, starts = _segments(ll, ofv, ml, n_lit, rep)
    except ValueError as e:
        raise ImpossibleValue(str(e)) from None
    n = len(ll)
    dst = out_pos + starts[:-1]
    src = np.empty(2 * n + 1, dtype=np.int64)
    src[0::2] = pool_pos + np.concatenate([[0], np.cumsum(ll)])
    src[1::2] = dst[1::2] - offs
    # Every match byte must reference already-materialized frame output.
    if n and ((src[1::2] < 0).any() or (offs < 1).any()):
        raise ImpossibleValue("match references future or pre-frame data")
    far = int(seg[1::2][src[1::2] < out_pos].sum())
    return src, dst, seg, int(starts[-1]), far


def build_copy_program(fp, lit_outs, seq_outs) -> CopyProgram:
    """Turn one frame's blocks into a copy program.

    Takes the block kinds ``_assemble_frame_device`` of the JAX engine
    takes: raw and RLE blocks become prefilled output bytes; a compressed
    block appends its literals to the pool and gives, per sequence, at
    most one literal op (pool → output) and one match op (``src = dst -
    offset``), and one more literal op for its trailing literals (all of
    a literals-only block's).  Raises ``ImpossibleValue`` on a corrupt
    block, as the C executor's errors do."""
    rep = list(INITIAL_REPEAT_OFFSETS)
    pools, fills, parts = [], [], []
    pool_len = out_len = far = 0
    for bp in fp.blocks:
        if bp.kind == BlockType.RAW:
            fills.append((out_len, np.frombuffer(bp.raw, dtype=np.uint8)))
            out_len += len(bp.raw)
            continue
        if bp.kind == BlockType.RLE:
            fills.append((out_len, np.full(bp.rle_repeat, bp.rle_byte, dtype=np.uint8)))
            out_len += bp.rle_repeat
            continue
        literals = block_literals(bp, lit_outs)
        if bp.seq_lane < 0:
            n = literals.size
            parts.append((np.array([pool_len]), np.array([out_len]), np.array([n]), np.ones(1, bool)))
            size = n
        else:
            ll, ofv, ml = seq_outs[bp.seq_lane]
            src, dst, seg, size, block_far = _sequence_ops(
                ll, ofv, ml, literals.size, rep, pool_len, out_len)
            far += block_far
            is_lit = np.zeros(src.size, dtype=bool)
            is_lit[0::2] = True
            parts.append((src, dst, seg, is_lit))
        pools.append(literals)
        pool_len += literals.size
        out_len += size
    buf = np.zeros(pool_len + out_len, dtype=np.uint8)
    if pools:
        np.concatenate(pools, out=buf[:pool_len])
    for pos, arr in fills:
        buf[pool_len + pos : pool_len + pos + arr.size] = arr
    if not parts:
        return CopyProgram(buf=buf, out_start=pool_len, ops=np.zeros((3, 0), np.int64))
    src, dst, ln, is_lit = (np.concatenate(x) for x in zip(*parts))
    keep = ln > 0
    # Output positions follow the pool in the frame's buffer.
    src = src + np.where(is_lit, 0, pool_len)
    ops = np.stack([src[keep], dst[keep] + pool_len, ln[keep]]).astype(np.int64)
    return CopyProgram(buf=buf, out_start=pool_len, ops=ops, far_match_bytes=far)


def pack_programs(progs: list[CopyProgram]) -> GroupProgram:
    """Lay copy programs end to end in one buffer, with absolute op
    positions: one launch runs them all."""
    n_ops = sum(p.ops.shape[1] for p in progs)
    head = 8 * (3 * n_ops + len(progs) + 1)
    blob = np.zeros(head + sum(p.buf.size for p in progs), dtype=np.uint8)
    ops, op_off, buf = _views(blob, n_ops, len(progs), np.int64)
    np.cumsum([p.ops.shape[1] for p in progs], out=op_off[1:])
    outs = []
    base = 0
    for p, a, b in zip(progs, op_off[:-1], op_off[1:]):
        buf[base : base + p.buf.size] = p.buf
        ops[:2, a:b] = p.ops[:2] + base
        ops[2, a:b] = p.ops[2]
        outs.append((base + p.out_start, p.buf.size - p.out_start))
        base += p.buf.size
    return GroupProgram(blob=blob, ops=ops, op_off=op_off, buf=buf, outs=outs,
                        far=[p.far_match_bytes for p in progs])
