"""Plain PyTorch forms of the batched entropy decode (the JAX
reference's ``zstd_tpu/kernels/entropy2.py``).

These are the functions the CUDA kernels compute, written as tensor
code over all lanes at once with a Python loop over symbol/sequence
slots.  They serve three roles:

* the kernel wrappers (``literals.py``, ``sequences.py``,
  ``compact.py``) run them when handed CPU tensors — the CPU engine and
  the CPU tests;
* ``chip_smoke.py`` holds every CUDA kernel against them on the card;
* the tests hold them against the JAX functions of the same names on
  the same inputs, whole returned arrays included.

Signatures and layouts follow the reference: planes are
``(steps, slots, L)`` lane-last, u32 values travel in int64 (CPU
PyTorch has no uint32 arithmetic, see ``bitbuf``), and the ``*_dense``
wrappers return one concatenated array, dense words then per-lane ok
flags.  The never-stall invariants that make slot validity a per-lane
prefix are the reference's (see ``_sequences_scan``).
"""

from __future__ import annotations

import torch

from .bitbuf import M32, _shl, _shr, as_u32, read_bits

I64 = torch.int64

LIT_SYMS_PER_STEP = 32
SEQ_SLOTS_PER_STEP = 8
SEQ_MAX_BITS = 90  # of extra <= 31, ml/ll extra <= 16, 3 updates <= 9 each
FSE_SLOT_SIZE = 512  # table rows a lane may address (accuracy log <= 9)
SEQ_BUF_BITS = 192  # the reference's 6-word buffer: refills fire at <= 160
LIT_LANE_COLS = 5  # lane_mat columns: base, p0, pend, regen, slot
SEQ_LANE_COLS = 13  # lane_mat columns: base, p0, pend, nseq, w_ll, w_ml,
#                     w_of, ll_slot, of_slot, ml_slot, ll_al, of_al, ml_al


def _take_clip(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``jnp.take(src, idx, mode="clip")`` on a 1-D tensor."""
    return src[idx.clamp(0, src.numel() - 1)]


def _dense_lanes(cum: torch.Tensor, n_dense: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(lane, k) of each element of a dense array of per-lane prefixes:
    ``cum`` is int[L + 1] (cum[j]..cum[j+1] = lane j's dense range) and
    element i is item k = i - cum[lane] of its lane.  Lane attribution
    is a scatter of boundary marks + cumsum (marks past the end are
    dropped); positions past cum[-1] fall to lane L (padding)."""
    cum = cum.to(I64)
    ends = cum[1:]
    ends = ends[(ends >= 0) & (ends < n_dense)]
    marks = torch.zeros(n_dense, dtype=I64, device=cum.device)
    marks.index_add_(0, ends, torch.ones_like(ends))
    lane = torch.cumsum(marks, 0)
    return lane, torch.arange(n_dense, dtype=I64, device=cum.device) - _take_clip(cum, lane)


def _dense_indices(cum: torch.Tensor, n_dense: int, n_lanes: int) -> torch.Tensor:
    """Flat gather indices compacting per-lane prefixes into one array:
    dense element i maps to element ``k * L + lane`` of a row-major
    (rows, L) plane."""
    lane, k = _dense_lanes(cum, n_dense)
    return k * n_lanes + lane


def _compact(plane: torch.Tensor, cum: torch.Tensor, n_dense: int) -> torch.Tensor:
    """Gather each lane's first cum[j+1]-cum[j] rows of a ``(..., L)``
    plane into a dense 1-D array (clipped gathers for the padding)."""
    idx = _dense_indices(cum, n_dense, plane.shape[-1])
    return _take_clip(plane.reshape(-1), idx)


def _pack_words(pa, pb, w_ll, w_ml, w_of):
    """Field-pack sequence triples: (lo, hi, lane_overflow).

    ``v = ll | ml << w_ll | ofv << (w_ll + w_ml)`` split into its low and
    high u32 words per slot; a value exceeding its field width flags
    the lane for the wide retry.  pa, pb: (R, L) narrow planes (u32 in
    any integer dtype); w_*: int[L]."""
    pa, pb = as_u32(pa), as_u32(pb)
    valid = pa >> 31
    ofv = torch.where(valid != 0, pa & 0x7FFFFFFF, torch.zeros_like(pa))
    ll = pb >> 16
    ml = pb & 0xFFFF
    wl = w_ll.to(I64)[None, :]
    wm = w_ml.to(I64)[None, :]
    wo = w_of.to(I64)[None, :]
    s_ml = wl
    s_of = wl + wm
    lo = ll | _shl(ml, s_ml) | _shl(ofv, s_of)
    hi = _shr(ml, 32 - s_ml) | torch.where(
        s_of >= 32, _shl(ofv, s_of - 32), _shr(ofv, 32 - s_of)
    )
    over = (
        (_shr(ll, wl) != 0) | (_shr(ml, wm) != 0) | (_shr(ofv, wo) != 0)
    ) & (valid != 0)
    return lo, hi, over.any(dim=0)


def _seq_word_plane(lo, hi, w_ll, w_ml, w_of):
    """(2R, L) plane whose rows are each lane's packed words in order:
    lanes with field-width sum <= 32 use lo rows directly, the others
    interleave lo/hi.  Elementwise — the input to the compaction kernel."""
    R, L = lo.shape
    inter = torch.stack([lo, hi], dim=1).reshape(2 * R, L)
    lo_pad = torch.cat([lo, torch.zeros_like(lo)], dim=0)
    g1 = ((w_ll.to(I64) + w_ml.to(I64) + w_of.to(I64)) <= 32)[None, :]
    return torch.where(g1, lo_pad, inter)


def _pack_triples(pa, pb, w_ll, w_ml, w_of, nseq, cumw, n_dense_w: int):
    """Word-granular pack + gather compaction (the reference's XLA form).

    Each lane's sequence k occupies ``g`` whole u32 words (g = 1 when
    the lane's field-width sum is <= 32, else 2).  cumw: int[L+1] prefix
    sums of per-lane word counts nseq * g.  Returns (packed u32[n_dense_w]
    in int64, lane_overflow bool[L])."""
    R = pa.shape[0] * pa.shape[1]
    L = pa.shape[2]
    lo, hi, lane_over = _pack_words(
        pa.reshape(R, L), pb.reshape(R, L), w_ll, w_ml, w_of
    )
    loihi = torch.stack([lo, hi], dim=1).reshape(-1)
    gsh = ((w_ll.to(I64) + w_ml.to(I64) + w_of.to(I64)) > 32).to(I64)
    lane, k = _dense_lanes(cumw, n_dense_w)
    gl = _take_clip(gsh, lane)
    idx = ((k >> gl) * 2 + (k & gl)) * L + lane
    return _take_clip(loihi, idx), lane_over


def _huffman_symbol(v, limits, prevs, lengths, rankb, ranked):
    """Arithmetic canonical Huffman: (symbol, code length) of the 11-bit
    peek ``v`` per lane.  The class is the number of class limits <= v;
    a class index or rank outside its table selects 0, as the
    reference's one-hot selects do."""
    ar = torch.arange(v.shape[0], device=v.device)
    j = (v[:, None] >= limits).sum(dim=1)
    hit = j < limits.shape[1]
    jc = j.clamp(max=limits.shape[1] - 1)
    zero = torch.zeros_like(v)
    length = torch.where(hit, lengths[ar, jc], zero)
    prev = torch.where(hit, prevs[ar, jc], zero)
    rb = torch.where(hit, rankb[ar, jc], zero)
    rank = rb + ((v - prev) >> (11 - length))
    in_rank = (rank >= 0) & (rank < ranked.shape[1])
    sym = torch.where(in_rank, ranked[ar, rank.clamp(0, ranked.shape[1] - 1)], zero)
    return sym & 0xFF, length


def _literals_scan(
    words, base, p0, pend, regen, limits, prevs, lengths, rankb, ranked, max_steps: int
):
    """Shared literals scan: (packed u32[max_steps, 8, L] in int64, ok[L]).

    Symbol i of a lane is decoded at the lane's current bit position and
    consumes its code length while ``i < regen``; past regen the position
    freezes and the slot repeats the symbol there (the reference's
    inactive slots do the same).  Row r of a step holds symbols
    4r..4r+3, LSB first."""
    base, pos, pend, regen = (t.to(I64) for t in (base, p0, pend, regen))
    limits, prevs, lengths, rankb, ranked = (
        t.to(I64) for t in (limits, prevs, lengths, rankb, ranked)
    )
    L = base.shape[0]
    n_sym = max_steps * LIT_SYMS_PER_STEP
    syms = torch.zeros(n_sym, L, dtype=I64, device=base.device)
    live = min(n_sym, int(regen.max()) if L else 0)
    for i in range(live):
        v = read_bits(words, base, pos, 11)
        sym, length = _huffman_symbol(v, limits, prevs, lengths, rankb, ranked)
        syms[i] = sym
        pos = pos - torch.where(i < regen, length, torch.zeros_like(length))
    if live < n_sym and L:
        # Every lane is past its regen: positions are frozen.
        v = read_bits(words, base, pos, 11)
        syms[live:] = _huffman_symbol(v, limits, prevs, lengths, rankb, ranked)[0]
    q = syms.reshape(max_steps, 8, 4, L)
    ys = q[:, :, 0] | (q[:, :, 1] << 8) | (q[:, :, 2] << 16) | (q[:, :, 3] << 24)
    return ys, pos == pend


def decode_literals_dense(
    words,
    lane_mat,  # int[L, 5] stacked per-lane columns (LIT_LANE_COLS)
    cum,  # int[L + 1] word-count prefix sums (ceil(regen / 4))
    b_limits,  # int[T, 12] table banks; per-lane rows gathered by slot
    b_prevs,
    b_lengths,
    b_rankb,
    b_ranked,  # int[T, 256]
    *,
    max_steps: int,
    n_dense: int,
):
    """Literals decode with compaction: one u32 array (int64) of the
    dense words (lane j's packed words at cum[j]..cum[j+1]) then the
    per-lane ok flags."""
    base, p0, pend, regen, slots = (lane_mat[:, c].to(I64) for c in range(LIT_LANE_COLS))
    ys, ok = _literals_scan(
        words, base, p0, pend, regen,
        b_limits[slots], b_prevs[slots], b_lengths[slots], b_rankb[slots],
        b_ranked[slots], max_steps,
    )
    return torch.cat([_compact(ys, cum, n_dense), ok.to(I64)])


def _fse_entry(rows: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """rows[l, state[l]] per lane; 0 for a state past the row plane (the
    reference's one-hot select finds no row)."""
    ar = torch.arange(rows.shape[0], device=rows.device)
    R = rows.shape[1]
    e = rows[ar, state.clamp(0, R - 1)]
    return torch.where((state >= 0) & (state < R), e, torch.zeros_like(e))


def _sequences_scan(
    words, base, p0, pend, nseq,
    ll_p0, ll_p1, of_p0, of_p1, ml_p0, ml_p1,
    ll_al, of_al, ml_al,
    n_slots: int,
    wide: bool,
):
    """Shared interleaved-tANS sequence scan over ``n_slots`` slots.

    Returns ``(pa, pb, ok)`` (narrow) or ``(pa, ll, ml, ok)`` (wide),
    planes ``(n_slots, L)``.  State init reads LL, OF, ML; extra bits
    OF, ML, LL; state updates LL, ML, OF, skipped on a lane's last
    sequence; ``ofv = (1 << of_code) + extra``.

    The reference's 192-bit buffer is tracked by its fill count alone
    (``nb``: three refills per slot, each +32 while nb <= 160): a slot
    decodes only with nb >= SEQ_MAX_BITS.  By the never-stall invariant
    that always holds, so validity is a per-lane prefix; a stall would
    flag the lane bad in the narrow form."""
    base, pos, pend, nseq = (t.to(I64) for t in (base, p0, pend, nseq))
    ll_al, of_al, ml_al = (t.to(I64) for t in (ll_al, of_al, ml_al))
    ll_p0, ll_p1, of_p0, of_p1, ml_p0, ml_p1 = (
        t.to(I64) for t in (ll_p0, ll_p1, of_p0, of_p1, ml_p0, ml_p1)
    )
    L = base.shape[0]
    dev = base.device
    zero = torch.zeros(L, dtype=I64, device=dev)
    nb = (pos & 31) + SEQ_BUF_BITS - 32

    def take(n):
        nonlocal pos, nb
        v = read_bits(words, base, pos, n)
        pos = pos - n
        nb = nb - n
        return v

    s_ll = take(ll_al)
    s_of = take(of_al)
    s_ml = take(ml_al)
    emitted = zero.clone()
    bad = torch.zeros(L, dtype=torch.bool, device=dev)

    pa = torch.zeros(n_slots, L, dtype=I64, device=dev)
    pb = torch.zeros(n_slots, L, dtype=I64, device=dev)
    pc = torch.zeros(n_slots, L, dtype=I64, device=dev) if wide else None
    last = int(nseq.max()) if L else 0
    for t in range(n_slots):
        if t >= last and bool((emitted >= nseq).all()):
            # Every lane is done: the remaining slots are invalid and
            # carry (1 << of_code) of the frozen offset state.
            of_code = _fse_entry(of_p1, s_of)
            pa[t:] = (_shl(torch.ones_like(of_code), of_code) & 0x7FFFFFFF)[None, :]
            break
        for _ in range(3):
            nb = torch.where(nb <= SEQ_BUF_BITS - 32, nb + 32, nb)
        active = emitted < nseq
        can = active & (nb >= SEQ_MAX_BITS)

        e0_ll, e1_ll = _fse_entry(ll_p0, s_ll), _fse_entry(ll_p1, s_ll)
        e0_of, of_code = _fse_entry(of_p0, s_of), _fse_entry(of_p1, s_of)
        e0_ml, e1_ml = _fse_entry(ml_p0, s_ml), _fse_entry(ml_p1, s_ml)

        v = take(torch.where(can, of_code, zero))
        ofv = (_shl(torch.ones_like(of_code), of_code) + v) & M32
        ml = (e1_ml >> 5) + take(torch.where(can, e1_ml & 31, zero))
        ll = (e1_ll >> 5) + take(torch.where(can, e1_ll & 31, zero))

        upd = can & (emitted < nseq - 1)
        v = take(torch.where(upd, e0_ll & 0xFFFF, zero))
        s_ll = torch.where(upd, (e0_ll >> 16) + v, s_ll)
        v = take(torch.where(upd, e0_ml & 0xFFFF, zero))
        s_ml = torch.where(upd, (e0_ml >> 16) + v, s_ml)
        v = take(torch.where(upd, e0_of & 0xFFFF, zero))
        s_of = torch.where(upd, (e0_of >> 16) + v, s_of)

        emitted = emitted + can.to(I64)
        pa[t] = (can.to(I64) << 31) | (ofv & 0x7FFFFFFF)
        bad = bad | (can & (of_code >= 31))
        if wide:
            pb[t] = torch.where(can, ll, zero)
            pc[t] = torch.where(can, ml, zero)
        else:
            bad = bad | (active & ~can)
            bad = bad | (can & ((ll > 0xFFFF) | (ml > 0xFFFF)))
            packed = ((ll << 16) & M32) | (ml & 0xFFFF)
            pb[t] = torch.where(can, packed, zero)
    ok = (emitted == nseq) & (pos == pend) & ~bad
    return (pa, pb, pc, ok) if wide else (pa, pb, ok)


def decode_sequences_v2(
    words,
    base,
    p0,
    pend,
    nseq,
    ll_p0,  # int[L, 512]  baseline << 16 | nbits
    ll_p1,  # int[L, 512]  value_base << 5 | value_extra_bits
    of_p0,
    of_p1,  # int[L, 512]  offset code (value = (1 << code) + extra)
    ml_p0,
    ml_p1,
    ll_al,
    of_al,
    ml_al,
    *,
    max_steps: int,
    wide: bool = False,
):
    """Decode L interleaved tANS sequence streams, 8 slots per step.

    narrow: ``(pa u32[steps, 8, L], pb u32[steps, 8, L], ok[L])`` with
    ``pa = valid << 31 | offset_value`` and ``pb = ll << 16 | ml``;
    wide: ``(pa, ll, ml, ok)`` with full-range ll/ml."""
    out = _sequences_scan(
        words, base, p0, pend, nseq, ll_p0, ll_p1, of_p0, of_p1, ml_p0, ml_p1,
        ll_al, of_al, ml_al, max_steps * SEQ_SLOTS_PER_STEP, wide,
    )
    L = out[0].shape[1]
    planes = tuple(p.reshape(max_steps, SEQ_SLOTS_PER_STEP, L) for p in out[:-1])
    return (*planes, out[-1])


def fse_bank_rows(bank_flat, bank_off, slot):
    """(L, R) rows of each lane's FSE table from a flat variable-size
    bank (slot i = rows off[i]..off[i]+2^al; rows past a table's end are
    the next table's, never selected since states stay < 2^al)."""
    idx = bank_off.to(I64)[slot.to(I64)][:, None] + torch.arange(
        FSE_SLOT_SIZE, dtype=I64, device=bank_flat.device
    )
    return _take_clip(bank_flat, idx)


def sequences_rows_scan(words, lane_mat, bank_flat0, bank_flat1, bank_off, n_slots: int, wide: bool):
    """``_sequences_scan`` over SEQ_LANE_COLS lane columns with table rows
    gathered from the flat banks: the function of the CUDA sequences
    kernel, planes ``(n_slots, L)``."""
    c = [lane_mat[:, k].to(I64) for k in range(SEQ_LANE_COLS)]
    base, p0, pend, nseq = c[0:4]
    ll_slot, of_slot, ml_slot, ll_al, of_al, ml_al = c[7:13]

    def rows(flat, slot):
        return fse_bank_rows(flat, bank_off, slot)

    return _sequences_scan(
        words, base, p0, pend, nseq,
        rows(bank_flat0, ll_slot), rows(bank_flat1, ll_slot),
        rows(bank_flat0, of_slot), rows(bank_flat1, of_slot),
        rows(bank_flat0, ml_slot), rows(bank_flat1, ml_slot),
        ll_al, of_al, ml_al, n_slots, wide,
    )


def decode_sequences_dense(
    words,
    lane_mat,  # int[L, 13] stacked per-lane columns (SEQ_LANE_COLS)
    cumw,  # int[L + 1] prefix sums of per-lane packed word counts
    bank_flat0,  # int[N] flat FSE bank planes
    bank_flat1,
    bank_off,  # int[S] first row of each slot
    *,
    max_steps: int,
    n_dense_w: int,
):
    """Narrow-packed sequence decode with word compaction: one u32 array
    (int64) of the packed words (lane j's at cumw[j]..cumw[j+1]) then
    per-lane ok flags (ok and no packed-field overflow)."""
    pa, pb, ok = sequences_rows_scan(
        words, lane_mat, bank_flat0, bank_flat1, bank_off,
        max_steps * SEQ_SLOTS_PER_STEP, False,
    )
    L = lane_mat.shape[0]
    w_ll, w_ml, w_of = (lane_mat[:, k] for k in (4, 5, 6))
    packed, over = _pack_triples(
        pa.reshape(max_steps, SEQ_SLOTS_PER_STEP, L),
        pb.reshape(max_steps, SEQ_SLOTS_PER_STEP, L),
        w_ll, w_ml, w_of, lane_mat[:, 3], cumw, n_dense_w,
    )
    return torch.cat([packed, (ok & ~over).to(I64)])
