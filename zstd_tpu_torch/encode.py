"""ZSTD encoder (host side).

The reference has no encoder; the north star requires one so round
trips hold (BASELINE.json).  This is a from-scratch RFC 8878 encoder:

* frame writer (magic, header with FCS/window descriptor, optional
  XXH64 content checksum)
* 128 KiB blocks: raw / RLE / compressed, chosen by measured size
* greedy hash-table LZ77 matcher (native C, zt_lz77_greedy; frame-wide
  history so matches cross block boundaries) with repeat-offset coding
* literals: raw / RLE / Huffman-compressed (1 or 4 backward streams),
  package-merge length-limited (<= 11) canonical codes, direct-weights
  serialization
* sequences: LL/OF/ML code streams as interleaved tANS with per-block
  normalized FSE tables (or predefined / RLE modes), written in the
  exact reverse of the decoder's read discipline

Bit-level output is vectorized: each backward stream collects
(value, nbits) pairs and packs them with NumPy scatter-ORs.

Encoded output is validated in tests by round-tripping through both
this package's decoder and libzstd.
"""

from __future__ import annotations

import numpy as np

from .format.frame import MAGIC_ZSTD
from .ops import fse as fse_ops
from .ops.sequence_codes import (
    LL_BASELINE,
    LL_EXTRA_BITS,
    ML_BASELINE,
    ML_EXTRA_BITS,
)
from .utils.xxh64 import xxh64

MAX_BLOCK = 128 << 10


# --------------------------- bit packing ------------------------------------


class ForwardBits:
    """LSB-first forward bit writer (headers, FSE table descriptions)."""

    def __init__(self) -> None:
        self.vals: list[int] = []
        self.bits: list[int] = []

    def write(self, value: int, nbits: int) -> None:
        if nbits:
            self.vals.append(value & ((1 << nbits) - 1))
            self.bits.append(nbits)

    @property
    def bitlen(self) -> int:
        return sum(self.bits)

    def to_bytes(self) -> bytes:
        total = self.bitlen
        out = bytearray((total + 7) // 8)
        pos = 0
        for v, n in zip(self.vals, self.bits):
            byte, off = pos >> 3, pos & 7
            acc = v << off
            while acc:
                out[byte] |= acc & 0xFF
                acc >>= 8
                byte += 1
            pos += n
        return bytes(out)


def pack_backward_stream(values: np.ndarray, nbits: np.ndarray) -> bytes:
    """Pack (value, nbits) writes into a backward stream with sentinel.

    Writes fill the little-endian bit space from bit 0 upward; the
    decoder reads from the sentinel downward, so the *last* write is
    read first.  Vectorized scatter-OR into u32 words.
    """
    values = np.asarray(values, dtype=np.uint64)
    nbits = np.asarray(nbits, dtype=np.int64)
    assert (values < (np.uint64(1) << np.uint64(32))).all()
    pos = np.concatenate([[0], np.cumsum(nbits)])
    total = int(pos[-1])
    nwords = (total + 1 + 31) // 32 + 1
    words = np.zeros(nwords, dtype=np.uint32)
    starts = pos[:-1]
    # value < 2^32 shifted by <= 31 fits two u32 words.
    shifted = values << (starts.astype(np.uint64) & 31)
    idx = (starts >> 5).astype(np.int64)
    np.bitwise_or.at(words, idx, (shifted & 0xFFFFFFFF).astype(np.uint32))
    np.bitwise_or.at(words, idx + 1, (shifted >> 32).astype(np.uint32))
    # Sentinel bit just above the payload.
    words[total >> 5] |= np.uint32(1) << (total & 31)
    raw = words.tobytes()
    return raw[: (total + 1 + 7) // 8]


# ------------------------- Huffman (literals) -------------------------------


def package_merge_lengths(freqs: np.ndarray, max_len: int = 11) -> np.ndarray:
    """Optimal length-limited code lengths (package-merge, boundary form)."""
    syms = np.flatnonzero(freqs)
    if len(syms) <= 1:
        lengths = np.zeros(len(freqs), dtype=np.int64)
        lengths[syms] = 1
        return lengths
    # Package-merge over (weight, {symbols}) items.
    items = [(int(freqs[s]), (int(s),)) for s in syms]
    items.sort()
    level = items
    merged: list[tuple[int, tuple[int, ...]]] = []
    for _ in range(max_len - 1):
        packages = [
            (level[i][0] + level[i + 1][0], level[i][1] + level[i + 1][1])
            for i in range(0, len(level) - 1, 2)
        ]
        level = sorted(items + packages)
    # Take the first 2n-2 items; each symbol's length = its occurrence count.
    lengths = np.zeros(len(freqs), dtype=np.int64)
    for _, ss in level[: 2 * len(syms) - 2]:
        for s in ss:
            lengths[s] += 1
    return lengths


def huffman_codes(freqs: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Canonical codes from frequencies.

    Returns (code, length, max_bits); canonical layout matches the
    decoder (longest codes first from 0, ties by symbol index:
    ops/huffman.py build_huffman_table).
    """
    lengths = package_merge_lengths(freqs)
    max_bits = int(lengths.max())
    codes = np.zeros(len(freqs), dtype=np.int64)
    idx = 0  # position in the 2^max_bits window space
    for w in range(1, max_bits + 1):  # weight ascending == length descending
        length = max_bits + 1 - w
        for s in np.flatnonzero(lengths == length):
            codes[s] = idx >> (w - 1)
            idx += 1 << (w - 1)
    assert idx == 1 << max_bits, "lengths do not form a complete code"
    return codes, lengths, max_bits


def serialize_huffman_weights(lengths: np.ndarray, max_bits: int) -> bytes | None:
    """Weights serialization: FSE-compressed when smaller, else direct.

    The last present symbol's weight is implied (huffman.rs:92-106).
    Direct form: header 128..255 → (header - 127) 4-bit weights.
    FSE form: header < 128 → that many bytes of table description +
    two-state interleaved tANS weight stream (RFC 8878 §4.2.1.2).
    """
    weights = np.where(lengths > 0, max_bits + 1 - lengths, 0)
    last = int(np.flatnonzero(weights)[-1])
    explicit = weights[:last].astype(np.int64)  # weight of `last` implied

    direct = None
    if len(explicit) <= 128:
        out = bytearray([127 + len(explicit)])
        for i in range(0, len(explicit), 2):
            hi = int(explicit[i]) << 4
            lo = int(explicit[i + 1]) if i + 1 < len(explicit) else 0
            out.append(hi | lo)
        direct = bytes(out)

    fse = _serialize_weights_fse(explicit)
    if fse is not None and (direct is None or len(fse) < len(direct)):
        return fse
    return direct


def _serialize_weights_fse(explicit: np.ndarray) -> bytes | None:
    """FSE-compress the explicit weights (two interleaved tANS states).

    Write order is the exact reverse of the decoder's read order
    (ops/huffman.py decode_fse_weights): the decoder reads state1 then
    state2, then symbols alternate 1,2,1,2,... with each state updated
    right after its symbol is emitted.
    """
    n = len(explicit)
    if n < 2:
        return None
    freqs = np.bincount(explicit, minlength=int(explicit.max()) + 1)
    if len(np.flatnonzero(freqs)) < 2:
        # A single weight value would normalize to a full-probability
        # symbol (0-bit states) — the decoder's drain loop could not
        # terminate on bits; use the direct form instead.
        return None
    al = max(5, min(6, int(n).bit_length()))  # weights cap: AL <= 6
    dist = normalize_distribution(freqs, al)
    try:
        table = fse_ops.build_fse_table(al, dist)
    except Exception:
        return None
    fb = ForwardBits()
    serialize_fse_distribution(al, dist, fb)
    desc = fb.to_bytes()
    enc = FseEncoder(table)

    # Decoder read order: s1, s2, then per k: emit w[k] from state
    # (k % 2) and update that state (reads its nbits) unless it's one of
    # the two final buffered symbols.  Encoder walks backwards.
    # States: chain for even indices (state1) and odd indices (state2).
    # The last update consumed for state i-parity is at the largest k of
    # that parity with k < n - 2... every symbol except the final one of
    # each parity has a following update read.
    writes_v: list[int] = []
    writes_n: list[int] = []
    chains = {p: [k for k in range(n) if k % 2 == p] for p in (0, 1)}
    state = {p: enc.init_state(int(explicit[chains[p][-1]])) for p in (0, 1)}
    # Transition writes, interleaved in reverse global order.  The
    # decoder's update for symbol k happens right after emitting k (for
    # all k except the final symbol of each parity, which is flushed
    # from the buffer).  Reverse read order => iterate k from high to
    # low, skipping each parity's last symbol.
    skip = {p: chains[p][-1] for p in (0, 1)}
    pending: list[tuple[int, int]] = []
    for k in range(n - 1, -1, -1):
        if k == skip[k % 2]:
            continue
        p = k % 2
        state[p], v, nb = enc.transition(int(explicit[k]), state[p])
        pending.append((v, nb))
    # Reads happen init-first; writes are appended in reverse read
    # order, so transitions (built high-k to low-k) come first...
    for v, nb in pending:
        writes_v.append(v)
        writes_n.append(nb)
    # ... then the two init states: decoder reads s1 (parity 0) then s2.
    writes_v.append(state[1])
    writes_n.append(enc.al)
    writes_v.append(state[0])
    writes_n.append(enc.al)
    stream = pack_backward_stream(np.array(writes_v), np.array(writes_n))

    payload = desc + stream
    if len(payload) >= 128:
        return None
    return bytes([len(payload)]) + payload


def encode_literals_streams(
    literals: np.ndarray, codes: np.ndarray, lengths: np.ndarray, n_streams: int
) -> list[bytes]:
    """Huffman-encode literals into 1 or 4 backward streams.

    Each stream's symbols are written in reverse order (the decoder
    reads from the sentinel down, first literal on top).
    """
    n = len(literals)
    if n_streams == 1:
        parts = [literals]
    else:
        per = (n + 3) // 4
        parts = [literals[0:per], literals[per : 2 * per],
                 literals[2 * per : 3 * per], literals[3 * per :]]
    out = []
    for part in parts:
        rev = part[::-1].astype(np.int64)
        out.append(pack_backward_stream(codes[rev], lengths[rev]))
    return out


# ----------------------------- FSE (sequences) -------------------------------


def normalize_distribution(freqs: np.ndarray, al: int) -> np.ndarray:
    """Normalize counts to sum 2^al with -1 for rare symbols (RFC §4.1).

    Largest-remainder apportionment: floor the scaled counts, then hand
    the leftover table slots to the symbols with the largest fractional
    parts (instead of dumping the whole correction on argmax, which
    skewed every table and cost ~0.1 bit/sequence on locked streams)."""
    total = int(freqs.sum())
    size = 1 << al
    probs = np.zeros(len(freqs), dtype=np.int64)
    scaled = freqs.astype(np.float64) * size / total
    rare = (freqs > 0) & (scaled < 1.0)
    probs[rare] = -1
    big = scaled >= 1.0
    probs[big] = np.floor(scaled[big]).astype(np.int64)
    diff = size - int(probs[big].sum()) - int(rare.sum())
    if big.any():
        if diff > 0:
            # Distribute surplus slots by largest fractional part.
            frac = np.where(big, scaled - np.floor(scaled), -1.0)
            order = np.argsort(-frac)
            k = 0
            while diff > 0:
                s = order[k % len(order)]
                if big[s]:
                    probs[s] += 1
                    diff -= 1
                k += 1
        elif diff < 0:
            # Remove slots from the largest entries (keeping >= 1).
            while diff < 0:
                s = int(np.argmax(probs))
                if probs[s] <= 1:
                    break
                probs[s] -= 1
                diff += 1
            if diff < 0:
                probs[np.argmax(freqs)] += diff
    if probs[np.argmax(freqs)] <= 0:
        # Degenerate adjustment; fall back to dumping everything on argmax.
        probs[:] = np.where(freqs > 0, -1, 0)
        probs[np.argmax(freqs)] = size - (int((freqs > 0).sum()) - 1)
    return probs


def serialize_fse_distribution(al: int, dist: np.ndarray, fb: ForwardBits) -> None:
    """Write the FSE table description (inverse of parse_fse_distribution)."""
    fb.write(al - 5, 4)
    remaining = 1 << al
    i = 0
    dist = list(dist)
    # Trim trailing zeros — the reader stops when remaining hits 0.
    while dist and dist[-1] == 0:
        dist.pop()
    while remaining > 0 and i < len(dist):
        proba = int(dist[i])
        bits = (remaining + 1).bit_length()
        lower_mask = (1 << (bits - 1)) - 1
        threshold = (1 << bits) - 1 - (remaining + 1)
        value = proba + 1
        if value < threshold:
            fb.write(value, bits - 1)
        elif value <= lower_mask:
            fb.write(value, bits)
        else:
            fb.write(value + threshold, bits)
        remaining -= abs(proba) if proba != 0 else 0
        if proba == -1:
            remaining -= 0  # abs(-1) already subtracted 1
        i += 1
        if proba == 0:
            # Zero-run escape.
            run = 0
            while i < len(dist) and dist[i] == 0 and run < 10000:
                run += 1
                i += 1
            while run >= 3:
                fb.write(3, 2)
                run -= 3
            fb.write(run, 2)


class FseEncoder:
    """Inverse-of-decode-table tANS encoder for one code stream.

    Built from the same decode table the decoder will construct: for
    symbol s and desired next-decoder-state v, the transition state is
    the state t of s whose [baseline, baseline + 2^nbits) range contains
    v; the emitted bits are v - baseline(t).
    """

    def __init__(self, table: fse_ops.FseTable):
        size = table.size
        self.al = table.accuracy_log
        self.state_of = {}
        self.nbits_of = {}
        self.base_of = {}
        sym_states: dict[int, list[int]] = {}
        for t in range(size):
            sym_states.setdefault(int(table.symbol[t]), []).append(t)
        for s, states in sym_states.items():
            st = np.zeros(size, dtype=np.int64)
            nb = np.zeros(size, dtype=np.int64)
            ba = np.zeros(size, dtype=np.int64)
            for t in states:
                b, n = int(table.baseline[t]), int(table.nbits[t])
                st[b : b + (1 << n)] = t
                nb[b : b + (1 << n)] = n
                ba[b : b + (1 << n)] = b
            self.state_of[s] = st
            self.nbits_of[s] = nb
            self.base_of[s] = ba
        self.first_state = {s: states[0] for s, states in sym_states.items()}

    def init_state(self, sym: int) -> int:
        return self.first_state[int(sym)]

    def transition(self, sym: int, next_state: int) -> tuple[int, int, int]:
        """(state, bits_value, nbits) so the decoder moves to next_state."""
        s = int(sym)
        return (
            int(self.state_of[s][next_state]),
            next_state - int(self.base_of[s][next_state]),
            int(self.nbits_of[s][next_state]),
        )


# --------------------------- sequence coding ---------------------------------


def offsets_to_values(
    ll: np.ndarray, off: np.ndarray, rep: list[int]
) -> np.ndarray:
    """Offsets → offset_values using the 3-slot history (inverse of
    ops/sequence_codes.resolve_offset), mutating ``rep``."""
    out = np.zeros(len(off), dtype=np.int64)
    for i in range(len(off)):
        o = int(off[i])
        l = int(ll[i])
        if l != 0:
            if o == rep[0]:
                v = 1
            elif o == rep[1]:
                v = 2
            elif o == rep[2]:
                v = 3
            else:
                v = o + 3
        else:
            if o == rep[1]:
                v = 1
            elif o == rep[2]:
                v = 2
            elif o == rep[0] - 1 and o > 0:
                v = 3
            else:
                v = o + 3
        # Apply the decoder's history update (decoding_context.rs:50-75):
        # the effective repeat index is v-1 for ll != 0, v for ll == 0.
        idx = v - 1 if l != 0 else v
        if v > 3:
            rep[0], rep[1], rep[2] = o, rep[0], rep[1]
        elif idx == 0:
            pass
        elif idx == 1:
            rep[0], rep[1] = rep[1], rep[0]
        elif idx == 2:
            rep[0], rep[1], rep[2] = rep[2], rep[0], rep[1]
        else:  # idx == 3: ll == 0, v == 3 -> rep0 - 1 pushed as new
            rep[0], rep[1], rep[2] = o, rep[0], rep[1]
        out[i] = v
    return out


def _code_of(values: np.ndarray, baselines: np.ndarray) -> np.ndarray:
    """code = last baseline <= value (LL/ML code tables)."""
    return np.searchsorted(baselines, values, side="right") - 1


def _of_code(values: np.ndarray) -> np.ndarray:
    """Offset code = floor(log2(offset_value)) (sequence.rs:50)."""
    return np.int64(np.floor(np.log2(values.astype(np.float64)))).astype(np.int64)


class FrameCtx:
    """Per-frame entropy-table context: mirrors what the DECODER caches
    across blocks (treeless Huffman reuse, FSE Repeat mode —
    decoding_context.rs:17-26 is the decoder's side).  Snapshot/restore
    keeps the encoder's view transactional: a block that falls back to
    raw must not advertise tables the decoder never installed."""

    def __init__(self) -> None:
        self.seq: dict = {}  # kind -> ("rle", sym) | ("tab", table, al, dist)
        self.huff: tuple | None = None  # (codes, lengths, max_bits)

    def snapshot(self) -> tuple:
        return (dict(self.seq), self.huff)

    def restore(self, snap: tuple) -> None:
        self.seq, self.huff = dict(snap[0]), snap[1]


def _fse_stream_bits(counts: np.ndarray, al: int, dist) -> float:
    """Expected tANS stream bits for ``counts[c]`` occurrences of each
    code under a table with slot distribution ``dist`` (|-1| = 1 slot);
    inf when a needed code has no slots (table incompatible)."""
    dist = np.asarray(dist, dtype=np.int64)
    slots = np.where(dist == -1, 1, dist).astype(np.float64)
    used = np.flatnonzero(counts)
    if used.size == 0:
        return 0.0
    if used.max() >= len(dist) or (slots[used] <= 0).any():
        return float("inf")
    return float(np.sum(counts[used] * (al - np.log2(slots[used]))))


_PREDEF = {
    "ll": (fse_ops.LITERALS_LENGTH_DEFAULT_AL, fse_ops.LITERALS_LENGTH_DEFAULT_DIST),
    "of": (fse_ops.OFFSET_DEFAULT_AL, fse_ops.OFFSET_DEFAULT_DIST),
    "ml": (fse_ops.MATCH_LENGTH_DEFAULT_AL, fse_ops.MATCH_LENGTH_DEFAULT_DIST),
}
_PREDEF_TABLE = {
    "ll": fse_ops.PREDEFINED_LL_TABLE,
    "of": fse_ops.PREDEFINED_OF_TABLE,
    "ml": fse_ops.PREDEFINED_ML_TABLE,
}


def choose_mode(codes: np.ndarray, kind: str, nseq: int, ctx: FrameCtx | None = None):
    """Pick the cheapest mode for one field by MEASURED cost (stream
    bits + header bytes): 'rle' | 'predefined' | 'fse' | 'repeat'."""
    counts = np.bincount(codes)
    uniq = np.flatnonzero(counts)
    candidates: list[tuple[float, str, object]] = []

    if len(uniq) == 1:
        candidates.append((8.0, "rle", int(uniq[0])))

    p_al, p_dist = _PREDEF[kind]
    candidates.append(
        (_fse_stream_bits(counts, p_al, p_dist), "predefined", _PREDEF_TABLE[kind])
    )

    if len(uniq) > 1:
        al_cap = {"ll": 9, "of": 8, "ml": 9}[kind]
        al = max(5, min(al_cap, int(nseq).bit_length() - 1))
        dist = normalize_distribution(counts, al)
        try:
            fse_table = fse_ops.build_fse_table(al, dist)
            fb = ForwardBits()
            serialize_fse_distribution(al, dist, fb)
            header_bits = 8 * len(fb.to_bytes())
            cost = header_bits + _fse_stream_bits(counts, al, dist)
            candidates.append((cost, "fse", (fse_table, al, dist)))
        except Exception:
            pass

    if ctx is not None and kind in ctx.seq:
        prev = ctx.seq[kind]
        if prev[0] == "rle":
            if len(uniq) == 1 and int(uniq[0]) == prev[1]:
                candidates.append((0.0, "repeat", prev))
        else:
            _tag, table, al, dist = prev
            cost = _fse_stream_bits(counts, al, dist)
            if cost != float("inf"):
                candidates.append((cost, "repeat", prev))

    candidates.sort(key=lambda c: c[0])
    return candidates[0][1], candidates[0][2]


def _rle_encoder(sym: int) -> FseEncoder:
    return FseEncoder(
        fse_ops.FseTable(
            accuracy_log=0,
            symbol=np.array([sym], dtype=np.uint16),
            baseline=np.array([0], dtype=np.uint16),
            nbits=np.array([0], dtype=np.uint8),
        )
    )


def encode_sequences_section(
    ll: np.ndarray, ofv: np.ndarray, ml: np.ndarray, ctx: FrameCtx | None = None
) -> bytes:
    """Serialize the full sequences section of one block.

    With a :class:`FrameCtx`, table choice is cost-based across all
    four modes including Repeat (reusing the table the decoder already
    holds — zero header bytes), and the context is updated to what the
    decoder will cache after this block."""
    nseq = len(ll)
    out = bytearray()
    if nseq < 128:
        out.append(nseq)
    elif nseq < 0x7F00:
        out.append((nseq >> 8) + 128)
        out.append(nseq & 0xFF)
    else:
        out.append(255)
        out += int(nseq - 0x7F00).to_bytes(2, "little")
    if nseq == 0:
        return bytes(out)

    ll_codes = _code_of(ll, LL_BASELINE)
    ml_codes = _code_of(ml, ML_BASELINE)
    of_codes = _of_code(ofv)

    fields = {}
    mode_bits = {}
    for kind, codes in (("ll", ll_codes), ("of", of_codes), ("ml", ml_codes)):
        mode, payload = choose_mode(codes, kind, nseq, ctx)
        fields[kind] = (mode, payload, codes)
        mode_bits[kind] = {"predefined": 0, "rle": 1, "fse": 2, "repeat": 3}[mode]

    out.append(mode_bits["ll"] << 6 | mode_bits["of"] << 4 | mode_bits["ml"] << 2)

    # Mode payloads in LL, OF, ML order.
    encoders = {}
    for kind in ("ll", "of", "ml"):
        mode, payload, codes = fields[kind]
        if mode == "rle":
            out.append(payload)
            encoders[kind] = _rle_encoder(payload)
            if ctx is not None:
                ctx.seq[kind] = ("rle", payload)
        elif mode == "predefined":
            encoders[kind] = FseEncoder(payload)
            if ctx is not None:
                p_al, p_dist = _PREDEF[kind]
                ctx.seq[kind] = ("tab", payload, p_al, p_dist)
        elif mode == "repeat":
            if payload[0] == "rle":
                encoders[kind] = _rle_encoder(payload[1])
            else:
                encoders[kind] = FseEncoder(payload[1])
        else:
            fse_table, al, dist = payload
            fb = ForwardBits()
            serialize_fse_distribution(al, dist, fb)
            out += fb.to_bytes()
            encoders[kind] = FseEncoder(fse_table)
            if ctx is not None:
                ctx.seq[kind] = ("tab", fse_table, al, dist)

    # Extra-bit values.
    of_extra = ofv - (np.int64(1) << of_codes)
    of_extra_bits = of_codes
    ml_extra = ml - ML_BASELINE[ml_codes]
    ml_extra_bits = ML_EXTRA_BITS[ml_codes]
    ll_extra = ll - LL_BASELINE[ll_codes]
    ll_extra_bits = LL_EXTRA_BITS[ll_codes]

    enc_ll, enc_of, enc_ml = encoders["ll"], encoders["of"], encoders["ml"]
    writes_v: list[int] = []
    writes_n: list[int] = []

    # Last sequence: extras only (its states are the init states).
    last = nseq - 1
    writes_v += [int(ll_extra[last]), int(ml_extra[last]), int(of_extra[last])]
    writes_n += [int(ll_extra_bits[last]), int(ml_extra_bits[last]),
                 int(of_extra_bits[last])]
    d_ll = enc_ll.init_state(ll_codes[last])
    d_of = enc_of.init_state(of_codes[last])
    d_ml = enc_ml.init_state(ml_codes[last])

    for i in range(nseq - 2, -1, -1):
        # Transitions feeding the decoder's update after seq i (read
        # order LL, ML, OF -> written OF, ML, LL... decoder reads these
        # *after* seq i's extras; we write transitions first so they
        # land above the extras: write order per zstd is
        # encode OF, ML, LL then extras LL, ML, OF.
        d_of, v, n = enc_of.transition(of_codes[i], d_of)
        writes_v.append(v)
        writes_n.append(n)
        d_ml, v, n = enc_ml.transition(ml_codes[i], d_ml)
        writes_v.append(v)
        writes_n.append(n)
        d_ll, v, n = enc_ll.transition(ll_codes[i], d_ll)
        writes_v.append(v)
        writes_n.append(n)
        writes_v += [int(ll_extra[i]), int(ml_extra[i]), int(of_extra[i])]
        writes_n += [int(ll_extra_bits[i]), int(ml_extra_bits[i]),
                     int(of_extra_bits[i])]

    # Flush initial states: ML, OF, LL (decoder init reads LL, OF, ML).
    writes_v += [d_ml, d_of, d_ll]
    writes_n += [enc_ml.al, enc_of.al, enc_ll.al]

    out += pack_backward_stream(np.array(writes_v), np.array(writes_n))
    return bytes(out)


# ----------------------------- literals section ------------------------------


def encode_literals_section(
    literals: np.ndarray, ctx: FrameCtx | None = None
) -> bytes:
    """Serialize the literals section: raw / RLE / Huffman-compressed /
    treeless (reusing the frame's cached Huffman table when the decoder
    already holds one that covers this block's bytes and measures
    cheaper than a fresh table + weights header)."""
    n = len(literals)
    if n == 0:
        return bytes([0 << 0 | 0])  # raw, size 0
    uniq = np.unique(literals)
    if len(uniq) == 1:
        return _literals_rle_header(n) + bytes([int(uniq[0])])

    freqs = np.bincount(literals, minlength=256)
    if len(np.flatnonzero(freqs)) < 2 or n < 64:
        return _literals_raw(literals)
    codes, lengths, max_bits = huffman_codes(freqs)
    weights_ser = serialize_huffman_weights(lengths, max_bits)
    if weights_ser is None:
        return _literals_raw(literals)
    cost_new = 8 * len(weights_ser) + int((lengths * freqs).sum())

    treeless = False
    if ctx is not None and ctx.huff is not None:
        p_codes, p_lengths, _p_mb = ctx.huff
        used = freqs > 0
        if (p_lengths[used] > 0).all():
            cost_prev = int((p_lengths * freqs).sum())
            if cost_prev < cost_new:
                treeless = True
                codes, lengths = p_codes, p_lengths

    ltype = 3 if treeless else 2
    n_streams = 1 if n < 1024 else 4
    streams = encode_literals_streams(literals, codes, lengths, n_streams)
    head = b"" if treeless else weights_ser
    if n_streams == 4:
        jump = b"".join(len(s).to_bytes(2, "little") for s in streams[:3])
        payload = head + jump + b"".join(streams)
    else:
        payload = head + streams[0]
    if len(payload) >= n:
        return _literals_raw(literals)

    comp_size = len(payload)
    if n_streams == 1:
        header = _pack_lit_header(ltype, 0, n, comp_size, 3)
    elif n <= 0x3FF and comp_size <= 0x3FF:
        header = _pack_lit_header(ltype, 1, n, comp_size, 3)
    elif n <= 0x3FFF and comp_size <= 0x3FFF:
        header = _pack_lit_header(ltype, 2, n, comp_size, 4)
    else:
        header = _pack_lit_header(ltype, 3, n, comp_size, 5)
    if ctx is not None and not treeless:
        ctx.huff = (codes, lengths, max_bits)
    return header + payload


def _pack_lit_header(ltype, size_format, regen, comp, nbytes) -> bytes:
    if size_format in (0, 1):
        packed = ltype | (size_format << 2) | (regen << 4) | (comp << 14)
    elif size_format == 2:
        packed = ltype | (size_format << 2) | (regen << 4) | (comp << 18)
    else:
        packed = ltype | (size_format << 2) | (regen << 4) | (comp << 22)
    return int(packed).to_bytes(nbytes, "little")


def _literals_raw(literals: np.ndarray) -> bytes:
    n = len(literals)
    if n <= 31:
        header = bytes([(n << 3) | 0])
    elif n <= 0xFFF:
        header = int(((n << 4) | (1 << 2) | 0)).to_bytes(2, "little")
    else:
        header = int(((n << 4) | (3 << 2) | 0)).to_bytes(3, "little")
    return header + literals.tobytes()


def _literals_rle_header(n: int) -> bytes:
    if n <= 31:
        return bytes([(n << 3) | 1])
    if n <= 0xFFF:
        return int((n << 4) | (1 << 2) | 1).to_bytes(2, "little")
    return int((n << 4) | (3 << 2) | 1).to_bytes(3, "little")


# ------------------------------- frame writer --------------------------------


def _frame_header(content_size: int, checksum: bool, single_segment: bool,
                  window_log: int) -> bytes:
    out = bytearray()
    if content_size <= 255 and single_segment:
        fcs_flag, fcs_bytes = 0, 1
    elif content_size - 256 <= 0xFFFF and content_size >= 256:
        fcs_flag, fcs_bytes = 1, 2
    elif content_size <= 0xFFFFFFFF:
        fcs_flag, fcs_bytes = 2, 4
    else:
        fcs_flag, fcs_bytes = 3, 8
    if not single_segment and fcs_flag == 0:
        fcs_bytes = 0
    desc = (fcs_flag << 6) | (int(single_segment) << 5) | (int(checksum) << 2)
    out.append(desc)
    if not single_segment:
        out.append((window_log - 10) << 3)
    if fcs_bytes:
        v = content_size - 256 if fcs_flag == 1 else content_size
        out += int(v).to_bytes(fcs_bytes, "little")
    return bytes(out)


def compress(
    data: bytes,
    level: int = 3,
    *,
    checksum: bool = False,
    max_window_log: int = 23,
) -> bytes:
    """Compress ``data`` into a single ZSTD frame.

    ``level <= 0`` stores raw blocks.  Levels map to match-search
    effort (hash-chain attempts + lazy evaluation), zstd-style:
    1 = fast greedy, 2-3 = wider greedy, 4-6 = lazy, 7+ = deep lazy.
    """
    src = np.frombuffer(data, dtype=np.uint8)
    n = len(src)
    single_segment = n <= (1 << max_window_log) and n > 0
    window_log = min(max_window_log, max(10, int(n - 1).bit_length() if n else 10))
    out = bytearray(MAGIC_ZSTD.to_bytes(4, "little"))
    out += _frame_header(n, checksum, single_segment, window_log)

    try:
        from . import native

        have_native = native.available() and level > 0
    except Exception:
        have_native = False
    attempts, lazy = _level_params(level)

    if have_native and lazy == "optimal":
        # Whole-frame best-of: the DP parse usually wins, but on
        # structured synthetics the weaker lazy parse can land on
        # lower-entropy streams whose advantage COMPOUNDS through the
        # frame's entropy context (per-block min was measured worse
        # than either pure strategy — cross-block coupling).  Encode
        # the frame both ways and keep the smaller.
        blocks = min(
            _compress_frame_blocks(src, n, window_log, have_native, attempts, "optimal"),
            # The level-3 lazy strategy, verbatim: a deliberately weak
            # parse — deeper searches LOSE on counter-style synthetics
            # (attempts=32 lazy measured worse than attempts=8 here).
            _compress_frame_blocks(src, n, window_log, have_native, 8, True),
            key=len,
        )
    else:
        blocks = _compress_frame_blocks(src, n, window_log, have_native, attempts, lazy)
    out += blocks

    if checksum:
        out += (xxh64(data) & 0xFFFFFFFF).to_bytes(4, "little")
    return bytes(out)


def _compress_frame_blocks(
    src: np.ndarray, n: int, window_log: int, have_native: bool,
    attempts: int, lazy,
) -> bytes:
    """Encode all blocks of one frame with one parse strategy."""
    state = None
    if have_native:
        from . import native

        state = native.new_match_state(chain_log=min(22, max(16, window_log)))
    out = bytearray()
    rep = [1, 4, 8]
    ctx = FrameCtx()
    nblocks = max(1, -(-n // MAX_BLOCK))
    for bi in range(nblocks):
        start, end = bi * MAX_BLOCK, min(n, (bi + 1) * MAX_BLOCK)
        last = 1 if bi == nblocks - 1 else 0
        block = src[start:end]
        body = None
        if have_native and end - start >= 64:
            body = _compress_block(
                src, start, end, 1 << window_log, state, rep, attempts, lazy,
                ctx,
            )
        if body is not None and len(body) < len(block):
            header = last | (2 << 1) | (len(body) << 3)
            out += header.to_bytes(3, "little") + body
        elif len(np.unique(block)) == 1 and len(block) > 0:
            header = last | (1 << 1) | (len(block) << 3)
            out += header.to_bytes(3, "little") + bytes([int(block[0])])
        else:
            header = last | (0 << 1) | (len(block) << 3)
            out += header.to_bytes(3, "little") + block.tobytes()
    return bytes(out)


def _level_params(level: int) -> tuple[int, bool]:
    """Compression level → (hash-chain attempts, parse mode).

    Mode False = greedy, True = one-step lazy, "optimal" = the
    price-driven DP parse (native zt_lz77_optimal) — the btopt
    analog that leaves under-priced matches as literals."""
    if level <= 1:
        return 2, False
    if level <= 2:
        return 8, False
    if level <= 3:
        return 8, True
    # The DP parse beats deeper lazy searches from here on: on 300 KB
    # of moby text, lazy-16 = 124,082 B vs optimal-32 = 112,719 B —
    # past libzstd-6's 116,080 (r5; BASELINE.md encoder table).
    if level <= 6:
        return 32, "optimal"
    if level <= 9:
        return 48, "optimal"
    return 64, "optimal"


def _compress_block(
    src, start, end, window, state, rep, attempts, lazy, ctx: FrameCtx
) -> bytes | None:
    """Build one compressed-block body, or None if not worthwhile.

    ``ctx`` updates (cached Huffman table, FSE tables) commit only when
    the compressed body is actually used — a raw-block fallback must
    leave the decoder-visible caches untouched.

    At optimal levels the block is parsed BOTH ways (price-driven DP
    and one-step lazy) and the smaller encoding wins: on structured
    synthetics the weaker parse sometimes lands on lower-entropy
    streams (see BASELINE.md encoder notes), and measuring beats
    guessing."""
    from . import native

    snap = ctx.snapshot()
    if lazy == "optimal":
        ll, off, ml, literals = native.lz77_optimal(
            src, start, end, window, state, rep, attempts
        )
    else:
        ll, off, ml, literals = native.lz77_lazy(
            src, start, end, window, state, rep, attempts, lazy
        )
    body = _encode_parsed(ll, off, ml, literals, end - start, rep, ctx)
    if body is None:
        ctx.restore(snap)
    return body


def _encode_parsed(ll, off, ml, literals, block_len, rep, ctx) -> bytes | None:
    """Sections from one parse result; None when not worthwhile.
    Mutates ``rep``/``ctx`` on success; ``rep`` is restored on failure
    (the caller restores ``ctx``)."""
    rep_snapshot = list(rep)
    if len(ll) == 0:
        try:
            lit_sec = encode_literals_section(literals, ctx)
        except Exception:
            return None
        if len(lit_sec) + 1 >= block_len:
            return None
        return lit_sec + bytes([0])  # 0 sequences
    ofv = offsets_to_values(ll, off, rep)
    try:
        lit_sec = encode_literals_section(literals, ctx)
        seq_sec = encode_sequences_section(
            ll.astype(np.int64), ofv, ml.astype(np.int64), ctx
        )
    except Exception:
        rep[:] = rep_snapshot
        return None
    body = lit_sec + seq_sec
    if len(body) >= block_len:
        rep[:] = rep_snapshot
        return None
    return body


