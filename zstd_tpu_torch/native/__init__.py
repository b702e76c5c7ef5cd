"""Native host-runtime bindings (ctypes over a gcc-built shared object).

Builds ``zstd_tpu_torch/csrc/host.c`` on first use (plain ``gcc -O2
-shared``) into the git-ignored ``build/zstd_tpu_torch/`` directory at
the repository root, and exposes the decode side:

* ``require()`` (the library, or ``NativeUnavailable`` with the
  compiler's message) / ``available()``
* ``fse_parse_build(data)`` / ``fse_weights(payload)`` (prepass tables)
* ``huffman_canonical(payload)`` / ``fse_pack(symbol, baseline, nbits,
  kind)`` (the batch plan's tables packed for the kernels' banks)
* ``xxh64(data, seed)``
* ``unpack_sequences(words, cumw, nseq, w_ll, w_ml, w_of)`` (the
  sequences kernel's fetched words split into (ll, ofv, ml))
* ``assemble_group(out, frames, blocks, ...)`` (a frame group's frames
  assembled onto a ``bytearray`` in one call, with each frame's status)
  and ``execute_sequences(out, out_len, literals, ll, ofv, ml, rep)``
  (its executor on one block, with the bytes its matches copy from
  earlier blocks)
* ``resolve_offsets(ll, ofv, rep)`` (the device LZ77 route's offset scan)

and the encoder's match finders (``encode.py``):

* ``MatchState`` / ``new_match_state(chain_log)`` (hash-chain tables
  kept across a frame's blocks)
* ``lz77_lazy(...)`` (hash-chain lazy matcher) and ``lz77_optimal(...)``
  (price-driven optimal parse)

The engine requires the library, as it requires the CUDA build:
``DeviceEngine`` calls ``require()`` at construction, and the batch
plan, the sequence unpack, the C executor and the device LZ77 route's
offset scan have no other form.  ``fse_parse_build``, ``fse_weights``,
``xxh64`` and the match finders serve the host modules copied verbatim
from ``zstd_tpu`` (``ops/fse.py``, ``ops/huffman.py``,
``utils/xxh64.py``, ``encode.py``), which check ``available()`` and keep
their own fallbacks.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "host.c"
BUILD_DIR = _PKG.parent / "build" / "zstd_tpu_torch"
_SO = BUILD_DIR / "libzstd_tpu_torch_host.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
_error = ""  # why the library is not loaded: the compiler's stderr or the loader's error


class NativeUnavailable(RuntimeError):
    pass


def _build() -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Build to a private name, then rename: concurrent test workers may
    # build at once, and a reader must never load a half-written file.
    tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CC", "gcc"), "-O2", "-fPIC", "-shared", "-o", str(tmp), str(_SRC)]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    os.replace(tmp, _SO)


def _load() -> ctypes.CDLL | None:
    global _lib, _tried, _error
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
                _build()
            lib = ctypes.CDLL(str(_SO))
        except (OSError, subprocess.SubprocessError) as e:
            # The compiler's own message where it gave one.
            _error = (getattr(e, "stderr", None) or b"").decode(errors="replace").strip() or str(e)
            return None
        lib.zt_xxh64.restype = ctypes.c_uint64
        lib.zt_xxh64.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_uint64]
        lib.zt_execute_sequences.restype = ctypes.c_int
        lib.zt_execute_sequences.argtypes = [
            ctypes.c_void_p,  # out
            ctypes.c_size_t,  # cap
            ctypes.POINTER(ctypes.c_size_t),  # out_len io
            ctypes.c_void_p,  # literals
            ctypes.c_size_t,  # lit_len
            ctypes.c_void_p,  # ll int32*
            ctypes.c_void_p,  # ofv uint32*
            ctypes.c_void_p,  # ml int32*
            ctypes.c_size_t,  # n
            ctypes.c_void_p,  # rep uint64[3]
            ctypes.POINTER(ctypes.c_size_t),  # far-match bytes io (may be NULL)
        ]
        lib.zt_assemble_group.restype = ctypes.c_int
        lib.zt_assemble_group.argtypes = [
            ctypes.c_void_p,  # buf
            ctypes.c_size_t,  # cap
            ctypes.c_size_t,  # wend (cap + SLACK)
            ctypes.POINTER(ctypes.c_size_t),  # pos io
            ctypes.c_void_p,  # frames int64[n_frames, FRAME_COLS]
            ctypes.c_size_t,  # first frame to run
            ctypes.c_size_t,  # n_frames
            ctypes.c_void_p,  # blocks int64[n_blocks, BLOCK_COLS]
            ctypes.c_size_t,  # n_blocks
            ctypes.c_void_p,  # lit_ptr int64[n_lit]
            ctypes.c_void_p,  # lit_len int64[n_lit]
            ctypes.c_void_p,  # lit_ok uint8[n_lit]
            ctypes.c_size_t,  # n_lit
            ctypes.c_void_p,  # seq_ptr int64[n_seq, 3] (ll, ofv, ml)
            ctypes.c_void_p,  # seq_n int64[n_seq]
            ctypes.c_void_p,  # seq_ok uint8[n_seq]
            ctypes.c_size_t,  # n_seq
            ctypes.c_void_p,  # res int64[n_frames, RESULT_COLS]
            ctypes.POINTER(ctypes.c_size_t),  # exact-path sequences io
        ]
        lib.zt_unpack_sequences.restype = ctypes.c_int
        lib.zt_unpack_sequences.argtypes = [
            ctypes.c_void_p,  # words uint32*
            ctypes.c_size_t,  # n_words
            ctypes.c_void_p,  # cumw int32[n_lanes]
            ctypes.c_void_p,  # nseq int32[n_lanes]
            ctypes.c_void_p,  # w_ll int32[n_lanes]
            ctypes.c_void_p,  # w_ml int32[n_lanes]
            ctypes.c_void_p,  # w_of int32[n_lanes]
            ctypes.c_size_t,  # n_lanes
            ctypes.c_void_p,  # out ll int32[sum nseq]
            ctypes.c_void_p,  # out ofv uint32[sum nseq]
            ctypes.c_void_p,  # out ml int32[sum nseq]
        ]
        lib.zt_lz77_lazy.restype = ctypes.c_size_t
        lib.zt_lz77_lazy.argtypes = [
            ctypes.c_void_p,  # src
            ctypes.c_size_t,  # block_start
            ctypes.c_size_t,  # block_end
            ctypes.c_size_t,  # window
            ctypes.c_void_p,  # head int32[1<<16]
            ctypes.c_void_p,  # chain int32[chain_mask+1]
            ctypes.c_size_t,  # chain_mask
            ctypes.c_int,  # attempts
            ctypes.c_int,  # lazy
            ctypes.c_void_p,  # reps io int32[3]
            ctypes.c_void_p,  # ll_out
            ctypes.c_void_p,  # off_out
            ctypes.c_void_p,  # ml_out
            ctypes.c_size_t,  # max_seqs
            ctypes.c_void_p,  # lit_out
            ctypes.POINTER(ctypes.c_size_t),  # lit_len io
        ]
        lib.zt_lz77_optimal.restype = ctypes.c_size_t
        lib.zt_lz77_optimal.argtypes = [
            ctypes.c_void_p,  # src
            ctypes.c_size_t,  # block_start
            ctypes.c_size_t,  # block_end
            ctypes.c_size_t,  # window
            ctypes.c_void_p,  # head
            ctypes.c_void_p,  # chain
            ctypes.c_size_t,  # chain_mask
            ctypes.c_int,  # attempts
            ctypes.c_void_p,  # reps io int32[3]
            ctypes.c_void_p,  # lit_price uint32[256]
            ctypes.c_void_p,  # ll_price uint32[36]
            ctypes.c_void_p,  # ml_price uint32[53]
            ctypes.c_void_p,  # of_price uint32[32]
            ctypes.c_void_p,  # ll_out
            ctypes.c_void_p,  # off_out
            ctypes.c_void_p,  # ml_out
            ctypes.c_size_t,  # max_seqs
            ctypes.c_void_p,  # lit_out
            ctypes.POINTER(ctypes.c_size_t),  # lit_len io
        ]
        lib.zt_resolve_offsets.restype = ctypes.c_int
        lib.zt_resolve_offsets.argtypes = [
            ctypes.c_void_p,  # ll int32*
            ctypes.c_void_p,  # ofv uint32*
            ctypes.c_size_t,  # n
            ctypes.c_void_p,  # rep uint64[3]
            ctypes.c_void_p,  # off_out int64*
        ]
        lib.zt_fse_parse_build.restype = ctypes.c_int
        lib.zt_fse_parse_build.argtypes = [
            ctypes.c_char_p,  # data
            ctypes.c_size_t,  # len
            ctypes.c_int,  # max accuracy log
            ctypes.c_void_p,  # symbol uint16[512]
            ctypes.c_void_p,  # baseline uint16[512]
            ctypes.c_void_p,  # nbits uint8[512]
            ctypes.POINTER(ctypes.c_size_t),  # bits consumed
        ]
        lib.zt_fse_weights.restype = ctypes.c_int
        lib.zt_fse_weights.argtypes = [
            ctypes.c_char_p,  # payload
            ctypes.c_size_t,  # len
            ctypes.c_void_p,  # out weights uint8[256]
        ]
        lib.zt_huffman_canonical.restype = ctypes.c_int
        lib.zt_huffman_canonical.argtypes = [
            ctypes.c_char_p,  # payload (header byte + weights)
            ctypes.c_size_t,  # len
            ctypes.c_void_p,  # out canon int32[CANON_WORDS]
            ctypes.c_void_p,  # out weights uint8[256] (just past canon)
        ]
        lib.zt_fse_pack.restype = ctypes.c_int
        lib.zt_fse_pack.argtypes = [
            ctypes.c_char_p,  # symbol uint16[size]
            ctypes.c_char_p,  # baseline uint16[size]
            ctypes.c_char_p,  # nbits uint8[size]
            ctypes.c_size_t,  # size
            ctypes.c_int,  # kind: 0 ll, 1 of, 2 ml
            ctypes.c_void_p,  # out p0 int32[size]
            ctypes.c_void_p,  # out p1 int32[size] (just past p0)
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def require() -> ctypes.CDLL:
    """The library, built on first use; raises ``NativeUnavailable``
    carrying the compiler's stderr (or the loader's error) when it cannot
    be built or loaded."""
    lib = _load()
    if lib is None:
        raise NativeUnavailable(f"the host C library {_SRC.name} did not build: {_error}")
    return lib


def fse_parse_build(data) -> tuple | None:
    """Parse + build an FSE decode table from the buffer's bit 0.

    Returns ``(accuracy_log, symbol, baseline, nbits, bits_consumed)``
    with arrays sized to the table, or ``None`` when the native library
    is unavailable or the stream is corrupt — the caller then runs the
    Python path, which raises the precise typed error."""
    lib = _load()
    if lib is None:
        return None
    buf = bytes(data)
    symbol = np.empty(512, dtype=np.uint16)
    baseline = np.empty(512, dtype=np.uint16)
    nbits = np.empty(512, dtype=np.uint8)
    bits = ctypes.c_size_t(0)
    al = lib.zt_fse_parse_build(
        buf,
        len(buf),
        9,
        symbol.ctypes.data,
        baseline.ctypes.data,
        nbits.ctypes.data,
        ctypes.byref(bits),
    )
    if al < 0:
        return None
    size = 1 << al
    return al, symbol[:size], baseline[:size], nbits[:size], int(bits.value)


def fse_weights(payload) -> list[int] | None:
    """Decode FSE-compressed Huffman weights; None → run the Python path."""
    lib = _load()
    if lib is None:
        return None
    buf = bytes(payload)
    out = np.empty(256, dtype=np.uint8)
    n = lib.zt_fse_weights(buf, len(buf), out.ctypes.data)
    if n < 0:
        return None
    return out[:n].tolist()


# zt_huffman_canonical's output row: limits, prevs, lengths, rankb (12
# int32 each), then ranked (256).
CANON_WORDS = 4 * 12 + 256
FSE_KINDS = {"ll": 0, "of": 1, "ml": 2}


def huffman_canonical(payload) -> tuple[np.ndarray, np.ndarray] | None:
    """Canonical Huffman classes of a block's table payload (header byte +
    weights): ``(canon int32[CANON_WORDS], completed weights uint8[n])``,
    or ``None`` when the weights are corrupt (the caller then runs the
    Python path, which raises the typed error)."""
    lib = require()
    buf = bytes(payload)
    # One allocation and one pointer: a ctypes pointer costs more than the
    # pack itself.
    out = np.empty(4 * CANON_WORDS + 256, dtype=np.uint8)
    at = out.ctypes.data
    n = lib.zt_huffman_canonical(buf, len(buf), at, at + 4 * CANON_WORDS)
    if n < 0:
        return None
    return out[: 4 * CANON_WORDS].view(np.int32), out[4 * CANON_WORDS : 4 * CANON_WORDS + n]


def fse_pack(symbol, baseline, nbits, kind: str) -> tuple[np.ndarray, np.ndarray, int] | None:
    """A sequence-code FSE table's dual planes and value bits: ``(p0, p1,
    wbits)``, or ``None`` when a code is out of ``kind``'s range (the
    Python path then raises the typed error)."""
    lib = require()
    n = len(symbol)
    # Inputs as bytes (a copy of at most 2.5 KiB) and both planes in one
    # allocation: a ctypes pointer from numpy costs more than the pack.
    planes = np.empty(2 * n, dtype=np.int32)
    at = planes.ctypes.data
    wbits = lib.zt_fse_pack(
        np.asarray(symbol, dtype=np.uint16).tobytes(),
        np.asarray(baseline, dtype=np.uint16).tobytes(),
        np.asarray(nbits, dtype=np.uint8).tobytes(),
        n, FSE_KINDS[kind], at, at + 4 * n,
    )
    if wbits < 0:
        return None
    return planes[:n], planes[n:], wbits


def xxh64(data, seed: int = 0) -> int:
    lib = require()
    arr = (
        data
        if isinstance(data, np.ndarray)
        else np.frombuffer(data, dtype=np.uint8)
    )
    if arr.size == 0:
        return lib.zt_xxh64(None, 0, seed)
    return lib.zt_xxh64(arr.ctypes.data, arr.size, seed)


_STATUS = {
    1: "null offset",
    2: "literal run exceeds remaining literals",
    3: "offset exceeds decoded length",
    4: "output overflow",
    5: "a lane's words lie outside the fetched buffer",
    6: "field widths below 0 or summing past 63",
}


def unpack_sequences(words, cumw, nseq, w_ll, w_ml, w_of) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split the sequences kernel's word stream (``words``, uint32) into
    flat ``(ll int32, ofv uint32, ml int32)`` arrays, lane after lane:
    lane j's ``nseq[j]`` sequences start at word ``cumw[j]`` and take one
    word each, two when its field widths sum past 32 (``cumw`` may hold a
    last, unread entry).  Raises ValueError with the status message when
    a lane's words lie outside ``words`` (nothing outside is read) or its
    widths are out of range."""
    lib = require()
    words = np.ascontiguousarray(words, dtype=np.uint32)
    cols = [np.ascontiguousarray(a, dtype=np.int32) for a in (nseq, w_ll, w_ml, w_of)]
    cumw = np.ascontiguousarray(cumw, dtype=np.int32)
    n = len(cols[0])
    if len(cumw) < n or any(len(c) != n for c in cols):
        raise ValueError("unpack_sequences: cumw, nseq and the widths differ in length")
    if (cols[0] < 0).any():
        raise ValueError("unpack_sequences: negative sequence count")
    tot = int(cols[0].sum(dtype=np.int64))
    ll = np.empty(tot, dtype=np.int32)
    ofv = np.empty(tot, dtype=np.uint32)
    ml = np.empty(tot, dtype=np.int32)
    status = lib.zt_unpack_sequences(
        words.ctypes.data, words.size, cumw.ctypes.data,
        *(c.ctypes.data for c in cols), n,
        ll.ctypes.data, ofv.ctypes.data, ml.ctypes.data,
    )
    if status != 0:
        raise ValueError(f"sequence unpack failed: {_STATUS.get(status, status)}")
    return ll, ofv, ml


def execute_sequences(
    out: np.ndarray,
    out_len: int,
    literals,
    ll: np.ndarray,
    ofv: np.ndarray,
    ml: np.ndarray,
    rep: np.ndarray,
) -> tuple[int, int]:
    """Run sequences into preallocated ``out`` (uint8, big enough).

    Returns the new output length and the bytes of the matches whose
    source starts before ``out_len`` (in an earlier block of the frame);
    raises ValueError with the status message on corruption.  ``rep`` is
    a uint64[3] array, mutated.
    """
    lib = require()
    lit = np.frombuffer(literals, dtype=np.uint8) if not isinstance(
        literals, np.ndarray
    ) else literals
    ll = np.ascontiguousarray(ll, dtype=np.int32)
    ofv = np.ascontiguousarray(ofv, dtype=np.uint32)
    ml = np.ascontiguousarray(ml, dtype=np.int32)
    n = len(ll)
    out_len_c = ctypes.c_size_t(out_len)
    far = ctypes.c_size_t(0)
    status = lib.zt_execute_sequences(
        out.ctypes.data,
        out.size,
        ctypes.byref(out_len_c),
        lit.ctypes.data if lit.size else None,
        lit.size,
        ll.ctypes.data,
        ofv.ctypes.data,
        ml.ctypes.data,
        n,
        rep.ctypes.data,
        ctypes.byref(far),
    )
    if status != 0:
        raise ValueError(execute_status(status))
    return out_len_c.value, far.value


# zt_assemble_group (csrc/host.c): the bytes a strided copy may write past
# an output's end; the tables' columns (a frame: first block row, block
# count, flags, content size or -1, stored checksum, size estimate; a
# block: kind, payload address, payload length, RLE byte, literals kind,
# 4 literal lanes, sequence lane; a result: status, start, length,
# far-match bytes, computed checksum); a frame's flags; the frame
# statuses beside the executor's 1-4.
SLACK = 32
FRAME_COLS, BLOCK_COLS, RESULT_COLS = 6, 10, 5
F_EST = 5
R_STATUS, R_LEN, R_FAR = 0, 2, 3
FLAG_SKIP, FLAG_CHECKSUM = 1, 2
FRAME_OK, LITERALS_SIZE, CHECKSUM, CONTENT_SIZE, LANES, NEED_ROOM, TABLE = 0, 7, 8, 9, 11, 12, 13

_resize = ctypes.pythonapi.PyByteArray_Resize
_resize.argtypes = [ctypes.py_object, ctypes.c_ssize_t]
_resize.restype = ctypes.c_int


def execute_status(status: int) -> str:
    """The message of an executor status (1-4), as ``execute_sequences``
    raises it."""
    return f"sequence execution failed: {_STATUS.get(status, status)}"


def assemble_group(
    out: bytearray, frames, blocks, lit_ptr, lit_len, lit_ok, seq_ptr, seq_n, seq_ok
) -> tuple[np.ndarray, int]:
    """Assemble a frame group onto the end of ``out`` with one
    ``zt_assemble_group`` call: ``out`` grows once by the frames'
    estimated sizes (``frames[:, F_EST]``) plus ``SLACK``, the call writes
    the frames there, and the slack and whatever the estimates left over
    are cut off.  A frame that outgrows the estimates stops the call; the
    buffer then grows by what it needs and the call goes on from it.

    ``frames`` int64[F, FRAME_COLS] and ``blocks`` int64[B, BLOCK_COLS]
    are the group's tables; the lanes' outputs are given by address and
    length (``lit_ptr``, ``lit_len``; ``seq_ptr`` int64[S, 3] of ll int32,
    ofv uint32, ml int32 and ``seq_n``) and ok flags (bool).  The caller
    keeps every addressed array alive through the call.

    Returns ``(res, exact)``: int64[F, RESULT_COLS] of each frame's
    status, start in ``out``, length, far-match bytes and computed
    checksum (the frames that ran OK lie one after another in ``out``),
    and the count of sequences that took the bounds-exact path.  Raises
    ValueError when a table names a block or lane out of range."""
    lib = require()
    frames = np.ascontiguousarray(frames, dtype=np.int64)
    blocks = np.ascontiguousarray(blocks, dtype=np.int64)
    lit_ptr = np.ascontiguousarray(lit_ptr, dtype=np.int64)
    lit_len = np.ascontiguousarray(lit_len, dtype=np.int64)
    lit_ok = np.ascontiguousarray(lit_ok, dtype=np.bool_)
    seq_ptr = np.ascontiguousarray(seq_ptr, dtype=np.int64)
    seq_n = np.ascontiguousarray(seq_n, dtype=np.int64)
    seq_ok = np.ascontiguousarray(seq_ok, dtype=np.bool_)
    n = len(frames)
    res = np.zeros((n, RESULT_COLS), dtype=np.int64)
    est = frames[:, F_EST]
    pos = ctypes.c_size_t(len(out))
    exact = ctypes.c_size_t(0)
    first = 0
    cap = len(out) + int(est.sum())
    while True:
        _resize(out, cap + SLACK)
        status = lib.zt_assemble_group(
            ctypes.addressof(ctypes.c_char.from_buffer(out)), cap, cap + SLACK, ctypes.byref(pos),
            frames.ctypes.data, first, n, blocks.ctypes.data, len(blocks),
            lit_ptr.ctypes.data, lit_len.ctypes.data, lit_ok.ctypes.data, len(lit_ptr),
            seq_ptr.ctypes.data, seq_n.ctypes.data, seq_ok.ctypes.data, len(seq_n),
            res.ctypes.data, ctypes.byref(exact),
        )
        if status != NEED_ROOM:
            break
        first += int(np.argmax(res[first:, R_STATUS] == NEED_ROOM))
        cap = pos.value + int(res[first, R_LEN]) + int(est[first + 1 :].sum())
    del out[pos.value :]
    if status == TABLE:
        raise ValueError("frame group assembly: a table names a block or lane out of range")
    return res, exact.value


HASH_LOG = 16


class MatchState:
    """Hash-chain matcher state, persisted across a frame's blocks so
    cross-block matches resolve (the decoder's window spans the frame)."""

    def __init__(self, chain_log: int = 17):
        self.head = np.full(1 << HASH_LOG, -1, dtype=np.int32)
        self.chain = np.full(1 << chain_log, -1, dtype=np.int32)
        self.chain_mask = (1 << chain_log) - 1


def new_match_state(chain_log: int = 17) -> MatchState:
    return MatchState(chain_log)


def lz77_lazy(
    src: np.ndarray,
    block_start: int,
    block_end: int,
    window: int,
    state: MatchState,
    reps: list[int] | np.ndarray,
    attempts: int,
    lazy: bool,
):
    """Hash-chain LZ77 with repeat-offset-aware scoring and optional
    one-step lazy matching over src[block_start:block_end].

    Returns (ll, off, ml) int32 arrays and the literal bytes.  ``reps``
    is the 3-slot repeat-offset history at block start (read-only for
    the caller; offsets_to_values recomputes the updates).
    """
    lib = require()
    n = block_end - block_start
    max_seqs = n // 4 + 1
    ll = np.empty(max_seqs, dtype=np.int32)
    off = np.empty(max_seqs, dtype=np.int32)
    ml = np.empty(max_seqs, dtype=np.int32)
    lit = np.empty(n, dtype=np.uint8)
    lit_len = ctypes.c_size_t(0)
    reps_arr = np.ascontiguousarray(np.asarray(reps, dtype=np.int32)[:3])
    n_seq = lib.zt_lz77_lazy(
        src.ctypes.data,
        block_start,
        block_end,
        window,
        state.head.ctypes.data,
        state.chain.ctypes.data,
        state.chain_mask,
        attempts,
        int(lazy),
        reps_arr.ctypes.data,
        ll.ctypes.data,
        off.ctypes.data,
        ml.ctypes.data,
        max_seqs,
        lit.ctypes.data,
        ctypes.byref(lit_len),
    )
    return ll[:n_seq], off[:n_seq], ml[:n_seq], lit[: lit_len.value]


def _entropy_prices(counts: np.ndarray, lo=8, hi=8 * 20) -> np.ndarray:
    """Counts → 1/8-bit prices: -8*log2(freq/total); unseen = hi."""
    total = float(counts.sum())
    prices = np.full(len(counts), hi, dtype=np.float64)
    seen = counts > 0
    if total > 0 and seen.any():
        prices[seen] = -8.0 * np.log2(counts[seen] / total)
    return np.ascontiguousarray(
        np.clip(np.round(prices), lo, hi).astype(np.uint32)
    )


def lz77_optimal(
    src: np.ndarray,
    block_start: int,
    block_end: int,
    window: int,
    state: MatchState,
    reps: list[int] | np.ndarray,
    attempts: int,
    passes: int = 2,
):
    """Price-driven optimal parse over src[block_start:block_end]
    (zt_lz77_optimal): per-position DP with repeat-history-aware
    candidate pricing, iterated: pass 1 uses block-histogram literal
    prices and flat code priors; later passes re-derive every price
    table from the PREVIOUS pass's emitted literal/code histograms —
    the adaptive feedback that makes the parse converge on stream
    structure (skewed literals, locked repeat offsets) instead of raw
    match length.  Returns (ll, off, ml, literals) like
    :func:`lz77_lazy`; minmatch 3 for repeats, so up to n/3 + 1
    sequences."""
    lib = require()
    n = block_end - block_start
    block = src[block_start:block_end]
    # Pass-1 priors: block-histogram literal entropy + flat pessimistic
    # code estimates.  NOTE: carrying the previous block's CONVERGED
    # prices forward was tried and measured to hurt badly (multiblock
    # synthetic 1.10x -> 1.66-2.60x): optimistic near-zero code prices
    # make swarms of tiny rep matches look free, the code streams
    # diversify, and the real encoding blows up — a self-consistent but
    # globally bad fixed point.  Flat priors + per-block repricing is
    # the stable scheme.
    lit_price = _entropy_prices(np.bincount(block, minlength=256), hi=8 * 14)
    ll_price = np.full(36, 8 * 4, dtype=np.uint32)
    ml_price = np.full(53, 8 * 4, dtype=np.uint32)
    of_price = np.full(32, 8 * 4, dtype=np.uint32)

    max_seqs = n // 3 + 2
    ll = np.empty(max_seqs, dtype=np.int32)
    off = np.empty(max_seqs, dtype=np.int32)
    ml = np.empty(max_seqs, dtype=np.int32)
    lit = np.empty(n, dtype=np.uint8)
    reps_in = np.asarray(reps, dtype=np.int32)[:3]
    head0, chain0 = state.head.copy(), state.chain.copy()

    from ..ops.sequence_codes import LL_BASELINE, ML_BASELINE

    n_seq = 0
    lit_len = ctypes.c_size_t(0)
    for it in range(max(passes, 1)):
        if it:
            state.head[:] = head0  # re-parse over identical chains
            state.chain[:] = chain0
        reps_arr = np.ascontiguousarray(reps_in.copy())
        lit_len = ctypes.c_size_t(0)
        n_seq = lib.zt_lz77_optimal(
            src.ctypes.data,
            block_start,
            block_end,
            window,
            state.head.ctypes.data,
            state.chain.ctypes.data,
            state.chain_mask,
            attempts,
            reps_arr.ctypes.data,
            lit_price.ctypes.data,
            ll_price.ctypes.data,
            ml_price.ctypes.data,
            of_price.ctypes.data,
            ll.ctypes.data,
            off.ctypes.data,
            ml.ctypes.data,
            max_seqs,
            lit.ctypes.data,
            ctypes.byref(lit_len),
        )
        if it == max(passes, 1) - 1 or n_seq == 0:
            break
        # Reprice from this pass's emitted stats.
        lit_price = _entropy_prices(
            np.bincount(lit[: lit_len.value], minlength=256), hi=8 * 14
        )
        lls = ll[:n_seq].astype(np.int64)
        mls = ml[:n_seq].astype(np.int64)
        ll_codes = np.searchsorted(LL_BASELINE, lls, side="right") - 1
        ml_codes = np.searchsorted(ML_BASELINE, mls, side="right") - 1
        # Offset values need the rep history walk (cheap, in C).
        rep_sim = reps_in.astype(np.uint64).copy()
        try:
            offs = off[:n_seq]
            ofv = _offsets_to_values_np(lls, offs, rep_sim)
            of_codes = np.int64(np.floor(np.log2(ofv.astype(np.float64))))
        except Exception:
            of_codes = np.zeros(n_seq, dtype=np.int64)
        ll_price = _entropy_prices(np.bincount(ll_codes, minlength=36)[:36])
        ml_price = _entropy_prices(np.bincount(ml_codes, minlength=53)[:53])
        of_price = _entropy_prices(np.bincount(of_codes, minlength=32)[:32])
    return ll[:n_seq], off[:n_seq], ml[:n_seq], lit[: lit_len.value]


def _offsets_to_values_np(lls, offs, rep):
    """Forward offset→value walk (mirror of encode.offsets_to_values)."""
    out = np.zeros(len(offs), dtype=np.uint64)
    r = [int(rep[0]), int(rep[1]), int(rep[2])]
    for i in range(len(offs)):
        o, l = int(offs[i]), int(lls[i])
        if l != 0:
            v = 1 if o == r[0] else 2 if o == r[1] else 3 if o == r[2] else o + 3
        else:
            v = (1 if o == r[1] else 2 if o == r[2]
                 else 3 if o == r[0] - 1 and o > 0 else o + 3)
        idx = v - 1 if l != 0 else v
        if v > 3:
            r[0], r[1], r[2] = o, r[0], r[1]
        elif idx == 1:
            r[0], r[1] = r[1], r[0]
        elif idx >= 2:
            r[0], r[1], r[2] = o, r[0], r[1]
        out[i] = v
    return out


def resolve_offsets(ll, ofv, rep: np.ndarray) -> np.ndarray:
    """Resolve (ll, offset_value) pairs to actual offsets; mutates the
    uint64[3] ``rep`` history.  Raises ValueError on a null offset."""
    lib = require()
    ll = np.ascontiguousarray(ll, dtype=np.int32)
    ofv = np.ascontiguousarray(ofv, dtype=np.uint32)
    out = np.empty(len(ll), dtype=np.int64)
    status = lib.zt_resolve_offsets(
        ll.ctypes.data, ofv.ctypes.data, len(ll), rep.ctypes.data,
        out.ctypes.data,
    )
    if status != 0:
        raise ValueError("null offset in sequence stream")
    return out
