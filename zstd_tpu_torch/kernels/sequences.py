"""Interleaved tANS sequence decode: the CUDA kernel ``csrc/sequences.cu``
and its plain PyTorch form, plus the elementwise word packing around it.

Replaces the TPU kernel ``zstd_tpu/kernels/pallas_seq.py:108``
(``_kernel`` behind ``decode_sequences_dense_pl``) in narrow mode, and
the lax.scan wide form the JAX engine retries overflow lanes on, in
wide mode.  Every state depends on the bits the previous sequence
consumed, so a lane is a serial chain and a launch takes its longest
lane's chain.  The kernel gives each lane one warp of its own (one block
per lane, so a frame group's 64 lanes reach 64 SMs), stages the lane's
three FSE tables in shared memory as pre-digested 16-byte rows, and reads
the stream from a shared ring of words: a sequence's six reads go out
together once its three rows are loaded.  Its times (~100 ns per
sequence on an H100) and what holds it are in ``PERF.md``.

:func:`pack_dense` field-packs the narrow planes into the word format
the host unpacks (one u32 per sequence, two when the lane's field-width
sum exceeds 32) with elementwise tensor ops, then compacts the word
plane with the compaction kernel (``compact.py``).

A wrapper handed CPU tensors runs the plain form; handed CUDA tensors it
launches the kernel on their card (that card made current around the C
call), and raises if the kernel cannot build or launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .bitbuf import to_i32
from .compact import compact_lanes
from .entropy2 import SEQ_LANE_COLS, _pack_words, _seq_word_plane, sequences_rows_scan

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong,  # words, n_words
    ctypes.c_void_p,  # lane_mat
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,  # flat0, flat1, n_flat
    ctypes.c_void_p,  # bank_off
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # rows, n_lanes, wide
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # out a/b/c, ok
    ctypes.c_void_p,  # stream
]


def sequences_plain(words, lane_mat, bank_flat0, bank_flat1, bank_off, *, rows: int, wide: bool = False):
    """The kernel's function in PyTorch, in the kernel's int32 layout."""
    out = sequences_rows_scan(words, lane_mat, bank_flat0, bank_flat1, bank_off, rows, wide)
    return (*(to_i32(p) for p in out[:-1]), out[-1].to(torch.int32))


def decode_sequences(words, lane_mat, bank_flat0, bank_flat1, bank_off, *, rows: int, wide: bool = False):
    """Decode every lane's sequence stream into (rows, L) planes.

    words: int32[W] (u32 bits); lane_mat: int32[L, 13] (entropy2
    SEQ_LANE_COLS); FSE banks int32[N] x 2 and int32[S] slot offsets.
    rows >= every lane's nseq.  Narrow: (da, db, ok) with da = valid << 31
    | ofv and db = ll << 16 | ml (u32 bits in int32); wide: (pa, ll, ml,
    ok).  ok is int32[L]."""
    if words.device.type == "cpu":
        return sequences_plain(
            words, lane_mat, bank_flat0, bank_flat1, bank_off, rows=rows, wide=wide
        )
    if words.device.type != "cuda":
        raise ValueError(f"decode_sequences runs on cpu or cuda, not {words.device}")
    args = (words, lane_mat, bank_flat0, bank_flat1, bank_off)
    for t in args:
        if t.device != words.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("decode_sequences wants contiguous int32 tensors on one device")
    L = lane_mat.shape[0]
    if lane_mat.shape != (L, SEQ_LANE_COLS) or bank_flat0.shape != bank_flat1.shape:
        raise ValueError("decode_sequences wants lane_mat [L, 13] and equal FSE bank planes")

    def plane():
        return torch.empty(rows, L, dtype=torch.int32, device=words.device)

    a, b = plane(), plane()
    c = plane() if wide else None
    ok = torch.empty(L, dtype=torch.int32, device=words.device)
    lib = _build.load("sequences")
    fn = lib.zt_sequences
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(words.device):
        code = fn(
            words.data_ptr(), words.numel(), lane_mat.data_ptr(),
            bank_flat0.data_ptr(), bank_flat1.data_ptr(), bank_flat0.numel(),
            bank_off.data_ptr(), rows, L, int(wide),
            a.data_ptr(), b.data_ptr(), c.data_ptr() if wide else None, ok.data_ptr(),
            _build.stream_ptr(words),
        )
    _build.check(lib, code, "sequences kernel")
    decode_sequences.launches += 1
    return (a, b, c, ok) if wide else (a, b, ok)


decode_sequences.launches = 0


def pack_dense(da, db, lane_mat, cumw, *, n_dense_w: int):
    """Field-pack narrow planes and compact them: (dense int32[n_dense_w]
    — lane j's words at cumw[j]..cumw[j+1] — and lane_overflow bool[L]).
    Field widths come from lane_mat columns 4..6 (w_ll, w_ml, w_of)."""
    w_ll, w_ml, w_of = (lane_mat[:, k] for k in (4, 5, 6))
    lo, hi, over = _pack_words(da, db, w_ll, w_ml, w_of)
    plane = to_i32(_seq_word_plane(lo, hi, w_ll, w_ml, w_of))
    return compact_lanes(plane, cumw, n_dense=n_dense_w), over
