"""Huffman literals decode: the CUDA kernel ``csrc/literals.cu`` and its
plain PyTorch form.

Replaces the TPU kernel ``zstd_tpu/kernels/pallas_lit.py:63``
(``_kernel`` behind ``decode_literals_dense_pl``).  Each symbol's
position depends on the previous symbol's code length, so a lane is a
serial chain and a launch takes its longest lane's chain.  The kernel
gives each lane one warp of its own (one block per lane, 256 lanes over
the 132 SMs), builds direct 2 048-entry length and symbol tables for the
lane's Huffman table in shared memory, and peeks from a 64-bit window
loaded a symbol ahead from a shared ring of stream words; it writes four
symbols per u32 straight to the dense output.  Its times (~28 ns per
symbol on an H100) and what holds it are in ``PERF.md``.

A wrapper handed CPU tensors runs the plain form; handed CUDA tensors it
launches the kernel on their card (that card made current around the C
call), and raises if the kernel cannot build or launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .entropy2 import LIT_LANE_COLS, LIT_SYMS_PER_STEP, _compact, _literals_scan

_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_longlong]  # words, n_words
    + [ctypes.c_void_p] * 9  # lane_mat, cum, 5 table banks, dense, ok
    + [ctypes.c_int, ctypes.c_void_p]  # n_lanes, stream
)


def literals_plain(words, lane_mat, cum, limits, prevs, lengths, rankb, ranked, *, n_dense: int):
    """The kernel's function in PyTorch: (dense u8[4 * n_dense], ok i32[L])."""
    base, p0, pend, regen, slots = (lane_mat[:, c].long() for c in range(LIT_LANE_COLS))
    steps = -(-int(regen.max()) // LIT_SYMS_PER_STEP) if len(regen) else 0
    ys, ok = _literals_scan(
        words, base, p0, pend, regen,
        limits[slots], prevs[slots], lengths[slots], rankb[slots], ranked[slots], steps,
    )
    dense = _compact(ys, cum, n_dense)
    shifts = torch.arange(4, device=dense.device) * 8
    dense_bytes = ((dense[:, None] >> shifts) & 0xFF).to(torch.uint8).reshape(-1)
    return dense_bytes, ok.to(torch.int32)


def decode_literals(words, lane_mat, cum, limits, prevs, lengths, rankb, ranked, *, n_dense: int):
    """Decode every lane's literal stream.

    words: int32[W] (u32 bits) raw input words; lane_mat: int32[L, 5]
    (base, p0, pend, regen, slot); cum: int32[L + 1] prefix sums of
    ceil(regen / 4); table banks int32[T, 12] x 4 and int32[T, 256];
    n_dense = cum[L].  Returns (dense uint8[4 * n_dense] — lane j's
    symbols from byte 4 * cum[j] — and ok int32[L])."""
    if words.device.type == "cpu":
        return literals_plain(
            words, lane_mat, cum, limits, prevs, lengths, rankb, ranked, n_dense=n_dense
        )
    if words.device.type != "cuda":
        raise ValueError(f"decode_literals runs on cpu or cuda, not {words.device}")
    args = (words, lane_mat, cum, limits, prevs, lengths, rankb, ranked)
    for t in args:
        if t.device != words.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("decode_literals wants contiguous int32 tensors on one device")
    L = lane_mat.shape[0]
    if lane_mat.shape != (L, LIT_LANE_COLS) or cum.shape != (L + 1,):
        raise ValueError("decode_literals wants lane_mat [L, 5] and cum [L + 1]")
    if limits.shape[1:] != (12,) or ranked.shape[1:] != (256,):
        raise ValueError("decode_literals wants table banks [T, 12] x 4 and [T, 256]")
    dense = torch.empty(4 * n_dense, dtype=torch.uint8, device=words.device)
    ok = torch.empty(L, dtype=torch.int32, device=words.device)
    lib = _build.load("literals")
    fn = lib.zt_literals
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(words.device):
        code = fn(
            words.data_ptr(), words.numel(),
            *(t.data_ptr() for t in args[1:]),
            dense.data_ptr(), ok.data_ptr(), L, _build.stream_ptr(words),
        )
    _build.check(lib, code, "literals kernel")
    decode_literals.launches += 1
    return dense, ok


decode_literals.launches = 0
