"""Ragged lane compaction: the CUDA kernel ``csrc/compact.cu`` and its
plain PyTorch form.

Replaces the TPU kernel ``zstd_tpu/kernels/compact_dma.py:37``
(``_kernel`` behind ``compact_lanes_dma``): lane j's first
``cum[j+1] - cum[j]`` words of a (rows, L) plane land at
``dense[cum[j]:cum[j+1]]``.  The TPU form needed 1024-word-aligned
offsets and a fetch pad (Mosaic HBM tiling) and ran only for big calls;
here it runs for every sequences call, at any offset, as a tiled
transpose: a block takes 32 lanes by 128 rows of the plane, reads them
row by row (32 neighbouring lanes a 128-byte line) into padded shared
memory, and writes each lane's run of words contiguously, so the grid
covers the plane over every SM.  Bound on the H100: bytes over the
memory rate (each kept word read once and written once).  ``PERF.md``
keeps its times.

A wrapper handed CPU tensors runs the plain form; handed CUDA tensors it
launches the kernel on their card (that card made current around the C
call), and raises if the kernel cannot build or launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .entropy2 import _compact

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # plane, rows, n_lanes
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # cum, dense, stream
]


def compact_plain(plane, cum, *, n_dense: int):
    """The kernel's function in PyTorch (the reference's clipped gather)."""
    return _compact(plane, cum, n_dense).to(plane.dtype)


def compact_lanes(plane, cum, *, n_dense: int):
    """Compact an int32 (rows, L) plane by lane: int32[n_dense], n_dense =
    cum[L].  Every count cum[j+1] - cum[j] must be <= rows."""
    if plane.device.type == "cpu":
        return compact_plain(plane, cum, n_dense=n_dense)
    if plane.device.type != "cuda":
        raise ValueError(f"compact_lanes runs on cpu or cuda, not {plane.device}")
    for t in (plane, cum):
        if t.device != plane.device or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("compact_lanes wants contiguous int32 tensors on one device")
    if plane.dim() != 2 or cum.shape != (plane.shape[1] + 1,):
        raise ValueError("compact_lanes wants a plane [rows, L] and cum [L + 1]")
    rows, L = plane.shape
    dense = torch.empty(n_dense, dtype=torch.int32, device=plane.device)
    if rows == 0 or L == 0:  # no words to move: no launch, nothing counted
        return dense
    lib = _build.load("compact")
    fn = lib.zt_compact
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(plane.device):
        code = fn(
            plane.data_ptr(), rows, L, cum.data_ptr(), dense.data_ptr(), _build.stream_ptr(plane)
        )
    _build.check(lib, code, "compaction kernel")
    compact_lanes.launches += 1
    return dense


compact_lanes.launches = 0
