"""LZ77 copy-program executor: the CUDA kernel ``csrc/lz77.cu`` and its
plain PyTorch form.

Replaces the TPU kernel ``tools/lz77_pallas_spike.py:46`` (``_kernel``
behind ``run_ops``): run (src, dst, len) byte copies in order over a
buffer, with forward-copy semantics (a self-overlapping copy replicates
its period).  Here it runs a batch of programs — program p's ops are
``ops[:, op_off[p]:op_off[p+1]]`` — over one uint8 buffer updated in
place, one warp per program (the source note says why and what bounds
it).  ``PERF.md`` keeps its times.

The plain form is the JAX package's device LZ77 algorithm, not a loop
over ops: the ops become a per-byte source map and pointer doubling
(``lz77_device.resolve_and_materialize``) resolves it.  The two agree on
every program whose ops write disjoint bytes and read only bytes that
no op writes or that earlier ops (or the same op, before) wrote — what a
frame's copy program is.

A wrapper handed CPU tensors runs the plain form; handed CUDA tensors it
launches the kernel, and raises if the kernel cannot build or launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .lz77_device import doubling_rounds, resolve_and_materialize

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong,  # ops, n_ops
    ctypes.c_void_p, ctypes.c_int,  # op_off, n_progs
    ctypes.c_void_p, ctypes.c_void_p,  # buf, stream
]


def _check(ops, op_off, buf) -> None:
    """Raise ValueError unless the program is one the kernel can run:
    int64 ops [3, n] and op_off [P + 1], a uint8 buffer, all contiguous on
    one device; 0 <= src < dst and dst + len <= buf size for every op;
    op ranges from 0 to n in order."""
    for t, dt in ((ops, torch.int64), (op_off, torch.int64), (buf, torch.uint8)):
        if t.device != buf.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError("exec_ops wants contiguous int64 ops/op_off and a uint8 buffer on one device")
    if ops.dim() != 2 or ops.shape[0] != 3 or op_off.dim() != 1 or op_off.numel() < 1 or buf.dim() != 1:
        raise ValueError("exec_ops wants ops [3, n], op_off [P + 1] and a flat buffer")
    src, dst, ln = ops
    bad = ((src < 0) | (src >= dst) | (ln < 0) | (dst + ln > buf.numel())).any()
    bad |= (op_off[0] != 0) | (op_off[-1] != ops.shape[1]) | (op_off[1:] < op_off[:-1]).any()
    if bool(bad):
        raise ValueError("copy program has an op out of the buffer, with src >= dst, or bad op ranges")


def exec_ops_plain(ops, op_off, buf):
    """The kernel's function in PyTorch: the ops as a per-byte source map
    (every byte an op does not write is its own origin), resolved by
    pointer doubling; returns the resulting buffer (a new tensor).
    ``op_off`` does not change the result: programs write disjoint bytes."""
    n = buf.numel()
    dev = buf.device
    src_map = -torch.arange(1, n + 1, dtype=torch.int64, device=dev)
    lens = ops[2]
    total = int(lens.sum())
    if total:
        op_id = torch.repeat_interleave(torch.arange(ops.shape[1], device=dev), lens)
        first = torch.cumsum(lens, 0) - lens
        k = torch.arange(total, device=dev) - first[op_id]
        src_map[ops[1][op_id] + k] = ops[0][op_id] + k
    return resolve_and_materialize(src_map, buf, rounds=doubling_rounds(n))


def exec_ops(ops, op_off, buf):
    """Run copy programs over ``buf`` (uint8, updated in place and
    returned): int64 ``ops`` [3, n] rows (src, dst, len), program p's ops
    ``op_off[p]:op_off[p+1]``."""
    if buf.device.type not in ("cpu", "cuda"):
        raise ValueError(f"exec_ops runs on cpu or cuda, not {buf.device}")
    _check(ops, op_off, buf)
    if buf.device.type == "cpu":
        return buf.copy_(exec_ops_plain(ops, op_off, buf))
    if ops.shape[1] == 0:  # nothing to run: no launch, nothing counted
        return buf
    lib =_build.load("lz77")
    fn = lib.zt_lz77_exec
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    code = fn(
        ops.data_ptr(), ops.shape[1], op_off.data_ptr(), op_off.numel() - 1,
        buf.data_ptr(), _build.stream_ptr(buf),
    )
    _build.check(lib, code, "lz77 kernel")
    exec_ops.launches += 1
    return buf


exec_ops.launches = 0
