"""LZ77 copy-program executor: the CUDA kernel ``csrc/lz77.cu`` and its
plain PyTorch form.

Replaces the TPU kernel ``tools/lz77_pallas_spike.py:46`` (``_kernel``
behind ``run_ops``): run (src, dst, len) byte copies in order over a
buffer, with forward-copy semantics (a self-overlapping copy replicates
its period).  Here it runs a batch of programs — program p's ops are
``ops[:, op_off[p]:op_off[p+1]]`` — over one uint8 buffer updated in
place.

The kernel does not walk the ops in order.  Under its precondition
(within a program the ops' destination ranges ascend and do not overlap;
``0 <= src < dst``; no op reads a byte another program's ops write) byte
``dst + k`` of an op takes the final value of byte ``src + k mod (dst -
src)``, so the kernel writes that source into a per-byte int32 map over
the span the ops write (expand), resolves chains of matches of matches
by in-place pointer jumping over the whole map (a fixed budget of rounds
that return at once once everything is resolved), and gathers every
written byte from its root.  The source note says what bounds it;
``PERF.md`` keeps its times.  ``exec_ops.launches`` counts wrapper calls
that launch, ``exec_ops.cuda_launches`` the CUDA launches they make
(init, expand, the rounds, gather); :func:`last_rounds` reads how many
rounds the last call ran.

The plain form is the JAX package's device LZ77 algorithm: the ops
become a per-byte source map (without the period fold) and pointer
doubling (``lz77_device.resolve_and_materialize``) resolves it.  The two
agree on every program that meets the precondition — what a frame
group's copy programs are.

A wrapper handed CPU tensors runs the plain form; handed CUDA tensors it
launches the kernel, and raises if the kernel cannot build or launch.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .lz77_device import doubling_rounds, resolve_and_materialize

HOPS = 4  # chain steps an open map entry takes per round (csrc/lz77.cu kHops)
MAX_BUF = 1 << 31  # the map holds positions as int32

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong,  # ops, n_ops
    ctypes.c_void_p, ctypes.c_int,  # op_off, n_progs
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,  # buf, lo, n_map
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # map, flags, rounds
    ctypes.c_void_p,  # stream
]


def _check(ops, op_off, buf) -> tuple[int, int]:
    """Raise ValueError unless the program is one the kernel can run:
    int64 ops [3, n] and op_off [P + 1], a uint8 buffer below 2^31 bytes,
    all contiguous on one device; 0 <= src < dst and dst + len <= buf
    size for every op; op ranges from 0 to n in order; within a program,
    each op's destination starting at or after the previous op's end.
    Returns the span [lo, hi) of the bytes the ops write (lo = hi when
    there is none): one host synchronisation for it all."""
    for t, dt in ((ops, torch.int64), (op_off, torch.int64), (buf, torch.uint8)):
        if t.device != buf.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError("exec_ops wants contiguous int64 ops/op_off and a uint8 buffer on one device")
    if ops.dim() != 2 or ops.shape[0] != 3 or op_off.dim() != 1 or op_off.numel() < 1 or buf.dim() != 1:
        raise ValueError("exec_ops wants ops [3, n], op_off [P + 1] and a flat buffer")
    if buf.numel() >= MAX_BUF:
        raise ValueError(f"exec_ops wants a buffer below 2^31 bytes, not {buf.numel()}")
    n = ops.shape[1]
    src, dst, ln = ops
    end = dst + ln
    bad = ((src < 0) | (src >= dst) | (ln < 0) | (end > buf.numel())).any()
    bad |= (op_off[0] != 0) | (op_off[-1] != n) | (op_off[1:] < op_off[:-1]).any()
    if n > 1:
        starts = torch.zeros(n + 1, dtype=torch.bool, device=buf.device)
        starts[op_off.clamp(0, n)] = True  # the programs' first ops
        bad |= ((end[:-1] > dst[1:]) & ~starts[1:n]).any()
    written = ln > 0
    if n:
        lo = torch.where(written, dst, buf.numel()).min()
        hi = torch.where(written, end, 0).max()
    else:
        lo = hi = torch.zeros((), dtype=torch.int64, device=buf.device)
    bad_, lo, hi = torch.stack([bad.long(), lo, hi]).tolist()
    if bad_:
        raise ValueError("copy program has an op out of the buffer, with src >= dst, "
                         "out of order or overlapping in its program, or bad op ranges")
    return lo, max(lo, hi)


def round_budget(span: int) -> int:
    """Jump rounds that resolve any chain over ``span`` written bytes:
    each round takes an open entry at least HOPS + 1 times as far along
    its chain, and a chain is shorter than the span."""
    rounds = 1
    while (HOPS + 1) ** rounds < span:
        rounds += 1
    return rounds


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
    lo, hi = _check(ops, op_off, buf)
    if buf.device.type == "cpu":
        return buf.copy_(exec_ops_plain(ops, op_off, buf))
    return launch(ops, op_off, buf, lo, hi)


def launch(ops, op_off, buf, lo: int, hi: int):
    """The kernel on CUDA tensors that ``_check`` passed, with the span
    [lo, hi) it returned: no host synchronisation (``exec_ops`` without
    its checks, which a CUDA graph can capture)."""
    if hi <= lo:  # no byte to write: no launch, nothing counted
        return buf
    n_map = (hi - lo + 3) & ~3
    rounds = round_budget(hi - lo)
    scratch = torch.empty(n_map, dtype=torch.int32, device=buf.device)
    flags = torch.empty(rounds, dtype=torch.int32, device=buf.device)
    lib = _build.load("lz77")
    fn = lib.zt_lz77_exec
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    code = fn(
        ops.data_ptr(), ops.shape[1], op_off.data_ptr(), op_off.numel() - 1,
        buf.data_ptr(), lo, n_map, scratch.data_ptr(), flags.data_ptr(), rounds,
        _build.stream_ptr(buf),
    )
    _build.check(lib, code, "lz77 kernel")
    exec_ops.launches += 1
    exec_ops.cuda_launches += rounds + 3
    exec_ops.last_flags = flags
    return buf


def last_rounds() -> tuple[int, int, bool]:
    """(jump rounds the last kernel call ran, its round budget, whether
    every entry was resolved), from its round flags: a host
    synchronisation, for tests and measurement."""
    flags = exec_ops.last_flags.tolist()
    return min(len(flags), 1 + sum(flags)), len(flags), flags[-1] == 0


exec_ops.launches = 0
exec_ops.cuda_launches = 0
exec_ops.last_flags = None
