"""The LZ77 spike's copy program (``tools/lz77_pallas_spike.build_program``),
copied, and programs of it laid end to end as the inputs of
``kernels.lz77.exec_ops``.

A realistic program of (src, dst, len) ops shaped like zstd sequence
streams, with the bytes its execution must produce.
"""

from __future__ import annotations

import numpy as np
import torch

LANES = 128


def build_program(out_kb: int = 96, seed: int = 0):
    """A realistic copy program: literals region ‖ output region, with
    (src, dst, len) op pairs from zstd-shaped sequences (ll ~ 4-40,
    ml ~ 4-60, offsets mixed incl. 20% self-overlapping)."""
    rng = np.random.default_rng(seed)
    target = out_kb << 10
    lit_bytes = rng.integers(0, 256, target, dtype=np.uint8)
    ops = []
    expect = bytearray()
    lit_pos = 0
    out_base = target  # literals live at [0, target); output follows
    while len(expect) < target - 256:
        ll = int(rng.integers(4, 40))
        ml = int(rng.integers(4, 60))
        ops.append((lit_pos, out_base + len(expect), ll))
        expect += bytes(lit_bytes[lit_pos : lit_pos + ll])
        lit_pos += ll
        if rng.random() < 0.2:
            off = int(rng.integers(1, 16))
        else:
            off = int(rng.integers(1, len(expect)))
        start = len(expect) - off
        ops.append((out_base + start, out_base + len(expect), ml))
        for k in range(ml):
            expect.append(expect[start + k])
    total = out_base + len(expect)
    R = -(-total // LANES) + 2
    buf = np.zeros(R * LANES, np.int32)
    buf[:target] = lit_bytes
    src = np.array([o[0] for o in ops], np.int32)
    dst = np.array([o[1] for o in ops], np.int32)
    lens = np.array([o[2] for o in ops], np.int32)
    return buf.reshape(R, LANES), src, dst, lens, bytes(expect), out_base, R


def batch_programs(seeds, out_kb: int = 2):
    """Spike programs, one per seed, laid end to end in one buffer (one
    program each): (ops int64 [3, n], op_off int64 [P + 1], buf uint8,
    [(output start, expected bytes)]), CPU tensors."""
    ops, bufs, off, outs, base = [], [], [0], [], 0
    for s in seeds:
        buf, src, dst, lens, expect, out_base, _r = build_program(out_kb, s)
        flat = buf.reshape(-1).astype(np.uint8)
        ops.append(np.stack([src, dst, lens]).astype(np.int64) + np.array([[base], [base], [0]]))
        bufs.append(flat)
        off.append(off[-1] + len(src))
        outs.append((base + out_base, expect))
        base += flat.size
    return (
        torch.from_numpy(np.concatenate(ops, axis=1)),
        torch.tensor(off, dtype=torch.int64),
        torch.from_numpy(np.concatenate(bufs)),
        outs,
    )
