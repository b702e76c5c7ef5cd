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


# -- adversarial copy programs ---------------------------------------------------

ADVERSARIAL = ("offset_1", "offset_eq_len", "offset_below_len", "long_ops", "deep_chain", "end_to_end")


def _frame_program(pool: np.ndarray, steps):
    """One frame-shaped ``lz77_device.CopyProgram``: its buffer is the
    literal ``pool`` then the output, built from ``steps`` in order —
    ("lit", pool position, n) copies pool bytes to the output's end,
    ("match", offset, n) copies from ``offset`` bytes back (forward-copy
    semantics), ("raw", bytes) prefills output bytes that no op writes."""
    from ..kernels.lz77_device import CopyProgram

    ops, fills, out = [], [], 0
    for kind, a, *rest in steps:
        if kind == "raw":
            fills.append((out, np.frombuffer(a, np.uint8)))
            out += len(a)
            continue
        n = rest[0]
        src = a if kind == "lit" else pool.size + out - a
        ops.append((src, pool.size + out, n))
        out += n
    buf = np.zeros(pool.size + out, np.uint8)
    buf[: pool.size] = pool
    for pos, b in fills:
        buf[pool.size + pos : pool.size + pos + b.size] = b
    return CopyProgram(buf=buf, out_start=pool.size, ops=np.array(ops, np.int64).T.reshape(3, -1))


def _chain_steps(rng, n_matches: int, ml: int = 8):
    """A literal run, then ``n_matches`` matches each copying the previous
    match's output, a 1-3 byte literal run before each: a chain of
    matches of matches ``n_matches`` deep."""
    steps, out, pool_pos = [("lit", 0, ml)], ml, ml
    prev = 0  # output position of the previous match (the first run here)
    for _ in range(n_matches):
        ll = int(rng.integers(1, 4))
        steps.append(("lit", pool_pos, ll))
        pool_pos += ll
        out += ll
        steps.append(("match", out - prev, ml))
        prev = out
        out += ml
    return steps


def adversarial_programs(seed: int = 0) -> dict:
    """Copy programs at the edges of the LZ77 kernel's design, each as
    (ops int64 [3, n], op_off int64 [P + 1], buf uint8) CPU tensors laid
    end to end by ``pack_programs`` (absolute positions):

    * ``offset_1``: offset-1 runs (one byte replicated), short and long;
    * ``offset_eq_len`` / ``offset_below_len``: offset equal to the length
      and one below it;
    * ``long_ops``: matches and a literal run of 2^16 bytes and more (the
      wide retry corpus's 100 000-byte run);
    * ``deep_chain``: 4 096 matches, each copying the previous match's
      output (chain depth 4 096);
    * ``end_to_end``: three programs laid end to end, the middle one with
      no ops (a raw frame), and matches reading prefilled raw bytes.
    """
    from ..kernels.lz77_device import pack_programs

    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 256, 1 << 18, dtype=np.uint8)
    cases = {
        "offset_1": [[("lit", 0, 1), ("match", 1, 1000), ("lit", 1, 5), ("match", 1, 7),
                      ("match", 1, 33), ("lit", 6, 2), ("match", 1, 1)]],
        "offset_eq_len": [[("lit", 0, 64), ("match", 40, 40), ("match", 17, 17), ("lit", 64, 3),
                           ("match", 33, 33), ("match", 32, 32), ("match", 1, 1)]],
        "offset_below_len": [[("lit", 0, 50), ("match", 49, 50), ("match", 99, 100), ("lit", 50, 7),
                              ("match", 31, 32), ("match", 32, 33), ("match", 2, 3)]],
        "long_ops": [[("lit", 0, 3), ("match", 3, 100_000), ("lit", 3, 70_000), ("match", 1, 70_000),
                      ("match", 65_541, 66_000), ("lit", 70_003, 10), ("match", 200_000, 1 << 16)]],
        "deep_chain": [_chain_steps(rng, 4096)],
        "end_to_end": [
            [("lit", 0, 20), ("match", 7, 300), ("raw", pool[:50].tobytes()), ("match", 45, 60)],
            [("raw", bytes(range(200)))],
            [("raw", b"zstd" * 10), ("lit", 0, 5), ("match", 44, 90), ("match", 1, 40)]
            + _chain_steps(rng, 64, ml=5),
        ],
    }
    assert tuple(cases) == ADVERSARIAL
    out = {}
    for name, progs in cases.items():
        gp = pack_programs([_frame_program(pool, s) for s in progs])
        out[name] = tuple(torch.from_numpy(a.copy()) for a in (gp.ops, gp.op_off, gp.buf))
    return out


def place_high(ops, buf, size: int):
    """A program moved to the top of a zeroed ``size``-byte buffer on
    ``buf``'s device (positions near 2^31 when ``size`` is): (its ops, the
    big buffer, the offset it was moved by)."""
    base = size - buf.numel()
    big = torch.zeros(size, dtype=torch.uint8, device=buf.device)
    big[base:] = buf
    return ops + torch.tensor([[base], [base], [0]], device=ops.device), big, base
