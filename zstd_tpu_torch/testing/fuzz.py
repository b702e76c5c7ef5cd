"""Differential fuzz harness (the port's form of ``tools/fuzz.py``).

Round trips must be byte-equal to libzstd, and corrupt, truncated or
garbage input must raise a typed ``ZstdError`` — never crash, hang, or
return wrong bytes silently.  Four modes, drawn per iteration from the
same seeded sequence as ``tools/fuzz.py``: a libzstd round trip, the
port's encoder checked by both decoders, bit flips of a libzstd frame,
and truncated frames with garbage appended.  ``corrupt_frames`` gives
seeded bit flips and truncations of one frame for the card tests and
``chip_smoke.py``.

With ``--engine`` every mode's input also goes through
``DeviceEngine(device=D)`` (the CUDA card by default), and the engine's
result must equal the host oracle's on the same input: the same bytes,
or a ``ZstdError`` where the oracle raises one.  Another exception type,
other bytes or a CUDA error is a failure; on the card each engine call
ends in ``torch.cuda.synchronize()`` so that a fault is charged to the
input that caused it.

    python -m zstd_tpu_torch.testing.fuzz [--iterations N] [--seed S] [--engine] [--device D]

Exits 1 on any failure.
"""

from __future__ import annotations

import argparse
import random
import sys
from dataclasses import dataclass, field

from .. import encode
from ..runtime.oracle import decompress
from ..utils.errors import ZstdError
from . import libzstd

SIZES = (0, 1, 7, 100, 1000, 5000, 40_000, 200_000, 500_000)


def gen_payload(rng: random.Random, sizes=SIZES) -> bytes:
    n = rng.choice(sizes)
    kind = rng.randrange(6)
    if kind == 0:
        return rng.randbytes(n)
    if kind == 1:
        return bytes(rng.choice(b"abcdefgh \n") for _ in range(n))
    if kind == 2:
        return (b"repetitive payload unit! " * (n // 25 + 1))[:n]
    if kind == 3:
        return bytes(rng.randrange(3) for _ in range(n))
    if kind == 4:
        return b"".join(
            rng.randbytes(rng.randrange(1, 16)) * rng.randrange(1, 20)
            for _ in range(n // 64 + 1)
        )[:n]
    return bytes(n)  # zeros


@dataclass
class FuzzCounts:
    iterations: int = 0
    failures: int = 0
    engine_equal: int = 0  # engine inputs decoded to the oracle's bytes
    engine_typed_errors: int = 0  # engine inputs rejected with a ZstdError, as by the oracle
    modes: dict = field(default_factory=lambda: dict.fromkeys(range(4), 0))  # iterations by mode


def oracle(data: bytes) -> tuple[bytes | None, ZstdError | None]:
    """The host oracle's result on ``data``: (bytes, None) or (None, the
    ZstdError it raised)."""
    try:
        return decompress(data), None
    except ZstdError as e:
        return None, e


def hold_to_oracle(engine, data: bytes, want: tuple, counts: FuzzCounts) -> None:
    """Decode ``data`` with the engine and hold it to the oracle's result
    ``want`` (``oracle(data)``): raise AssertionError unless both give the
    same bytes or both raise a ``ZstdError``.  Any other exception from
    the engine propagates."""
    want_bytes, want_err = want
    try:
        got = engine.decompress(data)
    except ZstdError as e:
        if want_err is None:
            raise AssertionError(f"engine raised {e!r}, the oracle decoded {len(want_bytes)} bytes") from None
        counts.engine_typed_errors += 1
        return
    finally:
        if engine.device.type == "cuda":
            import torch

            torch.cuda.synchronize(engine.device)
    if want_err is not None:
        raise AssertionError(f"engine decoded {len(got)} bytes, the oracle raised {want_err!r}")
    if got != want_bytes:
        raise AssertionError(f"engine bytes differ from the oracle's ({len(got)} vs {len(want_bytes)})")
    counts.engine_equal += 1


def corrupt_frames(frame: bytes, seed: int, flips: int = 64, truncations: int = 16) -> list[bytes]:
    """Corrupt copies of one frame from a seeded generator: ``flips``
    copies with 1-4 bits flipped at bytes past the frame header (block
    headers and bodies: literal and sequence streams, tables), then
    ``truncations`` prefixes of it."""
    from ..format.frame import parse_frame_header
    from ..utils.bits import ForwardByteCursor

    cur = ForwardByteCursor(frame)
    cur.le_u32()  # magic
    parse_frame_header(cur)
    rng = random.Random(seed)
    out = []
    for _ in range(flips):
        comp = bytearray(frame)
        for _ in range(rng.randrange(1, 5)):
            comp[rng.randrange(cur.pos, len(frame))] ^= 1 << rng.randrange(8)
        out.append(bytes(comp))
    out += [frame[: rng.randrange(1, len(frame))] for _ in range(truncations)]
    return out


def run(iterations: int = 200, seed: int = 0, *, engine=None, sizes=SIZES, log=print) -> FuzzCounts:
    """The fuzz loop; failures are logged and counted, never raised."""
    rng = random.Random(seed)
    counts = FuzzCounts(iterations=iterations)
    for it in range(iterations):
        payload = gen_payload(rng, sizes)
        mode = rng.randrange(4)
        counts.modes[mode] += 1
        try:
            if mode == 0:  # libzstd round-trip
                comp = libzstd.compress(
                    payload, rng.choice([1, 3, 6, 12, 19]), checksum=rng.random() < 0.5
                )
                assert decompress(comp) == payload
            elif mode == 1:  # the port's encoder, both decoders
                comp = encode.compress(payload, 3, checksum=True)
                assert decompress(comp) == payload
                assert libzstd.decompress(comp) == payload
            elif mode == 2:  # mutation: typed error or valid output
                comp = bytearray(libzstd.compress(payload, 3, checksum=True))
                if comp:
                    for _ in range(rng.randrange(1, 5)):
                        comp[rng.randrange(len(comp))] ^= 1 << rng.randrange(8)
                comp = bytes(comp)
                try:
                    decompress(comp)
                except ZstdError:
                    pass
            else:  # truncation / garbage
                comp = libzstd.compress(payload, 3)[: rng.randrange(0, 64)]
                comp += rng.randbytes(rng.randrange(0, 32))
                try:
                    decompress(comp)
                except ZstdError:
                    pass
            if engine is not None:
                hold_to_oracle(engine, comp, oracle(comp), counts)
        except Exception as e:  # noqa: BLE001 — report and continue
            counts.failures += 1
            log(f"[{it}] FAILURE mode={mode} len={len(payload)}: {type(e).__name__}: {e}")
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iterations", type=int, default=200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", action="store_true", help="also hold the device engine to the oracle")
    ap.add_argument("--device", help="the engine's device (default: the CUDA card)")
    args = ap.parse_args(argv)

    engine = None
    if args.engine:
        from ..runtime.engine import DeviceEngine

        engine = DeviceEngine(device=args.device)
    counts = run(args.iterations, args.seed, engine=engine)
    print(
        f"{counts.iterations} iterations, {counts.failures} failures"
        + (f", engine on {engine.device}: {counts.engine_equal} equal bytes, "
           f"{counts.engine_typed_errors} typed errors" if engine is not None else "")
    )
    return 1 if counts.failures else 0


if __name__ == "__main__":
    sys.exit(main())
