"""Command-line interface.

The PyTorch port's copy of ``zstd_tpu/cli.py``, with the same flags,
output and exit codes.  Run it as ``python -m zstd_tpu_torch.cli``.

Mirrors the reference CLI's flags and behavior
(the reference's src/main.rs:7-25): positional input file, ``--info``
frame dump, ``-o/--output``, ``--print-skippable``; skippable frames are
dropped from the output unless requested.  Unlike the reference — which
routes output through ``String::from_utf8`` and panics on binary data
(src/main.rs:55-57) — output is always raw bytes.

Extra flags expose codec capabilities the reference lacks: checksum
enforcement, window-size override, a run report and a profiler trace.
Decoding always runs the port's ``DeviceEngine`` on the CUDA card
``cuda:0``, and raises when CUDA is not available; ``--device`` is
accepted, so that the flags stay those of ``zstd_tpu.cli``, and changes
nothing.  ``--info`` parses the frames on the host.
"""

from __future__ import annotations

import argparse
import sys

from .format.frame import SkippableFrame, iter_frames
from .utils.errors import ZstdError


def _huffman_info(payload, indent: str) -> list[str]:
    """Parsed-Huffman dump: weights, max_bits, and the canonical code
    list — the content of the reference's Debug iterator
    (the reference's zstd-decompressor/src/decoders/huffman.rs:23-77,
    printed from src/main.rs:35-40)."""
    from .ops.huffman import parse_huffman_table
    from .utils.bits import ForwardByteCursor

    try:
        t = parse_huffman_table(ForwardByteCursor(payload))
    except ZstdError as e:
        return [f"{indent}huffman: <corrupt: {type(e).__name__}: {e}>"]
    lines = [
        f"{indent}huffman: max_bits={t.max_bits} "
        f"num_symbols={len(t.weights)} (last weight implied)"
    ]
    ws = " ".join(str(int(w)) for w in t.weights)
    lines.append(f"{indent}  weights: [{ws}]")
    codes = []
    code = 0
    # Canonical enumeration, longest codes first (huffman.py table order).
    pos = 0
    while pos < t.size:
        n = int(t.nbits[pos])
        sym = int(t.symbol[pos])
        code = pos >> (t.max_bits - n)
        codes.append(f"{sym:#04x}:{code:0{n}b}")
        pos += 1 << (t.max_bits - n)
    lines.append(f"{indent}  codes: " + " ".join(codes))
    return lines


def _seq_table_info(name: str, m, indent: str) -> str:
    if m.mode.name == "RLE":
        return f"{indent}{name}_table: rle(symbol={m.rle_byte})"
    if m.fse_table is not None:
        t = m.fse_table
        probs = getattr(t, "distribution", None)
        detail = f" distribution={list(map(int, probs))}" if probs is not None else ""
        return (
            f"{indent}{name}_table: {m.mode.name.lower()}"
            f"(accuracy_log={t.accuracy_log}, states={1 << t.accuracy_log})"
            + detail
        )
    return f"{indent}{name}_table: {m.mode.name.lower()}"


def _format_info(frame, index: int) -> str:
    if isinstance(frame, SkippableFrame):
        return (
            f"Frame #{index}: Skippable(magic={frame.magic:#010x}, "
            f"length={len(frame.payload)})"
        )
    h = frame.header
    lines = [
        f"Frame #{index}: ZStandard",
        f"  window_size:   {h.window_size}",
        f"  content_size:  {h.content_size}",
        f"  dict_id:       {h.dict_id}",
        f"  checksum_flag: {h.checksum_flag}",
        f"  checksum:      "
        + (f"{frame.checksum:#010x}" if frame.checksum is not None else "None"),
        f"  blocks:        {len(frame.blocks)}",
    ]
    for i, b in enumerate(frame.blocks):
        extra = ""
        if b.btype.name == "RLE":
            extra = f" byte={b.rle_byte:#04x} repeat={b.rle_repeat}"
        elif b.btype.name == "COMPRESSED":
            lit = b.literals
            seq = b.sequences
            extra = (
                f" literals={lit.ltype.name.lower()}({lit.regenerated_size})"
                f" sequences={seq.num_sequences}"
            )
        elif b.data is not None:
            extra = f" size={len(b.data)}"
        lines.append(f"    block #{i}: {b.btype.name.lower()}{extra}")
        if b.btype.name == "COMPRESSED":
            if b.literals.huffman_payload is not None:
                lines += _huffman_info(b.literals.huffman_payload, "      ")
            if b.sequences.num_sequences:
                for name, m in (
                    ("ll", b.sequences.ll),
                    ("of", b.sequences.of),
                    ("ml", b.sequences.ml),
                ):
                    lines.append(_seq_table_info(name, m, "      "))
    return "\n".join(lines)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="zstd-tpu",
        description="ZSTD codec on PyTorch and CUDA (decompress a .zst file).",
    )
    p.add_argument("file_name", help="input .zst file")
    p.add_argument(
        "--info", action="store_true", help="print frame metadata instead of decoding"
    )
    p.add_argument("-o", "--output", default=None, help="output file (default stdout)")
    p.add_argument(
        "--print-skippable",
        action="store_true",
        help="include skippable-frame payloads in the output",
    )
    p.add_argument(
        "--no-verify-checksum",
        action="store_true",
        help="do not enforce content checksums (the reference only warns)",
    )
    p.add_argument(
        "--max-window-log",
        type=int,
        default=23,
        help="maximum window size as log2 (default 23 = 8 MiB, reference parity)",
    )
    p.add_argument(
        "--device",
        action="store_true",
        help="decode on the CUDA card via the batched device engine "
        "(always so; kept for the flags of zstd_tpu.cli)",
    )
    p.add_argument(
        "--report",
        action="store_true",
        help="print a structured per-run report (JSON) to stderr after "
        "decoding (throughput, per-stage wall clock, lane/fallback "
        "counters)",
    )
    p.add_argument(
        "--trace-dir",
        default=None,
        metavar="DIR",
        help="wrap the device decode in a torch.profiler trace written to "
        "DIR/trace.json (Chrome trace format)",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        data = open(args.file_name, "rb").read()
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    max_window = 1 << args.max_window_log
    try:
        if args.info:
            for i, frame in enumerate(iter_frames(data, max_window_size=max_window)):
                print(_format_info(frame, i))
            return 0

        from .observability import RunReport, profiled
        from .runtime.engine import DeviceEngine

        engine = DeviceEngine(max_window_size=max_window)
        with profiled(args.trace_dir):
            out = engine.decompress(
                data,
                verify_checksum=not args.no_verify_checksum,
                include_skippable=args.print_skippable,
            )
        if args.report:
            print(RunReport.from_engine(engine).to_json(), file=sys.stderr)
    except ZstdError as e:
        print(f"error: {type(e).__name__}: {e}", file=sys.stderr)
        return 1

    if args.output:
        with open(args.output, "wb") as f:
            f.write(out)
    else:
        try:
            sys.stdout.buffer.write(out)
            sys.stdout.buffer.flush()
        except BrokenPipeError:
            # Reader (e.g. `| head`) closed the pipe — not an error.
            import os

            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
