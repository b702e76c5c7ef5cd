"""Per-frame decoding context — the complete inter-block resume state.

Mirror of the reference's ``DecodingContext``
(zstd-decompressor/src/decoding_context.rs:17-47): output
so far, the 3-slot repeat-offset history, the cached Huffman table
(treeless literals reuse, literals.rs:59-66) and the three cached
sequence-table specs (repeat FSE modes, sequences.rs:232-234).

Serializing this context checkpoints a decode mid-frame — it is the
checkpoint/resume unit for giant inputs (``state_dict`` /
``load_state_dict``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..format.sequences import SeqMode
from ..ops.fse import FseTable
from ..ops.huffman import HuffmanTable
from ..ops.sequence_codes import INITIAL_REPEAT_OFFSETS


@dataclass
class TableSpec:
    """A resolved sequence-code table: RLE byte, or an FSE table.

    Stored kind is never REPEAT — repeats resolve against the previous
    spec at decode time.
    """

    kind: SeqMode
    rle_byte: int = 0
    fse_table: FseTable | None = None


@dataclass
class DecodingContext:
    window_size: int
    output: bytearray = field(default_factory=bytearray)
    rep: list[int] = field(default_factory=lambda: list(INITIAL_REPEAT_OFFSETS))
    huffman: HuffmanTable | None = None
    ll_spec: TableSpec | None = None
    of_spec: TableSpec | None = None
    ml_spec: TableSpec | None = None

    def state_dict(self) -> dict:
        """Snapshot for checkpoint/resume of a mid-frame decode."""

        def spec(s: TableSpec | None):
            if s is None:
                return None
            return {
                "kind": int(s.kind),
                "rle_byte": s.rle_byte,
                "fse": None
                if s.fse_table is None
                else {
                    "al": s.fse_table.accuracy_log,
                    "symbol": s.fse_table.symbol.copy(),
                    "baseline": s.fse_table.baseline.copy(),
                    "nbits": s.fse_table.nbits.copy(),
                },
            }

        return {
            "window_size": self.window_size,
            "output": bytes(self.output),
            "rep": list(self.rep),
            "huffman": None
            if self.huffman is None
            else {
                "max_bits": self.huffman.max_bits,
                "weights": self.huffman.weights.copy(),
            },
            "ll_spec": spec(self.ll_spec),
            "of_spec": spec(self.of_spec),
            "ml_spec": spec(self.ml_spec),
        }

    @classmethod
    def from_state_dict(cls, state: dict) -> "DecodingContext":
        from ..ops.huffman import build_huffman_table

        def spec(d):
            if d is None:
                return None
            fse = d["fse"]
            table = None
            if fse is not None:
                table = FseTable(
                    accuracy_log=fse["al"],
                    symbol=np.asarray(fse["symbol"], dtype=np.uint16),
                    baseline=np.asarray(fse["baseline"], dtype=np.uint16),
                    nbits=np.asarray(fse["nbits"], dtype=np.uint8),
                )
            return TableSpec(SeqMode(d["kind"]), d["rle_byte"], table)

        ctx = cls(window_size=state["window_size"])
        ctx.output = bytearray(state["output"])
        ctx.rep = list(state["rep"])
        if state["huffman"] is not None:
            # Rebuild the flat table from weights (excluding the implied last).
            w = list(state["huffman"]["weights"][:-1])
            ctx.huffman = build_huffman_table(w)
        ctx.ll_spec = spec(state["ll_spec"])
        ctx.of_spec = spec(state["of_spec"])
        ctx.ml_spec = spec(state["ml_spec"])
        return ctx
