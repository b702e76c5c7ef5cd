"""Lanes at the edges of the entropy kernels' bit reader, derived from a
real batch plan.

Each edge lane copies a lane of the plan (picked with the caller's
numpy generator) and changes one thing, so that its reads reach an edge
of the backward-bitstream contract (``kernels/bitbuf.py``):

* ``shifted_p0``: the start bit moved up by 1-7 bits; the stream decodes
  as garbage and the lane is not ok;
* ``clamped_base``: the base word moved to the last words of the input,
  so most word indices clamp to the last word;
* ``below_base``: the start bit a few dozen bits above the base word and
  more symbols (sequences) than that holds, so reads run into the phantom
  zeros below the base word;
* ``one``: one symbol (sequence);
* literals ``past_table``: a copy of the lane's Huffman table whose class
  limits stop at 1 024, so a peek at or above it falls in the class past
  the table (code length 0, rank 0);
* sequences ``overflow``: an RLE literal-length table of code 35 (value
  base 65 536, 16 extra bits), so the first sequence overflows the narrow
  16-bit field and only the wide form carries it;
* sequences ``past_rows``: tables whose state updates send half the
  states past the 512 rows a lane addresses, where a lookup selects the
  zero entry;
* sequences ``stall``: tables that consume 120 bits a sequence (three
  31-bit extra fields, three 9-bit state updates), so the reference
  buffer's fill count runs down and narrow slots stall.  No table header yields such a table:
  the never-stall invariant (96 bits of refill a slot against at most 90
  read) is what makes the random-access reader equal the JAX buffered
  reader, so this lane is for the kernels against their plain forms only
  (``BEYOND_REFERENCE``).

Lengths are capped at ``cap`` symbols (sequences) a lane, which keeps the
plain forms' per-slot loops short.  Table edges are new slots appended to
copies of the plan's banks; the plan itself is not changed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..runtime.engine import literal_lanes, sequence_lanes

BEYOND_REFERENCE = ("stall",)
HUFF_BANKS = ("limits", "prevs", "lengths", "rankb", "ranked")
FSE_BANKS = ("fse_flat0", "fse_flat1", "fse_off")


@dataclass
class EdgeLanes:
    """One kernel call's edge lanes.  ``lane_mat`` has the kernel's lane
    columns; ``banks`` the plan's table banks with the edge slots
    appended (literals: ``HUFF_BANKS``, sequences: ``FSE_BANKS``);
    ``cum`` the output prefix sums (literals: words of ceil(regen / 4);
    sequences: packed words, entropy2.decode_sequences_dense's cumw);
    ``rows`` the longest lane's symbols (sequences)."""

    names: list[str]
    lane_mat: np.ndarray
    banks: dict[str, np.ndarray]
    cum: np.ndarray
    rows: int


def _prefix(counts) -> np.ndarray:
    cum = np.zeros(len(counts) + 1, dtype=np.int32)
    np.cumsum(np.asarray(counts, dtype=np.int64), out=cum[1:])
    return cum


def literal_edges(plan, rng: np.random.Generator, cap: int) -> EdgeLanes:
    """Literal lanes (entropy2.LIT_LANE_COLS) at the reader's edges."""
    _idx, real, _cum = literal_lanes(plan)
    if not len(real):
        raise ValueError("the plan has no literal lane")
    banks = {k: np.asarray(getattr(plan, f"huff_{k}")).astype(np.int32) for k in HUFF_BANKS}
    n_words = len(plan.words)
    rows, names = [], []

    def lane(name, **change):
        row = real[int(rng.integers(len(real)))].copy()  # base, p0, pend, regen, slot
        row[3] = min(row[3], cap)
        for col, v in change.items():
            row[("base", "p0", "pend", "regen", "slot").index(col)] = v
        rows.append(row)
        names.append(name)
        return row

    row = lane("shifted_p0")
    row[1] += int(rng.integers(1, 8))
    lane("clamped_base", base=n_words - int(rng.integers(1, 4)))
    lane("below_base", p0=int(rng.integers(12, 32)), regen=cap)
    lane("one", regen=1)
    row = lane("past_table")
    src = int(row[4])
    for k in HUFF_BANKS:
        banks[k] = np.concatenate([banks[k], banks[k][src : src + 1]])
    banks["limits"][-1] = np.minimum(banks["limits"][-1], 1024)
    row[4] = len(banks["limits"]) - 1

    lane_mat = np.stack(rows).astype(np.int32)
    cum = _prefix(-(-lane_mat[:, 3] // 4))
    return EdgeLanes(names, lane_mat, banks, cum, int(lane_mat[:, 3].max()))


def _append_slot(banks: dict, e0: np.ndarray, e1: np.ndarray) -> int:
    slot = len(banks["fse_off"])
    banks["fse_off"] = np.append(banks["fse_off"], len(banks["fse_flat0"])).astype(np.int32)
    banks["fse_flat0"] = np.concatenate([banks["fse_flat0"], e0]).astype(np.int32)
    banks["fse_flat1"] = np.concatenate([banks["fse_flat1"], e1]).astype(np.int32)
    return slot


def sequence_edges(plan, rng: np.random.Generator, cap: int) -> EdgeLanes:
    """Sequence lanes (entropy2.SEQ_LANE_COLS) at the reader's edges."""
    _idx, real, _cumw = sequence_lanes(plan)
    if not len(real):
        raise ValueError("the plan has no sequence lane")
    banks = {k: np.asarray(getattr(plan, k)).astype(np.int32) for k in FSE_BANKS}
    n_words = len(plan.words)
    rows, names = [], []

    def lane(name):
        row = real[int(rng.integers(len(real)))].copy()
        row[3] = min(row[3], cap)
        rows.append(row)
        names.append(name)
        return row

    lane("shifted_p0")[1] += int(rng.integers(1, 8))
    lane("clamped_base")[0] = n_words - int(rng.integers(1, 4))
    row = lane("below_base")
    row[1], row[3] = int(rng.integers(24, 64)), cap
    lane("one")[3] = 1

    # RLE literal-length table of code 35: value base 65 536, 16 extra bits.
    rle35 = _append_slot(banks, np.zeros(1), np.full(1, (65536 << 5) | 16))
    row = lane("overflow")
    row[7], row[10] = rle35, 0  # ll_slot, ll_al

    # 512 rows of 5-bit state updates from baseline 0 on even rows and 600
    # on odd ones, and 3 extra bits (OF code 3): half the updates leave the
    # 512 rows, and the next row is the zero entry.
    e0 = np.where(np.arange(512) % 2 == 1, 600 << 16, 0) | 5
    past = _append_slot(banks, e0, np.full(512, 3))
    row = lane("past_rows")
    row[7:10], row[10:13] = past, 9

    # 512 rows of 9-bit state updates and 31 extra bits: 120 bits a sequence.
    heavy = _append_slot(banks, np.full(512, 9), np.full(512, 31))
    row = lane("stall")
    row[7:10], row[10:13] = heavy, 9

    lane_mat = np.stack(rows).astype(np.int32)
    w_sum = lane_mat[:, 4:7].astype(np.int64).sum(axis=1)
    cum = _prefix(lane_mat[:, 3].astype(np.int64) * (1 + (w_sum > 32)))
    return EdgeLanes(names, lane_mat, banks, cum, int(lane_mat[:, 3].max()))
