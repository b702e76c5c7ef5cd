"""A cell's inputs, made from ``--seed``: the content file cut into the
configuration's chunks and compressed once in set-up, then dealt into
requests.

The content (``content/<name>.tar.zst``, checked against its SHA-256)
is rotated by an offset drawn from the seed, below ``frame_bytes``, and
cut into chunks of ``frame_bytes``, each compressed alone at the
traffic's level.  Request ``i`` belongs to pass ``i // batches_per_file``:
each pass deals every chunk once, in an order drawn from the seed and the
pass, into ``batches_per_file`` requests of near-equal chunk counts.  So
every pass holds the same work and no two requests are the same bytes.
"""

from __future__ import annotations

import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from . import libzstd, sections, spec

CONTENT = spec.HERE / "content"


def content(name: str) -> bytes:
    """The raw bytes of content file ``name``, checked against its
    description."""
    desc = json.loads((CONTENT / f"{name}.json").read_text())
    raw = libzstd.decompress((CONTENT / f"{name}.tar.zst").read_bytes(), desc["bytes"])
    if len(raw) != desc["bytes"] or hashlib.sha256(raw).hexdigest() != desc["sha256"]:
        raise ValueError(f"content {name!r} does not match its description")
    return raw


def _rng(seed: int, *key: int) -> np.random.Generator:
    """A generator distinct for every (seed, key), for any integer seed
    however large."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), *key])


@dataclass
class Corpus:
    raw: list  # each chunk's raw bytes
    frames: list  # each chunk compressed alone: one frame
    work: list  # each frame's entropy work (sections.EntropyWork)
    batches_per_file: int
    seed: int

    def order(self, i: int) -> np.ndarray:
        """The chunks of request ``i``, in the order it holds them."""
        b = self.batches_per_file
        perm = _rng(self.seed, 1, i // b).permutation(len(self.frames))
        return np.array_split(perm, b)[i % b]

    def request(self, i: int) -> bytes:
        return b"".join([self.frames[j] for j in self.order(i)])

    def expected(self, i: int) -> bytes:
        """What decoding request ``i`` has to give, byte for byte."""
        return b"".join([self.raw[j] for j in self.order(i)])

    def entropy_bytes(self, i: int) -> int:
        return sum(self.work[j].bytes for j in self.order(i))


def make_corpus(cell: spec.Cell, seed: int, raw: bytes | None = None) -> Corpus:
    """The cell's chunks from ``seed``: ``raw`` (by default the traffic's
    content file) rotated, cut and compressed.  Chunks compress on a
    thread pool: libzstd runs without the interpreter lock."""
    raw = content(cell.traffic["content"]) if raw is None else raw
    step = int(cell.config["frame_bytes"])
    off = int(_rng(seed, 0).integers(0, min(step, len(raw))))
    raw = raw[off:] + raw[:off]
    chunks = [raw[i : i + step] for i in range(0, len(raw), step)]
    level = int(cell.traffic["level"])
    with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
        frames = list(ex.map(lambda c: libzstd.compress(c, level, checksum=False), chunks))
    return Corpus(raw=chunks, frames=frames, work=[sections.frame_work(f) for f in frames],
                  batches_per_file=int(cell.config["batches_per_file"]), seed=seed)
