"""Sharded (multi-device) batched decode.

Independent entropy-stream lanes are sharded over a 1-D device mesh.
``ShardedEngine`` is a thin subclass of the single-device
``DeviceEngine``: it sets ``mesh``, and the engine's dispatch
(``runtime/engine.py``) splits each launch's lanes into one contiguous
block per mesh device, so the sharded path runs the same kernels and
code as the single-device one; no collective is needed until the
ordered host assembly.

Multi-process execution lives in ``parallel/multihost.py``: balanced
lane bins per process (``shard_lanes_balanced``) and the ordered
cross-process exchange.
"""

from __future__ import annotations

import numpy as np

from ..format.frame import MAX_WINDOW_SIZE
from ..runtime.engine import DeviceEngine
from .mesh import make_mesh


def shard_lanes_balanced(costs: np.ndarray, n_shards: int) -> list[np.ndarray]:
    """Greedy balanced binning of lanes by cost (e.g. symbol count).

    Returns per-shard lane-index arrays; the multi-host scheduler
    (SURVEY.md §2.3, parallel/multihost.py) assigns shard i to process
    i so hosts decode near-equal byte volumes.
    """
    order = np.argsort(-np.asarray(costs))
    bins: list[list[int]] = [[] for _ in range(n_shards)]
    loads = np.zeros(n_shards)
    for lane in order:
        i = int(np.argmin(loads))
        bins[i].append(int(lane))
        loads[i] += costs[lane]
    return [np.asarray(sorted(b), dtype=np.int64) for b in bins]


class ShardedEngine(DeviceEngine):
    """DeviceEngine with each launch's lanes split over a device mesh.

    The mesh size must be a power of two <= 128, as the JAX engine's is
    (its padded lane counts must stay divisible); the port pads nothing,
    but keeps the contract."""

    def __init__(self, mesh=None, *, max_window_size: int = MAX_WINDOW_SIZE, **kw):
        if mesh is None:
            mesh = make_mesh()
        n = mesh.size
        if n & (n - 1) or n > 128:
            raise ValueError(f"mesh size {n} must be a power of two <= 128")
        super().__init__(max_window_size=max_window_size, mesh=mesh, **kw)


def sharded_decompress(data: bytes, mesh=None, *, max_window_size=None) -> bytes:
    """Full multi-device decode: prepass → lane-sharded kernels →
    ordered host assembly.  Byte-identical to the host oracle."""
    engine = ShardedEngine(mesh, max_window_size=max_window_size or MAX_WINDOW_SIZE)
    return engine.decompress(data)
