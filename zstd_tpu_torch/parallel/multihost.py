"""Multi-process (multi-host) distributed decode over ``torch.distributed``.

Every process of the job runs the same program:

1. the identical host prepass (the block table is deterministic),
2. ``shard_lanes_balanced`` splits the literal and sequence lane tables
   into per-process bins balanced by symbol count,
3. each process decodes only its bin with the engine's dispatch
   (``runtime/engine.py``) on its own card (``rank_device``) unless
   given a device, or lane-sharded over its local devices when given a
   ``local_mesh``,
4. per-lane outputs are exchanged with an ordered fixed-shape all-gather
   across processes (pad-to-max buffers and exact slicing), and
5. every process assembles the full frame bytes identically.

The exchange moves host arrays after the fetch over a **gloo** process
group, as the JAX package's moves them through
``multihost_utils.process_allgather``: processes may share a card (CUDA
allows it, NCCL does not), and the bytes exchanged are a few per
sequence.  ``zstd_tpu/parallel/multihost.py`` is the reference.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..format.frame import MAX_WINDOW_SIZE
from ..runtime.engine import DeviceEngine
from .dist import shard_lanes_balanced


def initialize(coordinator_address: str, num_processes: int, process_id: int) -> None:
    """Join the multi-process job: a gloo process group whose rendezvous
    is ``tcp://<coordinator_address>`` ("host:port"; process 0 listens
    there).  Call once per process before building a MultihostEngine."""
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
    )


def _job() -> tuple[int, int]:
    """(process count, this process's index); (1, 0) outside a job."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _allgather(arr: np.ndarray) -> np.ndarray:
    """Fixed-shape all-gather over processes of a host array: (P,
    *arr.shape), in process order."""
    if _job()[0] == 1:
        return np.asarray(arr)[None].copy()
    t = torch.from_numpy(np.ascontiguousarray(arr))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def rank_device(rank: int) -> str | None:
    """The card of process ``rank`` on its machine: ``cuda:LOCAL_RANK``
    when the launcher sets ``LOCAL_RANK``, else ``cuda:{rank mod the
    card count}``; None without CUDA (the engine then raises, as
    ``resolve_device`` does for every engine without a device)."""
    if not torch.cuda.is_available():
        return None
    local = os.environ.get("LOCAL_RANK")
    return f"cuda:{int(local) if local is not None else rank % torch.cuda.device_count()}"


class MultihostEngine(DeviceEngine):
    """DeviceEngine whose lane work is scattered over processes.

    Each process decodes a balanced bin of lanes locally (optionally
    lane-sharded over its local devices via ``local_mesh``), then bins
    are exchanged with ordered all-gathers; assembly and checksum
    verification run identically everywhere, so ``decompress`` returns
    the same bytes on every process.  ``exchange_stats`` holds the bytes
    gathered and the seconds of each phase's exchange in the last run.
    """

    def __init__(self, *, max_window_size: int = MAX_WINDOW_SIZE, local_mesh=None, device=None, **kw):
        # With neither a device nor a local mesh, each process takes its
        # own card, as each JAX process runs on its own local devices.
        nproc, pid = _job()
        if device is None and local_mesh is None:
            device = rank_device(pid)
        super().__init__(max_window_size=max_window_size, mesh=local_mesh, device=device, **kw)
        self.nproc, self.pid = nproc, pid
        self.exchange_stats: dict = {}

    # -- scattered dispatch -------------------------------------------------

    def _pipelines(self) -> bool:
        """Never: each phase's exchange is a collective that every process
        must enter in the same order, on the same plan, so a call takes the
        one-plan route."""
        return False

    def _run_both(self, plan):
        """Sequential per-phase form: each phase's cross-process exchange
        is a collective every process must enter in the same order."""
        return self._run_literals(plan), self._run_sequences(plan)

    def _run_literals(self, plan):
        bins = shard_lanes_balanced(plan.lit_regen, self.nproc)
        outs, ok = self._run_literals_wide(plan, subset=bins[self.pid])
        self._exchange_literals(plan, bins, outs, ok)
        return outs, ok

    def _run_sequences(self, plan):
        bins = shard_lanes_balanced(plan.seq_nseq, self.nproc)
        outs, ok = self._run_sequences_wide(plan, subset=bins[self.pid])
        self._exchange_sequences(plan, bins, outs, ok)
        return outs, ok

    def _gather(self, phase: str, buf: np.ndarray, okbuf: np.ndarray):
        t0 = time.perf_counter()
        gathered, ok_g = _allgather(buf), _allgather(okbuf)
        self.exchange_stats[phase] = {
            "bytes": int(gathered.nbytes + ok_g.nbytes),
            "s": time.perf_counter() - t0,
        }
        return gathered, ok_g

    # -- ordered exchange ---------------------------------------------------
    #
    # All processes know every bin and every per-lane size from the
    # (identical) plan, so buffers are fixed-shape: each process packs
    # its bin's outputs into a pad-to-max flat buffer, one all-gather
    # moves them, and exact slicing restores per-lane arrays in order.

    def _exchange_literals(self, plan, bins, outs, ok) -> None:
        sizes = [int(plan.lit_regen[b].sum()) for b in bins]
        width = max(max(sizes), 1)
        buf = np.zeros(width, dtype=np.uint8)
        pos = 0
        for lane in bins[self.pid]:
            r = int(plan.lit_regen[lane])
            if r and outs[lane] is not None:
                buf[pos : pos + r] = outs[lane]
            pos += r
        okbuf = np.zeros(max(len(b) for b in bins) + 1, dtype=bool)
        okbuf[: len(bins[self.pid])] = ok[bins[self.pid]]
        gathered, ok_g = self._gather("literals", buf, okbuf)
        for p, b in enumerate(bins):
            if p == self.pid:
                continue
            pos = 0
            for k, lane in enumerate(b):
                r = int(plan.lit_regen[lane])
                outs[lane] = gathered[p, pos : pos + r]
                ok[lane] = ok_g[p, k]
                pos += r

    def _exchange_sequences(self, plan, bins, outs, ok) -> None:
        sizes = [int(plan.seq_nseq[b].sum()) for b in bins]
        width = max(max(sizes), 1)
        # Rows: ll (int32), ofv (uint32), ml (int32), widened to int64.
        buf = np.zeros((3, width), dtype=np.int64)
        pos = 0
        for lane in bins[self.pid]:
            ns = int(plan.seq_nseq[lane])
            if ns and outs[lane] is not None:
                ll, ofv, ml = outs[lane]
                got = len(ll)  # may be < ns when the lane failed
                buf[0, pos : pos + got] = ll
                buf[1, pos : pos + got] = ofv.astype(np.int64)
                buf[2, pos : pos + got] = ml
            pos += ns
        okbuf = np.zeros(max(len(b) for b in bins) + 1, dtype=bool)
        okbuf[: len(bins[self.pid])] = ok[bins[self.pid]]
        gathered, ok_g = self._gather("sequences", buf, okbuf)
        for p, b in enumerate(bins):
            if p == self.pid:
                continue
            pos = 0
            for k, lane in enumerate(b):
                ns = int(plan.seq_nseq[lane])
                # The dtypes of the engine's own _finish_sequences (the JAX
                # package returns int64 / uint64 / int64 here).
                outs[lane] = (
                    gathered[p, 0, pos : pos + ns].astype(np.int32),
                    gathered[p, 1, pos : pos + ns].astype(np.uint32),
                    gathered[p, 2, pos : pos + ns].astype(np.int32),
                )
                ok[lane] = ok_g[p, k]
                pos += ns


def multihost_decompress(data: bytes, *, max_window_size=None, **kw) -> bytes:
    """Decode ``data`` cooperatively across all processes of the job.

    Returns the full output bytes on every process (identical)."""
    engine = MultihostEngine(max_window_size=max_window_size or MAX_WINDOW_SIZE, **kw)
    return engine.decompress(data)
