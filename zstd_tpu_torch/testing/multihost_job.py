"""A multi-process decode job on one machine, for the tests and
``chip_smoke.py``.

:func:`run_job` starts ``nproc`` worker processes (this module with
``--worker``), each of which joins a gloo process group on
``127.0.0.1`` (``parallel.multihost.initialize``), decodes one ``.zst``
file with ``MultihostEngine`` on its device (with ``--local-mesh N``,
lane-sharded over N copies of it), and prints one JSON line: its
output's SHA-256 and whether it equals the expected bytes, its engine
counters, launches and launches by mesh position from its first decode,
its bins of both phases (lanes and symbols or sequences, its own and
every process's), the lanes it launched, the bytes and seconds of the
two exchanges, and its decode walls: the first (cold) and, with
``--reps N``, the median of the N - 1 after it, and the least kernel
phase (``stats.wall_s["kernels"]``) of those N - 1.  A worker that exits
non-zero or outlives its timeout fails the job: every worker is killed
and :func:`run_job` raises.

    python -m zstd_tpu_torch.testing.multihost_job --worker --rank R \\
        --nproc P --port PORT --input FILE [--expect FILE] [--device DEV] [--reps N] \\
        [--local-mesh N]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import pathlib
import socket
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_job(input_path, expect_path=None, *, nproc: int = 2, device: str | None = None,
            timeout: float = 300.0, threads: int | None = None, reps: int = 1,
            local_mesh: int | None = None) -> list[dict]:
    """Run the job, every rank on ``device`` when one is named (``"cpu"``
    included), else each on its own card (``MultihostEngine`` resolves it
    through ``multihost.rank_device``); returns each worker's JSON result
    in rank order.  Raises RuntimeError when a worker fails or times out."""
    port = free_port()
    cmd = [sys.executable, "-m", "zstd_tpu_torch.testing.multihost_job", "--worker",
           "--nproc", str(nproc), "--port", str(port), "--input", str(input_path)]
    if expect_path is not None:
        cmd += ["--expect", str(expect_path)]
    if threads is not None:
        cmd += ["--threads", str(threads)]
    if local_mesh is not None:
        cmd += ["--local-mesh", str(local_mesh)]
    if device is not None:
        cmd += ["--device", str(device)]
    cmd += ["--reps", str(reps)]
    procs = [
        subprocess.Popen([*cmd, "--rank", str(r)], cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for r in range(nproc)
    ]
    results = []
    try:
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"multihost worker {r} did not finish in {timeout} s") from None
            if p.returncode != 0:
                raise RuntimeError(f"multihost worker {r} exited {p.returncode}:\n{out[-4000:]}")
            results.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def _bins(plan, nproc: int) -> dict:
    from ..parallel.dist import shard_lanes_balanced

    out = {}
    for phase, counts in (("literals", plan.lit_regen), ("sequences", plan.seq_nseq)):
        bins = shard_lanes_balanced(counts, nproc)
        out[phase] = {
            "lanes": [len(b) for b in bins],
            "lanes_with_work": [int((counts[b] > 0).sum()) for b in bins],
            "work": [int(counts[b].sum()) for b in bins],  # symbols or sequences
        }
    return out


def _worker(args) -> dict:
    import torch

    from ..format.block_table import build_batch_plan
    from ..kernels import compact, literals, sequences
    from ..parallel import multihost
    from ..parallel.mesh import make_mesh

    if args.threads:
        torch.set_num_threads(args.threads)
    data = pathlib.Path(args.input).read_bytes()
    multihost.initialize(f"127.0.0.1:{args.port}", args.nproc, args.rank)
    try:
        if args.local_mesh:
            dev = args.device or multihost.rank_device(args.rank)
            eng = multihost.MultihostEngine(local_mesh=make_mesh(args.local_mesh, device=dev))
        else:
            eng = multihost.MultihostEngine(device=args.device)
        fns = {"literals": literals.decode_literals, "sequences": sequences.decode_sequences,
               "compact": compact.compact_lanes}
        for f in fns.values():
            f.launches = 0
        walls, kernels = [], []
        for i in range(args.reps):
            t0 = time.perf_counter()
            got = eng.decompress(data)
            if eng.device.type == "cuda":
                torch.cuda.synchronize(eng.device)
            walls.append(time.perf_counter() - t0)
            kernels.append(eng.stats.wall_s["kernels"])
            if i == 0:
                out, stats = got, eng.stats
                launches = {k: f.launches for k, f in fns.items()}
        bins = _bins(build_batch_plan(data), args.nproc)
        res = {
            "rank": eng.pid, "nproc": eng.nproc, "device": str(eng.device),
            "sha256": hashlib.sha256(out).hexdigest(), "bytes_out": len(out),
            "exact": None if args.expect is None else out == pathlib.Path(args.expect).read_bytes(),
            "all_reps_equal": got == out,
            "cold_wall_s": walls[0], "wall_s": statistics.median(walls[1:] or walls), "walls_s": walls,
            "kernels_s": min(kernels[1:] or kernels),
            "launches": launches, "kernel_calls": stats.kernel_calls, "mesh_calls": stats.mesh_calls,
            "fallback_frames": stats.fallback_frames, "fallback_reasons": stats.fallback_reasons,
            "lit_lanes_run": stats.lit_lanes_run, "seq_lanes_run": stats.seq_lanes_run,
            "retry_lanes": stats.retry_lanes, "bins": bins, "exchange": eng.exchange_stats,
        }
        multihost.dist.barrier()
    finally:
        multihost.dist.destroy_process_group()
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worker", action="store_true", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--input", required=True)
    ap.add_argument("--expect")
    ap.add_argument("--device", help="default: the rank's own card (multihost.rank_device)")
    ap.add_argument("--threads", type=int)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--local-mesh", type=int)
    args = ap.parse_args(argv)
    print(json.dumps(_worker(args)), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
