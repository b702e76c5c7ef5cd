"""Multi-process kernel-phase scaling: the port of the JAX package's
``tools/scaling_bench.py``.

    python -m zstd_tpu_torch.testing.scaling_bench [--corpus-mb F] [--device cpu]

Runs ``testing/multihost_job`` (``MultihostEngine`` over a gloo group on
127.0.0.1) at 1 and at 2 processes on the same input, ``corpus_mb`` of
the bench corpus in 32 KiB libzstd frames at level 3, and prints one JSON
line with the JAX tool's keys: ``corpus_MB``, ``kernels_s_1proc``,
``kernels_s_2proc`` (the slowest process), ``speedup``, ``efficiency`` =
t(1) / (2 * t(2)) and ``per_proc_2``.  ``kernels_s`` is a worker's
``stats.wall_s["kernels"]``, the least of its two decodes after a cold
first one, as in the JAX tool.  Added: ``device`` (the card's name, or ``"cpu"``) and
``cards``, the number of distinct cards the two ranks used.

By default each rank runs on its own card (``multihost.rank_device``);
without CUDA the bench exits non-zero.  With one card both ranks share
``cuda:0`` (``"cards": 1``), so the line times two processes on one card,
not scaling.  ``--device cpu`` runs gloo over CPU processes, the JAX
tool's own topology.  Every worker's output must be bit-exact with no
oracle fallback.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import tempfile

import torch

from ..runtime.engine import resolve_device
from . import multihost_job
from .corpus import build_corpus, compress_chunks

FRAME_BYTES = 32 << 10
REPS = 3  # decodes a worker: one cold, then the two timed


def _job(src, expect, nproc: int, device) -> list[dict]:
    results = multihost_job.run_job(src, expect, nproc=nproc, device=device, reps=REPS, timeout=900)
    for r in results:
        if not (r["exact"] and r["all_reps_equal"] and r["fallback_frames"] == 0):
            raise RuntimeError(f"scaling bench: rank {r['rank']} of {nproc} is not bit-exact "
                               f"or fell back: {r['fallback_reasons']}")
    return results


def run(corpus_mb: float = 0.75, device=None) -> dict:
    """The scaling line; raises RuntimeError without CUDA unless
    ``device`` names the CPU, or when a worker fails."""
    dev = resolve_device(device)
    raw = build_corpus(corpus_mb)
    comp = compress_chunks(raw, 3, chunk=FRAME_BYTES)
    with tempfile.TemporaryDirectory() as tmp:
        src, expect = pathlib.Path(tmp) / "in.zst", pathlib.Path(tmp) / "expect.bin"
        src.write_bytes(comp)
        expect.write_bytes(raw)
        r1 = _job(src, expect, 1, device)
        r2 = _job(src, expect, 2, device)
    t1 = r1[0]["kernels_s"]
    t2 = max(r["kernels_s"] for r in r2)  # the job ends with its slowest process
    on_card = dev.type == "cuda"
    return {
        "metric": "multihost kernel-phase scaling (" + ("GPU" if on_card else "CPU processes") + ", gloo)",
        "corpus_MB": corpus_mb,
        "kernels_s_1proc": t1,
        "kernels_s_2proc": t2,
        "speedup": t1 / t2,
        "efficiency": t1 / (2 * t2),
        "per_proc_2": [r["kernels_s"] for r in r2],
        "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
        "cards": len({r["device"] for r in r2 if r["device"].startswith("cuda")}),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus-mb", type=float, default=0.75)
    ap.add_argument("--device", help="cpu for gloo over CPU processes (default: each rank's own card)")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"scaling_bench: {e}", file=sys.stderr)
        return 2
    print(json.dumps(run(args.corpus_mb, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
