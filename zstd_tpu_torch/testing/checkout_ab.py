"""Several checkouts of the port, in turns on one card.

    python -m zstd_tpu_torch.testing.checkout_ab NAME=DIR [NAME=DIR ...] [--pairs N]

Each DIR is the root of a checkout (the parent commit, for example,
unpacked with ``git archive`` into a git-ignored directory).  One worker
process per checkout imports that checkout's own ``zstd_tpu_torch``: its
engine, its wrappers and its kernels, built into its own ``build/``.
Each worker builds ``chip_smoke.py``'s 24 MB level-3 corpus and checks
one ``DeviceEngine().decompress`` of it (bit-exact, no oracle fallback);
then the workers run in turns, one at a time:

* the lane kernels, once each in the order A B ... B A: at every frame
  group, the median time between CUDA events around one wrapper call of
  literals and of sequences narrow and wide (``chip_smoke.py``'s ``ms``);
* the decode wall, ``--pairs`` times: one ``decompress`` of the corpus
  per checkout, in the order A B ... on even pairs and ... B A on odd.

Prints one JSON line per phase: the kernel times, then every wall with
its median, min, max and quartiles, the median of each checkout's wall
less the first checkout's in the same pair, and the pairs in which it
was the faster.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

WORKER = r"""
import json, statistics, sys, time
import numpy as np, torch
from zstd_tpu_torch import DeviceEngine
from zstd_tpu_torch.format.block_table import build_batch_plan, input_words
from zstd_tpu_torch.kernels import literals, sequences
from zstd_tpu_torch.runtime import engine
from zstd_tpu_torch.testing.corpus import build_corpus, compress_chunks

raw = build_corpus()
comp = compress_chunks(raw, 3)
eng = DeviceEngine()
assert eng.decompress(comp) == raw and eng.stats.fallback_frames == 0


def event_ms(fn, reps):
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernels():
    dev = torch.device("cuda", 0)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)
    words, out = input_words(comp), []
    for frames in engine.frame_groups(comp):
        plan = build_batch_plan(comp, words=words, frames=frames)
        banks = engine.plan_to_device(plan, dev)
        _i, lit_mat, cum = engine.literal_lanes(plan)
        _i, seq_mat, _c = engine.sequence_lanes(plan)
        lit = (banks["words"], up(lit_mat), up(cum),
               *(banks[k] for k in ("limits", "prevs", "lengths", "rankb", "ranked")))
        seq = (banks["words"], up(seq_mat), banks["fse_flat0"], banks["fse_flat1"], banks["fse_off"])
        n_dense, rows = int(cum[-1]), int(seq_mat[:, 3].max())
        out.append({
            "literals": event_ms(lambda: literals.decode_literals(*lit, n_dense=n_dense), 10),
            "narrow": event_ms(lambda: sequences.decode_sequences(*seq, rows=rows), 10),
            "wide": event_ms(lambda: sequences.decode_sequences(*seq, rows=rows, wide=True), 5),
        })
    return out


def wall():
    t0 = time.perf_counter()
    eng.decompress(comp)
    return time.perf_counter() - t0


print(json.dumps("ready"), flush=True)
for line in sys.stdin:
    print(json.dumps(kernels() if line.strip() == "kernels" else wall()), flush=True)
"""


def _ask(name: str, proc: subprocess.Popen, command: str | None):
    if command is not None:
        proc.stdin.write(command + "\n")
        proc.stdin.flush()
    line = proc.stdout.readline()
    if not line:
        raise RuntimeError(f"worker {name} exited with {proc.wait()}")
    return json.loads(line)


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", metavar="NAME=DIR")
    ap.add_argument("--pairs", type=int, default=12)
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.trees)
    names = list(trees)
    procs = {}
    try:
        for name, root in trees.items():
            root = os.path.abspath(root)
            procs[name] = subprocess.Popen(
                [sys.executable, "-c", WORKER], cwd=root, env={**os.environ, "PYTHONPATH": root},
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            )
        for name, proc in procs.items():
            if _ask(name, proc, None) != "ready":
                raise RuntimeError(f"worker {name} did not start")
        kern = {name: [] for name in names}
        for name in names + names[::-1]:
            kern[name].append(_ask(name, procs[name], "kernels"))
        print(json.dumps({"kernel_event_ms": kern}), flush=True)
        walls = {name: [] for name in names}
        for i in range(args.pairs):
            for name in names if i % 2 == 0 else names[::-1]:
                walls[name].append(_ask(name, procs[name], "wall"))
        first = walls[names[0]]
        print(json.dumps({"wall_s": {
            name: {"walls": w, "median": statistics.median(w), "min": min(w), "max": max(w),
                   "quartiles": statistics.quantiles(w, n=4)[::2],
                   "median_less_first": statistics.median(a - b for a, b in zip(w, first)),
                   "pairs_faster_than_first": sum(a < b for a, b in zip(w, first))}
            for name, w in walls.items()
        }}), flush=True)
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
