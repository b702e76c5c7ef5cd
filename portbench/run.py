"""Run one cell of the benchmark once, on one CUDA card.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``<config>.<traffic>`` in ``BENCHMARK.json``) names a
configuration file (``configs/``: framing, batches, engine options,
guarantees) and a traffic file (``traffic/``: content file, level).
Set-up cuts the content into chunks and compresses them
(``inputs.make_corpus``, from ``--seed``), builds the engine
(``zstd_tpu_torch``'s ``DeviceEngine``) and decodes the first
``WARM_PASSES`` passes of requests.  The window is a closed loop of one
caller: each request is one ``decompress_with_stats`` call over the
frames that ``inputs.Corpus`` deals it, sent when the previous one has
returned, for ``--seconds``.  With ``--trace 1`` the window runs under
``torch.profiler`` and the per-layer metrics are read from it and from
the engine's spans; with ``--trace 0`` the end-to-end metrics.

After the window every output kept (every request's, up to
``RETAIN_BYTES``; past that a uniform sample drawn from the seed) is
compared byte for byte with the raw chunks it has to give, and every
request's fallback counters are read.  The last line of standard output
is the result (JSON); the last lines of standard error are each
compared number beside its limit.  Without a CUDA card the run exits 2
and prints no result.
"""

from __future__ import annotations

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
# Caches of the libraries the program may use, at fixed paths inside the
# checkout (the program's own kernels build into ``build/`` beside it).
CACHE_DIRS = {
    "TORCH_EXTENSIONS_DIR": os.path.join(REPO, "build", "portbench", "torch_extensions"),
    "TRITON_CACHE_DIR": os.path.join(REPO, "build", "portbench", "triton"),
    "CUDA_CACHE_PATH": os.path.join(REPO, "build", "portbench", "cuda_cache"),
}
FORBIDDEN = ("jax", "jaxlib", "flax", "zstd_tpu")
RETAIN_BYTES = 8 << 30  # outputs kept for the comparison after the window
WARM_PASSES = 2  # passes over the content decoded in set-up


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def process_start_s() -> float:
    """This process's start on the CLOCK_BOOTTIME scale (seconds)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return int(fields[19]) / os.sysconf("SC_CLK_TCK")


def since_start(t0: float) -> float:
    return time.clock_gettime(time.CLOCK_BOOTTIME) - t0


def forbidden_modules(names=None) -> list[str]:
    """Top-level names of JAX and the JAX package among ``names`` (by
    default the loaded modules), compared whole."""
    return sorted({m.split(".", 1)[0] for m in (sys.modules if names is None else names)} & set(FORBIDDEN))


def card(device) -> dict:
    import subprocess

    import torch

    try:
        power = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        power = "unknown"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "power_limit": power}


class Retained:
    """The outputs kept for the comparison: every one while they fit in
    ``capacity``, then a uniform sample of that many (reservoir sampling,
    drawn from the seed)."""

    def __init__(self, capacity: int, seed: int):
        import numpy as np

        self.capacity = max(1, capacity)
        self.rng = np.random.default_rng([abs(int(seed)), 1])
        self.items: list = []  # (request index, output)
        self.seen = 0

    def offer(self, i: int, out: bytes) -> None:
        if len(self.items) < self.capacity:
            self.items.append((i, out))
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.capacity:
                self.items[j] = (i, out)
        self.seen += 1


def window(engine, corpus, first: int, seconds: float, seed: int, trace: bool):
    """The measured closed loop from request ``first``: (requests, window
    seconds, CPU seconds, retained outputs).  A request's bytes are joined
    before its call, inside the window and outside its latency."""
    from . import record
    from .trace import request_span

    per_request = sum(len(c) for c in corpus.raw) // corpus.batches_per_file + 1
    keep = Retained(RETAIN_BYTES // per_request, seed)
    reqs = []
    cpu0 = time.process_time()
    t0 = now = time.perf_counter()
    while now - t0 < seconds:
        i = first + len(reqs)
        data = corpus.request(i)
        start = time.perf_counter()
        if trace:
            with request_span():
                out = engine.decompress_with_stats(data)
        else:
            out = engine.decompress_with_stats(data)
        now = time.perf_counter()
        st = engine.stats
        reqs.append(record.Request(i, start, now, len(out), dict(st.wall_s), st.fallback_frames,
                                   len(st.fallback_reasons), corpus.entropy_bytes(i)))
        keep.offer(len(reqs) - 1, out)
        del out, data
    return reqs, now - t0, time.process_time() - cpu0, keep


def default_engine(device, options):
    """The system under test: the port's ``DeviceEngine`` with the
    configuration's options."""
    from zstd_tpu_torch.runtime.engine import DeviceEngine

    return DeviceEngine(device=device, **options)


def execute(cell, seed: int, seconds: float, trace: bool, *, device, t_start: float,
            make_engine=None, corpus=None, log=log) -> dict:
    """One run of ``cell``: set-up, window, checks.  Returns the result
    object (without checking for a card: ``main`` does that).
    ``make_engine(device, options)`` builds the system under test
    (``default_engine`` unless given).  ``corpus`` passes inputs already
    made from this seed (``inputs.make_corpus``)."""
    import gc
    import json

    import torch

    from . import inputs, record, spec
    from . import trace as tr
    from .reference import compare

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    make_engine = make_engine or default_engine
    log(f"imports done at {since_start(t_start):.2f} s")
    if corpus is None:
        corpus = inputs.make_corpus(cell, seed)
    log(f"{cell.name} seed {seed}: {len(corpus.frames)} chunks, "
        f"{sum(map(len, corpus.raw))} B -> {sum(map(len, corpus.frames))} B, "
        f"set-up {since_start(t_start):.2f} s so far")
    engine = make_engine(dev, dict(cell.config.get("engine", {})))
    first = WARM_PASSES * corpus.batches_per_file
    for i in range(first):  # kernel builds, first launches, pinned buffers
        engine.decompress_with_stats(corpus.request(i))
    if on_card:
        torch.cuda.synchronize(dev)
    if trace and on_card:
        tr.warm_up(dev, log)
    setup_s = since_start(t_start)
    log(f"set-up {setup_s:.3f} s")

    evs = None
    if trace and on_card:
        def traced_window():
            with tr.layer_spans(engine):
                return window(engine, corpus, first, seconds, seed, True)

        evs, (reqs, window_s, cpu_s, keep) = tr.traced(traced_window, log)
    else:
        reqs, window_s, cpu_s, keep = window(engine, corpus, first, seconds, seed, False)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    log(f"window {window_s:.3f} s, {len(reqs)} requests, cpu {cpu_s:.3f} s")

    readings = {
        "fallback_frames": sum(r.fallback_frames for r in reqs),
        "fallback_reasons": sum(r.fallback_reasons for r in reqs),
    }
    del engine
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    wrong = {i: compare.wrong_bytes(out, corpus.expected(reqs[i].index)) for i, out in keep.items}
    keep.items.clear()
    readings["wrong_bytes"] = sum(wrong.values())
    failed = sum(1 for i, r in enumerate(reqs) if r.fallback_frames or r.fallback_reasons or wrong.get(i))
    checked = compare.checks(readings)

    trace_read = None
    if evs is not None:
        t_read = time.perf_counter()
        trace_read = tr.read(evs)
        log(f"trace of {len(evs)} events read in {time.perf_counter() - t_read:.1f} s")
    kind = card(dev) if on_card else {"platform": "cpu", "kind": "cpu", "count": 0}
    peaks = json.loads(open(os.path.join(HERE, "peaks.json")).read()).get(kind["kind"])
    run = record.Run(cell, reqs, window_s, cpu_s, setup_s, trace_read, peaks)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {**kind, "memory_peak_bytes": peak}
    result = {"correct": bool(reqs) and compare.passed(checked), "attempted": len(reqs),
              "failed": failed, "metrics": metrics, "device": dev_info}
    if trace_read is not None:
        dev_info.update(busy_s=trace_read.busy_s, window_s=trace_read.window_s)
        result["breakdown"] = tr.breakdown(trace_read)
        log(f"entropy bytes a request {reqs[0].entropy_bytes if reqs else None}; peak table "
            f"{peaks}; power limit {kind.get('power_limit')}")
    log(f"compared {len(wrong)} of {len(reqs)} outputs byte for byte")
    result["checks"] = checked
    return result


def main(argv=None) -> int:
    import argparse

    t_start = process_start_s()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for k, v in CACHE_DIRS.items():
        os.environ[k] = v
    os.environ["USE_FLAX"] = "0"

    import json

    import torch

    from . import spec

    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    result = execute(cell, args.seed, args.seconds, bool(args.trace), device="cuda:0",
                     t_start=t_start)
    bad = forbidden_modules()
    if bad:
        log(f"loaded after the window: {bad} (the run may load neither JAX nor the JAX package)")
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
