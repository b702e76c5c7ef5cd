"""Benchmark of the port: batch ZSTD decode throughput on one CUDA card.

    python -m zstd_tpu_torch.bench [--device cuda:0|cpu] [--corpus-mb F]
        [--hl-bytes N] [--iters N] [--enc-bytes N]

Prints ONE JSON line on stdout; every log goes to stderr:

    {"metric": ..., "value": N, "unit": "GB/s", "vs_baseline": N, "detail": {...}}

The port of the JAX package's root ``bench.py``, in its order and with
its field names wherever the meaning is the same; the defaults are its
sizes (a 24 MB corpus, its first 8 MiB at level 19, 5 timed decodes,
200 000-byte encoder sets).  It runs on ``cuda:0`` by default and exits
non-zero without CUDA: there is no fallback to the CPU.  ``--device cpu``
runs the kernels' plain PyTorch forms, for the tests; the line then says
so in ``metric`` and ``device.torch_device``, and every device-only field
(``idle_share``, ``device_busy_ms``, ``top_device_ms``, the pinned
transfer rates, ``fetch_GBs``, the card's name and power limit) is null.

Steps, each timed window after the build and its route's warm-up:

1. ``build_s``: every CUDA kernel (``kernels/_build.build_all``, on the
   card only) and the host C library, which must build: without it the
   encoder silently writes raw blocks.
2. The corpus: ``testing/corpus.build_corpus(corpus_mb)``, libzstd level
   3 with checksums, one frame per 4 MiB.  Unlike ``bench.py``, the text
   part is always the generated word text (``bench.py`` decodes a bundled
   text file where one exists), so the bytes depend on no file outside
   the repository.
3. The main route (``DeviceEngine``): one warm-up decode, then ``iters``
   timed decodes, each ended by a synchronisation of the card; ``value``
   is the median GB/s, ``best_gbs``/``worst_gbs`` the spread.  Every
   decode must be bit-exact with ``fallback_frames == 0``: the oracle
   fallback turns a wrong kernel into right bytes, so a fallback fails
   the bench (``bench.py`` only reports it).  ``lit_lanes``,
   ``seq_lanes``, ``kernel_calls`` and ``wall_s`` are the last timed
   decode's (the pipelined route's per-group plans: ``wall_s`` holds
   prepass, kernels, assembly, total and the engine's ``STEPS``).  ``bench.py`` takes
   ``kernel_calls`` and ``wall_s`` from its ``measure_phases`` decode
   instead (the one-plan route, with its dispatch and fetch keys), so
   these two keys do not compare across the packages.
4. ``transfers``: one ``measure_phases`` decode after a warm-up of that
   one-plan route: ``kernel_s`` (dispatch, upload_wait, device_compute,
   fetch), ``rest_s`` (``total_s`` less those four, ``prepass_s`` and
   ``assembly_s``: the host finish and the wide retry), ``upload_MB``,
   ``fetch_MB``, ``compute_only_GBs``, ``compute_incl_upload_GBs``.
5. Pinned transfer probes in place of ``bench.py``'s relay probes: a
   32 MiB pinned host buffer copied to the card and back, the median of
   10 copies each way between CUDA events (``h2d_pinned_GBs``,
   ``d2h_pinned_GBs``), and ``fetch_GBs`` (step 4's fetch MB over its
   fetch seconds).
6. ``highlevel_mix``: the first ``hl_bytes`` at level 19 as one frame,
   bit-exact, timed over 2 decodes, fallbacks gated at 0.
7. ``device_route``: ``DeviceEngine(device_execute=True)`` (LZ77 on the
   card) on the main corpus, warm-up then ``iters`` timed decodes, gated
   like step 3; ``lz77_calls`` is the LZ77 kernel's launches in its
   warm-up decode (0 on the CPU, where the plain form runs).
8. ``idle_share``: one traced main-route decode after the timed ones
   (tracing is off while timing), after a warm-up trace, retaking a
   trace that lacks the lane kernels (``observability.traced``):
   ``device_busy_ms`` from device-side events, ``idle_share`` against
   step 3's median wall, ``top_device_ms`` the 10 largest ops.
9. ``encode_vs_libzstd``: the port's ``compress`` over four sets
   (``encoder_sets``) at levels 1, 3, 6 and 19; each value is its frame
   length over libzstd's, and libzstd must decode every frame.
10. Bars: ``oracle_baseline_gbs`` (the port's host oracle on a 2 MiB
    slice; ``vs_baseline``), ``libzstd_serial_gbs`` (libzstd on the
    whole corpus through ``libzstd.decompress``, which allocates and
    copies its output buffer a call, mean of ``iters``;
    ``vs_libzstd_serial``) and ``libzstd_reused_gbs`` (the same decode
    into one buffer and one DCtx made before the clock starts,
    ``libzstd.Decoder``; ``vs_libzstd_reused``).
11. ``device``: ``torch_device``, the card's ``name``
    (``torch.cuda.get_device_name``), its ``power_limit`` (``nvidia-smi``,
    the row at the card's PCI address) and the ``count`` of cards.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from . import native
from .encode import compress
from .kernels import _build, lz77
from .observability import (
    card_line,
    device_ms_by_op,
    event_ms,
    holds_kernels,
    idle_share,
    profiler_warm_up,
    traced,
)
from .runtime.engine import DeviceEngine, resolve_device
from .runtime.oracle import decompress as oracle_decompress
from .testing import libzstd
from .testing.corpus import build_corpus, compress_chunks

ENC_LEVELS = (1, 3, 6, 19)
LANE_KERNELS = ("literals_kernel", "sequences_kernel<false>")
PROBE_BYTES = 32 << 20
ORACLE_SLICE = 2 << 20


class BenchFailed(RuntimeError):
    """A gate of the bench failed: wrong bytes, a fallback, a missing build."""


def log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def check(ok: bool, what) -> None:
    if not ok:
        raise BenchFailed(what)


def card_info(dev: torch.device) -> dict:
    """The card's name, its power limit as ``nvidia-smi`` gives it, and
    the number of cards."""
    power = card_line(dev.index).rsplit(", ", 1)[1]
    return {"torch_device": str(dev), "name": torch.cuda.get_device_name(dev), "power_limit": power,
            "count": torch.cuda.device_count()}


def encoder_sets(raw: bytes, n: int = 200_000) -> dict:
    """``bench.py``'s four encoder inputs (text, records, low-entropy,
    repetitive), scaled to about ``n`` bytes each; ``n`` = 200 000 gives
    its sets exactly."""
    rng = np.random.default_rng(7)
    records = round(6000 * n / 200_000)
    lowent = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), n).tobytes()
    block = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    chunks = rng.integers(512, 4096, max(1, round(80 * n / 200_000)))
    return {
        "text": raw[:n],
        "records": b"".join(
            b"id=%08d|name=user%04d|score=%05d;" % (i, i % 7919, (i * 2654435761) % 99999)
            for i in range(records)
        ),
        "lowent": lowent,
        "repetitive": b"".join(block[: int(k)] for k in chunks),
    }


def encode_table(sets: dict) -> dict:
    """{set: {"L<level>": port frame length / libzstd frame length}}; every
    port frame must decode to its input through libzstd."""
    table = {}
    for name, payload in sets.items():
        table[name] = {}
        for lv in ENC_LEVELS:
            ref = len(libzstd.compress(payload, lv))
            ours = compress(payload, level=lv)
            check(libzstd.decompress(ours) == payload, f"libzstd cannot decode the port's {name} frame at level {lv}")
            table[name][f"L{lv}"] = len(ours) / ref
    return table


def _decode(eng: DeviceEngine, comp: bytes, raw: bytes, what: str) -> float:
    """One decode, timed until the card has finished; it must be bit-exact
    with no oracle fallback."""
    t0 = time.perf_counter()
    out = eng.decompress(comp)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    check(out == raw, f"{what}: decode is not bit-exact")
    check(eng.stats.fallback_frames == 0, f"{what}: oracle fallback: {eng.stats.fallback_reasons}")
    return dt


def _timed(eng: DeviceEngine, comp: bytes, raw: bytes, iters: int, what: str) -> list[float]:
    """Walls of ``iters`` decodes after one warm-up decode (the kernels'
    first launches, the pinned buffers)."""
    _decode(eng, comp, raw, f"{what} warm-up")
    return [_decode(eng, comp, raw, what) for _ in range(iters)]


def _gbs(n: int, seconds: float) -> float:
    return n / seconds / 1e9


def _pinned_probes(dev: torch.device) -> tuple[float, float]:
    """GB/s of a pinned 32 MiB host buffer copied to the card and back,
    each the median of 10 copies between CUDA events after a warm-up."""
    host = torch.from_numpy(
        np.random.default_rng(1).integers(0, 255, PROBE_BYTES, dtype=np.uint8)
    ).pin_memory()
    on_card = torch.empty_like(host, device=dev)
    with torch.cuda.device(dev):
        h2d = event_ms(lambda: on_card.copy_(host, non_blocking=True), 10)
        d2h = event_ms(lambda: host.copy_(on_card, non_blocking=True), 10)
    return PROBE_BYTES / h2d / 1e6, PROBE_BYTES / d2h / 1e6


def _idle(eng: DeviceEngine, comp: bytes, raw: bytes, wall_s: float) -> dict:
    """Device busy time by op over one traced main-route decode and the
    idle share against the untraced median wall."""
    profiler_warm_up(log)
    prof = traced(lambda: _decode(eng, comp, raw, "traced"), holds_kernels(*LANE_KERNELS),
                  "lacks a lane kernel", log)
    dev_ms = device_ms_by_op(prof)
    busy = sum(dev_ms.values())
    return {"device_busy_ms": busy, "idle_share": idle_share(busy, wall_s),
            "top_device_ms": dict(sorted(dev_ms.items(), key=lambda kv: -kv[1])[:10])}


def run(device=None, corpus_mb: float = 24.0, hl_bytes: int = 8 << 20, iters: int = 5,
        enc_bytes: int = 200_000) -> dict:
    """The bench's JSON object; raises BenchFailed when a gate fails and
    RuntimeError without CUDA unless ``device`` names the CPU."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"

    t0 = time.perf_counter()
    if on_card:
        _build.build_all()
    native.require()
    build_s = time.perf_counter() - t0
    log(f"build {build_s:.1f} s on {dev}")

    raw = build_corpus(corpus_mb)
    comp = compress_chunks(raw, 3)
    log(f"corpus {len(raw)} B -> {len(comp)} B (level 3)")

    engine = DeviceEngine(device=dev)
    times = sorted(_timed(engine, comp, raw, iters, "main route"))
    dt = statistics.median(times)
    stats = engine.stats.as_dict()
    log(f"main route walls {times}")

    engine.measure_phases = True
    _decode(engine, comp, raw, "measure_phases warm-up")
    _decode(engine, comp, raw, "measure_phases")
    engine.measure_phases = False
    ph = engine.stats.as_dict()
    w = ph["wall_s"]
    four = ("dispatch", "upload_wait", "device_compute", "fetch")
    compute_s = w["dispatch"] + w["device_compute"]
    compute_up_s = compute_s + w["upload_wait"]
    h2d = d2h = None
    if on_card:
        h2d, d2h = _pinned_probes(dev)
    transfers = {
        "kernel_s": {k: w[k] for k in four},
        "rest_s": w["total"] - sum(w[k] for k in (*four, "prepass", "assembly")),
        "prepass_s": w["prepass"],
        "assembly_s": w["assembly"],
        "total_s": w["total"],
        "upload_MB": ph["upload_bytes"] / 1e6,
        "fetch_MB": ph["fetch_bytes"] / 1e6,
        "h2d_pinned_GBs": h2d,
        "d2h_pinned_GBs": d2h,
        "fetch_GBs": ph["fetch_bytes"] / 1e9 / w["fetch"] if on_card and w["fetch"] else None,
        "compute_only_GBs": _gbs(len(raw), compute_s) if compute_s else None,
        "compute_incl_upload_GBs": _gbs(len(raw), compute_up_s) if compute_up_s else None,
    }
    log(f"transfers {json.dumps(transfers)}")

    hl_raw = raw[:hl_bytes]
    hl_comp = libzstd.compress(hl_raw, 19, checksum=True)
    hl_times = _timed(engine, hl_comp, hl_raw, 2, "high-level mix")
    hl_detail = {
        "corpus_bytes": len(hl_raw),
        "compressed_bytes": len(hl_comp),
        "gbs": _gbs(len(hl_raw), statistics.mean(hl_times)),
        "fallback_frames": engine.stats.fallback_frames,
    }
    log(f"high-level mix {json.dumps(hl_detail)}")

    dev_engine = DeviceEngine(device=dev, device_execute=True)
    lz77.exec_ops.launches = 0
    _decode(dev_engine, comp, raw, "device route warm-up")
    lz77_calls = lz77.exec_ops.launches
    check(lz77_calls > 0 or not on_card, "device route: the LZ77 kernel never launched")
    dev_times = sorted(_decode(dev_engine, comp, raw, "device route") for _ in range(iters))
    device_route = {
        "gbs": _gbs(len(raw), statistics.median(dev_times)),
        "best_gbs": _gbs(len(raw), dev_times[0]),
        "worst_gbs": _gbs(len(raw), dev_times[-1]),
        "fallback_frames": dev_engine.stats.fallback_frames,
        "lz77_calls": lz77_calls,
    }
    log(f"device route walls {dev_times}")

    idle = {"device_busy_ms": None, "idle_share": None, "top_device_ms": None}
    if on_card:
        idle = _idle(engine, comp, raw, dt)
        log(f"idle {json.dumps(idle)}")

    t0 = time.perf_counter()
    encode_ratios = encode_table(encoder_sets(raw, enc_bytes))
    log(f"encoder table {time.perf_counter() - t0:.1f} s")

    slice_raw = raw[:ORACLE_SLICE]
    slice_comp = libzstd.compress(slice_raw, 3, checksum=True)
    t0 = time.perf_counter()
    check(oracle_decompress(slice_comp) == slice_raw, "the host oracle is not bit-exact")
    oracle_gbs = _gbs(len(slice_raw), time.perf_counter() - t0)
    check(libzstd.decompress(comp) == raw, "libzstd is not bit-exact")
    t0 = time.perf_counter()
    for _ in range(iters):
        libzstd.decompress(comp)
    libzstd_gbs = _gbs(len(raw), (time.perf_counter() - t0) / iters)
    dec = libzstd.Decoder(len(raw))
    try:
        n = dec.decode(comp)
        check(dec.buffer.raw[:n] == raw, "libzstd into a reused buffer is not bit-exact")
        t0 = time.perf_counter()
        for _ in range(iters):
            dec.decode(comp)
        reused_gbs = _gbs(len(raw), (time.perf_counter() - t0) / iters)
    finally:
        dec.close()
    log(f"libzstd one thread: {libzstd_gbs:.4f} GB/s, into a reused buffer {reused_gbs:.4f} GB/s")

    gbs = _gbs(len(raw), dt)
    where = "1 GPU" if on_card else "CPU (plain forms)"
    return {
        "metric": f"silesia-like batch decode throughput ({where}, bit-exact)",
        "value": gbs,
        "unit": "GB/s",
        "vs_baseline": gbs / oracle_gbs,
        "detail": {
            "device": card_info(dev) if on_card else
            {"torch_device": "cpu", "name": None, "power_limit": None, "count": 0},
            "build_s": build_s,
            "corpus_bytes": len(raw),
            "compressed_bytes": len(comp),
            "iters": iters,
            "best_gbs": _gbs(len(raw), times[0]),
            "worst_gbs": _gbs(len(raw), times[-1]),
            "oracle_baseline_gbs": oracle_gbs,
            "libzstd_serial_gbs": libzstd_gbs,
            "vs_libzstd_serial": gbs / libzstd_gbs,
            "libzstd_reused_gbs": reused_gbs,
            "vs_libzstd_reused": gbs / reused_gbs,
            "lit_lanes": stats["lit_lanes"],
            "seq_lanes": stats["seq_lanes"],
            "kernel_calls": stats["kernel_calls"],
            "fallback_frames": stats["fallback_frames"],
            "wall_s": stats["wall_s"],
            "transfers": transfers,
            "highlevel_mix": hl_detail,
            "device_route": device_route,
            **idle,
            "encode_vs_libzstd": encode_ratios,
        },
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", help="cuda:N (default cuda:0) or cpu (the plain forms, for tests)")
    ap.add_argument("--corpus-mb", type=float, default=24.0)
    ap.add_argument("--hl-bytes", type=int, default=8 << 20)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--enc-bytes", type=int, default=200_000)
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    report = run(args.device, args.corpus_mb, args.hl_bytes, args.iters, args.enc_bytes)
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
