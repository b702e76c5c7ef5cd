#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``zstd_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (no phase's error is caught):

1. Card: name and power limit (``nvidia-smi``); build every CUDA kernel
   from ``zstd_tpu_torch/csrc`` (one ``nvcc`` per source, in parallel)
   and the host C routines.
2. Corpus: the bench's 24 MB Silesia-like corpus, compressed by the
   system libzstd at level 3 with checksums, one frame per 4 MiB; and
   its first 8 MiB at level 19 (treeless and repeat tables, long
   offsets, the wide retry).
3. Each kernel against its plain PyTorch form, at the inputs the main
   path gives it: literals (dense bytes + ok flags) and sequences narrow
   and wide (whole planes + ok flags, pre-retry) at every frame group of
   the level-3 corpus, and on the edge lanes of its first group
   (``zstd_tpu_torch.testing.edge_lanes``); compaction (dense words) at
   every frame group, beside the one PyTorch call that computes it
   (``plane.t()[mask]``, ``library_ms``).  Tolerance 0: the codec is
   integer-exact.  The first group's literals and narrow sequences are
   compared on the card; the other groups' plain forms run in CPU worker
   processes started first, beside the card's work.  A kernel's ``ms`` is
   the median time between CUDA events around one wrapper call (the
   kernel and the wrapper's host time, the measure of every earlier run);
   ``device_ms`` is its device time alone, from replays of a CUDA graph
   of one call, held against the profiler's kernel durations in phase 7
   (compaction's, a few microseconds, is the profiler's over 20 calls).
   Both come with ns per step (the longest lane's symbols or sequences)
   and the launch geometry; the plain form is timed once on the card.
   The ``ptxas -v`` resource lines of every kernel are printed first.
4. The main path: ``DeviceEngine().decompress`` of the level-3 corpus
   with every launch count set to 0 just before and read just after;
   the output must equal the corpus, with no oracle fallback, and every
   kernel must have launched.  Then the wall time, median of 3.
5. The same for the level-19 mix, with its retry count.
6. The wide retry: a block whose first sequence overflows the narrow
   packing decodes exactly through the sequences kernel in wide mode.
7. Device time by kernel and the device's idle share over one
   main-path decode (``torch.profiler``); the lane kernels' mean time per
   launch there must agree with phase 3's ``device_ms`` within 20%.
8. The LZ77 copy-program kernel against its plain form (pointer
   doubling), tolerance 0: on the LZ77 spike's own 96 KiB program (also
   against its expected bytes), on the adversarial programs of
   ``zstd_tpu_torch.testing.copy_program`` (one at positions just below
   2^31) and on the copy programs of the level-3 corpus's first frame
   group; per call its CUDA launches, jump rounds, event ms, device ms
   (CUDA-graph replays of ``lz77.launch``) and the profiler's device ms
   by kernel; with the host C executor's ns/byte on the same frames.
9. The device LZ77 route: its assembly of each level-3 frame group step
   by step from outside the engine (program build, upload, LZ77 call,
   fetch, XXH64); then ``DeviceEngine(device_execute=True).decompress``
   of both corpora with every count set to 0 just before and read just
   after: bit-exact, no oracle fallback, every kernel launched, one
   ``lz77`` wrapper call per frame group (and its CUDA launches); then
   the wall time, median of 3.
10. The CLI: ``python -m zstd_tpu_torch.cli --report`` on the level-19
   file, with ``--device`` and without (it decodes on the card either
   way): bit-exact output, and a report naming the card.
11. Sharded: ``ShardedEngine`` over every card there is (``make_mesh()``)
   and over ``make_mesh(2, device="cuda:0")`` (two blocks on one card).
   On one plan of the whole level-3 corpus (every group's lanes in one
   launch a lane list: 736 literal and 184 sequence lanes, shapes phase 3
   does not reach), the single-device engine's per-lane outputs and ok
   flags before and after the wide retry equal the plain forms' (the same
   engine on the CPU, in a worker process started first) and each mesh's
   (tolerance 0); then ``decompress`` with every count set to 0 just
   before: bit-exact, no oracle fallback, each mesh position launching
   once for each lane list whose block it holds; the wall, median of 3,
   and the device time of one decode by kernel (``torch.profiler``).
   With one card, a line says that a mesh over real cards and launches on
   a second card are not run.
12. Multihost: two worker processes (``testing/multihost_job.py``) join a
   gloo group on 127.0.0.1, each decodes the level-3 corpus with
   ``MultihostEngine`` on its own card (the runner names no device, so
   rank r resolves ``cuda:{r mod the card count}`` through
   ``multihost.rank_device``; both on ``cuda:0`` with one card): both bit-exact with one SHA-256, each
   with kernels launched over its own bin only and no oracle fallback,
   bins balanced within 25%; each process's bins, the bytes and seconds
   of its two exchanges, and its walls (its first decode, then the median
   of three more).  A worker that fails or outlives its timeout fails
   the run.
13. Phase split: one decode with ``measure_phases``: bit-exact, and the
   split dispatch / upload_wait / device_compute / fetch beside the total
   (and what prepass, assembly and the four leave: the host finish).
14. The port's encoder: the corpus's first 8 MiB compressed by
   ``zstd_tpu_torch.compress`` as two 4 MiB frames with checksums at
   levels 1, 3 and 19 (one encode a worker process, all at once); per
   level the encode MB/s of one host thread and the size against
   libzstd's at the same level; libzstd decodes each to the raw bytes;
   then ``DeviceEngine()`` on both routes with every count set to 0
   just before and read just after: bit-exact, no oracle fallback, every
   kernel the plans need launched (all three lane kernels at levels 3
   and 19; level-1 frames may hold raw literals only), and the wall,
   median of 3; the
   level-19 input (one frame group) lane by lane against the plain
   forms (a CPU worker process, tolerance 0).
15. Corrupt input on the card: seeded bit flips (64 sets of 1-4, past
   the frame header) and 16 truncations of a 256 KiB level-3 libzstd
   frame and a 256 KiB level-19 port-made frame, each through
   ``DeviceEngine`` on both routes with a synchronisation after each,
   held to the host oracle (the same bytes, or a ``ZstdError`` where it
   raises one), with each route's launches by kernel and the number of
   inputs that reached a kernel (at least one on each route); four of
   the flipped inputs whose prepass succeeds lane
   by lane against the plain forms (CPU worker processes); then the
   fuzz harness, ``python -m zstd_tpu_torch.testing.fuzz --engine
   --iterations 100 --seed 0``, on the card.  Any other exception, other
   bytes or a CUDA error fails the run.
16. The port bench and the scaling bench on the card, each in a process
   of its own: ``python -m zstd_tpu_torch.bench`` (its defaults: 24 MB at
   level 3 on both routes, 8 MiB at level 19, the encoder table, the
   bars) must exit 0 with one JSON line whose main route, device LZ77
   route and level-19 mix had no oracle fallback, that names this card,
   has an idle share in [0, 1] and the pinned transfer rates and the
   libzstd bar; its median GB/s is logged beside phase 4's.  Then
   ``python -m zstd_tpu_torch.testing.scaling_bench`` (1 and 2
   processes, each rank on its own card: both on ``cuda:0`` with one).

The line before the last is the ``kernels`` JSON object; the last line
is ``{"ok": true, "device": {...}}``.  Exits non-zero, printing no
result, without a CUDA card or outside a checkout of the repository.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
SCALAR_OPS_PER_S = 67e12  # H100 SXM non-tensor peak, the table's float32 rate
# Integer operations per decoded unit, counted from the kernels' inner
# loops (csrc/literals.cu per symbol, csrc/sequences.cu per sequence).
LIT_OPS_PER_SYMBOL = 40
SEQ_OPS_PER_SEQUENCE = 150


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what) -> None:
    """Fail the run (a check that survives ``python -O``)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def timed_once(fn):
    """(result, device milliseconds) of one run of ``fn``."""
    import torch

    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def max_abs_err(pairs) -> int:
    """Largest |kernel - plain| over integer tensor pairs (shapes must match)."""
    err = 0
    for k, p in pairs:
        check(k.shape == p.shape, (k.shape, p.shape))
        if k.numel():
            err = max(err, int((k.long() - p.long()).abs().max()))
    return err


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _np_i32(a) -> "np.ndarray":
    import numpy as np

    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)


def _plain_on_cpu(kind: str, arrays: list, kw: dict) -> list:
    """Worker process: a kernel's plain form on CPU tensors (numpy in and
    out), for the frame groups whose comparison runs beside the card."""
    import torch

    from zstd_tpu_torch.kernels import literals, sequences

    torch.set_num_threads(1)
    fn = literals.literals_plain if kind == "literals" else sequences.sequences_plain
    return [o.numpy() for o in fn(*(torch.from_numpy(a) for a in arrays), **kw)]


def _lane_kernel_inputs(plan) -> dict:
    """Both lane kernels' host inputs for one plan, as int32 numpy arrays."""
    from zstd_tpu_torch.runtime import engine

    _idx, lit_mat, cum = engine.literal_lanes(plan)
    _idx, seq_mat, cumw = engine.sequence_lanes(plan)
    words = _np_i32(plan.words)
    huff = [_np_i32(getattr(plan, f"huff_{k}")) for k in ("limits", "prevs", "lengths", "rankb", "ranked")]
    fse = [_np_i32(getattr(plan, k)) for k in ("fse_flat0", "fse_flat1", "fse_off")]
    return {
        "lit": [words, _np_i32(lit_mat), _np_i32(cum), *huff], "n_dense": int(cum[-1]),
        "seq": [words, _np_i32(seq_mat), *fse], "rows": int(seq_mat[:, 3].max()),
        "lit_mat": lit_mat, "seq_mat": seq_mat, "cumw": cumw,
    }


def kernel_phase(comp: bytes, dev) -> dict:
    """Phase 3: every kernel against its plain form.  Literals and
    sequences (narrow and wide) run and are timed at every frame group of
    the level-3 corpus and on the edge lanes of its first group; the
    first group's literals and narrow sequences are compared with their
    plain forms on the card (timed: plain_ms), the other groups' in CPU
    worker processes, all started first so they run beside the card."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    from zstd_tpu_torch.format.block_table import build_batch_plan, input_words
    from zstd_tpu_torch.kernels import _build, literals, sequences
    from zstd_tpu_torch.observability import device_ms, event_ms
    from zstd_tpu_torch.runtime import engine
    from zstd_tpu_torch.testing import edge_lanes

    words = input_words(comp)
    plans = [build_batch_plan(comp, words=words, frames=f) for f in engine.frame_groups(comp)]
    inputs = [_lane_kernel_inputs(plan) for plan in plans]
    up = lambda a: torch.from_numpy(_np_i32(a)).to(dev)  # noqa: E731
    results = {}
    for name in _build.SOURCES:
        for line in _build.ptxas_report(name):
            log(f"ptxas {name}: {line}")

    workers = max(1, min(6, (os.cpu_count() or 2) - 2))
    pool = ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
    try:
        cpu = {}  # (group, kind) -> future of the plain form's outputs
        for g, x in enumerate(inputs):
            if g:
                cpu[g, "literals"] = pool.submit(_plain_on_cpu, "literals", x["lit"], {"n_dense": x["n_dense"]})
                cpu[g, "narrow"] = pool.submit(_plain_on_cpu, "sequences", x["seq"], {"rows": x["rows"]})
            cpu[g, "wide"] = pool.submit(_plain_on_cpu, "sequences", x["seq"], {"rows": x["rows"], "wide": True})
        log(f"kernels vs plain: {len(cpu)} plain runs in {workers} CPU worker processes")

        kept = {}  # (group, kind) -> the kernel's outputs, on the host
        device = {"literals": [], "sequences": []}  # device ms by group
        errs = {"literals": 0, "sequences": 0}
        for g, x in enumerate(inputs):
            # -- literals ----------------------------------------------------
            lit_args = [up(a) for a in x["lit"]]
            n_dense = x["n_dense"]
            run_lit = lambda: literals.decode_literals(*lit_args, n_dense=n_dense)  # noqa: E731
            kd, kok = run_lit()
            geo = _build.launch_info("literals", len(x["lit_mat"]))
            check(bool(kok.all()), f"group {g}: a literal lane is not ok")
            regen = x["lit_mat"][:, 3].astype(np.int64)
            stream_bytes = 4 * int(((x["lit_mat"][:, 1] >> 5) + 1).sum())
            table_bytes = sum(a.nbytes for a in x["lit"][3:])
            n_bytes = stream_bytes + x["lit_mat"].nbytes + x["lit"][2].nbytes + table_bytes + 4 * n_dense + 4 * len(regen)
            b_ms, b_by = bound(n_bytes, LIT_OPS_PER_SYMBOL * int(regen.sum()))
            ms, dev_ms = event_ms(run_lit, 10), device_ms(run_lit, 10)
            device["literals"].append(dev_ms)
            res = dict(ms=ms, device_ms=dev_ms, bound_ms=b_ms, bound_by=b_by)
            if g == 0:
                (pd, pok), res["plain_ms"] = timed_once(
                    lambda: literals.literals_plain(*lit_args, n_dense=n_dense))
                errs["literals"] = max(errs["literals"], max_abs_err([(kd, pd), (kok, pok)]))
                results["literals"] = res
            else:
                kept[g, "literals"] = [kd.cpu(), kok.cpu()]
            log(f"literals group {g}: lanes={len(regen)} symbols={int(regen.sum())} "
                f"longest={int(regen.max())} ms={ms:.4f} ns_per_step={ms * 1e6 / regen.max():.1f} "
                f"device_ms={dev_ms:.4f} device_ns_per_step={dev_ms * 1e6 / regen.max():.1f} "
                f"bound_ms={b_ms:.6f} ({b_by}) geometry={json.dumps(geo)}")

            # -- sequences, narrow and wide -----------------------------------
            seq_args = [up(a) for a in x["seq"]]
            rows = x["rows"]
            nseq = x["seq_mat"][:, 3].astype(np.int64)
            stream_bytes = 4 * int(((x["seq_mat"][:, 1] >> 5) + 1).sum())
            table_bytes = sum(a.nbytes for a in x["seq"][2:])
            L = len(nseq)
            n_bytes = stream_bytes + x["seq_mat"].nbytes + table_bytes + 2 * 4 * rows * L + 4 * L
            b_ms, b_by = bound(n_bytes, SEQ_OPS_PER_SEQUENCE * int(nseq.sum()))
            res = dict(bound_ms=b_ms, bound_by=b_by)
            for wide in (False, True):
                kind = "wide" if wide else "narrow"
                run_seq = lambda: sequences.decode_sequences(*seq_args, rows=rows, wide=wide)  # noqa: E731
                k = run_seq()
                check(bool(k[-1].all()) or not wide, f"group {g}: a wide sequences lane failed")
                res[f"{kind}_ms"] = event_ms(run_seq, 10 if not wide else 5)
                res[f"{kind}_device_ms"] = device_ms(run_seq, 10 if not wide else 5)
                res[f"{kind}_geometry"] = _build.launch_info("sequences", L, wide)
                if g == 0 and not wide:
                    p, res["plain_ms"] = timed_once(lambda: sequences.sequences_plain(*seq_args, rows=rows))
                    errs["sequences"] = max(errs["sequences"], max_abs_err(zip(k, p)))
                else:
                    kept[g, kind] = [t.cpu() for t in k]
            res["ms"], res["device_ms"] = res["narrow_ms"], res["narrow_device_ms"]
            device["sequences"].append(res["device_ms"])
            if g == 0:
                results["sequences"] = res
            log(f"sequences group {g}: lanes={L} sequences={int(nseq.sum())} longest={rows} "
                + " ".join(f"{p}ms={res[f'{k}_ms']:.4f} {p}ns_per_step={res[f'{k}_ms'] * 1e6 / rows:.1f} "
                           f"{p}device_ms={res[f'{k}_device_ms']:.4f} "
                           f"{p}device_ns_per_step={res[f'{k}_device_ms'] * 1e6 / rows:.1f}"
                           for k, p in (("narrow", ""), ("wide", "wide_")))
                + f" bound_ms={b_ms:.6f} ({b_by}) geometry={json.dumps(res['narrow_geometry'])}"
                f" wide_geometry={json.dumps(res['wide_geometry'])}")

        # -- edge lanes of the first group, kernel against plain on the card ---
        rng = np.random.default_rng(3)
        e = edge_lanes.literal_edges(plans[0], rng, cap=255)  # a last word that completes 32
        args = [up(words), up(e.lane_mat), up(e.cum), *(up(e.banks[k]) for k in edge_lanes.HUFF_BANKS)]
        n = int(e.cum[-1])
        err = max_abs_err(zip(literals.decode_literals(*args, n_dense=n),
                              literals.literals_plain(*args, n_dense=n)))
        errs["literals"] = max(errs["literals"], err)
        log(f"literals edge lanes {e.names}: max_abs_err={err}")
        e = edge_lanes.sequence_edges(plans[0], rng, cap=255)
        args = [up(words), up(e.lane_mat), *(up(e.banks[k]) for k in edge_lanes.FSE_BANKS)]
        for wide in (False, True):
            err = max_abs_err(zip(sequences.decode_sequences(*args, rows=e.rows, wide=wide),
                                  sequences.sequences_plain(*args, rows=e.rows, wide=wide)))
            errs["sequences"] = max(errs["sequences"], err)
            log(f"sequences edge lanes {e.names} wide={wide}: max_abs_err={err}")

        t0 = time.perf_counter()
        for (g, kind), fut in cpu.items():
            err = max_abs_err(zip(kept[g, kind], (torch.from_numpy(a) for a in fut.result())))
            name = "literals" if kind == "literals" else "sequences"
            errs[name] = max(errs[name], err)
            log(f"group {g} {kind}: max_abs_err={err} (plain form on the CPU)")
        log(f"kernels vs plain: waited {time.perf_counter() - t0:.1f} s for the CPU workers")
    finally:
        pool.shutdown(cancel_futures=True)
    for name, err in errs.items():
        results[name]["err"] = err
        results[name]["device_ms_by_group"] = device[name]
        check(err == 0, f"{name} kernel disagrees with its plain form")

    results["compact"] = compact_phase(inputs, up, dev)
    return results


def compact_phase(inputs: list, up, dev) -> dict:
    """Phase 3, compaction: the packed word plane of every frame group's
    narrow sequences, kernel against plain form on the card, timed (event
    and device ms) beside the one PyTorch call that computes the same
    function, ``plane.t()[mask]`` with the mask built beforehand.  Device
    ms is the profiler's, per launch over 20 calls."""
    import torch

    from zstd_tpu_torch.kernels import compact, sequences
    from zstd_tpu_torch.kernels.bitbuf import to_i32
    from zstd_tpu_torch.kernels.entropy2 import _pack_words, _seq_word_plane
    from zstd_tpu_torch.observability import event_ms, profiled_kernels

    res, err = None, 0
    for g, x in enumerate(inputs):
        da, db, _ok = sequences.decode_sequences(*(up(a) for a in x["seq"]), rows=x["rows"])
        w_ll, w_ml, w_of = (up(x["seq_mat"][:, c]) for c in (4, 5, 6))
        lo, hi, _over = _pack_words(da, db, w_ll, w_ml, w_of)
        plane = to_i32(_seq_word_plane(lo, hi, w_ll, w_ml, w_of))
        cum_t = up(x["cumw"])
        n_w = int(x["cumw"][-1])
        kc = compact.compact_lanes(plane, cum_t, n_dense=n_w)
        pc, plain_ms = timed_once(lambda: compact.compact_plain(plane, cum_t, n_dense=n_w))
        mask = torch.arange(plane.shape[0], device=dev)[None, :] < (cum_t[1:] - cum_t[:-1])[:, None]
        library = lambda: plane.t()[mask]  # noqa: E731
        g_err = max_abs_err([(kc, pc)])
        err = max(err, g_err)
        check(max_abs_err([(library(), pc)]) == 0, f"group {g}: the library call differs from the plain form")
        b_ms, b_by = bound(8 * n_w + x["cumw"].nbytes, 0)
        run_compact = lambda: compact.compact_lanes(plane, cum_t, n_dense=n_w)  # noqa: E731
        # A launch takes a few microseconds, less than a CUDA graph replay
        # takes to submit, so device time comes from the profiler.
        ms, lib_ms = event_ms(run_compact, 20), event_ms(library, 20)
        dev_ms = sum(profiled_kernels(run_compact, "compact_kernel", 20, log)[0].values())
        lib_dev_ms = sum(profiled_kernels(library, "", 20, log)[0].values())
        rows, L = plane.shape
        log(f"compact group {g}: lanes={L} words={n_w} plane={(rows, L)} max_abs_err={g_err} "
            f"ms={ms:.4f} device_ms={dev_ms:.4f} library_ms={lib_ms:.4f} library_device_ms={lib_dev_ms:.4f} "
            f"plain_ms={plain_ms:.3f} "
            f"bound_ms={b_ms:.6f} ({b_by}) grid={(-(-L // 32), -(-rows // 128))}")
        if g == 0:
            res = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                       bound_by=b_by, device_ms_by_group=[])
        res["device_ms_by_group"].append(dev_ms)
    check(err == 0, "compaction kernel disagrees with its plain form")
    res["err"] = err
    return res


def counters(device_execute: bool = False):
    from zstd_tpu_torch.kernels import compact, literals, lz77, sequences

    fns = {
        "literals": literals.decode_literals,
        "sequences": sequences.decode_sequences,
        "compact": compact.compact_lanes,
    }
    if device_execute:
        fns["lz77"] = lz77.exec_ops
    return fns


def lz77_device_split(run) -> dict:
    """Device milliseconds of one LZ77 wrapper call by kernel (init,
    expand, jump, gather; ``torch.profiler``) and their sum, the number of
    CUDA launches the profiler saw, and each jump round's milliseconds."""
    from zstd_tpu_torch.observability import profiled_kernels

    split, launches, each = profiled_kernels(run, "lz77_", log=log)
    rounds = [round(ms, 4) for name, ms in each if name == "jump"]
    return {"profiler_ms": sum(split.values()), "by_kernel_ms": split, "profiler_launches": launches,
            "jump_round_ms": rounds}


def lz77_phase(comp: bytes, dev) -> dict:
    """Phase 8: the LZ77 copy-program kernel against its plain form, on
    the spike's program, on the first frame group's copy programs, on the
    adversarial programs and at positions just below 2^31; per call its
    CUDA launches, jump rounds and device time."""
    import torch

    from zstd_tpu_torch.format.block_table import build_batch_plan, input_words
    from zstd_tpu_torch.kernels import lz77
    from zstd_tpu_torch.observability import device_ms, event_ms
    from zstd_tpu_torch.runtime import engine
    from zstd_tpu_torch.testing.copy_program import adversarial_programs, batch_programs, place_high

    def run_once(ops, op_off, buf):
        """The kernel once on a copy of ``buf``: (result, CUDA launches,
        (rounds run, round budget, resolved))."""
        before = lz77.exec_ops.cuda_launches
        got = lz77.exec_ops(ops, op_off, buf.clone())
        return got, lz77.exec_ops.cuda_launches - before, lz77.last_rounds()

    def measure(name, ops, op_off, buf, out_bytes):
        got, cuda_launches, (rounds, budget, resolved) = run_once(ops, op_off, buf)
        check(resolved, f"lz77 {name}: map entries left open after {budget} rounds")
        plain, plain_ms = timed_once(lambda: lz77.exec_ops_plain(ops, op_off, buf))
        err = max_abs_err([(got, plain)])
        work = buf.clone()  # a program's ops rewrite the bytes they wrote: re-runs are exact
        # exec_ops checks its ops on the host (one synchronisation) before
        # the launches, so its event time includes that check; device_ms
        # replays a CUDA graph of the launches alone (lz77.launch).
        ms = event_ms(lambda: lz77.exec_ops(ops, op_off, work), 5)
        lo, hi = lz77._check(ops, op_off, work)
        dev_ms = device_ms(lambda: lz77.launch(ops, op_off, work, lo, hi), 10)
        prof = lz77_device_split(lambda: lz77.exec_ops(ops, op_off, work))
        check(torch.equal(work, plain), f"lz77 {name}: re-runs changed the result")
        copied = int(ops[2].sum())
        b_ms, b_by = bound(ops.numel() * 8 + op_off.numel() * 8 + 2 * copied, 0)
        log(f"lz77 {name}: programs={op_off.numel() - 1} ops={ops.shape[1]} copied_bytes={copied} "
            f"output_bytes={out_bytes} span={hi - lo} max_abs_err={err} cuda_launches={cuda_launches} "
            f"rounds={rounds} of {budget} ms={ms:.4f} device_ms={dev_ms:.4f} "
            f"profiler={json.dumps(prof)} plain_ms={plain_ms:.2f} bound_ms={b_ms:.6f} ({b_by}) "
            f"ns_per_output_byte={ms * 1e6 / out_bytes:.3f} device_ns_per_output_byte={dev_ms * 1e6 / out_bytes:.4f}")
        check(err == 0, f"lz77 kernel disagrees with its plain form ({name})")
        return got, dict(err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         cuda_launches=cuda_launches, rounds=rounds, round_budget=budget, **prof)

    ops, op_off, buf, outs = batch_programs([0], out_kb=96)
    (start, expect), = outs
    got, spike = measure("spike_96KiB", ops.to(dev), op_off.to(dev), buf.to(dev), len(expect))
    check(bytes(got[start : start + len(expect)].cpu().numpy()) == expect,
          "lz77 kernel misses the spike program's expected bytes")

    err = spike["err"]
    for name, (ops, op_off, buf) in adversarial_programs().items():
        ops, op_off, buf = ops.to(dev), op_off.to(dev), buf.to(dev)
        got, cuda_launches, (rounds, budget, resolved) = run_once(ops, op_off, buf)
        want = lz77.exec_ops_plain(ops, op_off, buf)
        e = max_abs_err([(got, want)])
        log(f"lz77 adversarial {name}: ops={ops.shape[1]} copied_bytes={int(ops[2].sum())} "
            f"max_abs_err={e} cuda_launches={cuda_launches} rounds={rounds} of {budget}")
        check(resolved, f"lz77 adversarial {name}: entries left open")
        err = max(err, e)
        if name == "offset_below_len":  # the same program at positions just below 2^31
            hops, big, base = place_high(ops, buf, (1 << 31) - 1)
            lz77.exec_ops(hops, op_off, big)
            e = max_abs_err([(big[base:], want)]) + int(bool(big[:base].any()))
            log(f"lz77 adversarial {name} at base {base} (buffer 2^31 - 1 bytes): max_abs_err={e}")
            err = max(err, e)
            del big
            torch.cuda.empty_cache()
    check(err == 0, "lz77 kernel disagrees with its plain form on an adversarial program")

    frames = next(engine.frame_groups(comp))
    plan = build_batch_plan(comp, words=input_words(comp), frames=frames)
    eng = engine.DeviceEngine(device_execute=True)
    (lo, lok), (so, sok) = eng._run_both(plan)
    t0 = time.perf_counter()
    gp, idx, errors = engine.group_program(plan, lo, lok, so, sok)
    build_ms = (time.perf_counter() - t0) * 1e3
    check(len(idx) == len(plan.frames) and not errors, f"copy program build failed: {errors}")
    out_bytes = sum(n for _s, n in gp.outs)
    up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    got, res = measure("first_group", up(gp.ops), up(gp.op_off), up(gp.buf), out_bytes)
    res["err"] = max(res["err"], err)  # the kernels line's max_abs_err: every comparison above
    res["host_program_build_ms"] = build_ms
    log(f"lz77 first_group: copy programs built on the host in {build_ms:.1f} ms "
        f"({gp.blob.nbytes} bytes to upload)")

    host = engine.DeviceEngine()  # the host route: one host.c call a frame group
    host_out = bytearray()
    t0 = time.perf_counter()
    host._assemble_group(plan, lo, lok, so, sok, out=host_out, verify_checksum=True, include_skippable=False)
    host_s = time.perf_counter() - t0
    flat = got.cpu().numpy()
    check(host.stats.fallback_frames == 0, f"host C executor fell back: {host.stats.fallback_reasons}")
    check(host_out == b"".join(flat[s : s + n].tobytes() for s, n in gp.outs),
          "host C executor disagrees with the lz77 kernel on the first group")
    res["host_c_ns_per_byte"] = host_s * 1e9 / out_bytes
    res["kernel_ns_per_byte"] = res["ms"] * 1e6 / out_bytes
    log(f"lz77 first_group: host C executor {host_s * 1e3:.2f} ms "
        f"({res['host_c_ns_per_byte']:.3f} ns/byte) vs kernel {res['kernel_ns_per_byte']:.3f} ns/byte "
        f"on {len(plan.frames)} frames, {out_bytes} output bytes")
    return res


def device_route_split(comp: bytes, dev) -> None:
    """Phase 9, before the route's own run: the device LZ77 route's
    assembly of each frame group of the level-3 corpus, step by step and
    timed from outside the engine (host clock, a synchronisation after
    each step): copy-program build, upload, LZ77 wrapper call, fetch,
    XXH64 of every frame."""
    import torch

    from zstd_tpu_torch.format.block_table import build_batch_plan, input_words
    from zstd_tpu_torch.kernels import lz77
    from zstd_tpu_torch.runtime import engine
    from zstd_tpu_torch.utils.xxh64 import xxh64

    eng = engine.DeviceEngine(device_execute=True)
    words = input_words(comp)
    for g, frames in enumerate(engine.frame_groups(comp)):
        plan = build_batch_plan(comp, words=words, frames=frames)
        (lo, lok), (so, sok) = eng._run_both(plan)
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        gp, idx, errors = engine.group_program(plan, lo, lok, so, sok)
        t.append(time.perf_counter())
        blob = torch.from_numpy(gp.blob).to(dev)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        ops, op_off, buf = gp.split(blob)
        lz77.exec_ops(ops, op_off, buf)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        (host,) = eng._to_host([buf])
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        flat = memoryview(host.numpy())
        for fp, (start, n) in zip([plan.frames[i] for i in idx], gp.outs):
            check(xxh64(flat[start : start + n]) & 0xFFFFFFFF == fp.frame.checksum, f"group {g}: checksum")
        t.append(time.perf_counter())
        check(len(idx) == len(plan.frames) and not errors, f"group {g}: copy program build failed: {errors}")
        steps = dict(zip(("program_build", "upload", "lz77_call", "fetch", "xxh64"),
                         ((b - a) * 1e3 for a, b in zip(t, t[1:]))))
        log("device route split: " + json.dumps({"group": g, "frames": len(idx), "blob_bytes": gp.blob.nbytes,
                                                  "ms": steps, "total_ms": (t[-1] - t[0]) * 1e3}))


def kernels_needed(comp: bytes, device_execute: bool = False) -> set:
    """The kernels the engine's plans of ``comp`` give work: literals where
    a literal lane has symbols, sequences and compaction where a sequence
    lane has sequences, LZ77 on the device route."""
    from zstd_tpu_torch.format.block_table import build_batch_plan, input_words
    from zstd_tpu_torch.runtime.engine import frame_groups

    words = input_words(comp)
    need = {"lz77"} if device_execute else set()
    for frames in frame_groups(comp):
        plan = build_batch_plan(comp, words=words, frames=frames)
        if (plan.lit_regen > 0).any():
            need.add("literals")
        if (plan.seq_nseq > 0).any():
            need |= {"sequences", "compact"}
    return need


def end_to_end(name: str, comp: bytes, raw: bytes, device_execute: bool = False, need=None) -> dict:
    """Phases 4-5, 9 and 14: a route once with counts from 0, then timed
    runs.  Every kernel of the route must launch, or with ``need`` (phase
    14, from ``kernels_needed``) every kernel named there."""
    import torch

    from zstd_tpu_torch import DeviceEngine
    from zstd_tpu_torch.kernels import lz77
    from zstd_tpu_torch.runtime.engine import frame_groups

    fns = counters(device_execute)
    for f in fns.values():
        f.launches = 0
    lz77.exec_ops.cuda_launches = 0
    eng = DeviceEngine(device_execute=device_execute)
    out = eng.decompress(comp)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in fns.items()}
    lz77_cuda_launches = lz77.exec_ops.cuda_launches
    stats = eng.stats.as_dict()
    check(out == raw, f"{name}: decode is not bit-exact")
    check(stats["fallback_frames"] == 0, stats["fallback_reasons"])
    need = set(fns) if need is None else need
    check(all(launches[k] > 0 for k in need), f"{name}: a kernel never launched: {launches}, needed {need}")
    groups = sum(1 for _ in frame_groups(comp))
    if device_execute:
        check(launches["lz77"] == groups, f"{name}: {launches['lz77']} lz77 launches, {groups} groups")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        eng.decompress(comp)
        times.append(time.perf_counter() - t0)
    wall = statistics.median(times)
    res = {
        "raw_bytes": len(raw), "compressed_bytes": len(comp), "wall_s": wall,
        "gbs": len(raw) / wall / 1e9, "launches": launches, "groups": groups,
        "lit_lanes": stats["lit_lanes"],
        "seq_lanes": stats["seq_lanes"], "retry_lanes": stats["retry_lanes"],
        "frames": stats["frames"], "wall_split_s": eng.stats.wall_s,
    }
    if device_execute:
        res["lz77_cuda_launches"] = lz77_cuda_launches
    log(f"{name}: " + json.dumps(res))
    return res


def retry_phase() -> dict:
    """Phase 6: the wide retry on the card.  One 128 000-byte block whose
    first sequence carries a 100 000-byte literal run (over the narrow
    16-bit field): its lane must fail the narrow pass and come back
    exact from the sequences kernel in wide mode."""
    import numpy as np
    import torch

    from zstd_tpu_torch import DeviceEngine
    from zstd_tpu_torch.testing import libzstd

    rng = np.random.default_rng(11)
    head = rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes()
    raw = head + head[:28_000]
    comp = libzstd.compress(raw, 3, checksum=True)
    fns = counters()
    for f in fns.values():
        f.launches = 0
    eng = DeviceEngine()
    out = eng.decompress(comp)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in fns.items()}
    res = {"retry_lanes": eng.stats.retry_lanes, "fallback_frames": eng.stats.fallback_frames,
           "launches": launches}
    log("wide_retry: " + json.dumps(res))
    check(out == raw, "wide retry decode is not bit-exact")
    check(eng.stats.retry_lanes == 1 and eng.stats.fallback_frames == 0, res)
    check(launches["sequences"] == 2, "the retry did not run the sequences kernel")
    return res


def profile_phase(comp: bytes, wall_s: float, kres: dict) -> dict:
    """Phase 7: device time by kernel over one main-path decode, from
    torch.profiler (CUPTI); the idle share is against the median wall.
    The lane kernels' mean time per launch must agree with the mean of
    phase 3's ``device_ms`` (CUDA-graph replays) over the frame groups."""
    import torch
    from torch.autograd import DeviceType

    from zstd_tpu_torch import DeviceEngine
    from zstd_tpu_torch.observability import device_ms_by_op, holds_kernels, idle_share, traced

    eng = DeviceEngine()
    eng.decompress(comp)
    keys = (("literals", "literals_kernel"), ("sequences", "sequences_kernel<false>"))
    walls = []

    def decode():
        t0 = time.perf_counter()
        eng.decompress(comp)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)

    prof = traced(decode, holds_kernels(*(key for _name, key in keys)), "lacks a lane kernel", log)
    prof_wall = walls[-1]
    dev_ms = device_ms_by_op(prof)
    busy = sum(dev_ms.values())
    top = dict(sorted(dev_ms.items(), key=lambda kv: -kv[1])[:10])
    res = {"device_busy_ms": busy, "profiled_wall_s": prof_wall, "wall_s": wall_s,
           "idle_share": idle_share(busy, wall_s), "top_device_ms": top}
    log("profile: " + json.dumps(res))
    for name, key in keys:
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and key in ev.key and ev.count]
        check(len(evs) == 1, f"profile: {len(evs)} device entries for {key}")
        per_launch = evs[0].self_device_time_total / 1e3 / evs[0].count
        graph = statistics.mean(kres[name]["device_ms_by_group"])
        log(f"profile: {name} {evs[0].count} launches, {per_launch:.4f} ms per launch; "
            f"phase 3 device_ms mean {graph:.4f} (ratio {graph / per_launch:.3f})")
        check(0.8 <= graph / per_launch <= 1.25, f"{name}: device_ms disagrees with the profiler")
    return res


def cli_phase(comp: bytes, raw: bytes) -> dict:
    """Phase 10: the port's CLI on the card, in a process of its own, with
    ``--device`` and without."""
    import torch

    work = REPO / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    src, dst = work / "level19.zst", work / "level19.out"
    src.write_bytes(comp)
    for flags in (["--device"], []):
        dst.unlink(missing_ok=True)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "zstd_tpu_torch.cli", *flags, "--report", str(src), "-o", str(dst)],
            cwd=REPO, capture_output=True, text=True, timeout=300,
        )
        wall = time.perf_counter() - t0
        check(res.returncode == 0, f"cli {flags} exited {res.returncode}: {res.stderr[-2000:]}")
        report = json.loads(res.stderr.strip().splitlines()[-1])
        log(f"cli {' '.join(flags) or '(no --device)'}: process_wall_s={wall:.2f} report={json.dumps(report)}")
        check(dst.read_bytes() == raw, f"cli {flags} output is not bit-exact")
        check(report["device"] == torch.cuda.get_device_name(0), f"cli report device {report['device']}")
        check(report["fallback_frames"] == 0, report)
    return report


def blocks_with_work(n_lanes: int, size: int) -> list[int]:
    """Per mesh position, 1 where its contiguous block of ceil(n / size)
    lanes (the engine's split) holds a lane."""
    step = -(-n_lanes // size)
    return [int(i * step < n_lanes) for i in range(size)]


def _one_plan_plain(comp: bytes) -> tuple:
    """Worker process: one plan of the whole input through the engine on
    the CPU, where every kernel wrapper runs its plain form, lane by lane
    (``testing.lanes.engine_lanes``)."""
    import torch

    from zstd_tpu_torch import DeviceEngine
    from zstd_tpu_torch.format.block_table import build_batch_plan, input_words
    from zstd_tpu_torch.testing.lanes import engine_lanes

    torch.set_num_threads(4)
    t0 = time.perf_counter()
    plan = build_batch_plan(comp, words=input_words(comp))
    return engine_lanes(DeviceEngine(device="cpu"), plan), time.perf_counter() - t0


def sharded_phase(comp: bytes, raw: bytes, meshes: dict, dev) -> dict:
    """Phase 11: one plan of the whole input (every frame group's lanes in
    one launch a lane list) through the single-device engine on the card,
    held lane by lane to the plain forms (the same engine on the CPU, in a
    worker process started first) and to ShardedEngine over each mesh;
    then each mesh end to end with counts from 0 and the wall, median of
    3, once the worker is done."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from zstd_tpu_torch import DeviceEngine
    from zstd_tpu_torch.format.block_table import build_batch_plan, input_words
    from zstd_tpu_torch.observability import profiled_kernels
    from zstd_tpu_torch.parallel.dist import ShardedEngine
    from zstd_tpu_torch.testing.lanes import engine_lanes, lane_diffs

    kinds = ("literals", "pre_retry_sequences", "sequences")
    pool = ProcessPoolExecutor(1, mp_context=multiprocessing.get_context("spawn"))
    try:
        plain_run = pool.submit(_one_plan_plain, comp)
        plan = build_batch_plan(comp, words=input_words(comp))
        want = engine_lanes(DeviceEngine(device=dev), plan)
        lists = {"literals": int((plan.lit_regen > 0).sum()), "sequences": int((plan.seq_nseq > 0).sum()),
                 "retry": int((~want[1][1]).sum())}
        engines, out = {}, {}
        for name, mesh in meshes.items():
            eng = engines[name] = ShardedEngine(mesh)
            got = engine_lanes(eng, plan)
            diffs = {k: lane_diffs(g, w) for k, g, w in zip(kinds, got, want)}
            check(not any(diffs.values()), f"sharded {name}: lanes differ from the single-device engine: {diffs}")
            blocks = {k: blocks_with_work(n, mesh.size) for k, n in lists.items()}
            expect = [sum(b[i] for b in blocks.values()) for i in range(mesh.size)]
            check(eng.stats.mesh_calls == expect, f"sharded {name}: launches by position {eng.stats.mesh_calls}, "
                                                  f"blocks with work {expect}")
            out[name] = {"devices": [str(d) for d in mesh.devices], "lane_diffs": diffs, "lanes": lists,
                         "blocks": blocks, "expect_mesh_calls": expect}
        t0 = time.perf_counter()
        plain, plain_s = plain_run.result()
        plain_diffs = {k: lane_diffs(w, p) for k, w, p in zip(kinds, want, plain)}
        log(f"one plan, {lists['literals']} literal and {lists['sequences']} sequence lanes a launch: "
            f"single-device engine on the card vs plain forms on the CPU: lanes that differ {json.dumps(plain_diffs)} "
            f"(plain run {plain_s:.1f} s in a worker process, waited {time.perf_counter() - t0:.1f} s)")
        check(not any(plain_diffs.values()), f"one-plan lanes on the card differ from the plain forms: {plain_diffs}")
    finally:
        pool.shutdown(cancel_futures=True)

    for name, eng in engines.items():
        res, blocks, expect = out[name], out[name].pop("blocks"), out[name].pop("expect_mesh_calls")
        fns = counters()
        for f in fns.values():
            f.launches = 0
        dec = eng.decompress(comp)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = {k: f.launches for k, f in fns.items()}
        stats = eng.stats.as_dict()
        check(dec == raw, f"sharded {name}: decode is not bit-exact")
        check(stats["fallback_frames"] == 0, stats["fallback_reasons"])
        check(stats["mesh_calls"] == expect, f"sharded {name}: decode launches by position {stats['mesh_calls']}")
        if dev.type == "cuda":
            want_launches = {"literals": sum(blocks["literals"]), "compact": sum(blocks["sequences"]),
                             "sequences": sum(blocks["sequences"]) + sum(blocks["retry"])}
            check(launches == want_launches, f"sharded {name}: wrapper launches {launches}, want {want_launches}")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            eng.decompress(comp)
            times.append(time.perf_counter() - t0)
        wall = statistics.median(times)
        res.update(mesh_calls=stats["mesh_calls"], launches=launches, wall_s=wall, walls_s=times,
                   gbs=len(raw) / wall / 1e9, wall_split_s=stats["wall_s"])
        if dev.type == "cuda":  # device time of one decode, by kernel (torch.profiler)
            split = profiled_kernels(lambda: eng.decompress(comp), "", log=log)[0]
            res["device_ms"] = {
                "busy": sum(split.values()),
                "sequences": sum(v for k, v in split.items() if "sequences_kernel" in k),
                "literals": sum(v for k, v in split.items() if "literals_kernel" in k),
                "compact": sum(v for k, v in split.items() if "compact_kernel" in k),
            }
        log(f"sharded {name}: " + json.dumps(res))
    return out


def multihost_phase(comp: bytes, raw: bytes) -> dict:
    """Phase 12: a two-process gloo job on one machine, each process with a
    MultihostEngine on its own card (the runner names no device, so each
    worker resolves it through ``multihost.rank_device``); every check is
    fatal."""
    import hashlib

    import torch

    from zstd_tpu_torch.testing import multihost_job

    work = REPO / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    src, expect = work / "level3.zst", work / "level3.raw"
    src.write_bytes(comp)
    expect.write_bytes(raw)
    t0 = time.perf_counter()
    results = multihost_job.run_job(src, expect, nproc=2, timeout=300, reps=4)
    job_s = time.perf_counter() - t0
    sha = hashlib.sha256(raw).hexdigest()
    for r in results:
        rank = r["rank"]
        own = f"cuda:{rank % torch.cuda.device_count()}"
        check(r["device"] == own, f"multihost process {rank} ran on {r['device']}, not {own}")
        check(r["exact"] and r["all_reps_equal"] and r["sha256"] == sha,
              f"multihost process {rank}: output is not bit-exact")
        check(r["kernel_calls"] > 0 and r["fallback_frames"] == 0, f"multihost process {rank}: {r}")
        check(all(v > 0 for v in r["launches"].values()), f"multihost process {rank}: {r['launches']}")
        for phase, ran in (("literals", r["lit_lanes_run"]), ("sequences", r["seq_lanes_run"])):
            b = r["bins"][phase]
            check(ran == b["lanes_with_work"][rank], f"multihost process {rank}: {ran} {phase} lanes "
                                                     f"launched, its bin has {b['lanes_with_work'][rank]}")
            check(max(b["work"]) <= 1.25 * statistics.mean(b["work"]), f"multihost {phase} bins {b['work']}")
        log(f"multihost process {rank}: " + json.dumps({
            "device": r["device"], "wall_s": r["wall_s"], "cold_wall_s": r["cold_wall_s"],
            "walls_s": r["walls_s"], "exchange": r["exchange"],
            "bins": {k: {f: v[f][rank] for f in v} for k, v in r["bins"].items()},
            "lanes_run": {"literals": r["lit_lanes_run"], "sequences": r["seq_lanes_run"]},
            "launches": r["launches"], "kernel_calls": r["kernel_calls"], "retry_lanes": r["retry_lanes"]}))
    res = {"job_s": job_s, "walls_s": [r["wall_s"] for r in results], "cold_walls_s": [r["cold_wall_s"] for r in results],
           "exchange": [r["exchange"] for r in results], "bins": results[0]["bins"]}
    log("multihost: " + json.dumps(res))
    return res


def measure_phase(comp: bytes, raw: bytes, dev) -> dict:
    """Phase 13: one decode with measure_phases, bit-exact, and its split."""
    from zstd_tpu_torch import DeviceEngine

    eng = DeviceEngine(device=dev)
    eng.measure_phases = True
    out = eng.decompress(comp)
    check(out == raw, "measure_phases decode is not bit-exact")
    check(eng.stats.fallback_frames == 0, eng.stats.fallback_reasons)
    wall = eng.stats.wall_s
    res = {k: wall[k] for k in ("dispatch", "upload_wait", "device_compute", "fetch", "prepass", "assembly", "total")}
    # What the four phases and prepass and assembly leave: the host finish
    # (unpacking every lane) and the wide retry.
    res["rest"] = res["total"] - sum(res[k] for k in res if k != "total")
    log("phase split (measure_phases): " + json.dumps(res))
    return res


def _encode_frame(raw: bytes, level: int) -> tuple[bytes, float, int]:
    """Worker process: the port's ``compress`` of one frame with its
    seconds on one host thread, and libzstd's frame size at that level."""
    from zstd_tpu_torch import compress
    from zstd_tpu_torch.testing import libzstd

    t0 = time.perf_counter()
    comp = compress(raw, level, checksum=True)
    return comp, time.perf_counter() - t0, len(libzstd.compress(raw, level, checksum=True))


def hold_lanes(name: str, comp: bytes, plain_run, dev) -> dict:
    """One plan of ``comp`` through the engine on the card, lane by lane
    against the plain forms' run on the same plan (a future of
    ``_one_plan_plain``), tolerance 0: the count of differing lanes."""
    from zstd_tpu_torch import DeviceEngine
    from zstd_tpu_torch.format.block_table import build_batch_plan, input_words
    from zstd_tpu_torch.testing.lanes import engine_lanes, lane_diffs

    plan = build_batch_plan(comp, words=input_words(comp))
    got = engine_lanes(DeviceEngine(device=dev), plan)
    plain, plain_s = plain_run.result()
    diffs = {k: lane_diffs(g, w) for k, g, w in zip(("literals", "pre_retry_sequences", "sequences"), got, plain)}
    res = {"lit_lanes": plan.n_lit_lanes, "seq_lanes": plan.n_seq_lanes, "lanes_not_ok_on_card": {
        "literals": int((~got[0][1]).sum()), "sequences": int((~got[2][1]).sum())}, "differing_lanes": diffs,
        "plain_s": plain_s}
    log(f"lanes {name}, card vs plain forms: " + json.dumps(res))
    check(not any(diffs.values()), f"{name}: the card's lanes differ from the plain forms': {diffs}")
    return res


def encoder_phase(raw: bytes, dev) -> dict:
    """Phase 14: the port's encoder at levels 1, 3 and 19, two 4 MiB frames
    each (encoded in worker processes); libzstd decodes them; the engine
    decodes them on both routes with counts from 0; the level-19 input
    (one frame group) lane by lane against the plain forms."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from zstd_tpu_torch.testing import libzstd

    levels, chunk = (1, 3, 19), 4 << 20
    out = {}
    pool = ProcessPoolExecutor(6, mp_context=multiprocessing.get_context("spawn"))
    try:
        t0 = time.perf_counter()
        jobs = {(lv, i): pool.submit(_encode_frame, raw[i : i + chunk], lv)
                for lv in levels for i in range(0, len(raw), chunk)}
        comps = {}
        for lv in levels:
            parts = [jobs[lv, i].result() for i in range(0, len(raw), chunk)]
            comp = comps[lv] = b"".join(p[0] for p in parts)
            enc_s, lib_bytes = sum(p[1] for p in parts), sum(p[2] for p in parts)
            check(libzstd.decompress(comp) == raw, f"libzstd does not decode the port's level-{lv} frames")
            out[lv] = {"raw_bytes": len(raw), "frames": len(parts), "compressed_bytes": len(comp),
                       "libzstd_bytes": lib_bytes, "encode_vs_libzstd": len(comp) / lib_bytes,
                       "encode_s": enc_s, "encode_mbs": len(raw) / enc_s / 1e6}
            log(f"encoder level {lv}: " + json.dumps(out[lv]))
        log(f"encoder: {len(jobs)} frames encoded in {time.perf_counter() - t0:.1f} s in worker processes")
        plain_run = pool.submit(_one_plan_plain, comps[19])
        for lv in levels:
            for route, device_execute in (("default", False), ("device_lz77", True)):
                need = kernels_needed(comps[lv], device_execute)
                # Level-1 frames may hold raw literals only; levels 3 and
                # 19 give every lane kernel work.
                check(lv == 1 or {"literals", "sequences", "compact"} <= need,
                      f"level-{lv} frames need only {need}")
                r = end_to_end(f"encoder_level{lv}_8MiB_{route}", comps[lv], raw, device_execute, need)
                out[lv][f"{route}_wall_s"] = r["wall_s"]
                out[lv][f"{route}_launches"] = r["launches"]
        out["lanes_level19"] = hold_lanes("encoder_level19", comps[19], plain_run, dev)
    finally:
        pool.shutdown(cancel_futures=True)
    return out


def corrupt_phase(raw: bytes, dev) -> dict:
    """Phase 15: seeded bit flips and truncations of a level-3 libzstd frame
    and a level-19 port-made frame, 256 KiB each, through the engine on
    both routes, held to the oracle; four flipped inputs whose prepass
    succeeds lane by lane against the plain forms; then the fuzz harness
    on the card."""
    import logging
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from zstd_tpu_torch import DeviceEngine, compress
    from zstd_tpu_torch.format.block_table import build_batch_plan
    from zstd_tpu_torch.testing import fuzz, libzstd
    from zstd_tpu_torch.utils.errors import ZstdError

    size = 256 << 10
    bases = {
        "libzstd_level3": libzstd.compress(raw[:size], 3, checksum=True),
        "port_level19": compress(raw[4 << 20 : (4 << 20) + size], 19, checksum=True),
    }
    inputs = [(name, i, data) for seed, (name, frame) in enumerate(bases.items())
              for i, data in enumerate(fuzz.corrupt_frames(frame, seed))]
    # Four flipped inputs whose prepass succeeds, two a frame, for the lanes.
    picked = []
    for name, i, data in inputs:
        if i >= 64 or sum(p[0] == name for p in picked) == 2:
            continue
        try:
            plan = build_batch_plan(data)
        except ZstdError:
            continue
        if plan.n_lit_lanes and plan.n_seq_lanes:
            picked.append((name, i, data))
    check(len(picked) == 4, f"only {len(picked)} flipped inputs pass the prepass")
    # Each corrupt input makes the engine log a fallback warning: keep
    # them off the output (the counts below say what happened).
    engine_log = logging.getLogger("zstd_tpu_torch.runtime.engine")
    level = engine_log.level
    engine_log.setLevel(logging.ERROR)
    pool = ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn"))
    try:
        plain_runs = [pool.submit(_one_plan_plain, data) for _n, _i, data in picked]
        engines = {"default": DeviceEngine(device=dev), "device_lz77": DeviceEngine(device=dev, device_execute=True)}
        counts = {route: fuzz.FuzzCounts(iterations=len(inputs)) for route in engines}
        # Launches by route, and the inputs that reached at least one
        # kernel (the rest the host prepass rejected first).
        fns = counters(device_execute=True)
        for f in fns.values():
            f.launches = 0
        launched = {route: dict.fromkeys(fns, 0) for route in engines}
        reached = dict.fromkeys(engines, 0)
        failures = []
        t0 = time.perf_counter()
        for name, i, data in inputs:
            want = fuzz.oracle(data)
            for route, eng in engines.items():
                before = {k: f.launches for k, f in fns.items()}
                try:
                    fuzz.hold_to_oracle(eng, data, want, counts[route])
                except Exception as e:  # noqa: BLE001 — every failure is listed, then fatal
                    failures.append(f"{name} input {i} ({route}): {type(e).__name__}: {e}")
                    counts[route].failures += 1
                    torch.cuda.synchronize()  # a CUDA fault stops the run here
                delta = {k: f.launches - before[k] for k, f in fns.items()}
                for k, n in delta.items():
                    launched[route][k] += n
                reached[route] += any(delta.values())
        held_s = time.perf_counter() - t0
        lanes = [hold_lanes(f"{name} flipped input {i}", data, run, dev)
                 for (name, i, data), run in zip(picked, plain_runs)]
    finally:
        pool.shutdown(cancel_futures=True)
        engine_log.setLevel(level)
    res = {"inputs": len(inputs), "frames": {k: len(v) for k, v in bases.items()}, "held_s": held_s,
           "by_route": {r: {"equal_bytes": c.engine_equal, "typed_errors": c.engine_typed_errors,
                            "failures": c.failures, "launches": launched[r],
                            "inputs_reaching_a_kernel": reached[r]} for r, c in counts.items()},
           "lanes_compared": sum(x["lit_lanes"] + x["seq_lanes"] for x in lanes),
           "lanes_differing": sum(sum(x["differing_lanes"].values()) for x in lanes)}
    log("corrupt input on the card: " + json.dumps(res))
    for line in failures:
        log(f"corrupt input FAILURE: {line}")
    check(not failures, f"{len(failures)} corrupt inputs broke the oracle contract on the card")
    check(all(reached.values()), f"no corrupt input reached a kernel on some route: {reached}")

    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "zstd_tpu_torch.testing.fuzz", "--engine", "--device", str(dev),
         "--iterations", "100", "--seed", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    lines = run.stdout.strip().splitlines()
    res["fuzz"] = {"rc": run.returncode, "s": time.perf_counter() - t0, "summary": lines[-1] if lines else ""}
    log("fuzz harness on the card: " + json.dumps(res["fuzz"]))
    check(run.returncode == 0, f"fuzz harness failed:\n{run.stdout[-3000:]}{run.stderr[-3000:]}")
    return res


def _module_line(module: str, timeout: float) -> dict:
    """The one stdout line of ``python -m module`` run from the checkout,
    which must exit 0; its stderr is logged."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", module], cwd=REPO, capture_output=True,
                         text=True, timeout=timeout)
    for ln in res.stderr.splitlines()[-40:]:
        log(f"  {module}: {ln}")
    check(res.returncode == 0, f"{module} exited {res.returncode}")
    lines = [ln for ln in res.stdout.splitlines() if ln.strip()]
    check(len(lines) == 1, f"{module} printed {len(lines)} lines, not one JSON line: {lines[-3:]}")
    log(f"{module} ({time.perf_counter() - t0:.1f} s): {lines[0]}")
    return json.loads(lines[0])


def bench_phase(card: str, main_gbs: float) -> dict:
    """Phase 16: the port bench and the scaling bench on the card."""
    import torch

    line = _module_line("zstd_tpu_torch.bench", 600)
    d = line["detail"]
    fallbacks = [d["fallback_frames"], d["device_route"]["fallback_frames"],
                 d["highlevel_mix"]["fallback_frames"]]
    check(fallbacks == [0, 0, 0], f"bench: oracle fallbacks (main, device route, level 19): {fallbacks}")
    name, power = card.rsplit(", ", 1)
    check(d["device"]["name"] == torch.cuda.get_device_name(0) and d["device"]["power_limit"] == power,
          f"bench: device {d['device']}, card {card}")
    check(d["idle_share"] is not None and 0 <= d["idle_share"] <= 1, f"bench: idle share {d['idle_share']}")
    bars = [d["transfers"]["h2d_pinned_GBs"], d["transfers"]["d2h_pinned_GBs"], d["libzstd_serial_gbs"],
            d["vs_libzstd_serial"], d["libzstd_reused_gbs"]]
    check(None not in bars, f"bench: a pinned probe or the libzstd bar is null: {bars}")
    log(f"bench median GB/s {line['value']:.4f} (best {d['best_gbs']:.4f}, worst {d['worst_gbs']:.4f}); "
        f"phase 4 median {main_gbs:.4f}; device LZ77 route {d['device_route']['gbs']:.4f}; "
        f"libzstd one thread {d['libzstd_serial_gbs']:.4f}, into a reused buffer {d['libzstd_reused_gbs']:.4f}")
    scaling = _module_line("zstd_tpu_torch.testing.scaling_bench", 600)
    return {"bench": line, "scaling": scaling}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (REPO / "zstd_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import ctypes.util

    from zstd_tpu_torch import native
    from zstd_tpu_torch.kernels import _build
    from zstd_tpu_torch.observability import card_line, profiler_warm_up
    from zstd_tpu_torch.testing import libzstd
    from zstd_tpu_torch.testing.corpus import build_corpus, compress_chunks

    card = card_line()
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    log(f"SM clock (now, max): {clocks.stdout.strip().splitlines()[0]}")
    log(f"kernel build: {_build.build_all():.1f} s (nvcc, sm_90a)")
    native.require()  # the host C routines, or their compiler's message
    profiler_warm_up(log)

    log(f"libzstd: {ctypes.util.find_library('zstd')}")
    t0 = time.perf_counter()
    raw = build_corpus()
    comp = compress_chunks(raw, 3)
    hl_raw = raw[: 8 << 20]
    hl_comp = libzstd.compress(hl_raw, 19, checksum=True)
    log(f"corpus: {len(raw)} B -> {len(comp)} B (level 3), {len(hl_raw)} B -> "
        f"{len(hl_comp)} B (level 19) in {time.perf_counter() - t0:.1f} s")

    kres = kernel_phase(comp, torch.device("cuda", 0))
    main = end_to_end("level3_24MB", comp, raw)
    hl = end_to_end("level19_8MiB", hl_comp, hl_raw)
    retry_phase()
    profile_phase(comp, main["wall_s"], kres)

    kres["lz77"] = lz77_phase(comp, torch.device("cuda", 0))
    device_route_split(comp, torch.device("cuda", 0))
    dev_main = end_to_end("device_lz77_level3_24MB", comp, raw, device_execute=True)
    dev_hl = end_to_end("device_lz77_level19_8MiB", hl_comp, hl_raw, device_execute=True)
    log(f"device LZ77 route vs default route, GB/s: level3_24MB {dev_main['gbs']:.4f} vs "
        f"{main['gbs']:.4f}; level19_8MiB {dev_hl['gbs']:.4f} vs {hl['gbs']:.4f}")
    cli_phase(hl_comp, hl_raw)

    from zstd_tpu_torch.parallel.mesh import make_mesh

    if torch.cuda.device_count() == 1:
        log("one CUDA card here: a mesh over real cards and launches on a second card are not run "
            "(make_mesh() spans the one card)")
    dev = torch.device("cuda", 0)
    sharded = sharded_phase(comp, raw, {"all_cards": make_mesh(), "cuda0_x2": make_mesh(2, device="cuda:0")}, dev)
    mh = multihost_phase(comp, raw)
    measure_phase(comp, raw, dev)
    encoder_phase(hl_raw, dev)
    corrupt_phase(raw, dev)
    bench_phase(card, main["gbs"])
    log("level3_24MB walls, s (medians; the default route from phase 4): default route "
        f"{main['wall_s']:.4f}, one-plan route (all_cards) {sharded['all_cards']['wall_s']:.4f}, "
        f"cuda0_x2 {sharded['cuda0_x2']['wall_s']:.4f}, multihost per process "
        + ", ".join(f"{w:.4f}" for w in mh["walls_s"]))

    source = {
        "literals": ("zstd_tpu_torch/csrc/literals.cu", "zstd_tpu/kernels/pallas_lit.py:63"),
        "sequences": ("zstd_tpu_torch/csrc/sequences.cu", "zstd_tpu/kernels/pallas_seq.py:108"),
        "compact": ("zstd_tpu_torch/csrc/compact.cu", "zstd_tpu/kernels/compact_dma.py:37"),
        "lz77": ("zstd_tpu_torch/csrc/lz77.cu", "tools/lz77_pallas_spike.py:46"),
    }
    # Launches on the main path; lz77's on the device LZ77 route.
    launches = {**main["launches"], "lz77": dev_main["launches"]["lz77"]}
    kernels = [
        {
            "name": name, "route": "cuda", "source": source[name][0],
            "replaces": source[name][1], "launches": launches[name],
            "max_abs_err": r["err"], "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r.get("library_ms"),
        }
        for name, r in kres.items()
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
