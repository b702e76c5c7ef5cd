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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


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
    from zstd_tpu_torch.observability import event_ms

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
        dev_ms = sum(profiled_kernels(run_compact, "compact_kernel", 20)[0].values())
        lib_dev_ms = sum(profiled_kernels(library, "", 20)[0].values())
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


def profiled_kernels(run, key: str, reps: int = 1) -> tuple[dict, int, list]:
    """Device milliseconds per call of ``run`` by CUDA kernel whose name
    holds ``key`` (the name's part after ``key``; every device event for
    an empty key), over ``reps`` calls, the launches per call, and each
    launch's milliseconds in order, from ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    name = lambda k: k.split(key, 1)[1].split("(", 1)[0] if key else k  # noqa: E731
    split, launches = {}, 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and key in ev.key:
            split[name(ev.key)] = ev.self_device_time_total / 1e3 / reps
            launches += ev.count
    check(split, f"profile: no {key} kernel on the device")
    each = sorted((ev.time_range.start, name(ev.key), ev.time_range.elapsed_us() / 1e3)
                  for ev in prof.events() if ev.device_type == DeviceType.CUDA and key in ev.key)
    return split, launches // reps, [(n, ms) for _t, n, ms in each]


def lz77_device_split(run) -> dict:
    """Device milliseconds of one LZ77 wrapper call by kernel (init,
    expand, jump, gather; ``torch.profiler``) and their sum, the number of
    CUDA launches the profiler saw, and each jump round's milliseconds."""
    split, launches, each = profiled_kernels(run, "lz77_")
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
    _, res = measure("first_group", up(gp.ops), up(gp.op_off), up(gp.buf), out_bytes)
    res["err"] = max(res["err"], err)  # the kernels line's max_abs_err: every comparison above
    res["host_program_build_ms"] = build_ms
    log(f"lz77 first_group: copy programs built on the host in {build_ms:.1f} ms "
        f"({gp.blob.nbytes} bytes to upload)")

    t0 = time.perf_counter()
    for fp in plan.frames:
        eng._assemble_frame(fp, lo, so)
    host_s = time.perf_counter() - t0
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


def end_to_end(name: str, comp: bytes, raw: bytes, device_execute: bool = False) -> dict:
    """Phases 4-5 and 9: a route once with counts from 0, then timed runs."""
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
    check(all(v > 0 for v in launches.values()), f"{name}: a kernel never launched: {launches}")
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
    from torch.profiler import ProfilerActivity, profile

    from zstd_tpu_torch import DeviceEngine

    eng = DeviceEngine()
    eng.decompress(comp)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.decompress(comp)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    # Device-side events only (kernels, copies): a host op's entry also
    # carries the device time of what it launched.
    dev_ms = {
        ev.key: ev.self_device_time_total / 1e3
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
    }
    busy = sum(dev_ms.values())
    top = dict(sorted(dev_ms.items(), key=lambda kv: -kv[1])[:10])
    res = {"device_busy_ms": busy, "profiled_wall_s": prof_wall, "wall_s": wall_s,
           "idle_share": (1 - busy / 1e3 / wall_s) if busy else None, "top_device_ms": top}
    log("profile: " + json.dumps(res))
    for name, key in (("literals", "literals_kernel"), ("sequences", "sequences_kernel<false>")):
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
    check(native.available(), "host C routines failed to build")

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
