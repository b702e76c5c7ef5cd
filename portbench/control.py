"""The controls of the comparison that decides ``correct``: the program
with one of its own paths switched on that breaks a guarantee the
configuration states, run through the whole harness.  Each has to come
out not correct; the sound program, on the same seeds, correct.

    python -m portbench.control --workload <cell> --seeds S [S ...] --seconds S
        [--modes sound fallback]

* ``fallback``: the host oracle fallback switched on for the first frame
  of every request (the frame's plan flagged, as the prepass flags a
  frame the kernels cannot take): right bytes, but a frame the kernels
  did not decode.  Breaks "every frame is decoded by the kernels".

One JSON line a run on standard output, then the readings by mode: the
largest of each number over the sound runs and the smallest over each
control's runs.  The benchmark's own runs never run this; the tests in
``tests/`` run it at a small size on the CPU.
"""

from __future__ import annotations

import contextlib
import sys

from . import run

MODES = ("sound", "fallback")


def fallback_engine(device, options):
    """The program with its host oracle fallback switched on for the first
    frame of each call."""
    eng = run.default_engine(device, options)
    mod = sys.modules[type(eng).__module__]
    plan_fn, call = mod.build_batch_plan, eng.decompress_with_stats
    marked = [False]

    def flagging_plan(*a, **kw):
        plan = plan_fn(*a, **kw)
        if not marked[0] and plan.frames:
            plan.frames[0].fallback = True
            marked[0] = True
        return plan

    def decompress_with_stats(data, **kw):
        marked[0] = False
        mod.build_batch_plan = flagging_plan
        try:
            return call(data, **kw)
        finally:
            mod.build_batch_plan = plan_fn

    eng.decompress_with_stats = decompress_with_stats
    return eng


ENGINES = {"sound": run.default_engine, "fallback": fallback_engine}


def readings(cell, seeds, seconds: float, modes, device, log) -> list[dict]:
    """One record a (seed, mode): the result's ``correct`` and checks."""
    import time

    from . import inputs

    out = []
    for seed in seeds:
        corpus = inputs.make_corpus(cell, seed)
        for mode in modes:
            t0 = time.clock_gettime(time.CLOCK_BOOTTIME)
            res = run.execute(cell, seed, seconds, False, device=device, t_start=t0,
                              make_engine=ENGINES[mode], corpus=corpus, log=log)
            out.append({"seed": seed, "mode": mode, "correct": res["correct"],
                        "attempted": res["attempted"], "failed": res["failed"],
                        "checks": {k: c["value"] for k, c in res["checks"].items()}})
    return out


def summary(records: list[dict]) -> dict:
    """By mode: runs, correct runs, and for each number the largest
    reading over the sound runs (the lower reading of its limit) or the
    smallest over a control's runs (its upper reading)."""
    by: dict = {}
    for r in records:
        m = by.setdefault(r["mode"], {"runs": 0, "correct_runs": 0, "checks": {}})
        m["runs"] += 1
        m["correct_runs"] += int(r["correct"])
        pick = max if r["mode"] == "sound" else min
        for k, v in r["checks"].items():
            m["checks"][k] = pick(m["checks"].get(k, v), v)
    return by


def main(argv=None) -> int:
    import argparse
    import json
    import os

    from . import spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--modes", nargs="+", choices=MODES, default=list(MODES))
    args = ap.parse_args(argv)
    for k, v in run.CACHE_DIRS.items():
        os.environ[k] = v
    cell = spec.load(args.workload)
    with contextlib.redirect_stdout(sys.stderr):
        records = readings(cell, args.seeds, args.seconds, args.modes, "cuda:0", run.log)
    for r in records:
        print(json.dumps(r))
    print(json.dumps({"workload": args.workload, "readings": summary(records)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
