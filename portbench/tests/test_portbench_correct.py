"""The comparison that decides ``correct``, through the whole harness on
the CPU (the kernels' plain forms) at a small size: the sound program
comes out correct; the control (the program with its own oracle
fallback switched on) and the faults a decode can have come out not
correct."""

import pytest

from portbench import control, inputs, run, spec
from portbench.reference import compare

from .conftest import tiny, tiny_corpus

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def test_wrong_bytes_counts_every_difference():
    raw = bytes(range(256)) * 4
    assert compare.wrong_bytes(raw, raw) == 0
    flipped = bytearray(raw)
    flipped[100] ^= 0x10
    assert compare.wrong_bytes(bytes(flipped), raw) == 1
    assert compare.wrong_bytes(raw[:1000], raw) == 24
    assert compare.wrong_bytes(raw + b"x", raw) == 1
    assert compare.passed(compare.checks({"wrong_bytes": 0, "fallback_frames": 0}))
    assert not compare.passed(compare.checks({"wrong_bytes": 0, "fallback_frames": 1}))


def _broken(fault):
    """The program with ``fault`` planted where its output is produced."""

    def make(device, options):
        eng = control.ENGINES["sound"](device, options)
        call, last = eng.decompress_with_stats, []

        def decompress_with_stats(data, **kw):
            out = call(data, **kw)
            if fault == "flipped_byte":
                out = bytearray(out)
                out[len(out) // 2] ^= 0x01
                out = bytes(out)
            elif fault == "half_the_batch":
                out = out[: len(out) // 2]
            elif fault == "stale_answer":  # the call's answer left as the one before
                out, last[:] = (last[0] if last else out), [out]
            return out

        eng.decompress_with_stats = decompress_with_stats
        return eng

    return make


def _run(cell, make_engine, seed=2**31 + 21):
    return run.execute(cell, seed, 0.001, False, device="cpu", t_start=0.0,
                       make_engine=make_engine, corpus=tiny_corpus(cell, seed), log=lambda m: None)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_program_is_correct(workload):
    res = _run(tiny(workload), None)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(compare.LIMITS)


@pytest.mark.parametrize("fault", ["flipped_byte", "half_the_batch", "stale_answer"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_fault_in_the_timed_path_is_not_correct(workload, fault):
    res = _run(tiny(workload), _broken(fault))
    assert not res["correct"] and res["failed"] >= 1
    assert res["checks"]["wrong_bytes"]["value"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_fallback_frame_is_not_correct(workload):
    """One frame a request served by the host oracle: right bytes, yet not
    correct."""
    res = _run(tiny(workload), control.fallback_engine)
    assert not res["correct"] and res["failed"] == res["attempted"]
    assert res["checks"]["wrong_bytes"]["value"] == 0
    assert res["checks"]["fallback_frames"]["value"] == res["attempted"]


def test_control_readings_over_seeds(monkeypatch):
    """``control.readings`` and ``summary``, as the chip run uses them:
    the sound runs read 0 on every number, the control reads above 0 on
    the number it breaks."""
    cell = tiny(CELLS[0])
    small = tiny_corpus(cell, 0).raw
    monkeypatch.setattr(inputs, "content", lambda name: b"".join(small))
    recs = control.readings(cell, [1, 2**31 + 2], 0.001, control.MODES, "cpu", lambda m: None)
    by = control.summary(recs)
    assert by["sound"]["runs"] == by["sound"]["correct_runs"] == 2
    assert set(by["sound"]["checks"].values()) == {0}
    assert by["fallback"]["correct_runs"] == 0 and by["fallback"]["checks"]["fallback_frames"] >= 1

