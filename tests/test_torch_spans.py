"""The engine's step spans (``observability.span``) on the CPU engine:
every step of a decode call is timed into ``EngineStats.wall_s`` on each
route, the old totals keep their meaning, and the steps show in a
``torch.profiler`` trace only while a profiler records."""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_inputs import level3_small, overflow_match
from zstd_tpu_torch import observability
from zstd_tpu_torch.parallel.multihost import MultihostEngine
from zstd_tpu_torch.runtime import engine as t_engine
from zstd_tpu_torch.runtime.engine import STEPS, DeviceEngine, EngineStats
from zstd_tpu_torch.utils.errors import ImpossibleValue

KERNEL_STEPS = ("words", "launch", "wait", "unpack", "retry")  # inside wall_s["kernels"]
PHASE_KEYS = ("dispatch", "upload_wait", "device_compute", "fetch")  # measure_phases'


def _input() -> tuple[bytes, bytes]:
    """Three level-3 frames and one whose sequence lane goes to the wide
    retry: four frame groups at ``GROUP_BYTES`` = 1."""
    (a, pa), (b, pb) = level3_small(), overflow_match()
    return a + b, pa + pb


def _engine(route: str) -> DeviceEngine:
    eng = MultihostEngine(device="cpu") if route == "multihost" else DeviceEngine(device="cpu")
    eng.measure_phases = route == "measure_phases"
    return eng


@pytest.mark.parametrize("route", ["pipelined", "measure_phases", "multihost"])
def test_every_step_timed(monkeypatch, route):
    monkeypatch.setattr(t_engine, "GROUP_BYTES", 1)
    data, payload = _input()
    eng = _engine(route)
    assert eng.decompress(data) == payload
    assert eng.stats.fallback_frames == 0 and eng.stats.retry_lanes == 1
    w = eng.stats.wall_s
    for key in (*STEPS, "prepass", "kernels", "assembly", "total"):
        assert w[key] >= 0, key
    assert w["prepass"] == pytest.approx(w["parse"] + w["plan"], abs=1e-9)
    assert w["kernels"] == pytest.approx(w["total"] - w["prepass"] - w["assembly"], abs=1e-9)
    assert sum(w[k] for k in KERNEL_STEPS) <= w["kernels"]
    assert w["retry"] > 0
    # The one-plan routes plan without a separate parse; the pipeline parses.
    assert (w["parse"] > 0) == (route == "pipelined")
    assert set(STEPS).isdisjoint(PHASE_KEYS)
    assert set(PHASE_KEYS) & set(w) == (set(PHASE_KEYS) if route == "measure_phases" else set())


def test_replan_keeps_the_one_plan_prepass_and_assembly(monkeypatch):
    """A pipelined pass that fails and is replanned: prepass and assembly
    are the one-plan route's alone, the failed pass lies in kernels."""
    monkeypatch.setattr(t_engine, "GROUP_BYTES", 1)
    data, payload = _input()
    eng = DeviceEngine(device="cpu")
    assemble, calls = eng._assemble_group, []

    def fail_second(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise ImpossibleValue("injected")
        return assemble(*a, **kw)

    eng._assemble_group = fail_second
    assert eng.decompress(data) == payload
    assert eng.stats.fallback_reasons == ["pipelined: ImpossibleValue('injected')"]
    w = eng.stats.wall_s
    assert w["parse"] == 0 and w["prepass"] == w["plan"] > 0
    assert w["kernels"] == pytest.approx(w["total"] - w["prepass"] - w["assembly"], abs=1e-9)
    assert sum(w[k] for k in KERNEL_STEPS) <= w["kernels"]


ASSEMBLY_COUNTERS = (
    "frames", "blocks", "fallback_frames", "lit_lanes", "seq_lanes", "multiblock_frames",
    "far_match_bytes", "exact_tail_sequences",
)


def test_replan_counts_assembly_once(monkeypatch):
    """After a pipelined pass that fails in its second group's assembly,
    the counters assembly adds equal a clean one-plan call's on the same
    input; the counters of device work still count the failed attempt."""
    monkeypatch.setattr(t_engine, "GROUP_BYTES", 1)
    data, payload = _input()
    clean = _engine("measure_phases")
    assert clean.decompress(data) == payload
    eng = DeviceEngine(device="cpu")
    assemble, calls = eng._assemble_group, []

    def fail_second(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise ImpossibleValue("injected")
        return assemble(*a, **kw)

    eng._assemble_group = fail_second
    assert eng.decompress(data) == payload
    assert set(EngineStats.PASS_COUNTERS) == set(ASSEMBLY_COUNTERS)
    got, want = eng.stats.as_dict(), clean.stats.as_dict()
    assert want["frames"] == 4 and want["blocks"] > 0
    assert {k: got[k] for k in ASSEMBLY_COUNTERS} == {k: want[k] for k in ASSEMBLY_COUNTERS}
    for k in ("kernel_calls", "lit_lanes_run", "seq_lanes_run", "upload_bytes", "fetch_bytes"):
        assert got[k] > want[k], k
    assert got["mesh_calls"] == [got["kernel_calls"]]
    assert got["fallback_reasons"] == ["pipelined: ImpossibleValue('injected')"]


def test_steps_in_the_profiler_only_while_it_records(monkeypatch):
    monkeypatch.setattr(t_engine, "GROUP_BYTES", 1)
    data, payload = _input()
    eng = DeviceEngine(device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("call"):
            assert eng.decompress(data) == payload
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()]
    (call,) = [e for e in evs if e[0] == "call"]
    spans = [e for e in evs if e[0].startswith(observability.SPAN_PREFIX)]
    assert {n for n, _a, _b in spans} == {observability.SPAN_PREFIX + k for k in STEPS}
    assert all(call[1] <= a <= b <= call[2] for _n, a, b in spans)
    for step in ("plan", "execute"):
        # one a frame group
        assert sum(e[0] == observability.SPAN_PREFIX + step for e in spans) == 4

    def refuse(*a, **kw):
        raise AssertionError("record_function made with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert eng.decompress(data) == payload
    assert eng.stats.wall_s["plan"] > 0
