"""Each metric reader over a small recorded run, and the trace reads over
a small recorded profile."""

import pytest

from portbench import record, sections, spec, trace

WORK = sections.EntropyWork(literal_in=1000, literal_out=3000, sequence_in=5000, sequences=100)


def _run(tr=None):
    reqs = [
        record.Request(i, float(i), i + lat, 2_000_000, {"prepass": 0.01 * (i + 1), "kernels": 0.1,
                                                          "assembly": 0.02}, 0, 0, WORK.bytes)
        for i, lat in enumerate([0.1, 0.2, 0.3, 0.4, 0.5])
    ]
    return record.Run(cell=None, requests=reqs, window_s=2.0, cpu_s=3.0, setup_s=7.5,
                      trace=tr, peaks={"hbm_bytes_per_s": 1e12})


def read(name, run):
    return spec.module("metrics", name).read(run)


def test_end_to_end_readers():
    run = _run()
    assert read("decode_gbs", run) == pytest.approx(10e6 / 2.0 / 1e9)
    assert read("request_p95_ms", run) == pytest.approx(480.0)  # 0.4 + 0.8 * (0.5 - 0.4)
    assert read("host_cpu_s_per_gb", run) == pytest.approx(3.0 / 0.01)
    assert read("setup_s", run) == 7.5


def test_span_readers():
    run = _run()
    assert read("prepass_ms", run) == pytest.approx(30.0)
    assert read("dispatch_finish_ms", run) == pytest.approx(100.0)
    assert read("assembly_ms", run) == pytest.approx(20.0)
    run.requests[0].wall_s.pop("kernels")
    assert read("dispatch_finish_ms", run) is None  # a span the engine no longer reports


def _ev(name, start, end, device=True, annotation=False):
    return (name, device, start, end, annotation)


# Two requests over 0-1000 us; the device works 100-200 (sequences), 150-250
# (a copy) and 600-700 (literals): busy 250 us; idle 100 us in request 1
# before its first kernel, 230 us in its finish span and 120 outside it,
# 300 in request 2.
PROFILE = [
    _ev("portbench.request", 0, 500, device=False),
    _ev("portbench.request", 500, 1000, device=False),
    _ev("portbench._finish_sequences", 250, 480, device=False),
    _ev("aten::copy_", 260, 270, device=False),
    _ev("portbench.request", 0, 1000, annotation=True),  # a GPU-side user annotation
    _ev("void sequences_kernel<false>(int*)", 100, 200),
    _ev("Memcpy DtoH (Device -> Pinned)", 150, 250),
    _ev("literals_kernel", 600, 700),
]


def test_trace_read():
    t = trace.read(PROFILE)
    assert (t.requests, t.window_s, t.busy_s) == (2, 1e-3, 250e-6)
    assert t.kernel_s == pytest.approx(200e-6)
    assert t.device_s_named("sequences_kernel") == pytest.approx(100e-6)
    assert t.idle_s == pytest.approx({"portbench.request": 100e-6 + 20e-6 + 100e-6 + 300e-6,
                                      "portbench._finish_sequences": 230e-6})
    b = trace.breakdown(t)
    assert b["device_ops"][0][1] == pytest.approx(100e-6) and len(b["device_ops"]) == 3
    assert b["idle_gaps"][0][0] == "portbench.request"
    assert trace.short("void (anonymous namespace)::sequences_kernel<false>(int*)") == "sequences_kernel<false>"


def test_events_of_a_profile():
    """``events`` over a real (CPU) profile: the benchmark's spans and the
    host ops, none of them on a device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.request_span():
            torch.ones(64).mul_(2)
    evs = trace.events(prof)
    spans = [e for e in evs if e[0] == trace.REQUEST]
    assert len(spans) == 1 and not spans[0][1] and spans[0][3] > spans[0][2]
    assert not trace.has_kernels(evs)
    assert trace.read(evs).requests == 1


def test_trace_readers():
    run = _run(trace.read(PROFILE))
    run.requests = run.requests[:2]
    assert read("seq_kernel_ms", run) == pytest.approx(0.05)
    assert read("idle_share_pct", run) == pytest.approx(75.0)
    need = 2 * WORK.bytes / 1e12
    assert read("entropy_roofline", run) == pytest.approx(100 * need / 200e-6)
    for r in run.requests:
        r.entropy_bytes = sections.EntropyWork().bytes
    assert read("entropy_roofline", run) is None  # no entropy-coded section: no reading, never 0
    run.peaks = None
    assert read("entropy_roofline", run) is None  # a card the peak table lacks: no reading


def test_trace_readers_without_a_trace():
    run = _run()
    for name in ("seq_kernel_ms", "idle_share_pct", "entropy_roofline"):
        assert read(name, run) is None
