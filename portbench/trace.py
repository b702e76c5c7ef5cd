"""The traced run's reads from ``torch.profiler``: device busy time as
the union of device-event intervals, kernel time by name, and the idle
gaps named by what the host was doing.

Spans are the benchmark's own: ``portbench.request`` around each call,
and, while a run is traced, one span around each engine step that the
engine object exposes (``LAYER_STEPS``; a step it no longer has is
skipped), so an idle gap of the device is named by the innermost step
the host was in.  Untraced runs wrap nothing.
"""

from __future__ import annotations

import bisect
import contextlib
import sys
from dataclasses import dataclass, field

PREFIX = "portbench."
REQUEST = PREFIX + "request"
# Engine methods (and the prepass function in the engine's module) that
# a traced run wraps in spans, by layer.
LAYER_STEPS = (
    "_dispatch_literals",
    "_dispatch_sequences",
    "_fetch_pending",
    "_finish_literals",
    "_finish_sequences",
    "_retry_sequences",
    "_assemble_group",
)
PREPASS = "build_batch_plan"
TRIES = 3  # traces taken before one without device kernels counts as a failure


@dataclass
class Trace:
    window_s: float  # from the first request's start to the last one's end
    busy_s: float  # union of device-event intervals inside the window
    kernel_s: float  # summed duration of kernels (copies and fills left out)
    requests: int  # requests inside the traced window
    device_s: dict = field(default_factory=dict)  # device seconds by event name
    idle_s: dict = field(default_factory=dict)  # idle device seconds by host span

    def device_s_named(self, part: str) -> float:
        return sum(s for name, s in self.device_s.items() if part in name)


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def _union(intervals: list) -> list:
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _innermost(spans: list, starts: list, t: float) -> str:
    """The name of the latest-starting span open at ``t``: spans of one
    thread nest, so that is the innermost."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if spans[i][1] > t:
            return spans[i][2]
        i -= 1
    return "between requests"


def events(prof) -> list:
    """``(name, on_device, start_us, end_us, user_annotation)`` of every
    event of a finished profile, read from its kineto results: far faster
    than the profiler's own event tree over a window of some hundred
    thousand events."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() / 1e3
        note = ev.is_user_annotation() if hasattr(ev, "is_user_annotation") else False
        out.append((ev.name(), ev.device_type() != DeviceType.CPU, start, start + ev.duration_ns() / 1e3, note))
    return out


def read(evs: list) -> Trace:
    """The numbers of a trace's ``events`` (times in microseconds, read
    out in seconds)."""
    host, device = [], []
    for name, on_device, a, b, note in evs:
        if not on_device:
            if name.startswith(PREFIX):
                host.append((a, b, name))
        elif not note and not name.startswith(PREFIX):
            device.append((a, b, name))
    reqs = [(a, b) for a, b, n in host if n == REQUEST]
    if not reqs:
        return Trace(0.0, 0.0, 0.0, 0)
    w0, w1 = min(a for a, _ in reqs), max(b for _, b in reqs)
    busy = _union([(max(a, w0), min(b, w1)) for a, b, _ in device if b > w0 and a < w1])
    device_s: dict = {}
    for a, b, name in device:
        device_s[name] = device_s.get(name, 0.0) + (b - a) / 1e6
    kernel_s = sum(s for name, s in device_s.items() if not is_copy(name))
    idle_s: dict = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    spans = sorted(host)
    starts = [h[0] for h in spans]
    cuts = sorted({x for a, b, _ in host for x in (a, b)})
    for g0, g1 in zip(edges[::2], edges[1::2]):
        # the gap in pieces at span edges, each named by the span open in it
        inside = cuts[bisect.bisect_right(cuts, g0) : bisect.bisect_left(cuts, g1)]
        points = [g0, *inside, g1]
        for a, b in zip(points, points[1:]):
            if b > a:
                name = _innermost(spans, starts, (a + b) / 2)
                idle_s[name] = idle_s.get(name, 0.0) + (b - a) / 1e6
    return Trace(
        window_s=(w1 - w0) / 1e6,
        busy_s=sum(b - a for a, b in busy) / 1e6,
        kernel_s=kernel_s,
        requests=len(reqs),
        device_s=device_s,
        idle_s=idle_s,
    )


def short(name: str) -> str:
    """A kernel's name without its namespace noise and argument list."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(", 1)[0][:120]


def breakdown(trace: Trace) -> dict:
    """The ten device ops that took most time and the ten host spans
    during which the device stood idle longest, in seconds."""
    def top(d):
        merged: dict = {}
        for k, v in d.items():
            merged[short(k)] = merged.get(short(k), 0.0) + v
        return [[k, v] for k, v in sorted(merged.items(), key=lambda kv: -kv[1])[:10]]

    return {"device_ops": top(trace.device_s), "idle_gaps": top(trace.idle_s)}


def request_span():
    from torch.profiler import record_function

    return record_function(REQUEST)


@contextlib.contextmanager
def layer_spans(engine):
    """Wrap the engine's steps (and its module's prepass function) in
    spans named after them for the duration of the block."""
    from torch.profiler import record_function

    def wrap(fn, name):
        def spanned(*a, **kw):
            with record_function(PREFIX + name):
                return fn(*a, **kw)
        return spanned

    mod = sys.modules.get(type(engine).__module__)
    prepass = getattr(mod, PREPASS, None)
    steps = [n for n in LAYER_STEPS if callable(getattr(engine, n, None))]
    for n in steps:
        setattr(engine, n, wrap(getattr(engine, n), n))
    if prepass is not None:
        setattr(mod, PREPASS, wrap(prepass, "prepass"))
    try:
        yield
    finally:
        for n in steps:
            delattr(engine, n)
        if prepass is not None:
            setattr(mod, PREPASS, prepass)


def has_kernels(evs: list) -> bool:
    return any(on_device and not note and not is_copy(name) and not name.startswith(PREFIX)
               for name, on_device, _a, _b, note in evs)


def warm_up(device, log) -> None:
    """Start the profiler's device tracing before the trace that is read:
    a process's first trace can lose its device events while CUPTI
    starts.  Traces a fill of a small tensor until a trace holds it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.empty(1 << 20, device=device)
    for attempt in range(1, TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                x.fill_(1.0)
            torch.cuda.synchronize(device)
        if has_kernels(events(prof)):
            return
        log(f"profiler warm-up: trace {attempt} of {TRIES} holds no device kernel")
    raise RuntimeError(f"profiler warm-up: none of {TRIES} traces holds a device kernel")


def traced(run, log):
    """``(events(prof), run())`` for the first of ``TRIES`` traces of
    ``run`` that holds a device kernel: a trace can come back without the
    device events of its window (the port's ``observability.traced`` does
    the same)."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            result = run()
        evs = events(prof)
        if has_kernels(evs):
            return evs, result
        log(f"profile: trace {attempt} of {TRIES} holds no device kernel, taken again")
    raise RuntimeError(f"profile: none of {TRIES} traces holds a device kernel")
