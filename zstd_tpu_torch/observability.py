"""Observability: structured per-run reports and profiler hooks.

The reference's only introspection is an eprintln of the checksum
(frame.rs:245-249) and the ``--info`` dump.  Here: per-step wall clock
(``span``, summed into ``EngineStats.wall_s`` and, while a profiler
records, a ``zstd_tpu_torch.<step>`` span in its trace), achieved GB/s,
lane/fallback counters, and an optional ``torch.profiler`` trace around
the decode, exported as a Chrome trace; CUDA-event and
CUDA-graph timers; and the profiler reads that ``chip_smoke.py`` and the
bench share (device time by kernel, the device's idle share, the retake
of a trace that lost its device events).
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

import torch


SPAN_PREFIX = "zstd_tpu_torch."  # profiler name of a span: prefix + step


class span:
    """Add the block's ``time.perf_counter`` seconds to
    ``stats.wall_s[name]`` (summed over a call's frame groups).  While a
    ``torch.profiler`` records, checked once at entry, the block is also a
    ``record_function`` span named ``SPAN_PREFIX + name``, on the clock of
    the trace's device events; otherwise no ``record_function`` is made.
    A class rather than a generator: the engine opens one a frame, and this
    form costs half as much."""

    __slots__ = ("stats", "name", "t0", "rf")

    def __init__(self, stats, name: str):
        self.stats, self.name = stats, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        self.rf = None
        if torch.autograd.profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(SPAN_PREFIX + self.name)
            self.rf.__enter__()

    def __exit__(self, *exc) -> bool:
        try:
            if self.rf is not None:
                self.rf.__exit__(*exc)
        finally:
            wall = self.stats.wall_s
            wall[self.name] = wall.get(self.name, 0.0) + (time.perf_counter() - self.t0)
        return False


@dataclass
class RunReport:
    """Structured report for one decode run."""

    bytes_in: int = 0
    bytes_out: int = 0
    wall_s: dict = field(default_factory=dict)
    lit_lanes: int = 0
    seq_lanes: int = 0
    fallback_frames: int = 0
    kernel_calls: int = 0
    device: str = ""

    @property
    def throughput_gbs(self) -> float:
        total = self.wall_s.get("total", 0.0)
        return self.bytes_out / total / 1e9 if total else 0.0

    def to_json(self) -> str:
        return json.dumps(
            {
                "bytes_in": self.bytes_in,
                "bytes_out": self.bytes_out,
                "ratio": round(self.bytes_in / self.bytes_out, 4)
                if self.bytes_out
                else None,
                "throughput_gbs": round(self.throughput_gbs, 6),
                "wall_s": {k: round(v, 4) for k, v in self.wall_s.items()},
                "lit_lanes": self.lit_lanes,
                "seq_lanes": self.seq_lanes,
                "fallback_frames": self.fallback_frames,
                "kernel_calls": self.kernel_calls,
                "device": self.device,
            }
        )

    @classmethod
    def from_engine(cls, engine) -> "RunReport":
        """The report of ``engine``'s last run; ``device`` names the CUDA
        card the engine ran on, or ``"cpu"``."""
        s = engine.stats
        dev = engine.device
        device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        return cls(
            bytes_in=s.bytes_in,
            bytes_out=s.bytes_out,
            wall_s=dict(s.wall_s),
            lit_lanes=s.lit_lanes,
            seq_lanes=s.seq_lanes,
            fallback_frames=s.fallback_frames,
            kernel_calls=s.kernel_calls,
            device=device,
        )


@contextlib.contextmanager
def profiled(trace_dir: str | None = None):
    """Wrap a decode in a ``torch.profiler`` trace (host, and the CUDA
    device when there is one), exported as ``trace_dir/trace.json``
    (Chrome trace format).  No-op when ``trace_dir`` is None.  An
    exception raised inside propagates, and no trace is written."""
    if trace_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))


def event_ms(fn, reps: int) -> float:
    """Median milliseconds between CUDA events around one call of ``fn``
    over ``reps`` calls, after one warm-up call: the device's work plus
    the call's host time."""
    import statistics

    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int) -> float:
    """Device milliseconds per call of ``fn``, whose work is CUDA launches
    on the current stream with no host synchronisation: ``fn`` runs once,
    is captured into a CUDA graph, and the graph is replayed ``reps``
    times back to back between two CUDA events.  Unlike events around a
    call, it leaves out the call's host time (argument checks,
    allocation, the launch itself)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _pci_address(bus_id: str):
    """(domain, bus, device) of an ``nvidia-smi`` ``pci.bus_id`` such as
    ``00000000:19:00.0``; None where it is hidden (``[N/A]``)."""
    try:
        domain, bus, device = bus_id.split(":")
        return int(domain, 16), int(bus, 16), int(device.split(".")[0], 16)
    except ValueError:
        return None


def card_line(index: int | None = None) -> str:
    """CUDA card ``index``'s (default: the current card's) name and power
    limit as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``).  The row is
    the one at the card's PCI address: ``nvidia-smi`` lists cards in PCI
    order, CUDA numbers them fastest first and ``CUDA_VISIBLE_DEVICES``
    renumbers them, so a row index can name another card.  Where
    ``nvidia-smi`` hides every address, as in a container, the row at
    ``index`` is taken."""
    index = torch.cuda.current_device() if index is None else index
    props = torch.cuda.get_device_properties(index)
    want = (props.pci_domain_id, props.pci_bus_id, props.pci_device_id)
    rows = [
        row.split(", ", 1)
        for row in subprocess.run(
            ["nvidia-smi", "--query-gpu=pci.bus_id,name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
    ]
    addresses = [_pci_address(bus_id) for bus_id, _ in rows]
    if want in addresses:
        return rows[addresses.index(want)][1]
    if all(a is None for a in addresses):
        return rows[index][1]
    raise RuntimeError(f"nvidia-smi lists no card at PCI {want}: {rows}")


# -- torch.profiler: device time by kernel and the device's idle share -------

PROFILE_TRIES = 3  # traces taken before a profiled kernel counts as missing


def _stderr(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def traced(run, holds, lacks: str, log=_stderr):
    """A ``torch.profiler`` trace (host and CUDA activities) of one call of
    ``run`` followed by a synchronisation.  A trace can come back without
    the device events of its window (CUPTI flushes its activity buffers
    late, and a process's first trace can lose them while CUPTI starts),
    so a trace for which ``holds(prof)`` is false is taken again, up to
    ``PROFILE_TRIES`` traces in all, each retake logged as ``profile:
    trace i of N <lacks>``.  Raises RuntimeError when no trace holds."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        if holds(prof):
            return prof
        log(f"profile: trace {attempt} of {PROFILE_TRIES} {lacks}")
    raise RuntimeError(f"profile: every one of {PROFILE_TRIES} traces {lacks}")


def _device_events(prof) -> list:
    from torch.autograd import DeviceType

    return [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]


def holds_kernels(*keys: str):
    """A ``traced`` test: the trace has a device event whose name holds
    each of ``keys`` (any device event for an empty key)."""
    return lambda prof: all(any(k in ev.key for ev in _device_events(prof)) for k in keys)


def device_ms_by_op(prof) -> dict:
    """Device milliseconds by name, device-side events only (kernels,
    copies): a host op's entry also carries the device time of what it
    launched, so summing every entry would count that time twice."""
    return {
        ev.key: ev.self_device_time_total / 1e3
        for ev in _device_events(prof)
        if ev.self_device_time_total > 0
    }


def idle_share(busy_ms: float, wall_s: float) -> float | None:
    """The share of ``wall_s`` in which the device ran nothing, given its
    busy milliseconds over the same work; None when nothing was seen."""
    return (1 - busy_ms / 1e3 / wall_s) if busy_ms else None


def profiled_kernels(run, key: str, reps: int = 1, log=_stderr) -> tuple[dict, int, list]:
    """Device milliseconds per call of ``run`` by CUDA kernel whose name
    holds ``key`` (the name's part after ``key``; every device event for
    an empty key), over ``reps`` calls after one unprofiled call, the
    launches per call, and each launch's milliseconds in order, from
    ``torch.profiler`` (``traced``: a trace that holds no kernel of
    ``key`` is taken again)."""
    from torch.autograd import DeviceType

    run()
    torch.cuda.synchronize()

    def calls():
        for _ in range(reps):
            run()

    prof = traced(calls, holds_kernels(key), f"holds no {key or 'device'} kernel", log)
    name = lambda k: k.split(key, 1)[1].split("(", 1)[0] if key else k  # noqa: E731
    split, launches = {}, 0
    for ev in _device_events(prof):
        if key in ev.key:
            split[name(ev.key)] = ev.self_device_time_total / 1e3 / reps
            launches += ev.count
    each = sorted((ev.time_range.start, name(ev.key), ev.time_range.elapsed_us() / 1e3)
                  for ev in prof.events() if ev.device_type == DeviceType.CUDA and key in ev.key)
    return split, launches // reps, [(n, ms) for _t, n, ms in each]


def profiler_warm_up(log=_stderr) -> None:
    """Start the profiler's CUDA tracing before the first trace that is
    read: the first trace of a process is the one that can lose its
    device events while CUPTI starts.  Traces a fill of a small tensor
    until one trace holds its kernel."""
    x = torch.empty(1 << 20, device="cuda")
    profiled_kernels(lambda: x.fill_(1.0), "", 4, log)
