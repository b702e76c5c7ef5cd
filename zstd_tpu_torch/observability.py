"""Observability: structured per-run reports and profiler hooks.

The reference's only introspection is an eprintln of the checksum
(frame.rs:245-249) and the ``--info`` dump.  Here: per-stage wall clock,
achieved GB/s, lane/fallback counters, and an optional ``torch.profiler``
trace around the decode, exported as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import os
from dataclasses import dataclass, field

import torch


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
