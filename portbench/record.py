"""What one run recorded, as the metric readers see it."""

from __future__ import annotations

from dataclasses import dataclass

from .spec import Cell
from .trace import Trace


@dataclass
class Request:
    index: int  # the request's number in the corpus's stream (inputs.Corpus)
    start: float  # host clock (time.perf_counter) at the call
    end: float  # at its return, the bytes on the host
    bytes_out: int
    wall_s: dict  # the engine's per-call spans (EngineStats.wall_s)
    fallback_frames: int
    fallback_reasons: int
    entropy_bytes: int  # what its entropy stage has to move (sections.EntropyWork.bytes)

    @property
    def latency_s(self) -> float:
        return self.end - self.start


@dataclass
class Run:
    cell: Cell
    requests: list[Request]  # every request of the measured window, in order
    window_s: float  # from the first call to the last return
    cpu_s: float  # the process's CPU seconds (user + system, every thread) in the window
    setup_s: float  # from process start to the first call of the window
    trace: Trace | None  # the traced window's reads (--trace 1)
    peaks: dict | None  # the card's row of peaks.json; None for a card not in it

    @property
    def bytes_out(self) -> int:
        return sum(r.bytes_out for r in self.requests)

    def span_ms(self, key: str) -> float | None:
        """Mean milliseconds per request of the engine's span ``key``; None
        where the engine does not report it."""
        vals = [r.wall_s.get(key) for r in self.requests]
        if not vals or any(v is None for v in vals):
            return None
        return 1e3 * sum(vals) / len(vals)
