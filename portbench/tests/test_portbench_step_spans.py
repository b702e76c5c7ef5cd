"""The readers of the engine's step spans: each reads its ``wall_s`` key
per request, and gives None where the engine does not report the key."""

import pytest

from portbench import record, spec

READERS = {"parse_ms": "parse", "plan_ms": "plan", "words_ms": "words", "launch_ms": "launch",
           "wait_ms": "wait", "unpack_ms": "unpack", "retry_ms": "retry", "output_ms": "output"}


def _run(key: str) -> record.Run:
    reqs = [record.Request(i, float(i), i + 0.1, 1000, {key: 0.002 * (i + 1), "total": 0.1}, 0, 0, 0)
            for i in range(4)]
    return record.Run(cell=None, requests=reqs, window_s=1.0, cpu_s=1.0, setup_s=1.0,
                      trace=None, peaks=None)


@pytest.mark.parametrize("name", sorted(READERS))
def test_step_span_reader(name):
    reader = spec.module("metrics", name)
    run = _run(READERS[name])
    assert reader.read(run) == pytest.approx(5.0)  # 2, 4, 6 and 8 ms
    run.requests[0].wall_s.pop(READERS[name])
    assert reader.read(run) is None  # an engine without the span


def test_each_reader_is_in_the_benchmark():
    entries = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for name in READERS:
        m = entries[name]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == ("ms", "lower", "program_span", "decode_gbs")
