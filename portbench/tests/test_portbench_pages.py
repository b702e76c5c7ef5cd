"""The Parquet-page cell, ``pages-1mib.stdlib-l1``: it loads by name, its
corpus is the content file cut into 1 MiB level-1 frames of 8 blocks
with a window descriptor and no checksum (all but the file's tail), 10 a
request, and its metric
``execute_ms`` reads the engine's execute span."""

import functools

import pytest

from portbench import inputs, libzstd, record, spec

CELL = "pages-1mib.stdlib-l1"
SEED = 2**31 + 14


@functools.cache
def _corpus() -> inputs.Corpus:
    return inputs.make_corpus(spec.load(CELL), SEED)


def _frame_shape(frame: bytes) -> tuple[bool, bool, list[int]]:
    """(single segment, checksum flag, each block's type) from the
    frame's own headers (RFC 8878 sections 3.1.1.1 and 3.1.1.2)."""
    fhd = frame[4]
    single, checksum, dict_flag, fcs_flag = (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3, fhd >> 6
    fcs = (1, 2, 4, 8)[fcs_flag] if fcs_flag or single else 0
    pos = 5 + (0 if single else 1) + (0, 1, 2, 4)[dict_flag] + fcs
    kinds, last = [], False
    while not last:
        bh = int.from_bytes(frame[pos : pos + 3], "little")
        last, btype, size = bh & 1, (bh >> 1) & 3, bh >> 3
        kinds.append(btype)
        pos += 3 + (1 if btype == 1 else size)
    assert pos + 4 * checksum == len(frame)
    return bool(single), bool(checksum), kinds


def test_cell_loads_by_name():
    cell = spec.load(CELL)
    base = spec.load("chunks-64kib.stdlib-l3")
    assert set(cell.config) == set(base.config)
    assert cell.chips == 1 and cell.config["engine"] == {}
    assert (cell.config["frame_bytes"], cell.config["batches_per_file"]) == (1 << 20, 2)
    assert cell.config["reduced"] == ["batches_per_file"]
    assert cell.config["guarantees"] == base.config["guarantees"]
    assert (cell.traffic["content"], cell.traffic["level"]) == (base.traffic["content"], 1)
    assert len(cell.config["source"]) <= 200


def test_corpus_is_twenty_multiblock_pages():
    corpus = _corpus()
    assert len(corpus.frames) == 20
    assert all(len(r) == 1 << 20 for r in corpus.raw[:-1]) and 0 < len(corpus.raw[-1]) <= 1 << 20
    shapes = []
    for i, (frame, raw) in enumerate(zip(corpus.frames, corpus.raw)):
        single, checksum, kinds = _frame_shape(frame)
        assert int.from_bytes(frame[:4], "little") == 0xFD2FB528 and not checksum
        if i < 19:
            assert not single and len(kinds) == 8
            assert frame[5] == 9 << 3  # the window descriptor: 2^(10 + 9) = 512 KiB
        else:  # the file's tail, under 512 KiB: one segment, as long as its content
            assert single and len(kinds) == -(-len(raw) // (128 << 10)) > 1
        shapes.append("".join("RLC"[k] for k in kinds))
    assert sum(s.count("C") for s in shapes) > 0.8 * sum(map(len, shapes))  # mostly compressed
    assert any("CR" in s or "RC" in s for s in shapes)  # raw blocks beside compressed ones
    assert libzstd.decompress(corpus.request(0), 11 << 20) == corpus.expected(0)
    assert [len(corpus.order(i)) for i in range(4)] == [10] * 4


def test_execute_ms_reads_its_span():
    reader = spec.module("metrics", "execute_ms")
    reqs = [record.Request(i, float(i), i + 0.1, 1000, {"execute": 0.002 * (i + 1), "total": 0.1}, 0, 0, 0)
            for i in range(4)]
    run = record.Run(cell=None, requests=reqs, window_s=1.0, cpu_s=1.0, setup_s=1.0,
                     trace=None, peaks=None)
    assert reader.read(run) == pytest.approx(5.0)  # 2, 4, 6 and 8 ms
    run.requests[0].wall_s.pop("execute")
    assert reader.read(run) is None  # an engine without the span, as before it had one


def test_execute_ms_is_in_the_benchmark():
    (m,) = [m for m in spec.benchmark()["per_layer"] if m["name"] == "execute_ms"]
    assert m == {"name": "execute_ms", "unit": "ms", "better": "lower", "source": "program_span",
                 "layer": "assembly", "moves": "decode_gbs"}
