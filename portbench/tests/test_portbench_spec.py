"""BENCHMARK.json and the files it names: every workload loads by name,
and the file keeps to the benchmark contract's limits."""

import json
import re

import pytest

from portbench import inputs, spec

B = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in B["workloads"]])
def test_workload_loads_by_name(workload):
    cell = spec.load(workload)
    assert cell.chips == 1
    assert cell.config["frame_bytes"] > 0 and cell.config["batches_per_file"] >= 1
    assert (inputs.CONTENT / f"{cell.traffic['content']}.tar.zst").is_file()
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "decode_gbs"}
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.module("metrics", m["name"]).read)


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        spec.load("no-such.cell")


def test_contract_shape():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["portbench"] and B["command"][-1] == "portbench.run"
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    names = [c["name"] for c in B["configs"]] + [w["name"] for w in B["workloads"]]
    names += [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/configs/")
        conf = json.loads((spec.REPO / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] and len(c["source"]) <= 200
        assert all(k in conf for k in c["reduced"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in B["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    moves = {m["name"] for m in B["end_to_end"]}
    for m in B["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in moves and "bound" not in m
    assert len(json.dumps(B)) < 64 << 10
