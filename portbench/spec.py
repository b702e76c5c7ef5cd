"""Find a cell's pieces by name: its entry in ``BENCHMARK.json``, its
configuration file, its traffic file (which names its content file) and
the reader of each of its metrics.  No piece is named in code, so a
later change adds a configuration, a traffic mix, content or a metric by
adding files and entries only."""

from __future__ import annotations

import importlib.util
import json
import pathlib
from dataclasses import dataclass

HERE = pathlib.Path(__file__).resolve().parent
REPO = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    end_to_end: list  # BENCHMARK.json metric entries: every cell reports each
    per_layer: list  # (a reader with nothing to read leaves its metric out)


def benchmark() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def load(workload: str) -> Cell:
    """The cell named ``workload``; raises KeyError for an unknown name."""
    b = benchmark()
    entry = next((w for w in b["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in b["configs"] if c["name"] == entry["config"])
    return Cell(
        name=workload,
        chips=int(entry["chips"]),
        config=json.loads((REPO / conf["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text()),
        end_to_end=b["end_to_end"],
        per_layer=b["per_layer"],
    )


def module(kind: str, name: str):
    """``portbench/<kind>/<name>.py`` loaded by its path (a name may hold
    ``.`` or ``-``, which an import by name would not take)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench.{kind}.{name}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
