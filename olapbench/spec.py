"""What a cell is, found by name: ``BENCHMARK.json`` at the root of the
checkout lists the cells, their configurations, traffic mixes and metrics;
a configuration is ``configs/<config>.json`` (the file the entry names), a
traffic mix ``traffic/<traffic>.json``, a metric's reader
``metrics/<metric>.py``, the query a mix names ``queries/<query>.py`` and
the data a configuration names ``data/<generator>.py``.
Adding a cell, a configuration, a mix or a metric adds files and entries
and edits none."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent  # the checkout: BENCHMARK.json and the program beside olapbench/


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names read in."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # the metric entries this cell reports, in order
    per_layer: list


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _reported(metrics: list, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def cell(name: str) -> Cell:
    """The cell of BENCHMARK.json called ``name``; KeyError if none is."""
    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text())
    return Cell(name, int(entry["chips"]), config, traffic,
                _reported(bench["end_to_end"], name), _reported(bench["per_layer"], name))


def data_module(cfg: dict):
    """The data a configuration names: ``data/<generator>.py``."""
    return importlib.import_module(f"olapbench.data.{cfg['generator']}")


def query_module(name: str):
    """The query a traffic mix names: ``queries/<name>.py``."""
    return importlib.import_module(f"olapbench.queries.{name}")


def metric_reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"olapbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
