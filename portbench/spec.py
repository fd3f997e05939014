"""A cell of ``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration (``configs/<name>.json``: the network and the
session's settings), a traffic mix (``traffic/<name>.json``: the attribute
sets and the null) and, through ``BENCHMARK.json``, its metrics. Code is
found by name, one file each:

- ``networks/<network.kind>.py``: the configuration's network generator;
- ``reference/<settings.node_distance_metric>.py``: the reference's
  distances under the configuration's metric;
- ``kinds/<traffic.kind>.py``: the mix's kind of analysis: its inputs, its
  arguments to ``run_pipeline``, what it keeps of an analysis, the numbers
  it compares and their reference (see ``kinds/quantitative.py``);
- ``metrics/<name>.py``: the reader of a metric.

Adding a cell, a configuration, a mix, a kind or a metric adds files and
entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)   # metric entries
    per_layer: list = field(default_factory=list)

    @property
    def kind(self):
        """The mix's kind of analysis, ``kinds/<traffic.kind>.py``."""
        return module("kinds", self.traffic["kind"])

    @property
    def settings(self) -> dict:
        """The session's settings: the configuration's, then the mix's."""
        return {**self.config["settings"], **self.traffic.get("settings", {})}


def _applies(metric: dict, workload: str, end_to_end_names: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return True if "moves" not in metric else metric["moves"] in \
        end_to_end_names


def load_cell(root: Path, workload: str,
              bench: dict | None = None) -> Cell:
    """The cell ``workload`` of ``root/BENCHMARK.json`` (or of ``bench``,
    a dict of its form); raises KeyError for a cell it does not list."""
    if bench is None:
        with open(root / "BENCHMARK.json") as f:
            bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    with open(root / conf["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, workload, names)]
    return Cell(workload, int(w["chips"]), w["config"], w["traffic"],
                config, traffic, e2e, per_layer)


def module(folder: str, name: str):
    """The module ``<folder>/<name>.py`` under the benchmark's folder,
    loaded by its path (a name may hold dots)."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    key = "portbench._by_name." + f"{folder}.{name}".replace(
        ".", "_").replace("/", "_")
    if key not in _MODULES:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return _MODULES[key]


_MODULES: dict = {}


def reader(name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``. It returns a
    number, or None where it finds nothing to read. ``ctx`` holds:
    ``setup_s``; ``starts`` and ``ends`` of every analysis of the window
    (seconds from its start) and ``load_s`` (each ``load_attributes``);
    ``launches`` (``ops.apsp_cuda.LAUNCHES`` after each analysis, traced
    runs); ``peak_bytes`` (the window's allocated peak); ``spans`` (the
    profiled spans of device ops, ``trace.Span``) and ``host_spans`` (those
    that also recorded the host's ops and ``record_function`` ranges);
    ``session`` (the program's ``SAFE`` after the window); ``shapes`` of the
    last FW; ``card``, ``config`` and ``traffic``."""
    return module("metrics", name).read
