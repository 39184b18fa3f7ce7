"""A cell's parts, found by name.

``BENCHMARK.json`` at the root of the checkout lists the cells and the
metrics; each part lives in a file of its own under ``bench/``:

    bench/workloads/<cell>.json     the cell: configuration, traffic, chips,
                                    why, and the limits its check holds
    bench/configs/<config>.json     the model as it is run, its source, its
                                    cut, and how its weights are drawn
    bench/traffic/<traffic>.json    the traffic's parameters; its ``kind``
                                    names the module that drives it
    bench/traffic/<kind>.py         the driver of every mix of that kind
                                    and its end-to-end metrics
    bench/flops/<name>.py           a family's model FLOPs, named by the
                                    configuration's ``flops``
    bench/metrics/<metric>.py       one reader per per-layer metric
    bench/reference/<name>.py       the plain references, named by the
                                    configuration's ``reference``

Adding a cell, a configuration, a traffic mix or a metric adds files; no
file here changes.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @property
    def model(self) -> dict:
        return self.config["model"]


def _applies(metric: dict, cell: str, reported: set) -> bool:
    """Whether ``metric`` is reported in ``cell``: listed there, or with no
    list, wherever the end-to-end metric it moves is reported."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` as ``BENCHMARK.json`` and its files give it.
    Raises where the cell is unknown or its files disagree."""
    bench = read_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no cell {name!r}")
    here = root / "bench"
    workload = read_json(here / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: {key} is {entry[key]!r} in "
                             f"BENCHMARK.json, {workload[key]!r} in "
                             f"bench/workloads/{name}.json")
    config = read_json(here / "configs" / f"{entry['config']}.json")
    traffic = read_json(here / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, reported)]
    return Cell(name, workload, config, traffic, e2e, per_layer)


def _module(path: Path, name: str):
    """The module in ``path``, loaded as ``name``."""
    if not path.is_file():
        raise FileNotFoundError(f"no module {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = ROOT):
    """The reader module of per-layer metric ``name``
    (``bench/metrics/<name>.py``; names may hold dots)."""
    return _module(root / "bench" / "metrics" / f"{name}.py",
                   "bench.metrics." + name.replace(".", "__"))


def kind_module(kind: str, root: Path = ROOT):
    """The driver module of traffic kind ``kind``
    (``bench/traffic/<kind>.py``)."""
    return _module(root / "bench" / "traffic" / f"{kind}.py",
                   "bench.traffic." + kind.replace(".", "__"))


def flops_module(config: dict, root: Path = ROOT):
    """The FLOP count the configuration names
    (``bench/flops/<flops>.py``)."""
    name = config["flops"]
    return _module(root / "bench" / "flops" / f"{name}.py",
                   "bench.flops." + name.replace(".", "__"))


def reference(config: dict):
    """The plain reference module the configuration names."""
    return importlib.import_module("bench.reference." + config["reference"])
