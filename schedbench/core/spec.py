"""Finds a cell's files by name: ``BENCHMARK.json`` names the cell's
configuration and traffic mix and the metrics it reports; each of them
is a file of its own under ``schedbench/``:

- ``configs/<config>.json``: the scheduler's v1alpha1 document and the
  cluster;
- ``traffic/<mix>.json``: the mix's parameters, read by the one
  generator in ``core/workload.py``;
- ``metrics/<metric>.py``: a reader with ``read(record)``;
- ``limits/<cell>.json`` (else ``limits/default.json``): the limit of
  each number the correctness check compares.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Metric:
    name: str
    unit: str
    read: Callable


@dataclass
class Cell:
    name: str
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[Metric]
    limits: Dict[str, float]
    chips: int


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def load_reader(name: str, base: str = HERE) -> Callable:
    path = os.path.join(base, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"schedbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(cell: str, bench: Optional[dict] = None,
              base: str = HERE) -> Cell:
    bench = bench if bench is not None else benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"schedbench: no workload {cell!r} in "
                         "BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _load_json(os.path.join(os.path.dirname(base), conf["file"]))
    mix = _load_json(os.path.join(base, "traffic",
                                  f"{entry['traffic']}.json"))
    own = os.path.join(base, "limits", f"{cell}.json")
    limits = _load_json(own if os.path.exists(own)
                        else os.path.join(base, "limits", "default.json"))
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell)]
    layers = [Metric(m["name"], m["unit"], load_reader(m["name"], base))
              for m in bench["per_layer"] if _applies(m, cell)]
    return Cell(cell, config, mix, e2e, layers, limits, entry["chips"])
