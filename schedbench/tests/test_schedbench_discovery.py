"""A cell is added with new files only: a configuration, a traffic mix,
a per-layer metric and an entry in BENCHMARK.json, found by name."""

import json
import os
import shutil

from schedbench.core.harness import run_cell
from schedbench.core.spec import benchmark, load_cell
from tiny import ROOT_DIR, shrink

METRIC = '''"""Pods bound a cycle in the window."""


def read(record):
    if not record.cycles:
        return None
    return sum(len(c.bound) for c in record.cycles) / len(record.cycles)
'''


def test_new_cell_from_new_files(tmp_path):
    base = tmp_path / "schedbench"
    shutil.copytree(os.path.join(ROOT_DIR, "schedbench"), base,
                    ignore=shutil.ignore_patterns("_cache", "_out",
                                                  "__pycache__"))
    cfg = json.loads((base / "configs" / "sched-perf-5k.json").read_text())
    cfg["zones"] = 5
    (base / "configs" / "five-zones.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "affinity.json").read_text())
    mix["tolerate_soft_taint"] = {"share": 0.25}
    (base / "traffic" / "quarter.json").write_text(json.dumps(mix))
    (base / "metrics" / "pods_per_cycle.py").write_text(METRIC)
    (base / "limits" / "five-zones.quarter.json").write_text(
        (base / "limits" / "sched-perf-5k.affinity.json").read_text())
    bench = benchmark()
    bench["configs"].append({"name": "five-zones", "source": "test",
                             "file": "schedbench/configs/five-zones.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "five-zones.quarter",
                               "config": "five-zones", "traffic": "quarter",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "pods_per_cycle", "unit": "pods",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "scheduler", "moves": "pods_per_s",
                               "workloads": ["five-zones.quarter"]})
    cell = load_cell("five-zones.quarter", bench, str(base))
    assert cell.config["zones"] == 5
    assert cell.mix["tolerate_soft_taint"]["share"] == 0.25
    assert [m.name for m in cell.per_layer][-1] == "pods_per_cycle"
    # an existing cell does not see the new metric
    assert "pods_per_cycle" not in [
        m.name for m in load_cell("sched-perf-5k.affinity", bench,
                                  str(base)).per_layer]
    out = run_cell(shrink(cell), 4, 0.2, True, device="cpu")
    assert out.result["metrics"]["pods_per_cycle"]["value"] > 0
    assert out.result["correct"], out.checks
