"""Tiny sizes of the benchmark's cells, for runs on the CPU."""

from __future__ import annotations

import copy
import os

from schedbench.core.spec import benchmark, load_cell

ROOT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the cells of BENCHMARK.json
CELLS = tuple(w["name"] for w in benchmark()["workloads"])


def shrink(cell):
    """The cell at 200 nodes, at most 100 existing pods, at most 800
    pending and batches of 256 (chunks in the same ratio): the same
    generators, path and checks."""
    cell = copy.deepcopy(cell)
    c = cell.config
    c.update(nodes=200, existing_pods=min(c["existing_pods"], 100),
             pending_pods=min(c.get("pending_pods", 0), 800))
    s = c["scheduler"]
    chunk = min(256 * s["pipelineChunk"] // s["maxBatch"], 256)
    s["maxBatch"], s["pipelineChunk"] = 256, chunk
    s["warmup"]["podBuckets"] = [chunk]
    cell.mix["pool_pods_per_s"] = 2000
    return cell


def tiny(name: str):
    return shrink(load_cell(name))
