"""On the card: one short run of each cell through the command, correct
and with its metrics. Run with ``python -m pytest schedbench/tests -m
card`` on a machine with a CUDA card; skips elsewhere."""

import json
import os
import subprocess
import sys

import pytest

from tiny import CELLS, ROOT_DIR


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_on_the_card(card, name, trace):
    p = subprocess.run([sys.executable, "schedbench/run.py", "--workload",
                        name, "--seed", str(2**31 + 3), "--seconds", "5",
                        "--trace", str(trace)], capture_output=True,
                       text=True, cwd=ROOT_DIR, timeout=1200,
                       env=dict(os.environ))
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    if trace:
        assert r["device"]["busy_s"] > 0
        assert "device_idle_share" in r["metrics"]
    else:
        assert r["metrics"]["pods_per_s"]["value"] > 0
