"""Dry runs of every cell at a tiny size on the CPU: the generators, the
drain loop, the program's path, the check and the result line."""

import time

import numpy as np
import pytest

from schedbench.core import workload
from schedbench.core.harness import run_cell
from tiny import CELLS, tiny

KEYS = ("correct", "attempted", "failed", "metrics", "device")


class FakeTrace:
    """Device events at fixed offsets inside the traced cycles."""

    def start(self):
        self.t0 = time.monotonic() * 1e6

    def stop(self):
        pass

    def collect(self):
        t = self.t0
        self.events = [("fused_pair_staged_kernel", t + 1000, t + 1400),
                       ("fused_pair_kernel", t + 2000, t + 2600),
                       ("Memcpy HtoD", t + 3000, t + 3500)]


@pytest.mark.parametrize("name", CELLS)
def test_dry_run_reports_end_to_end(name):
    out = run_cell(tiny(name), 2**31 + 11, 0.5, False, device="cpu")
    r = out.result
    assert list(r)[:5] == list(KEYS) and list(r)[-1] == "checks"
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"pods_per_s", "setup_s"}
    assert r["metrics"]["pods_per_s"]["value"] > 0
    assert r["attempted"] > 0 and r["failed"] == 0
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("name", CELLS)
def test_traced_dry_run_reports_per_layer(name):
    out = run_cell(tiny(name), 5, 0.3, True, device="cpu",
                   tracer=FakeTrace())
    r = out.result
    m = r["metrics"]
    assert {"informer_share", "cycle_rest_share", "bind_share",
            "snapshot_share", "solve_share", "host_syncs_per_cycle",
            "device_idle_share"} <= set(m)
    assert 0 < m["device_idle_share"]["value"] < 100
    for k in ("informer_share", "bind_share", "snapshot_share",
              "solve_share"):
        assert 0 < m[k]["value"] < 100
    assert r["device"]["busy_s"] > 0 and r["device"]["window_s"] > 0
    assert len(r["breakdown"]["device_ops"]) == 3
    assert r["breakdown"]["idle_gaps"]
    # the CPU launches no kernel: the rooflines have nothing to read
    assert not any(k.endswith("_roofline") for k in m)


def _classes(pods, lo):
    return sorted(zip(pods.pref_zone[lo:].tolist(),
                      pods.tolerates[lo:].tolist()))


@pytest.mark.parametrize("name", CELLS)
def test_seeds_change_the_order_not_the_work(name):
    cell = tiny(name)
    n_pre = workload.prefill_count(cell.config)
    a = workload.make_pods(cell.config, cell.mix, 400, 3)
    b = workload.make_pods(cell.config, cell.mix, 400, 2**31 + 7)
    c = workload.make_pods(cell.config, cell.mix, 400, -5)
    assert _classes(a, n_pre) == _classes(b, n_pre) == _classes(c, n_pre)
    d = workload.make_pods(cell.config, cell.mix, 400, 3)
    assert np.array_equal(a.pref_zone, d.pref_zone)
    if "preferred_zone" in cell.mix:
        assert not np.array_equal(a.pref_zone, b.pref_zone)
        # every block of twenty pods holds each (zone, toleration) once
        z = a.pref_zone[n_pre:n_pre + 400].reshape(-1, 20)
        t = a.tolerates[n_pre:n_pre + 400].reshape(-1, 20)
        assert (np.sort(z * 2 + t, 1) == np.arange(20)).all()

