"""The frozen byte count of the pair is the one the port's kernel table
was measured against (``chip_smoke._pair_bound``)."""

import importlib.util
import os

import pytest

from schedbench.core import yardstick
from tiny import ROOT_DIR


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_yardstick", os.path.join(ROOT_DIR, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [(4096, 8192), (4096, 65536)])
def test_pair_bytes_match_the_kernel_table(shape):
    want = _chip_smoke()._pair_bound(*shape)
    assert yardstick.pair_bytes(*shape) == want["bytes"]
    assert yardstick.pair_ops(*shape) == want["ops"]
    assert yardstick.least_seconds(yardstick.pair_bytes(*shape),
                                   yardstick.pair_ops(*shape)) * 1e3 == \
        pytest.approx(want["bound_ms"])


def test_roofline_counts_traced_launches():
    from schedbench.core.harness import Record
    from schedbench.core.roofline import pair_share

    least = yardstick.pair_least_seconds({(4096, 8192): 1})
    rec = Record(window_s=1.0)
    # two traced launches, each at twice its least time: 50%
    rec.device_events = [("fused_pair_staged_kernel", 0.0, 2e6 * least),
                         ("fused_pair_staged_kernel", 10.0,
                          10.0 + 2e6 * least)]
    assert pair_share(rec, "fused_pair_staged_kernel",
                      {(4096, 8192): 5}) == pytest.approx(50.0)
    assert pair_share(rec, "fused_pair_kernel", {(4096, 8192): 5}) is None


def test_idle_gaps_split_over_the_spans_they_cross():
    from schedbench.core.profile import busy_seconds, idle_gaps

    spans = [("cycle", 0.0, 1.0, 0), ("snapshot", 0.1, 0.4, 1),
             ("bind", 0.6, 0.9, 1)]
    events = [("k", 0.45e6, 0.55e6)]  # busy 0.1 s in the middle
    got = dict(idle_gaps(events, spans, 0.0, 1e6))
    assert got == pytest.approx({"snapshot": 0.3, "bind": 0.3,
                                 "cycle": 0.3})
    assert busy_seconds(events, 0.0, 1e6) == pytest.approx(0.1)
