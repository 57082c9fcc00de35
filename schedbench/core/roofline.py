"""A kernel's share of its roofline in the traced cycles."""

from __future__ import annotations

from schedbench.core import yardstick


def pair_share(record, kernel: str, shapes: dict):
    """The pair's least seconds (``yardstick``) per launch, averaged
    over the launches the counters saw at each shape, times the
    launches the trace holds, over their device seconds, in percent.
    None where the trace holds no launch of ``kernel``."""
    evs = [(s, e) for n, s, e in record.device_events if kernel in n]
    launches = sum(shapes.values())
    if not evs or not launches:
        return None
    per_launch = yardstick.pair_least_seconds(shapes) / launches
    device_s = sum(e - s for s, e in evs) / 1e6
    return 100.0 * per_launch * len(evs) / device_s
