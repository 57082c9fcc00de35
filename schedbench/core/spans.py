"""Span arithmetic the per-layer readers share."""

from __future__ import annotations

from typing import Callable


def layer_seconds(record, match: Callable[[str], bool]) -> float:
    """Seconds of the window's cycles spent in spans ``match`` accepts,
    a span nested inside another accepted span counted once."""
    total = 0.0
    for out in record.cycles:
        for name, start, end, ancestors in out.spans:
            if match(name) and not any(match(a) for a in ancestors):
                total += end - start
    return total


def share(record, match: Callable[[str], bool]):
    """Those seconds as a percentage of the window; None where no cycle
    has such a span."""
    if not any(match(n) for out in record.cycles for n, *_ in out.spans):
        return None
    return 100.0 * layer_seconds(record, match) / record.window_s
