"""The traced run's device trace: ``torch.profiler`` over a few whole
cycles, its device events put on the host's clock, the card's busy
share, and the breakdown of device time and idle gaps.

The profiler records the card alone (CUPTI), so the cycles it covers
pay little on the host. A marker kernel (``torch.cuda._sleep``) launched
at a known host time after a synchronise ties the trace's clock to the
host's ``time.monotonic``, on which the program's spans are stamped.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

MARKER = "spin_kernel"


class DeviceTrace:
    def __init__(self) -> None:
        self.prof = None
        self.marker_host_us = 0.0
        self.events: List[Tuple[str, float, float]] = []  # host-clock us

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.marker_host_us = time.monotonic() * 1e6
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def collect(self) -> None:
        """Reads the trace's device events (after the window: parsing
        takes seconds)."""
        from torch.autograd import DeviceType

        raw = [(e.name, float(e.time_range.start), float(e.time_range.end))
               for e in self.prof.events()
               if e.device_type == DeviceType.CUDA]
        self.prof = None
        marks = [s for n, s, _ in raw if MARKER in n]
        off = (min(marks) - self.marker_host_us) if marks else None
        if off is None:
            self.events = []
            return
        self.events = [(n, s - off, e - off) for n, s, e in raw
                       if MARKER not in n]


def union(intervals: List[Tuple[float, float]], lo: float,
          hi: float) -> List[Tuple[float, float]]:
    """Merged intervals, clipped to [lo, hi]."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(events, lo_us: float, hi_us: float) -> float:
    """Seconds in which a kernel, copy or fill ran on the card, within
    [lo, hi] (the union of their intervals)."""
    return sum(e - s for s, e in union([(s, e) for _, s, e in events],
                                       lo_us, hi_us)) / 1e6


def top_ops(events, k: int = 10) -> List[list]:
    by: Dict[str, float] = {}
    for n, s, e in events:
        by[n[:120]] = by.get(n[:120], 0.0) + (e - s) / 1e6
    return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(events, spans, lo_us: float, hi_us: float,
              k: int = 10) -> List[list]:
    """The card's idle seconds within [lo, hi], split over the innermost
    host span open at each moment (``spans``: (name, start, end, depth)
    on the host clock, seconds), summed by name."""
    busy = union([(s, e) for _, s, e in events], lo_us, hi_us)
    gaps, t = [], lo_us
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi_us > t:
        gaps.append((t, hi_us))
    # elementary pieces between span edges, each named by its innermost
    # span
    edges = sorted({lo_us, hi_us} | {x * 1e6 for _, a, b, _ in spans
                                      for x in (a, b)
                                      if lo_us < x * 1e6 < hi_us})
    pieces = []
    for a, b in zip(edges, edges[1:]):
        mid = (a + b) / 2e6
        best: Optional[tuple] = None
        for name, s0, s1, depth in spans:
            if s0 <= mid <= s1 and (best is None or depth > best[1]):
                best = (name, depth)
        pieces.append((a, b, best[0] if best else "outside any span"))
    by: Dict[str, float] = {}
    for g0, g1 in gaps:
        for a, b, name in pieces:
            over = min(b, g1) - max(a, g0)
            if over > 0:
                by[name] = by.get(name, 0.0) + over / 1e6
    return [[n, v] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:k]]
