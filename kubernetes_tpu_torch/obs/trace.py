"""Operation tracing — the ``k8s.io/utils/trace`` analog the reference
wraps around every scheduling cycle (``generic_scheduler.go:185``:
``utiltrace.New(...)`` + steps + ``LogIfLong(100ms)``), extended with
NESTED spans and a Chrome trace-event exporter. A copy of
``kubernetes_tpu/obs/trace.py``.

A :class:`Trace` is a tree of :class:`Span` frames plus flat ``step``
marks (the utiltrace surface). ``log_if_long`` emits the breakdown
through ``logging`` only when total duration exceeds the threshold — the
cheap always-on profiler for slow cycles. ``to_chrome_events`` serializes
the tree as trace-event "complete" (``ph: "X"``) records so a cycle opens
directly in ``chrome://tracing`` or Perfetto (nesting is reconstructed
from ts/dur containment on one pid/tid).

Everything here is host code on an injectable clock: deterministic under
fake clocks. It reads no device state and never synchronises one."""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("kubernetes_tpu_torch.trace")

#: the reference logs steps that took >= 50% of a (threshold/len) share;
#: we keep it simple: log everything when over threshold.
DEFAULT_THRESHOLD_S = 0.1  # LogIfLong(100*time.Millisecond)


class Span:
    """One timed frame. ``end is None`` while the frame is open; ``steps``
    are instant marks (utiltrace ``trace.Step``) inside this frame."""

    __slots__ = ("name", "start", "end", "fields", "children", "steps")

    def __init__(self, name: str, start: float, **fields) -> None:
        self.name = name
        self.start = start
        self.end: Optional[float] = None
        self.fields: Dict[str, object] = fields
        self.children: List["Span"] = []
        self.steps: List[Tuple[float, str]] = []

    def duration_s(self, now: Optional[float] = None) -> float:
        end = self.end if self.end is not None else now
        return max(0.0, (end if end is not None else self.start) - self.start)


class Trace:
    """utiltrace.Trace with nesting. The flat surface (``step`` /
    ``total_s`` / ``format`` / ``log_if_long``) matches the seed's
    utils.trace.Trace exactly; ``span`` adds nested timed frames."""

    def __init__(
        self,
        name: str,
        clock: Callable[[], float] = time.monotonic,
        **fields,
    ) -> None:
        self.name = name
        self.fields = fields
        self.clock = clock
        self.start = clock()
        self.root = Span(name, self.start, **fields)
        self._stack: List[Span] = [self.root]
        #: flat (timestamp, msg) list — the seed-compat view of steps
        self.steps: List[Tuple[float, str]] = []
        #: (timestamp, track name, {series: value}) counter samples —
        #: the Chrome trace "C" events (Perfetto counter tracks); the
        #: perf ledger stamps model efficiency here so it renders
        #: alongside the cycle's spans
        self.counters: List[Tuple[float, str, Dict[str, float]]] = []

    # -- utiltrace surface --------------------------------------------------

    def step(self, msg: str) -> None:
        t = self.clock()
        self.steps.append((t, msg))
        self._stack[-1].steps.append((t, msg))

    def total_s(self) -> float:
        return self.clock() - self.start

    def format(self) -> str:
        fields = ",".join(f"{k}={v}" for k, v in self.fields.items())
        lines = [f'Trace "{self.name}" ({fields}) total={self.total_s()*1000:.1f}ms:']
        prev = self.start
        for t, msg in self.steps:
            lines.append(f"  +{(t - prev)*1000:.1f}ms {msg}")
            prev = t
        now = self.clock()
        for child in self.root.children:
            self._format_span(child, lines, indent=1, now=now)
        return "\n".join(lines)

    def _format_span(self, span: Span, lines: List[str], indent: int,
                     now: float) -> None:
        pad = "  " * indent
        lines.append(
            f"{pad}[span] {span.name} {span.duration_s(now)*1000:.1f}ms"
            + ("" if not span.fields
               else " (" + ",".join(f"{k}={v}"
                                    for k, v in span.fields.items()) + ")")
        )
        for child in span.children:
            self._format_span(child, lines, indent + 1, now=now)

    def log_if_long(self, threshold_s: float = DEFAULT_THRESHOLD_S) -> Optional[str]:
        if self.total_s() >= threshold_s:
            text = self.format()
            logger.info(text)
            return text
        return None

    # -- nested spans -------------------------------------------------------

    def begin_span(self, name: str, **fields) -> Span:
        """Open a nested timed frame explicitly (cycle loops that can't
        wrap a with-block); pair with :meth:`end_span`."""
        sp = Span(name, self.clock(), **fields)
        self._stack[-1].children.append(sp)
        self._stack.append(sp)
        return sp

    def end_span(self, sp: Span) -> None:
        sp.end = self.clock()
        # tolerate a span leaked open by re-entrant misuse: pop back to
        # (and including) this frame instead of corrupting the stack for
        # every later span
        while self._stack and self._stack[-1] is not sp:
            self._stack.pop()
        if self._stack:
            self._stack.pop()

    @contextmanager
    def span(self, name: str, **fields):
        """Open a nested timed frame; closes (records ``end``) on exit,
        including the exception path."""
        sp = self.begin_span(name, **fields)
        try:
            yield sp
        finally:
            self.end_span(sp)

    def counter(self, name: str, **values: float) -> None:
        """Record a counter-track sample (Chrome trace "C" event) at
        the current clock — values render as a stacked counter track in
        Perfetto, aligned with this trace's spans."""
        self.counters.append(
            (self.clock(), name, {k: float(v) for k, v in values.items()}))

    def finish(self) -> None:
        """Close the root frame (idempotent)."""
        if self.root.end is None:
            self.root.end = self.clock()
        self._stack = [self.root]

    def span_durations(self) -> Dict[str, float]:
        """Flat {span name: seconds} over the whole tree (later duplicate
        names accumulate) — the flight recorder's per-cycle timing row."""
        out: Dict[str, float] = {}
        now = self.clock()

        def walk(sp: Span) -> None:
            out[sp.name] = out.get(sp.name, 0.0) + sp.duration_s(now)
            for c in sp.children:
                walk(c)

        walk(self.root)
        return out

    def self_durations(self) -> Dict[str, float]:
        """Flat {span name: seconds EXCLUSIVE of child spans} — the
        perf ledger's phase-attribution view: a ``validate`` nested
        inside ``solve:batch`` counts once, so phase sums are disjoint
        slices of the cycle wall. ``span_durations`` keeps the
        inclusive view the flight recorder documents."""
        out: Dict[str, float] = {}
        now = self.clock()

        def walk(sp: Span) -> None:
            d = sp.duration_s(now) - sum(
                c.duration_s(now) for c in sp.children)
            out[sp.name] = out.get(sp.name, 0.0) + max(d, 0.0)
            for c in sp.children:
                walk(c)

        walk(self.root)
        return out

    # -- Chrome trace-event export ------------------------------------------

    def to_chrome_events(self, pid: int = 1, tid: int = 1) -> List[dict]:
        """Trace-event JSON records (Chrome trace format, "X" complete
        events in microseconds; steps become "i" instant events). ts
        rides the trace's own clock so events from one process line up
        across cycles."""
        self.finish()
        events: List[dict] = []
        # a span leaked open by an exception unwinding past begin_span
        # (deadline timeout mid-solve) still exports with the honest
        # duration-until-trace-end instead of dur=0
        root_end = self.root.end

        def walk(sp: Span) -> None:
            events.append({
                "name": sp.name,
                "ph": "X",
                "pid": pid,
                "tid": tid,
                "ts": round(sp.start * 1e6, 3),
                "dur": round(sp.duration_s(now=root_end) * 1e6, 3),
                **({"args": {k: str(v) for k, v in sp.fields.items()}}
                   if sp.fields else {}),
            })
            for t, msg in sp.steps:
                events.append({
                    "name": msg, "ph": "i", "s": "t",
                    "pid": pid, "tid": tid, "ts": round(t * 1e6, 3),
                })
            for c in sp.children:
                walk(c)

        walk(self.root)
        for t, name, values in self.counters:
            events.append({
                "name": name, "ph": "C", "pid": pid, "tid": tid,
                "ts": round(t * 1e6, 3), "args": values,
            })
        return events


def chrome_trace_json(traces, pid: int = 1) -> dict:
    """The ``chrome://tracing`` / Perfetto file shape: one traceEvents
    list over every given trace (sequential cycles share a tid, so the
    viewer stacks spans by ts/dur containment)."""
    events: List[dict] = []
    for tr in traces:
        events.extend(tr.to_chrome_events(pid=pid))
    return {"traceEvents": events, "displayTimeUnit": "ms"}
