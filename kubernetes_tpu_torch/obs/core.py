"""The scheduler's observability facade — only its tracer seam so far (the
port of ``kubernetes_tpu/obs/core.py``'s ``begin_cycle`` / ``span`` /
``step`` / ``end_cycle`` / ``chrome_trace``).

``Scheduler.obs`` opens one :class:`~.trace.Trace` per cycle; the cycle
puts spans at the reference's sites, under its names (``snapshot``,
``solve:{tier}``, ``validate``, ``bind``, ``solve:restricted``,
``solve:partitioned``, ``preemption`` and the pipelined executor's
``pipeline:pack@k`` / ``pipeline:dispatch@k`` / ``pipeline:readback@k`` /
``pipeline:bind@k``). Spans read ``time.perf_counter`` and nothing else:
they never synchronise the device, so a span around an enqueue measures
the host's enqueue, and the readback span is where the host waits.

Not ported yet (ROADMAP A.13): the flight recorder, the device telemetry
(compile, transfer and readback accounting), the memory ledger, pod
journeys and incidents.
"""

from __future__ import annotations

import collections
import time
from contextlib import nullcontext
from typing import Deque, Optional

from kubernetes_tpu_torch.obs.trace import Trace, chrome_trace_json

#: cycle traces kept for :meth:`Obs.chrome_trace`
TRACE_RING = 16


class Obs:
    """Per-scheduler tracer: the in-flight cycle's trace and a ring of the
    last finished ones."""

    def __init__(self) -> None:
        self.current_trace: Optional[Trace] = None
        self.last_trace: Optional[Trace] = None
        self.traces: Deque[Trace] = collections.deque(maxlen=TRACE_RING)

    def begin_cycle(self, cycle: int = 0) -> Trace:
        self.current_trace = Trace("Scheduling cycle",
                                   clock=time.perf_counter, cycle=cycle)
        return self.current_trace

    def span(self, name: str, **fields):
        """Nested span on the in-flight cycle trace (no-op outside a
        cycle)."""
        if self.current_trace is None:
            return nullcontext()
        return self.current_trace.span(name, **fields)

    def step(self, msg: str) -> None:
        if self.current_trace is not None:
            self.current_trace.step(msg)

    def end_cycle(self) -> Optional[Trace]:
        """Close the in-flight trace; it becomes ``last_trace``."""
        trace, self.current_trace = self.current_trace, None
        if trace is None:
            return None
        trace.finish()
        self.last_trace = trace
        self.traces.append(trace)
        return trace

    def chrome_trace(self) -> dict:
        """Chrome trace-event document over the retained traces."""
        return chrome_trace_json(list(self.traces))
