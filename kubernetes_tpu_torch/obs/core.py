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

The serving loop's and the recovery protocol's notes (``note_microbatch``,
``note_fenced_bind``, ``note_takeover``, ``note_device_reset``,
``note_ambiguous_bind``, ``note_invariant_violations``,
``note_oom_forensic``) land as fields of the cycle's trace:
``flush_trigger`` / ``window_s``, ``fenced_binds``, ``takeover`` (the
elector's epoch, stamped on the first cycle after a takeover
reconciliation), ``device_resets``, ``ambiguous_binds``,
``invariant_violations`` and ``oom_forensic``. A takeover, a violation
or a forensic flag noted between cycles (a reconcile, the serving
runtime's audit sweep, a warmup's device loss) parks and lands on the
next cycle's trace, as the reference parks it for its next flight
record. The counters behind these notes are the scheduler's metrics,
which the scheduler bumps itself.

Not ported yet (ROADMAP A.13): the flight recorder the reference also
flags with these notes, the device telemetry (compile, transfer and
readback accounting), the memory ledger (whose ``record_oom`` writes the
forensic record ``note_oom_forensic`` points at), pod journeys (and
their ``note_ambiguous_park``) and incidents.
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
        #: a takeover reconciliation runs BETWEEN cycles: its epoch parks
        #: here until the next begin_cycle stamps it on that cycle's trace
        self._pending_takeover = 0
        #: between-cycles notes parked for the next cycle's trace: the
        #: auditor's violations (the serving runtime's sweep) and a
        #: device loss's forensic flag (a warmup aborted by it)
        self._pending_invariants = 0
        self._pending_oom = ""

    def begin_cycle(self, cycle: int = 0) -> Trace:
        self.current_trace = Trace("Scheduling cycle",
                                   clock=time.perf_counter, cycle=cycle)
        f = self.current_trace.fields
        if self._pending_takeover:
            f["takeover"] = self._pending_takeover
            self._pending_takeover = 0
        if self._pending_invariants:
            f["invariant_violations"] = self._pending_invariants
            self._pending_invariants = 0
        if self._pending_oom:
            f["oom_forensic"] = self._pending_oom
            self._pending_oom = ""
        return self.current_trace

    def note_microbatch(self, trigger: str, window_s: float) -> None:
        """The serving loop's micro-batch provenance for this cycle: what
        flushed the accumulation window (bucket-fill | max-wait) and how
        long it held."""
        if self.current_trace is not None:
            self.current_trace.fields["flush_trigger"] = trigger
            self.current_trace.fields["window_s"] = window_s

    def note_takeover(self, epoch: int = 1) -> None:
        """A takeover reconciliation ran (between cycles): the NEXT
        cycle's trace carries ``takeover=epoch``."""
        self._pending_takeover = max(int(epoch), 1)

    def note_fenced_bind(self) -> None:
        """A bind was aborted by the lease fence this cycle."""
        if self.current_trace is not None:
            f = self.current_trace.fields
            f["fenced_binds"] = f.get("fenced_binds", 0) + 1

    def _bump(self, name: str, n: int = 1) -> None:
        f = self.current_trace.fields
        f[name] = f.get(name, 0) + n

    def note_device_reset(self) -> None:
        """The resident device table was dropped and rebuilt after a
        device error this cycle (``device_resets``)."""
        if self.current_trace is not None:
            self._bump("device_resets")

    def note_ambiguous_bind(self) -> None:
        """A bind timed out ambiguously this cycle and went through the
        read-your-write resolution (``ambiguous_binds``)."""
        if self.current_trace is not None:
            self._bump("ambiguous_binds")

    def note_invariant_violations(self, n: int = 1) -> None:
        """The state-conservation auditor (obs/audit.py) found ``n``
        violations: on the in-flight cycle's trace, or parked for the next
        one when the audit ran between cycles."""
        if self.current_trace is not None:
            self._bump("invariant_violations", int(n))
        else:
            self._pending_invariants += int(n)

    def note_oom_forensic(self, flag: str) -> None:
        """A device-loss or out-of-memory forensic flag for this cycle
        (``oom_forensic``), parked for the next cycle when the loss came
        between cycles (a warmup abort)."""
        if self.current_trace is not None:
            self.current_trace.fields["oom_forensic"] = flag
        else:
            self._pending_oom = flag

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
