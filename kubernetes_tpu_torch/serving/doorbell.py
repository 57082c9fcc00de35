"""The doorbell — wake-on-event for the serving loop.

The cycle-oriented loop sleeps a fixed ``--cycle-interval`` between
polls (cli.py), paying up to one full interval of create-to-bind latency
on a bursty queue and minting wakeups on an idle one. The doorbell is
the replacement signal: every source of schedulable work — the
SchedulingQueue's incoming events (PodAdd, PodUpdate, BackoffComplete,
the move-to-active sweeps the informer paths trigger), bind-path cache
invalidations, REST mutation handlers — rings it, and the serving loop
blocks on :meth:`Doorbell.wait` instead of a timer.

Semantics are level-triggered with a pending count (not edge-triggered):
a ring while nobody is waiting is remembered, so the classic lost-wakeup
race (event lands between the loop's depth check and its wait) cannot
drop work. ``ScheduleAttemptFailure`` deliberately does NOT ring — it is
the scheduler's own output, and ringing on it would spin the loop
against a queue of unschedulable pods that no cluster event has touched.

Thread-safe; waiting rides a ``threading.Condition`` (real time — the
serving loop is a real thread), but the ring/pending counters are
inspectable without blocking (``pending()`` / ``consume()``) so
fake-clock tests never sleep.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional


class Doorbell:
    """Level-triggered wakeup signal with per-reason ring accounting."""

    def __init__(self, metrics=None) -> None:
        self._cond = threading.Condition()
        self._pending = 0
        #: lifetime rings (monotone; pending is the unconsumed slice)
        self.rings_total = 0
        self.rings_by_reason: Dict[str, int] = {}
        #: optional SchedulerMetrics — drives
        #: scheduler_doorbell_rings_total{reason}
        self.metrics = metrics

    def ring(self, reason: str = "") -> None:
        """Signal that schedulable work may exist. Never blocks; safe
        from any thread (informer pumps, REST handler threads, the
        queue's own mutation paths)."""
        with self._cond:
            self._pending += 1
            self.rings_total += 1
            self.rings_by_reason[reason] = (
                self.rings_by_reason.get(reason, 0) + 1)
            self._cond.notify_all()
        m = self.metrics
        if m is not None:
            m.doorbell_rings.inc(reason=reason)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until rung or ``timeout`` (seconds; None = forever).
        Consumes every pending ring. Returns True when at least one ring
        arrived (before or during the wait), False on a clean timeout."""
        with self._cond:
            if self._pending == 0:
                self._cond.wait(timeout)
            rung = self._pending > 0
            self._pending = 0
            return rung

    def consume(self) -> int:
        """Non-blocking drain: pending ring count, resetting it to zero
        (the legacy serve loop's 'has anything happened since my last
        look' check; also what fake-clock tests poll)."""
        with self._cond:
            n, self._pending = self._pending, 0
            return n

    def pending(self) -> int:
        """Unconsumed rings (no reset)."""
        with self._cond:
            return self._pending
