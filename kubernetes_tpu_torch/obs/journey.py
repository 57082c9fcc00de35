"""Per-pod journey tracer: where did this pod's seconds go? (A copy of
``kubernetes_tpu/obs/journey.py``.)

Every observability layer before this one (trace spans, flight
recorder, perf ledger, memory ledger) is CYCLE-scoped: when
``scheduler_e2e_scheduling_duration_seconds`` shows a bad p99 none of
them can say which pod was slow or where its end-to-end latency went —
queue wait vs backoff vs ambiguous-bind parking vs solve. The
:class:`JourneyTracker` closes that gap: a bounded per-pod record fed
from the HOST seams the driver already owns (informer add, sub-queue
enter/exit, per-cycle attempt rows, Permit park, fenced bind,
ambiguous park/resolution, preemption eviction, bind RPC, confirm),
decomposing each bound pod's e2e latency into disjoint phase shares:

======================  =================================================
phase                   the pod was ...
======================  =================================================
``queue-wait``          in activeQ / unschedulableQ waiting for a cycle
``backoff``             serving its per-pod failure backoff window
``solve``               popped into an in-flight cycle (snapshot through
                        device solve through explain)
``bind-rpc``            inside the bind RPC (PreBind through confirm)
``ambiguous``           parked awaiting read-your-write resolution of an
                        ambiguous bind timeout (PR 15)
``permit``              parked on a Permit plugin wait
======================  =================================================

The tracker is pure host bookkeeping over the injected clock — zero
device syncs, no torch import — and every mutation takes one lock built
through the scheduler's lock sanitizer (the /debug/journeys handler
thread reads concurrently).

Retention is deliberately three-tiered so the interesting pods survive
without unbounded growth: ALL pending journeys (capped at
``max_pending``; beyond the cap new pods are counted, not tracked),
the slowest-K completed journeys per rolling ``window_s`` window, and
an unconditional 1-in-N completion sample (``sample_every``) so a
healthy fleet still shows representative timelines, not just its tail.
"""

from __future__ import annotations

import bisect
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch.sanitize import make_lock

#: internal pod state -> the phase its elapsed time accrues to. The
#: states mirror the queue's sub-queues plus the driver's park points;
#: phases are the public vocabulary (metric label, /debug shares).
PHASE_OF = {
    "active": "queue-wait",
    "unschedulable": "queue-wait",
    "backoff": "backoff",
    "solving": "solve",
    "binding": "bind-rpc",
    "ambiguous": "ambiguous",
    "permit": "permit",
}

#: the closed phase vocabulary, in display order. Bound pods observe
#: EVERY phase (zeros included) so the histogram's per-phase sample
#: counts stay comparable across phases.
PHASES = ("queue-wait", "backoff", "solve", "bind-rpc", "ambiguous",
          "permit")


class Journey:
    """One pod's life, from informer add to confirm (or deletion).

    Plain attribute bag — the tracker owns all mutation under its
    lock; handlers only ever see :meth:`to_json` copies."""

    __slots__ = ("key", "uid", "created_at", "state", "state_since",
                 "phases", "events", "attempts", "elided", "done",
                 "outcome", "finished_at", "e2e_s")

    def __init__(self, key: str, uid: str, now: float) -> None:
        self.key = key
        self.uid = uid
        self.created_at = now
        self.state = "active"
        self.state_since = now
        self.phases: Dict[str, float] = {}
        self.events: List[tuple] = [(now, "created", "")]
        self.attempts: List[dict] = []
        self.elided = 0          # events dropped beyond max_events
        self.done = False
        self.outcome = ""        # "" | bound | gone
        self.finished_at = 0.0
        self.e2e_s = 0.0

    def to_json(self) -> dict:
        total = sum(self.phases.values())
        return {
            "pod": self.key,
            "uid": self.uid,
            "created_at": round(self.created_at, 6),
            "state": self.state,
            "done": self.done,
            "outcome": self.outcome,
            "e2e_s": round(self.e2e_s, 6),
            "phases_s": {k: round(v, 6)
                         for k, v in sorted(self.phases.items())},
            "phase_share": {k: round(v / total, 4)
                            for k, v in sorted(self.phases.items())}
            if total > 0 else {},
            "attempts": list(self.attempts),
            "events": [{"t": round(t, 6), "event": e, "detail": d}
                       for (t, e, d) in self.events],
            "events_elided": self.elided,
        }


class JourneyTracker:
    """The bounded per-pod journey store + its retention policy.

    ``config``: :class:`kubernetes_tpu_torch.config.JourneysConfig` (duck —
    any object with the same fields; ``None`` uses defaults).
    ``metrics``: a :class:`kubernetes_tpu_torch.metrics.SchedulerMetrics`
    (``pod_journey_phase_seconds`` / ``pod_journeys_total``)."""

    def __init__(self, config=None, metrics=None,
                 clock: Callable[[], float] = time.monotonic,
                 lock_factory=None) -> None:
        if config is None:
            from kubernetes_tpu_torch.config import JourneysConfig

            config = JourneysConfig()
        self.config = config
        self.metrics = metrics
        #: per-phase precomputed-label observe handles — six histogram
        #: observes run per BOUND POD, so the label-key derivation is
        #: hoisted out of the bind path (Histogram.child)
        self._phase_observe = (
            {ph: metrics.pod_journey_phase_seconds.child(phase=ph)
             for ph in PHASES} if metrics is not None else None)
        self.clock = clock
        self._lock = make_lock(lock_factory, "obs.journeys")
        #: pod key -> in-flight Journey (bounded by max_pending)
        self._pending: Dict[str, Journey] = {}
        #: completed retention: the slowest-K within the rolling window
        self._slowest: List[Journey] = []
        #: oldest finished_at retained in _slowest — lets _retain's
        #: hot path prove nothing expired without scanning the list
        self._slowest_oldest = 0.0
        #: unconditional 1-in-N completion sample ring
        self._sampled: deque = deque(
            maxlen=max(int(getattr(config, "slow_k", 8)), 4))
        #: journeys touched by the in-flight cycle — finish_cycle
        #: backfills tier/scope onto exactly these attempt rows
        self._cycle_touched: List[dict] = []
        self.created_total = 0
        self.bound_total = 0
        self.gone_total = 0
        #: pods seen while _pending was at capacity — counted, untracked
        self.dropped_total = 0
        self._completed_seq = 0

    @property
    def enabled(self) -> bool:
        return bool(getattr(self.config, "enabled", False))

    # -- seam notes (queue + scheduler call these) --------------------------

    def note_created(self, key: str, uid: str = "") -> None:
        """Informer add landed the pod in the active queue."""
        if not self.enabled:
            return
        with self._lock:
            if key in self._pending:
                return
            if len(self._pending) >= int(self.config.max_pending):
                self.dropped_total += 1
                return
            self._pending[key] = Journey(key, uid, self.clock())
            self.created_total += 1

    def _event(self, j: Journey, name: str, detail: str,
               now: float) -> None:
        if len(j.events) >= int(self.config.max_events):
            j.elided += 1
            return
        j.events.append((now, name, detail))

    def _transition(self, j: Journey, state: str, now: float) -> None:
        phase = PHASE_OF.get(j.state)
        if phase is not None:
            j.phases[phase] = (j.phases.get(phase, 0.0)
                               + max(now - j.state_since, 0.0))
        j.state = state
        j.state_since = now

    def note_queue(self, key: str, queue: str) -> None:
        """The pod moved between sub-queues (active | backoff |
        unschedulable) — the PR-4 queue residency seam."""
        if not self.enabled:
            return
        state = queue if queue in ("active", "backoff",
                                   "unschedulable") else None
        if state is None:
            return
        with self._lock:
            j = self._pending.get(key)
            if j is None or j.done:
                return
            now = self.clock()
            self._transition(j, state, now)
            self._event(j, "queue", queue, now)

    def note_popped(self, key: str, cycle: int) -> None:
        """pop_batch handed the pod to an in-flight cycle."""
        if not self.enabled:
            return
        with self._lock:
            j = self._pending.get(key)
            if j is None or j.done:
                return
            now = self.clock()
            self._transition(j, "solving", now)
            self._event(j, "popped", f"cycle={cycle}", now)

    def note_attempt_failed(self, key: str, cycle: int,
                            reason: str) -> None:
        """The cycle failed the pod (PreFilter, solver, explain, bind
        error ...). The attempt row's tier/scope are backfilled by
        :meth:`finish_cycle` — they are only known once the cycle
        closes."""
        if not self.enabled:
            return
        with self._lock:
            j = self._pending.get(key)
            if j is None or j.done:
                return
            now = self.clock()
            row = {"cycle": int(cycle), "outcome": "failed",
                   "reason": reason, "tier": "", "scope": ""}
            if len(j.attempts) < int(self.config.max_events):
                j.attempts.append(row)
                self._cycle_touched.append(row)
            self._event(j, "failed", reason, now)

    def note_bind_start(self, key: str) -> None:
        """The bind RPC is about to run (PreBind passed)."""
        if not self.enabled:
            return
        with self._lock:
            j = self._pending.get(key)
            if j is None or j.done:
                return
            now = self.clock()
            self._transition(j, "binding", now)
            self._event(j, "bind-start", "", now)

    def note_permit_park(self, key: str, plugin: str = "") -> None:
        """A Permit plugin parked the pod (WAIT verdict)."""
        if not self.enabled:
            return
        with self._lock:
            j = self._pending.get(key)
            if j is None or j.done:
                return
            now = self.clock()
            self._transition(j, "permit", now)
            self._event(j, "permit-park", plugin, now)

    def note_ambiguous_park(self, key: str, origin: str = "") -> None:
        """An ambiguous bind timeout parked the pod for read-your-write
        resolution (PR 15). ``origin`` distinguishes the in-cycle park
        from the expired-assumption reap park."""
        if not self.enabled:
            return
        with self._lock:
            j = self._pending.get(key)
            if j is None:
                return
            now = self.clock()
            if j.done:
                # a reap-origin park can reopen a journey whose bind
                # already confirmed; keep the event, don't re-time
                self._event(j, "ambiguous-park", origin, now)
                return
            self._transition(j, "ambiguous", now)
            self._event(j, "ambiguous-park", origin, now)

    def note_fenced(self, key: str) -> None:
        """The lease fence aborted this pod's bind."""
        if not self.enabled:
            return
        with self._lock:
            j = self._pending.get(key)
            if j is None or j.done:
                return
            self._event(j, "fenced", "", self.clock())

    def note_evicted(self, key: str, by: str = "") -> None:
        """The pod was chosen as a preemption victim."""
        if not self.enabled:
            return
        with self._lock:
            j = self._pending.get(key)
            if j is None or j.done:
                return
            self._event(j, "evicted", by, self.clock())

    def note_bound(self, key: str, cycle: int = 0) -> None:
        """Bind confirmed — close the journey, observe the phase
        histogram (every phase, zeros included), run retention."""
        if not self.enabled:
            return
        with self._lock:
            j = self._pending.pop(key, None)
            if j is None or j.done:
                return
            now = self.clock()
            self._transition(j, "bound", now)
            self._event(j, "bound", f"cycle={cycle}", now)
            row = {"cycle": int(cycle), "outcome": "bound",
                   "reason": "", "tier": "", "scope": ""}
            if len(j.attempts) < int(self.config.max_events):
                j.attempts.append(row)
                self._cycle_touched.append(row)
            j.done = True
            j.outcome = "bound"
            j.finished_at = now
            j.e2e_s = max(now - j.created_at, 0.0)
            self.bound_total += 1
            self._retain(j, now)
        if self._phase_observe is not None:
            phases = j.phases
            for phase, observe in self._phase_observe.items():
                observe(phases.get(phase, 0.0))
            self.metrics.pod_journeys_total.inc(outcome="bound")

    def note_gone(self, key: str) -> None:
        """The pod left the scheduler's responsibility unbound (watch
        delete, terminating skip, reconcile prune, not-ours
        transition)."""
        if not self.enabled:
            return
        with self._lock:
            j = self._pending.pop(key, None)
            if j is None:
                return
            now = self.clock()
            self._transition(j, "gone", now)
            self._event(j, "gone", "", now)
            j.done = True
            j.outcome = "gone"
            j.finished_at = now
            j.e2e_s = max(now - j.created_at, 0.0)
            self.gone_total += 1
        if self.metrics is not None:
            self.metrics.pod_journeys_total.inc(outcome="gone")

    def finish_cycle(self, cycle: int, tier: str, scope: str) -> None:
        """The cycle closed: backfill the ladder tier and solve scope
        onto every attempt row this cycle touched (both are only known
        after the solve ran)."""
        if not self.enabled:
            return
        with self._lock:
            for row in self._cycle_touched:
                if row["cycle"] == cycle:
                    row["tier"] = tier
                    row["scope"] = scope
            self._cycle_touched = []

    # -- retention ----------------------------------------------------------

    def _retain(self, j: Journey, now: float) -> None:
        # caller holds the lock
        self._completed_seq += 1
        n = int(getattr(self.config, "sample_every", 0))
        if n > 0 and self._completed_seq % n == 0:
            self._sampled.append(j)
        window = float(self.config.window_s)
        k = int(self.config.slow_k)
        slow = self._slowest
        # hot path: the common completion neither beats the slowest-K
        # floor nor expires anything — two comparisons, no rebuild.
        # This runs once per BOUND POD, so the filter+sort below must
        # stay off the contended-cycle bind path.
        if (len(slow) >= k and j.e2e_s <= slow[0].e2e_s
                and now - self._slowest_oldest <= window):
            return
        if now - self._slowest_oldest > window:
            slow = [r for r in slow if now - r.finished_at <= window]
            # eviction below can strand a stale (too-old) oldest; that
            # only costs an extra pass through this branch, never a
            # wrongly-retained entry
            self._slowest_oldest = min(
                (r.finished_at for r in slow), default=now)
        # the list is kept ASCENDING by e2e (slowest last): a
        # qualifying completion is one C-level insort + one head pop,
        # not a Python-keyed sort — under a latency ramp (overload)
        # EVERY completion qualifies, so this runs per bound pod
        bisect.insort(slow, j, key=lambda r: r.e2e_s)
        if len(slow) > k:
            del slow[0]
        self._slowest = slow

    # -- read side ----------------------------------------------------------

    def sizes(self) -> Dict[str, int]:
        """Occupancy for ``Scheduler.state_sizes()`` / the soak
        sentinels: everything here must plateau or drain."""
        with self._lock:
            return {"journey_pending": len(self._pending),
                    "journey_slowest": len(self._slowest),
                    "journey_sampled": len(self._sampled)}

    def inflight_slowest(self, k: int) -> List[dict]:
        """The k in-flight journeys that have been pending longest —
        the incident recorder's 'who is hurting right now' slice."""
        with self._lock:
            now = self.clock()
            rows = sorted(self._pending.values(),
                          key=lambda j: j.created_at)[:max(int(k), 0)]
            out = []
            for j in rows:
                d = j.to_json()
                d["pending_s"] = round(max(now - j.created_at, 0.0), 6)
                out.append(d)
            return out

    def timeline(self, key: str) -> Optional[dict]:
        """Full journey for one pod key (pending first, then the
        completed retention tiers) — the ``/debug/journeys?pod=`` body."""
        with self._lock:
            j = self._pending.get(key)
            if j is None:
                for r in self._slowest:
                    if r.key == key:
                        j = r
                        break
            if j is None:
                for r in self._sampled:
                    if r.key == key:
                        j = r
                        break
            return None if j is None else j.to_json()

    def keys(self) -> List[str]:
        """Every key currently resolvable by :meth:`timeline`."""
        with self._lock:
            seen = dict.fromkeys(self._pending)
            for r in self._slowest:
                seen.setdefault(r.key)
            for r in self._sampled:
                seen.setdefault(r.key)
            return list(seen)

    def snapshot(self) -> dict:
        """The bare ``/debug/journeys`` body: counters + the slowest-K
        completed table + the oldest in-flight rows."""
        with self._lock:
            # stored ascending (insort); presented slowest-first
            slowest = [j.to_json() for j in reversed(self._slowest)]
            pending = len(self._pending)
            counters = {"created": self.created_total,
                        "bound": self.bound_total,
                        "gone": self.gone_total,
                        "dropped": self.dropped_total}
        return {
            "enabled": self.enabled,
            "pending": pending,
            **counters,
            "slowest": slowest,
            "inflight": self.inflight_slowest(
                int(getattr(self.config, "slow_k", 8))),
        }
