"""Event recording — the client-go ``tools/events``/``tools/record``
analog (the port's copy of ``kubernetes_tpu/events.py``). The reference
scheduler emits Scheduled / FailedScheduling / Preempted events (scheduler.go:274,:335,:457) through a broadcaster that
aggregates duplicates (same object+reason+message bump a count rather than
creating new objects).

Here: a host-side :class:`EventRecorder` with the same aggregation,
fan-out to sinks (the hub shim posts them to the API; tests and the sim
read them directly)."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import Pod

TYPE_NORMAL = "Normal"
TYPE_WARNING = "Warning"

#: the reasons the scheduler emits (scheduler.go / eventhandlers)
REASON_SCHEDULED = "Scheduled"
REASON_FAILED = "FailedScheduling"
REASON_PREEMPTED = "Preempted"
#: degradation-ladder transitions (kubernetes_tpu/faults.py breakers):
#: a solver tier / extender breaker opened (solves now route to a
#: fallback tier) or closed again after a successful half-open probe
REASON_DEGRADED = "SchedulerDegraded"
REASON_RECOVERED = "SchedulerRecovered"
#: an assumed pod's bind confirmation never arrived within the assume
#: TTL — the cache freed its capacity and the driver requeued it
#: (scheduler._reap_expired_assumptions)
REASON_ASSUMPTION_EXPIRED = "AssumptionExpired"
#: the perf ledger's SLO watchdog (obs/ledger.py): an objective's
#: multi-window burn rate crossed the threshold (create-to-bind p99 or
#: cycle-cost drift), and the later fast-window recovery. Emitted on
#: state TRANSITIONS only, then spam-filtered by the recorder like
#: every other series — a burning hour costs a handful of sink posts.
REASON_SLO_BURN = "SchedulerSLOBurn"
REASON_SLO_RECOVERED = "SchedulerSLORecovered"
#: the state-conservation auditor (obs/audit.py) found a pod in two
#: states at once, a node over-committed by committed binds, a lost or
#: zombie-queued pod — always a correctness bug; spam-filtered by the
#: recorder like every other series so a persistent violation costs a
#: handful of sink posts, not one per audit
REASON_INVARIANT_VIOLATION = "InvariantViolation"

_REASON_TYPE = {
    REASON_SCHEDULED: TYPE_NORMAL,
    REASON_FAILED: TYPE_WARNING,
    REASON_PREEMPTED: TYPE_WARNING,
    REASON_DEGRADED: TYPE_WARNING,
    REASON_RECOVERED: TYPE_NORMAL,
    REASON_ASSUMPTION_EXPIRED: TYPE_WARNING,
    REASON_SLO_BURN: TYPE_WARNING,
    REASON_SLO_RECOVERED: TYPE_NORMAL,
    REASON_INVARIANT_VIOLATION: TYPE_WARNING,
}


@dataclass(frozen=True)
class ObjectRef:
    """A minimal involved-object handle for events about things that are
    not Pods (the scheduler component itself, a solver tier, an extender
    endpoint). Carries exactly what the recorder reads: ``key()`` and
    ``involved_kind``. Cluster-scoped refs keep an empty namespace, so
    ``involvedObject.namespace`` serves as ``""`` like the reference's
    cluster-scoped events."""

    name: str
    namespace: str = ""
    involved_kind: str = "Scheduler"

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class Event:
    type: str
    reason: str
    object_key: str  # namespace/name of the involved object
    message: str
    count: int = 1
    first_timestamp: float = 0.0
    last_timestamp: float = 0.0
    #: involvedObject.kind — the scheduler's recorder events are about
    #: Pods; controller-manager events name their own kind (Node for
    #: routes, Service for balancers, Job for TTL deletes, ...)
    involved_kind: str = "Pod"


class EventRecorder:
    """Aggregating recorder: events with the same (object, reason, message)
    within the aggregation window bump ``count`` (the
    EventAggregator/eventBroadcaster behavior that keeps event storms from
    flooding etcd).

    Sink fan-out is SPAM-FILTERED like the reference correlator
    (client-go record/events_cache.go EventSourceObjectSpamFilter): a
    recurrence of the same series bumps ``count`` in place, but sinks —
    the API writes — are notified only at exponentially spaced counts
    (1, 2, 4, 8, ...) or after ``sink_refresh_s`` of silence on the
    series. An unschedulable pod failing 50 consecutive cycles used to
    cost 50 identical FailedScheduling sink posts; now it costs 6 while
    ``count`` (and any stored Event reference — the sink hands out the
    live object) still reads 50."""

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        sinks: Optional[List[Callable[[Event], None]]] = None,
        max_events: int = 10000,
        sink_refresh_s: float = 300.0,
    ) -> None:
        self.clock = clock
        self.sinks = sinks or []
        self.max_events = max_events
        #: a quiet series re-notifies sinks after this long even between
        #: count milestones, so slow drips still reach the hub fresh
        self.sink_refresh_s = sink_refresh_s
        self._events: Dict[Tuple[str, str, str], Event] = {}
        #: series key -> (next count milestone, last sink-notify time)
        self._sink_state: Dict[Tuple[str, str, str], Tuple[int, float]] = {}

    def event(self, reason: str, pod: Pod, message: str) -> Event:
        now = self.clock()
        key = (pod.key(), reason, message)
        ev = self._events.get(key)
        if ev is not None:
            ev.count += 1
            ev.last_timestamp = now
        else:
            if len(self._events) >= self.max_events:
                # drop the oldest (bounded store; the hub is the real sink)
                oldest = min(self._events, key=lambda k: self._events[k].last_timestamp)
                del self._events[oldest]
                self._sink_state.pop(oldest, None)
            ev = Event(
                type=_REASON_TYPE.get(reason, TYPE_NORMAL),
                reason=reason,
                object_key=pod.key(),
                message=message,
                first_timestamp=now,
                last_timestamp=now,
                # non-Pod involved objects (ObjectRef, nodes) carry their
                # kind; plain Pods keep the default
                involved_kind=getattr(pod, "involved_kind", "Pod"),
            )
            self._events[key] = ev
        milestone, last_notify = self._sink_state.get(key, (1, -1e18))
        if ev.count >= milestone or now - last_notify >= self.sink_refresh_s:
            self._sink_state[key] = (max(milestone, ev.count * 2), now)
            for sink in self.sinks:
                sink(ev)
        return ev

    def sink(self) -> Callable[[str, Pod, str], None]:
        """Adapter matching the driver's event_sink signature."""
        return lambda reason, pod, message: self.event(reason, pod, message)

    def events(self, object_key: Optional[str] = None) -> List[Event]:
        evs = list(self._events.values())
        if object_key is not None:
            evs = [e for e in evs if e.object_key == object_key]
        return sorted(evs, key=lambda e: e.first_timestamp)
