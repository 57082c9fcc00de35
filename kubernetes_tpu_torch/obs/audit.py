"""State-conservation auditor — the invariant checker that turns "never
double-place, never lose a pod" from a test assertion into a runtime
surface (the port's copy of ``kubernetes_tpu/obs/audit.py``).

The scheduler's state machine distributes every pod it knows across a
small set of disjoint states: *queued* (one of the three sub-queues),
*assumed* (capacity held, bind in flight or Permit-parked — the cache's
ASSUMED/EXPIRING states), *bound* (watch-confirmed ADDED), or *gone*
(deleted, or terminal). The chaos suites assert those invariants
at test time; under NETWORK faults (ambiguous bind timeouts, fuzzed
watch streams, relist storms) the failure modes are subtle
enough that production needs the checker running online:

``multi-state``       a pod in a queue AND the cache at once (its
                      capacity would be double-counted, and a queued
                      copy of a bound pod is a double-bind in waiting)
``capacity``          a node over-committed by COMMITTED binds (cache
                      pods' effective requests exceed allocatable cpu /
                      memory / pod count)
``lost-pod``          a pod left every local state with no explaining
                      exit — it was neither bound nor deleted (the
                      conservation rule: per-audit deltas must conserve
                      pods); with hub truth provided, also a truth-
                      pending responsible pod tracked nowhere locally
``double-bind-risk``  (truth mode) a hub-bound pod still sitting in a
                      scheduling queue — the exact prelude of a second
                      bind RPC reaching the hub CAS
``stale-entry``       (truth mode) a cached/queued pod the hub no
                      longer contains

Truth-mode checks use a TWO-STRIKE rule (a violation must persist
across two consecutive audits) because the informer feed is eventually
consistent by design — watch lag alone must never page anyone.

Violations land on ``scheduler_invariant_violations_total{invariant}``,
as a spam-filtered ``InvariantViolation`` event, and as the cycle
trace's ``invariant_violations`` field and the flight record's
``invariants=`` flag (``Obs.note_invariant_violations``). The chaos suites run :meth:`audit` continuously with
hub truth; :class:`~kubernetes_tpu_torch.serving.compose.ServingRuntime`
runs the structural checks at ``observability.audit_interval_s``.

Pure host code: dict walks over the queue/cache surfaces, no device
work, no clocks beyond the owner's.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Set

from kubernetes_tpu_torch.api.types import is_pod_terminated

#: every invariant the auditor can report — the metric label vocabulary
INVARIANTS = ("multi-state", "capacity", "lost-pod",
              "double-bind-risk", "stale-entry")


@dataclass
class Violation:
    """One invariant breach: which invariant, the subject (pod key or
    node name), and a human-readable detail line."""

    invariant: str
    subject: str
    detail: str


class StateAuditor:
    """Continuous invariant checker over a live Scheduler.

    ``audit(sched)`` runs the structural checks (multi-state, capacity,
    truthless conservation); ``audit(sched, truth_pods=...)`` adds the
    hub-truth conservation checks. Attach to a scheduler
    (``sched.attach_auditor(auditor)``) so legitimate exits — watch
    deletes, deletion-timestamp skips, reconcile drops — are reported
    via :meth:`note_gone` and never read as lost pods."""

    def __init__(self, metrics=None, event_sink=None, obs=None,
                 keep: int = 64) -> None:
        self.metrics = metrics
        self.event_sink = event_sink
        self.obs = obs
        self.audits = 0
        self.violations_total = 0
        #: ring of recent violations (postmortem surface)
        self.recent: deque = deque(maxlen=max(1, keep))
        #: keys whose exit from all local states is EXPLAINED (watch
        #: delete, deletion-timestamp skip, reconcile drop) since the
        #: last audit — the conservation rule's "gone" bucket
        self._gone: Set[str] = set()
        #: last audit's local state per key (the conservation baseline)
        self._last_states: Optional[Dict[str, str]] = None
        #: truth-mode two-strike memory: candidate violations seen last
        #: audit, confirmed only if still present this audit
        self._truth_strikes: Set[tuple] = set()

    # -- exit accounting (wired by Scheduler.attach_auditor) ---------------

    def note_gone(self, key: str) -> None:
        """A pod legitimately left the scheduler's state machine
        (deleted by the watch, dropped as terminating, removed by a
        takeover reconcile) — conservation must not count it lost."""
        self._gone.add(key)

    # -- the audit ---------------------------------------------------------

    def _local_states(self, sched) -> Dict[str, List[str]]:
        """key -> list of local states the pod currently occupies.
        Disjointness is the invariant: len > 1 is a violation."""
        states: Dict[str, List[str]] = {}
        pending = sched.queue.pending_pods()
        for sub, pods in pending.items():
            for p in pods:
                states.setdefault(p.key(), []).append(f"queued:{sub}")
        for key, st in sched.cache.pod_states().items():
            states.setdefault(key, []).append(st)
        return states

    def audit(self, sched, truth_pods=None) -> List[Violation]:
        """Run every applicable invariant; record, count, and return the
        violations (empty list = clean)."""
        out: List[Violation] = []
        states = self._local_states(sched)

        # 1. exactly-one-state: queued, assumed, and bound are disjoint
        for key, occ in states.items():
            if len(occ) > 1:
                out.append(Violation(
                    "multi-state", key,
                    f"pod occupies {len(occ)} states at once: "
                    f"{', '.join(sorted(occ))}"))

        # 2. capacity: committed binds never exceed a node's allocatable.
        # The cpu and memory of a pod's effective requests are its
        # requests' own (``effective_requests`` copies them to set the pod
        # count), so the sweep reads them without the copy
        for nd in sched.cache.nodes():
            pods = sched.cache.pods_on(nd.name)
            if not pods:
                continue
            cpu = mem = 0.0
            for p in pods:
                cpu += p.requests.cpu_milli
                mem += p.requests.memory
            alloc = nd.allocatable
            if (cpu > alloc.cpu_milli + 1e-6 or mem > alloc.memory + 1e-6
                    or len(pods) > alloc.pods):
                out.append(Violation(
                    "capacity", nd.name,
                    f"node over-committed by committed binds: "
                    f"cpu {cpu:.0f}/{alloc.cpu_milli:.0f}m "
                    f"mem {mem / 2**20:.0f}/{alloc.memory / 2**20:.0f}Mi "
                    f"pods {len(pods)}/{alloc.pods}"))

        # 3. conservation (truthless): every key of the previous audit
        # is still in some state, was bound (its exit may be a delete
        # whose event is still in flight... no: bound exits also
        # note_gone via the watch), or left through an explained exit
        if self._last_states is not None:
            for key, occ in self._last_states.items():
                if key in states or key in self._gone:
                    continue
                if any(s == "bound" for s in occ):
                    # a bound pod's only exit is deletion; its watch
                    # DELETE also lands in _gone, but a foreign-owned
                    # removal (node delete sweep) may not — bound exits
                    # are never "lost" in the double-bind sense
                    continue
                out.append(Violation(
                    "lost-pod", key,
                    f"pod left every local state (was {occ}) with no "
                    "bind, delete, or reconcile explaining the exit"))

        # 4/5. truth-mode conservation, two-strike confirmed
        strikes: Set[tuple] = set()
        if truth_pods is not None:
            truth = {p.key(): p for p in truth_pods}
            waiting = {wp.pod.key()
                       for wp in sched.framework.waiting.items()}
            for key, tp in truth.items():
                if is_pod_terminated(tp):
                    continue
                if tp.node_name:
                    if any(s.startswith("queued")
                           for s in states.get(key, ())):
                        strikes.add(("double-bind-risk", key))
                        if ("double-bind-risk", key) in self._truth_strikes:
                            out.append(Violation(
                                "double-bind-risk", key,
                                f"hub-bound pod (-> {tp.node_name}) still "
                                "in a scheduling queue two audits in a "
                                "row — a second bind RPC is imminent"))
                elif sched.responsible_for(tp):
                    # only pods the scheduler PREVIOUSLY tracked count:
                    # a pod the informer never delivered is a stream-
                    # health gap (the stall/relist machinery's job),
                    # not a conservation leak of the state machine. The
                    # strike itself carries the was-tracked memory — the
                    # rolled baseline no longer holds the key by the
                    # confirming audit.
                    was_tracked = (self._last_states is not None
                                   and key in self._last_states)
                    prior = ("lost-pod", key) in self._truth_strikes
                    if (key not in states and key not in waiting
                            and (was_tracked or prior)):
                        strikes.add(("lost-pod", key))
                        if prior:
                            out.append(Violation(
                                "lost-pod", key,
                                "truth-pending responsible pod left "
                                "every local state two audits in a row"))
            for key in states:
                if key not in truth:
                    strikes.add(("stale-entry", key))
                    if ("stale-entry", key) in self._truth_strikes:
                        out.append(Violation(
                            "stale-entry", key,
                            "locally tracked pod the hub no longer "
                            "contains (two audits in a row)"))
            # the two-strike memory rolls ONLY on truth audits: a
            # structural sweep interleaved between them (the serving
            # runtime's truthless 2 Hz pass) skipped every truth check
            # and must not reset a pending strike — "two consecutive
            # audits" means two consecutive audits THAT LOOKED
            self._truth_strikes = strikes

        # roll the baselines AFTER the checks
        self._last_states = {k: list(v) for k, v in states.items()}
        self._gone.clear()
        self.audits += 1
        self._publish(out)
        return out

    def _publish(self, violations: List[Violation]) -> None:
        if not violations:
            return
        self.violations_total += len(violations)
        self.recent.extend(violations)
        for v in violations:
            if self.metrics is not None:
                self.metrics.invariant_violations.inc(invariant=v.invariant)
            if self.event_sink is not None:
                from kubernetes_tpu_torch.events import (
                    REASON_INVARIANT_VIOLATION,
                    ObjectRef,
                )

                ns, _, name = v.subject.partition("/")
                ref = (ObjectRef(name=name, namespace=ns,
                                 involved_kind="Pod") if name
                       else ObjectRef(name=v.subject,
                                      involved_kind="Node"))
                self.event_sink(REASON_INVARIANT_VIOLATION, ref,
                                f"{v.invariant}: {v.detail}")
        if self.obs is not None:
            note = getattr(self.obs, "note_invariant_violations", None)
            if note is not None:
                note(len(violations))

    def report(self) -> dict:
        """Bench/chaos summary block."""
        return {
            "audits": self.audits,
            "invariant_violations": self.violations_total,
            "recent": [
                {"invariant": v.invariant, "subject": v.subject,
                 "detail": v.detail}
                for v in list(self.recent)[-8:]
            ],
        }
