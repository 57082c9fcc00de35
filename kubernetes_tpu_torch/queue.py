"""Scheduling queue — host-side parity with the reference's 3-queue
``PriorityQueue`` (``pkg/scheduler/internal/queue/scheduling_queue.go``):

- ``activeQ``     — heap ordered by (priority desc, enqueue time asc), the
  pods ready to schedule (``scheduling_queue.go:107``).
- ``podBackoffQ`` — heap by backoff-expiry time; pods that failed recently
  and must wait out an exponential backoff (initial 1 s, max 10 s — the
  values the factory wires in ``factory.go``; ``pod_backoff.go:27``).
- ``unschedulableQ`` — a map of pods that failed with no cluster event since
  that could make them schedulable (``scheduling_queue.go:368`` flushes
  leftovers after 60 s: ``unschedulableQTimeInterval`` ``:52``).

The lost-wakeup defense is the pair of cycle counters
(``scheduling_queue.go:127-134``): ``schedulingCycle`` increments on every
Pop; ``moveRequestCycle`` is stamped by MoveAllToActiveQueue. A pod that
failed in cycle C goes to backoff (not unschedulableQ) if a move request
happened at/after C — the event it missed might have been the one it needs.

The nominated-pods map (``scheduling_queue.go:740`` nominatedPodMap) tracks
pods nominated onto nodes by preemption so the filter pass can run its
two-pass rule (``generic_scheduler.go:610`` podFitsOnNode).

Differences from the reference, by design: no goroutines/locks — the driver
is single-threaded around device dispatch, so flushes are explicit ``tick``
calls (the reference's 1 s/30 s wait.Until loops,
``scheduling_queue.go:202-205``), and Pop is the batched non-blocking
``pop_batch`` feeding whole-queue device scheduling.
"""

from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.api.types import Pod

#: Backoff window — factory.go wires NewPodBackoffMap(1s, 10s).
INITIAL_BACKOFF_S = 1.0
MAX_BACKOFF_S = 10.0
#: scheduling_queue.go:52 unschedulableQTimeInterval.
UNSCHEDULABLEQ_FLUSH_S = 60.0


class PodBackoffMap:
    """Exponential per-pod backoff (``pod_backoff.go:27``): attempts counted
    per pod key; backoff = initial * 2^(attempts-1), capped."""

    def __init__(self, initial: float = INITIAL_BACKOFF_S, maximum: float = MAX_BACKOFF_S):
        self.initial = initial
        self.maximum = maximum
        self._attempts: Dict[str, int] = {}
        self._last_update: Dict[str, float] = {}

    def backoff_pod(self, key: str, now: float) -> None:
        self._attempts[key] = self._attempts.get(key, 0) + 1
        self._last_update[key] = now

    def backoff_time(self, key: str) -> float:
        """Absolute time the pod's backoff expires (0 if never backed off)."""
        n = self._attempts.get(key, 0)
        if n == 0:
            return 0.0
        d = min(self.initial * (2.0 ** (n - 1)), self.maximum)
        return self._last_update[key] + d

    def attempts(self, key: str) -> int:
        """Failed attempts recorded for the pod (the explain/metrics
        surface: scheduling attempts = failures + the current try)."""
        return self._attempts.get(key, 0)

    def clear_pod(self, key: str) -> None:
        self._attempts.pop(key, None)
        self._last_update.pop(key, None)


@dataclass(order=True)
class _ActiveEntry:
    sort_key: Tuple[int, float, int]
    pod: Pod = field(compare=False)


class NominatedPodMap:
    """scheduling_queue.go:740 — pods nominated to run on nodes (preemption
    victims' capacity is reserved for them while they retry)."""

    def __init__(self) -> None:
        self._by_node: Dict[str, List[Pod]] = {}
        self._node_of: Dict[str, str] = {}

    def add(self, pod: Pod, node_name: str = "") -> None:
        node = node_name or getattr(pod, "nominated_node_name", "") or ""
        if not node:
            return
        self.delete(pod)
        self._node_of[pod.key()] = node
        self._by_node.setdefault(node, []).append(pod)

    def delete(self, pod: Pod) -> None:
        node = self._node_of.pop(pod.key(), None)
        if node is None:
            return
        pods = self._by_node.get(node, [])
        self._by_node[node] = [p for p in pods if p.key() != pod.key()]
        if not self._by_node[node]:
            del self._by_node[node]

    def update(self, old: Pod, new: Pod, node_name: str = "") -> None:
        self.delete(old)
        self.add(new, node_name)

    def pods_for_node(self, node_name: str) -> List[Pod]:
        return list(self._by_node.get(node_name, ()))

    def items(self) -> List[Tuple[str, List[Pod]]]:
        return [(n, list(ps)) for n, ps in self._by_node.items()]

    def node_of(self, pod_key: str) -> Optional[str]:
        return self._node_of.get(pod_key)

    def __len__(self) -> int:
        return len(self._node_of)


class _CmpKey:
    """heapq adapter for a custom less(podA, podB) comparator; the seq
    breaks ties stably."""

    __slots__ = ("less", "pod", "seq")

    def __init__(self, less, pod: Pod, seq: int) -> None:
        self.less, self.pod, self.seq = less, pod, seq

    def __lt__(self, other: "_CmpKey") -> bool:
        if self.less(self.pod, other.pod):
            return True
        if self.less(other.pod, self.pod):
            return False
        return self.seq < other.seq


class SchedulingQueue:
    """The 3-queue priority structure. All times come from the injected
    ``clock`` so tests are deterministic."""

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        less: Optional[Callable[[Pod, Pod], bool]] = None,
        metrics=None,
    ) -> None:
        self.clock = clock
        self._seq = itertools.count()
        self._active: List[_ActiveEntry] = []  # heap
        self._backoff: List[Tuple[float, int, str]] = []  # (expiry, seq, key) heap
        self._unschedulable: Dict[str, Tuple[Pod, float]] = {}  # key -> (pod, added)
        self._in_active: Dict[str, Pod] = {}
        self._in_backoff: Dict[str, Pod] = {}
        self.backoff_map = PodBackoffMap()
        self.nominated = NominatedPodMap()
        self.scheduling_cycle = 0
        self.move_request_cycle = -1
        #: custom QueueSort comparator (framework queue-sort plugin,
        #: interface.go:131); None = priority desc then arrival asc.
        self._less = less
        #: optional SchedulerMetrics: the queue drives
        #: scheduler_queue_incoming_pods_total{event}, the per-sub-queue
        #: scheduler_queue_pod_age_seconds{queue} residency histograms,
        #: and keeps scheduler_pending_pods{queue} fresh on EVERY
        #: mutation (not just at cycle boundaries). The scheduler
        #: attaches its metrics object; standalone queues stay silent.
        self.metrics = metrics
        #: key -> (sub-queue, enter time) for residency accounting
        self._entered: Dict[str, Tuple[str, float]] = {}
        #: optional serving.Doorbell — rung on every incoming event that
        #: ADDS schedulable work (PodAdd/PodUpdate/BackoffComplete/
        #: the move-to-active sweeps). ScheduleAttemptFailure does not
        #: ring: it is the scheduler's own output, and ringing on it
        #: would spin the serving loop against pods no cluster event
        #: has made schedulable. The scheduler attaches it
        #: (Scheduler.attach_doorbell); standalone queues stay silent.
        self.doorbell = None
        #: optional obs.journey.JourneyTracker — fed the pod's
        #: sub-queue transitions (the phase boundaries of queue-wait /
        #: backoff time) and the pop-into-cycle edge. The scheduler
        #: attaches it (same duck pattern as metrics/doorbell);
        #: standalone queues stay silent.
        self.journeys = None

    # -- metrics plumbing --------------------------------------------------

    def _note_enter(self, key: str, queue: str) -> None:
        prev = self._entered.get(key)
        if prev is not None and prev[0] == queue:
            # in-place update / re-add within the same sub-queue: the pod
            # never left, so no exit sample and the original stamp stands
            # (same reason update() preserves queued_at)
            return
        if prev is not None and self.metrics is not None:
            q, t = prev
            self.metrics.queue_pod_age.observe(
                max(self.clock() - t, 0.0), queue=q)
        self._entered[key] = (queue, self.clock())
        if self.journeys is not None:
            self.journeys.note_queue(key, queue)

    def _note_exit(self, key: str) -> None:
        ent = self._entered.pop(key, None)
        if ent is not None and self.metrics is not None:
            q, t = ent
            self.metrics.queue_pod_age.observe(
                max(self.clock() - t, 0.0), queue=q)

    def _incoming(self, event: str, n: int = 1) -> None:
        if n and self.doorbell is not None \
                and event != "ScheduleAttemptFailure":
            self.doorbell.ring(f"queue:{event}")
        if self.metrics is not None and n:
            self.metrics.queue_incoming_pods.inc(n, event=event)

    def _sync_gauges(self) -> None:
        """scheduler_pending_pods{queue} refresh — the ONE place the
        gauge is set, called after every membership mutation so scrapes
        between cycles see the live depths."""
        if self.metrics is None:
            return
        for q, depth in self.pending_counts().items():
            self.metrics.pending_pods.set(depth, queue=q)

    # -- internal ----------------------------------------------------------

    def _push_active(self, pod: Pod) -> None:
        if self._less is None:
            key = (-pod.priority, pod.queued_at, next(self._seq))
        else:
            key = _CmpKey(self._less, pod, next(self._seq))
        heapq.heappush(self._active, _ActiveEntry(key, pod))
        self._in_active[pod.key()] = pod
        self._note_enter(pod.key(), "active")

    def _push_backoff(self, pod: Pod) -> None:
        expiry = self.backoff_map.backoff_time(pod.key())
        heapq.heappush(self._backoff, (expiry, next(self._seq), pod.key()))
        self._in_backoff[pod.key()] = pod
        self._note_enter(pod.key(), "backoff")

    def pending_pods(self) -> Dict[str, List[Pod]]:
        """Snapshot of queued pods by sub-queue (tooling/state dumps)."""
        return {
            "active": list(self._in_active.values()),
            "backoff": list(self._in_backoff.values()),
            "unschedulable": [p for p, _ in self._unschedulable.values()],
        }

    def pod(self, key: str) -> Optional[Pod]:
        """Look up a queued pod by key across the three sub-queues."""
        p = self._in_active.get(key) or self._in_backoff.get(key)
        if p is None and key in self._unschedulable:
            p = self._unschedulable[key][0]
        return p

    def _contains(self, key: str) -> bool:
        return key in self._in_active or key in self._in_backoff or key in self._unschedulable

    # -- reference API -----------------------------------------------------

    def add(self, pod: Pod) -> None:
        """Add a new pending pod to activeQ (scheduling_queue.go Add);
        removes stale copies from the other queues."""
        if not pod.queued_at:
            pod.queued_at = self.clock()
        # an informer relist re-adds every queued pod: that is not a
        # departure (keep the residency stamp — the same-queue guard in
        # _note_enter reuses it) and not a second PodAdd
        readd = self._contains(pod.key())
        if not readd and self.journeys is not None:
            self.journeys.note_created(pod.key(),
                                       getattr(pod, "uid", ""))
        self._remove_everywhere(pod.key(), observe=not readd)
        self._push_active(pod)
        self.nominated.add(pod)
        if not readd:
            self._incoming("PodAdd")
        self._sync_gauges()

    def add_if_not_present(self, pod: Pod) -> None:
        if self._contains(pod.key()):
            return
        self.add(pod)

    def add_unschedulable_if_not_present(self, pod: Pod, pod_scheduling_cycle: int) -> None:
        """scheduling_queue.go:300 — a pod that just failed goes to backoffQ
        if a move request arrived during its cycle (it may have missed the
        wakeup), else to unschedulableQ. Backoff attempts were already
        recorded by the caller via ``record_failure``."""
        if self._contains(pod.key()):
            return
        self.nominated.add(pod)
        if self.move_request_cycle >= pod_scheduling_cycle:
            self._push_backoff(pod)
        else:
            self._unschedulable[pod.key()] = (pod, self.clock())
            self._note_enter(pod.key(), "unschedulable")
        self._incoming("ScheduleAttemptFailure")
        self._sync_gauges()

    def record_failure(self, pod: Pod) -> None:
        """Bump the pod's backoff clock (the driver calls this on every
        failed scheduling attempt, mirroring podBackoff.BackoffPod in the
        error path)."""
        self.backoff_map.backoff_pod(pod.key(), self.clock())

    def pop_batch(self, max_n: int = 0) -> List[Pod]:
        """Pop up to ``max_n`` pods (0 = all) in activeQ order. Increments
        the scheduling cycle once — the whole batch shares one cycle, which
        is the batched analog of per-pod Pop (scheduling_queue.go:389)."""
        out: List[Pod] = []
        while self._active and (not max_n or len(out) < max_n):
            e = heapq.heappop(self._active)
            if self._in_active.get(e.pod.key()) is not e.pod:
                continue  # superseded entry
            del self._in_active[e.pod.key()]
            self._note_exit(e.pod.key())
            out.append(e.pod)
        if out:
            self.scheduling_cycle += 1
            if self.journeys is not None:
                for p in out:
                    self.journeys.note_popped(p.key(),
                                              self.scheduling_cycle)
            self._sync_gauges()
        return out

    def update(self, old_key: str, pod: Pod) -> None:
        """Update in place; an update to an unschedulable pod moves it to
        activeQ (the spec change may have made it schedulable —
        scheduling_queue.go Update). The original enqueue timestamp is
        preserved (the reference keeps podInfo's timestamp on Update) so a
        spec edit never jumps the FIFO order."""
        old = (
            self._in_active.get(old_key)
            or self._in_backoff.get(old_key)
            or (self._unschedulable.get(old_key) or (None,))[0]
        )
        if old is not None:
            pod.queued_at = old.queued_at
        if old_key in self._in_active:
            del self._in_active[old_key]
            self._push_active(pod)
        elif old_key in self._in_backoff:
            del self._in_backoff[old_key]
            self._push_backoff(pod)
        elif old_key in self._unschedulable:
            del self._unschedulable[old_key]
            self._push_active(pod)
        else:
            self.add(pod)
            return
        self._incoming("PodUpdate")
        self._sync_gauges()

    def delete(self, pod_key: str) -> None:
        self._remove_everywhere(pod_key)
        node = self.nominated.node_of(pod_key)
        if node is not None:
            # synthesize a minimal pod for map removal
            ns, name = pod_key.split("/", 1)
            self.nominated.delete(Pod(name=name, namespace=ns))
        self.backoff_map.clear_pod(pod_key)
        self._sync_gauges()

    def _remove_everywhere(self, key: str, observe: bool = True) -> None:
        self._in_active.pop(key, None)
        self._in_backoff.pop(key, None)
        self._unschedulable.pop(key, None)
        if observe:
            # observe=False: the caller is about to re-insert the pod
            # (relist re-add), so the residency stamp must survive
            self._note_exit(key)

    def move_all_to_active(self) -> None:
        """MoveAllToActiveQueue (scheduling_queue.go:519): every
        unschedulable pod moves to activeQ — or backoffQ if still backing
        off — and the move-request cycle is stamped."""
        now = self.clock()
        moved = 0
        for key, (pod, _) in list(self._unschedulable.items()):
            del self._unschedulable[key]
            if self.backoff_map.backoff_time(key) > now:
                self._push_backoff(pod)
            else:
                self._push_active(pod)
            moved += 1
        self.move_request_cycle = self.scheduling_cycle
        self._incoming("MoveAllToActive", moved)
        self._sync_gauges()

    def move_pods_to_active(self, keys: Sequence[str],
                            event: str = "MovePodsToActive") -> None:
        """Subset move (movePodsToActiveQueue) — used by AssignedPodAdded to
        wake only pods with matching affinity terms. ``event`` labels the
        incoming-pods counter with what triggered the move."""
        now = self.clock()
        moved = 0
        for key in keys:
            ent = self._unschedulable.pop(key, None)
            if ent is None:
                continue
            pod, _ = ent
            if self.backoff_map.backoff_time(key) > now:
                self._push_backoff(pod)
            else:
                self._push_active(pod)
            moved += 1
        self.move_request_cycle = self.scheduling_cycle
        self._incoming(event, moved)
        self._sync_gauges()

    def assigned_pod_added(self, pod: Pod) -> None:
        """AssignedPodAdded (scheduling_queue.go): an assigned pod appearing
        can satisfy pending pods' pod-affinity — move unschedulable pods
        that carry any required pod-affinity term matching the new pod's
        labels/namespace."""
        keys = [
            k
            for k, (u, _) in self._unschedulable.items()
            if _affinity_could_match(u, pod)
        ]
        if keys:
            self.move_pods_to_active(keys, event="AssignedPodAdded")

    def flush_backoff_completed(self) -> None:
        """flushBackoffQCompleted (scheduling_queue.go:334) — run each tick."""
        now = self.clock()
        moved = 0
        while self._backoff and self._backoff[0][0] <= now:
            _, _, key = heapq.heappop(self._backoff)
            pod = self._in_backoff.pop(key, None)
            if pod is not None:
                self._push_active(pod)
                moved += 1
        if moved:
            self._incoming("BackoffComplete", moved)
            self._sync_gauges()

    def flush_unschedulable_leftover(self) -> None:
        """flushUnschedulableQLeftover (scheduling_queue.go:368): pods stuck
        longer than 60 s re-enter activeQ."""
        now = self.clock()
        keys = [
            k
            for k, (_, added) in self._unschedulable.items()
            if now - added >= UNSCHEDULABLEQ_FLUSH_S
        ]
        if keys:
            self.move_pods_to_active(keys, event="UnschedulableTimeout")

    def tick(self) -> None:
        """One maintenance sweep = the reference's periodic flush goroutines."""
        self.flush_backoff_completed()
        self.flush_unschedulable_leftover()

    # -- introspection -----------------------------------------------------

    def pending_counts(self) -> Dict[str, int]:
        """Sizes per sub-queue (the pending_pods metric gauge labels)."""
        return {
            "active": len(self._in_active),
            "backoff": len(self._in_backoff),
            "unschedulable": len(self._unschedulable),
        }

    def __len__(self) -> int:
        return len(self._in_active) + len(self._in_backoff) + len(self._unschedulable)


def _affinity_could_match(unschedulable: Pod, assigned: Pod) -> bool:
    """getUnschedulablePodsWithMatchingAffinityTerm: does ``unschedulable``
    carry a required pod-affinity term whose selector+namespace matches the
    newly assigned pod?"""
    for t in unschedulable.affinity.pod_affinity_required:
        ns = t.namespaces or (unschedulable.namespace,)
        if assigned.namespace in ns and t.label_selector.matches(assigned.labels):
            return True
    return False
