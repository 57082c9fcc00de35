"""API-priority-and-fairness-style load shedding + watch fan-out
hardening for the REST facades.

The reference apiserver's APF layer (staging/.../flowcontrol: FlowSchema
matches requests into priority levels, each with a concurrency limit and
bounded per-level queues; overload answers 429 with Retry-After) exists
so one noisy client class cannot starve the rest, and so overload
degrades by SHEDDING instead of by queue collapse. This module is the
capability analog at this framework's scale:

- :class:`FlowSchema` — one request class (name, seat count, bounded
  FIFO queue, queue timeout). The default schemas split traffic the way
  the reference's mandatory flow schemas do: ``exempt`` (health/metrics/
  debug — never queued), ``watch``, ``readonly``, ``mutating``.
- :class:`FlowController` — classify + admit/release. A request beyond
  the seat limit waits in the flow's bounded FIFO; a full queue or a
  blown queue-timeout raises :class:`RequestRejected` (the 429 +
  Retry-After answer). A flow may also carry a SATURATION probe (e.g.
  the scheduler's pending-pod depth): admission sheds mutating traffic
  while the backend is drowning, which is what keeps "no unbounded
  queue growth" true under a 4x-overload churn storm.
- :class:`WatchHub` — bounded-buffer watch fan-out. Each watcher owns a
  bounded send buffer; a publisher NEVER blocks on a slow consumer —
  when a watcher's buffer fills, the watcher is marked gone (its next
  poll raises :class:`WatcherGone`, the 410-relist signal) instead of
  stalling the hub for everyone else.

Everything is thread-safe and lock-scoped small; queue waits ride real
time (these are real HTTP handler threads), but every shed path is
reachable with ``queue_timeout_s=0`` so tests stay sleep-free.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


class RequestRejected(Exception):
    """Admission refused — answer 429 TooManyRequests + Retry-After."""

    def __init__(self, flow: str, reason: str, retry_after_s: float) -> None:
        super().__init__(
            f"too many requests in flight for flow {flow!r} ({reason}); "
            f"retry after {retry_after_s:g}s")
        self.flow = flow
        self.reason = reason
        self.retry_after_s = retry_after_s


@dataclass(frozen=True)
class FlowSchema:
    """One request class: seats + a bounded FIFO of waiters."""

    name: str
    #: concurrent requests admitted (the priority level's seat count)
    concurrency: int = 16
    #: waiters held beyond the seats; the queue bound that turns
    #: overload into 429s instead of unbounded handler-thread pileup
    queue_length: int = 64
    #: longest a queued request waits for a seat before shedding
    queue_timeout_s: float = 1.0
    #: exempt flows (health/metrics/debug) bypass seats entirely —
    #: the probes that diagnose an overload must survive it
    exempt: bool = False


def default_flows(concurrency: int = 16, queue_length: int = 64,
                  watch_concurrency: int = 8,
                  queue_timeout_s: float = 1.0) -> List[FlowSchema]:
    """The mandatory-flow-schema analog: split watch fan-out from
    reads from writes so none can starve the others."""
    return [
        FlowSchema("exempt", exempt=True),
        FlowSchema("watch", concurrency=watch_concurrency,
                   queue_length=max(queue_length // 4, 1),
                   queue_timeout_s=queue_timeout_s),
        FlowSchema("readonly", concurrency=concurrency,
                   queue_length=queue_length,
                   queue_timeout_s=queue_timeout_s),
        FlowSchema("mutating", concurrency=concurrency,
                   queue_length=queue_length,
                   queue_timeout_s=queue_timeout_s),
    ]


#: paths that classify exempt regardless of verb
_EXEMPT_PREFIXES = ("/healthz", "/metrics", "/version", "/debug/")


class _FlowState:
    __slots__ = ("schema", "inflight", "queue", "saturation_fn",
                 "max_saturation")

    def __init__(self, schema: FlowSchema) -> None:
        self.schema = schema
        self.inflight = 0
        self.queue: deque = deque()  # ticket ids, FIFO
        #: optional backend-pressure probe: admission sheds when
        #: saturation_fn() > max_saturation (e.g. scheduler queue depth)
        self.saturation_fn: Optional[Callable[[], float]] = None
        self.max_saturation: float = 0.0


class FlowController:
    """Classify + admit/release with per-flow seats and bounded FIFO
    queues; rejection carries the Retry-After the facade should send."""

    def __init__(self, flows: Optional[List[FlowSchema]] = None,
                 retry_after_s: float = 1.0, metrics=None) -> None:
        self._cond = threading.Condition()
        self._seq = itertools.count()
        self.retry_after_s = retry_after_s
        self.metrics = metrics
        self._flows: Dict[str, _FlowState] = {}
        for fs in (flows if flows is not None else default_flows()):
            self._flows[fs.name] = _FlowState(fs)
        # counters (exposed via stats(); also mirrored to metrics when
        # a SchedulerMetrics is attached)
        self.admitted: Dict[str, int] = {}
        self.rejected: Dict[str, int] = {}  # key "flow/reason"
        self.queued_total = 0

    # -- classification ------------------------------------------------------

    @staticmethod
    def classify(http_verb: str, path: str) -> str:
        """Request -> flow name, the FlowSchema-matching step. Watch is
        split out positionally (the RequestInfo rule: 'watch' right
        after the version prefix); exempt prefixes cover the probes."""
        p = path.split("?", 1)[0]
        if p.startswith(_EXEMPT_PREFIXES) or p in ("/api", "/apis",
                                                   "/openapi/v2"):
            return "exempt"
        parts = [s for s in p.split("/") if s]
        # "watch" counts only POSITIONALLY, right after the version
        # prefix (the RequestInfo rule) — a namespace or pod literally
        # named "watch" stays in its verb's flow
        if ((parts[:2] == ["api", "v1"] and parts[2:3] == ["watch"])
                or (parts[:1] == ["apis"] and parts[3:4] == ["watch"])):
            return "watch"
        return "readonly" if http_verb in ("GET", "HEAD") else "mutating"

    # -- saturation wiring ---------------------------------------------------

    def set_saturation(self, flow: str, fn: Callable[[], float],
                       maximum: float) -> None:
        """Attach a backend-pressure probe to a flow: admission sheds
        with 429 while ``fn() > maximum``. This is how the mutating flow
        is tied to the scheduler's pending-pod depth — the bounded-queue
        guarantee under sustained overload."""
        with self._cond:
            st = self._flows[flow]
            st.saturation_fn = fn
            st.max_saturation = float(maximum)

    # -- admit / release -----------------------------------------------------

    def _reject(self, flow: str, reason: str) -> RequestRejected:
        key = f"{flow}/{reason}"
        self.rejected[key] = self.rejected.get(key, 0) + 1
        if self.metrics is not None:
            self.metrics.apf_rejected.inc(flow=flow, reason=reason)
        return RequestRejected(flow, reason, self.retry_after_s)

    def acquire(self, flow: str) -> str:
        """Take a seat in ``flow`` (blocking in its bounded FIFO if the
        seats are full); raises :class:`RequestRejected` on overload.
        Returns the flow name to pass back to :meth:`release`."""
        with self._cond:
            st = self._flows.get(flow)
            if st is None or st.schema.exempt:
                # an unconfigured flow name admits unmetered (matching
                # release's no-op) rather than borrowing another flow's
                # seats — misclassification must never deadlock a seat
                self.admitted[flow] = self.admitted.get(flow, 0) + 1
                return flow
            flow = st.schema.name
            if (st.saturation_fn is not None
                    and st.saturation_fn() > st.max_saturation):
                raise self._reject(flow, "saturated")
            if st.inflight < st.schema.concurrency and not st.queue:
                st.inflight += 1
                self._admitted(flow, st)
                return flow
            if len(st.queue) >= st.schema.queue_length:
                raise self._reject(flow, "queue-full")
            ticket = next(self._seq)
            st.queue.append(ticket)
            self.queued_total += 1
            deadline = time.monotonic() + st.schema.queue_timeout_s
            while True:
                if st.queue and st.queue[0] == ticket \
                        and st.inflight < st.schema.concurrency:
                    st.queue.popleft()
                    st.inflight += 1
                    self._admitted(flow, st)
                    # the next waiter may also have a free seat
                    self._cond.notify_all()
                    return flow
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    try:
                        st.queue.remove(ticket)
                    except ValueError:
                        pass
                    raise self._reject(flow, "timeout")
                self._cond.wait(remaining)

    def _admitted(self, flow: str, st: _FlowState) -> None:
        self.admitted[flow] = self.admitted.get(flow, 0) + 1
        if self.metrics is not None:
            self.metrics.apf_inflight.set(st.inflight, flow=flow)

    def release(self, flow: str) -> None:
        with self._cond:
            st = self._flows.get(flow)
            if st is None or st.schema.exempt:
                return
            st.inflight = max(st.inflight - 1, 0)
            if self.metrics is not None:
                self.metrics.apf_inflight.set(st.inflight, flow=flow)
            self._cond.notify_all()

    def admit(self, flow: str):
        """Context-manager form: ``with ctrl.admit(flow): handle()``."""
        ctrl = self

        class _Seat:
            def __enter__(self_s):
                self_s.flow = ctrl.acquire(flow)
                return self_s

            def __exit__(self_s, *exc):
                ctrl.release(self_s.flow)
                return False

        return _Seat()

    def stats(self) -> dict:
        with self._cond:
            return {
                "admitted": dict(self.admitted),
                "rejected": dict(self.rejected),
                "queued_total": self.queued_total,
                "inflight": {name: st.inflight
                             for name, st in self._flows.items()},
            }


# ---------------------------------------------------------------------------
# watch fan-out hardening
# ---------------------------------------------------------------------------


class WatcherGone(Exception):
    """This watcher fell too far behind and was disconnected — the
    410-Gone / relist signal (cacher.go's terminateAllWatchers answer to
    a blocked send buffer)."""


class Watcher:
    """One consumer's bounded send buffer on a :class:`WatchHub`."""

    __slots__ = ("_hub", "buf", "gone", "gone_reason", "dropped",
                 "delivered")

    def __init__(self, hub: "WatchHub") -> None:
        self._hub = hub
        self.buf: deque = deque()
        self.gone = False
        #: why the hub cut this watcher loose ("" while live) — carried
        #: into the WatcherGone message so the 410 answer names the
        #: right relist cause (buffer overflow vs. takeover relist)
        self.gone_reason = ""
        #: buffered-but-never-delivered events discarded at eviction —
        #: the accounting that makes the drop VISIBLE (it used to
        #: vanish: eviction cleared the buffer and counted nothing)
        self.dropped = 0
        self.delivered = 0

    def poll(self) -> list:
        """Drain buffered events; raises :class:`WatcherGone` once the
        hub evicted this watcher (consumer must relist + re-register).
        The raise is sticky: EVERY poll after eviction raises — an
        eviction racing a concurrent drain can therefore never read as
        a clean empty stream."""
        with self._hub._lock:
            if self.gone:
                reason = self.gone_reason or (
                    f"send buffer overflowed (bound {self._hub.buffer})")
                raise WatcherGone(
                    f"watcher evicted: {reason} "
                    f"({self.dropped} buffered events dropped); "
                    "relist and re-watch")
            out = list(self.buf)
            self.buf.clear()
            self.delivered += len(out)
            return out

    def lag(self) -> int:
        with self._hub._lock:
            return len(self.buf)

    def close(self) -> None:
        self._hub.unregister(self)


class WatchHub:
    """Bounded-buffer event fan-out: publish never blocks, slow
    watchers are evicted (Gone) instead of stalling the publisher."""

    def __init__(self, buffer: int = 1024, metrics=None) -> None:
        self.buffer = max(1, int(buffer))
        self.metrics = metrics
        self._lock = threading.Lock()
        self._watchers: List[Watcher] = []
        self.published = 0
        self.evicted = 0
        #: buffered events discarded by evictions (accounting for what
        #: eviction drops — the relist covers the GAP, but the hub must
        #: still know how much it threw away)
        self.events_dropped = 0
        self.max_lag = 0

    def register(self) -> Watcher:
        w = Watcher(self)
        with self._lock:
            self._watchers.append(w)
        return w

    def unregister(self, w: Watcher) -> None:
        with self._lock:
            try:
                self._watchers.remove(w)
            except ValueError:
                pass

    def _evict_locked(self, w: Watcher, reason: str) -> None:
        """Cut one watcher loose (callers hold ``_lock``): sticky Gone
        with the reason the 410 should carry, dropped-event accounting
        instead of a silent clear."""
        w.gone = True
        w.gone_reason = reason
        w.dropped += len(w.buf)
        self.events_dropped += len(w.buf)
        w.buf.clear()
        self.evicted += 1
        if self.metrics is not None:
            self.metrics.watch_evictions.inc()

    def publish(self, event) -> None:
        with self._lock:
            self.published += 1
            for w in self._watchers:
                if w.gone:
                    continue
                if len(w.buf) >= self.buffer:
                    # the slow watcher is cut loose, never the hub: its
                    # buffer is dropped (counted) and every later poll
                    # gets Gone with the overflow reason
                    self._evict_locked(
                        w, f"send buffer overflowed (bound {self.buffer})")
                    continue
                w.buf.append(event)
                if len(w.buf) > self.max_lag:
                    self.max_lag = len(w.buf)

    def evict_all(self, reason: str) -> int:
        """Evict EVERY live watcher with ``reason`` — the takeover /
        deposition relist broadcast: a leadership change splices two
        write histories, so a watcher that straddles it must relist
        from truth rather than trust its buffered tail. Each evicted
        watcher's next poll raises :class:`WatcherGone` carrying the
        reason (the 410 + relist-hint answer), never a silent drop —
        and the race with a concurrent in-flight ``poll`` is benign by
        construction: both sides serialize on the hub lock, and the
        Gone flag is sticky, so the watcher either drains first and
        gets Gone on its NEXT poll, or gets Gone immediately.
        Returns how many watchers were evicted."""
        with self._lock:
            n = 0
            for w in self._watchers:
                if w.gone:
                    continue
                self._evict_locked(w, reason)
                n += 1
            return n

    def stats(self) -> dict:
        with self._lock:
            return {
                "watchers": len(self._watchers),
                "published": self.published,
                "evicted": self.evicted,
                "events_dropped": self.events_dropped,
                "max_lag": self.max_lag,
            }
