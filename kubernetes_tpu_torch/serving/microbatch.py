"""Adaptive micro-batch accumulation window + the event-driven serving
loop (the port of ``kubernetes_tpu/serving/microbatch.py``).

The batched solver is at its best when a cycle carries a full
power-of-two pod bucket: ``pods_to_device`` pads every batch to
``bucket_size(len(batch))`` (utils/interner — the shape grid the warmup
captures the round-loop graphs for), so a batch of 17 pods pays the
32-bucket solve anyway. The window therefore trades a bounded amount of
queueing latency for shape-perfect batches:

- the window OPENS on the first pending pod (doorbell-driven, not
  polled);
- it flushes IMMEDIATELY when the accumulated depth fills a warmed
  bucket — either the configured accumulation cap (``target_bucket``),
  or, once ``min_wait`` has elapsed, any exact power-of-two boundary
  (zero padding waste; waiting longer only adds latency until a 2x
  larger bucket could fill);
- it flushes unconditionally at ``max_wait`` — the latency ceiling a
  trickle workload pays.

Steady-state churn therefore presents only bucket shapes the warmup
already captured: no round-loop graph is captured on the hot path
(``CycleResult.graph_captures`` stays 0), which is what makes
wake-on-event viable at production rates.

:class:`MicroBatchWindow` is pure decision logic on an injected clock
(fake-clock testable, no threads); :class:`ServingLoop` is the real
serve loop that marries it to a :class:`~kubernetes_tpu_torch.serving.
doorbell.Doorbell` and a ``Scheduler``.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from kubernetes_tpu_torch.utils.interner import bucket_size

#: the padding grid's smallest bucket (pods_to_device's bucket_size
#: minimum) — depths below it can never sit on a warmed boundary
MIN_BUCKET = 8


@dataclass
class WindowDecision:
    """What the window wants done right now."""

    flush: bool = False
    #: why ("bucket-fill" | "max-wait"); "" when not flushing
    trigger: str = ""
    #: when not flushing: how long the loop may wait before the next
    #: decision point (doorbell rings cut it short)
    wait_s: float = 0.0


class MicroBatchWindow:
    """Accumulation-window state machine (decision logic only)."""

    def __init__(
        self,
        clock: Callable[[], float] = time.monotonic,
        min_wait_s: float = 0.005,
        max_wait_s: float = 0.05,
        target_bucket: int = 1024,
    ) -> None:
        if min_wait_s < 0 or max_wait_s < min_wait_s:
            raise ValueError(
                "microbatch window needs 0 <= min_wait <= max_wait")
        self.clock = clock
        self.min_wait_s = float(min_wait_s)
        self.max_wait_s = float(max_wait_s)
        #: accumulation cap, snapped DOWN to the padding grid (snapping
        #: up would chase a bucket the warmup never captured)
        tb = bucket_size(max(int(target_bucket), MIN_BUCKET))
        self.target_bucket = tb if tb <= target_bucket else tb // 2
        #: None = closed; else the clock stamp of the first pending pod
        self.opened_at: Optional[float] = None

    @property
    def open(self) -> bool:
        return self.opened_at is not None

    def reset(self) -> None:
        self.opened_at = None

    def close(self, now: Optional[float] = None) -> float:
        """Close the window (the caller is about to flush); returns the
        accumulation duration actually spent."""
        now = self.clock() if now is None else now
        w = now - self.opened_at if self.opened_at is not None else 0.0
        self.opened_at = None
        return max(w, 0.0)

    def observe(self, depth: int, now: Optional[float] = None) -> WindowDecision:
        """One look at the active-queue depth -> flush / wait verdict."""
        now = self.clock() if now is None else now
        if depth <= 0:
            # nothing pending: an open window with zero depth means the
            # pods left by another path (delete, competing binder) —
            # close it rather than flushing an empty cycle at max_wait
            self.opened_at = None
            return WindowDecision()
        if self.opened_at is None:
            self.opened_at = now
        if depth >= self.target_bucket:
            return WindowDecision(flush=True, trigger="bucket-fill")
        elapsed = now - self.opened_at
        if elapsed >= self.max_wait_s:
            return WindowDecision(flush=True, trigger="max-wait")
        if (elapsed >= self.min_wait_s and depth >= MIN_BUCKET
                and bucket_size(depth) == depth):
            # the depth sits exactly on a warmed power-of-two boundary:
            # flushing now wastes zero padding, and any further
            # accumulation re-pays latency until a 2x bucket could fill
            return WindowDecision(flush=True, trigger="bucket-fill")
        deadline = self.opened_at + self.max_wait_s
        if elapsed < self.min_wait_s:
            deadline = min(deadline, self.opened_at + self.min_wait_s)
        return WindowDecision(wait_s=max(deadline - now, 0.0))


class ServingLoop:
    """The event-driven replacement for ``cli.run``'s fixed-interval
    loop: block on the doorbell, accumulate through the micro-batch
    window, drive ``Scheduler.schedule_cycle`` on flush.

    Idle behavior: with nothing in activeQ and the window closed, the
    loop parks on the doorbell up to ``idle_wait_s`` and runs
    ``Scheduler.idle_tick`` (queue maintenance only — backoff and
    unschedulable flushes, which themselves ring the bell when they move
    pods) on each timeout, so an idle cluster costs ~2 wakeups/second
    instead of one full solve-path poll per ``--cycle-interval``."""

    def __init__(
        self,
        sched,
        doorbell,
        config=None,
        on_cycle: Optional[Callable] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if config is None:
            from kubernetes_tpu_torch.config import ServingConfig

            config = ServingConfig()
        self.sched = sched
        self.bell = doorbell
        self.config = config
        #: injectable for fake-clock tests (the window's flush decisions
        #: ride it); the DOORBELL waits stay real-time — a fake-clock
        #: caller drives run_once directly instead of blocking in run()
        self.clock = clock
        self.window = MicroBatchWindow(
            clock=self.clock,
            min_wait_s=config.min_wait_s,
            max_wait_s=config.max_wait_s,
            target_bucket=min(config.target_bucket,
                              getattr(sched, "max_batch", config.target_bucket)),
        )
        # shape discipline under floods: the window decides WHEN to
        # flush, but schedule_cycle pops up to max_batch — an overload
        # burst would otherwise present one giant unwarmed bucket and
        # capture a graph on the hot path. Clamp pops to the warmed accumulation
        # target; the residue stays in activeQ and re-flushes
        # immediately (depth >= target is a bucket-fill).
        if getattr(sched, "max_batch", None) is not None:
            sched.max_batch = min(sched.max_batch,
                                  self.window.target_bucket)
        #: per-flush callback (bench/tests): receives the CycleResult
        self.on_cycle = on_cycle
        self.cycles = 0
        #: serializes the solve against cross-thread event feeds: the
        #: scheduler's queue/cache are single-writer structures, so an
        #: informer pump (or a producer) running on another thread must
        #: ingest through this lock (use :meth:`ingest`). Doorbell waits
        #: happen OUTSIDE it — feeding never blocks on a solve's wall
        #: time, only on its critical sections. (The reference builds it
        #: through the scheduler's lock sanitizer: ROADMAP A.13.)
        self.lock = threading.RLock()
        #: per-iteration maintenance hook run by :meth:`run` BETWEEN
        #: run_once iterations (never mid-cycle): the composed runtime
        #: parks its low-frequency state-conservation audit here
        self.maintenance: Optional[Callable[[], None]] = None

    def ingest(self, fn, *args, **kwargs):
        """Run an event-feed callable (scheduler.on_pod_add, ...) under
        the loop's ingest lock — the thread-safe seam for producers
        living on other threads."""
        with self.lock:
            return fn(*args, **kwargs)

    def _depth(self) -> int:
        return self.sched.queue.pending_counts()["active"]

    def run_once(self):
        """One wait/decide/flush iteration; returns the CycleResult when
        a cycle ran, else None. Bounded blocking (<= idle_wait_s)."""
        depth = self._depth()
        if depth == 0 and not self.window.open:
            if not self.bell.wait(self.config.idle_wait_s):
                # clean timeout: queue maintenance so parked backoff /
                # unschedulable pods still resurface; any pod it moves
                # rings the bell and the next iteration schedules it
                with self.lock:
                    self.sched.idle_tick()
            return None
        dec = self.window.observe(depth)
        if not dec.flush:
            self.bell.wait(dec.wait_s)
            return None
        window_s = self.window.close()
        with self.lock:
            res = self.sched.schedule_cycle(
                flush_trigger=dec.trigger, window_s=window_s)
        self.cycles += 1
        m = getattr(self.sched, "metrics", None)
        if m is not None:
            m.microbatch_flushes.inc(trigger=dec.trigger)
            m.microbatch_window.observe(window_s)
        if self.on_cycle is not None:
            self.on_cycle(res)
        return res

    def run(self, stop, gate: Optional[Callable[[], bool]] = None) -> None:
        """Serve until ``stop`` (threading.Event) is set. ``gate`` is
        the per-iteration admission hook (leader election + lazy warmup
        in cli.run): returning False skips this iteration — the gate is
        expected to pace itself (e.g. stop.wait(retry_period))."""
        while not stop.is_set():
            if gate is not None and not gate():
                continue
            self.run_once()
            if self.maintenance is not None:
                self.maintenance()
