"""The composed serving runtime — streaming serving WITH the
crash/failover protocol, as one first-class seam (the port of
``kubernetes_tpu/serving/compose.py``, on one card).

Micro-batch serving, fenced binds with takeover reconciliation, and APF
shedding each work alone; production needs them in ONE process: a
doorbell-driven loop flushing warmed micro-batches into the solve, an APF
layer shedding from the scheduler's REAL state, watch fan-out that
survives a takeover, and an elector whose leadership side-effects
(reconcile, drain, re-warm) serialize against the ingest lock.
:class:`ServingRuntime` is the one constructor ``cli.run`` and the chip
smoke test both use, so "the composed configuration" means the same
wiring everywhere.

What composing changes (vs. the pieces in isolation):

- **warmup**: the serving grid extends down to micro-batch buckets
  (min bucket 8), so a trickle cycle never captures a round-loop graph
  on the hot path; and when a mesh is on, the single-device host-mode
  shapes warm too (``warmup.host_fallback``), so a shard lost mid-churn
  degrades through the cooloff without a capture;
- **APF shedding**: the mutating flow's saturation probe is
  :meth:`Scheduler.backend_pressure` — active-queue depth INFLATED
  while the ladder runs degraded, the device cools off after a loss, or
  the perf ledger's SLO watchdog is burning (obs/ledger.py) — not bare
  queue length, so a limping backend sheds earlier at the same depth;
- **takeover**: ``attach_elector`` chains the scheduler's recovery
  callbacks (fenced binds, reconcile, stopped-leading drain) AND the
  watch hub's relist eviction — watchers of a deposed or newly-elected
  replica get 410 Gone + the relist hint instead of silently straddling
  two leaderships — and :meth:`gate` runs the elector tick under the
  loop's ingest lock.

- **auditing**: with ``observability.audit_interval_s`` > 0 the runtime
  attaches the state-conservation auditor (``obs/audit.py``) and runs
  its structural sweep as a maintenance hook between loop iterations,
  under the ingest lock (:meth:`maybe_audit`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from kubernetes_tpu_torch.serving.doorbell import Doorbell
from kubernetes_tpu_torch.serving.fairness import (
    FlowController,
    WatchHub,
    default_flows,
)
from kubernetes_tpu_torch.serving.microbatch import MIN_BUCKET, ServingLoop


class ServingRuntime:
    """One serving replica, fully composed: scheduler, doorbell,
    micro-batch loop, APF flow controller with the backend-pressure
    probe wired, and the watch fan-out hub."""

    def __init__(
        self,
        sched,
        serving=None,
        warmup=None,
        clock: Callable[[], float] = time.monotonic,
        on_cycle: Optional[Callable] = None,
    ) -> None:
        from kubernetes_tpu_torch.config import ServingConfig

        self.sched = sched
        self.config = serving if serving is not None else ServingConfig()
        self.clock = clock
        # -- warmed-grid adaptation ---------------------------------------
        wu = warmup if warmup is not None else sched.warmup_config
        if wu.enabled:
            if not wu.pod_buckets and wu.min_bucket > MIN_BUCKET:
                # the streaming path presents SMALL buckets (micro-batches
                # pad to bucket_size(depth), floor 8); the batch-mode
                # default min_bucket=256 would leave them unwarmed and
                # every trickle cycle would capture its round-loop graph
                # on the hot path
                wu = dataclasses.replace(wu, min_bucket=MIN_BUCKET)
            if sched.mesh is not None and not wu.host_fallback:
                # composed mode: a shard loss mid-churn must not capture
                # on the hot path — warm the host-mode fallback shapes
                wu = dataclasses.replace(wu, host_fallback=True)
        sched.warmup_config = wu
        self._warmup_pending = wu.enabled
        # -- the loop + doorbell ------------------------------------------
        self.bell = sched.attach_doorbell(Doorbell())
        self.loop = ServingLoop(sched, self.bell, self.config,
                                on_cycle=on_cycle, clock=clock)
        # -- APF admission with the REAL saturation probe -----------------
        self.flow = FlowController(
            flows=default_flows(
                concurrency=self.config.flow_concurrency,
                queue_length=self.config.flow_queue_length,
                watch_concurrency=self.config.watch_concurrency,
                queue_timeout_s=self.config.queue_timeout_s),
            retry_after_s=self.config.retry_after_s,
            metrics=sched.metrics)
        factor = self.config.degraded_pressure_factor
        self.flow.set_saturation(
            "mutating",
            lambda: sched.backend_pressure(degraded_factor=factor),
            maximum=float(self.shed_bound()))
        #: the SLO surface (obs/ledger.py): the serving loop's per-pod
        #: create-to-bind latencies feed the watchdog through end_cycle,
        #: and a sustained burn inflates the backend_pressure probe wired
        #: above (getattr: duck-typed scheduler fakes stay valid)
        self.ledger = getattr(getattr(sched, "obs", None), "ledger", None)
        # -- watch fan-out -------------------------------------------------
        self.hub = WatchHub(buffer=self.config.watch_buffer,
                            metrics=sched.metrics)
        # -- state-conservation auditor (obs/audit.py) ---------------------
        #: runs the structural invariants (multi-state, capacity,
        #: truthless conservation) every ``observability.
        #: audit_interval_s`` seconds BETWEEN loop iterations, under the
        #: ingest lock (never mid-cycle). 0 = off (the default: chaos
        #: harnesses attach their own)
        self.auditor = None
        obs_cfg = getattr(sched, "observability", None)
        self._audit_interval = float(
            getattr(obs_cfg, "audit_interval_s", 0.0) or 0.0)
        self._next_audit = 0.0
        if self._audit_interval > 0:
            from kubernetes_tpu_torch.obs.audit import StateAuditor

            self.auditor = sched.attach_auditor(StateAuditor())
            self.add_maintenance(self.maybe_audit)

    def add_maintenance(self, fn: Callable[[], object]) -> Callable:
        """CHAIN a per-iteration maintenance hook onto the serving loop
        (run between run_once iterations, never mid-cycle): hooks compose
        on one runtime without knowing about each other and run in
        attachment order. Returns ``fn``."""
        prev = self.loop.maintenance

        def chained() -> None:
            if prev is not None:
                prev()
            fn()

        self.loop.maintenance = chained
        return fn

    def maybe_audit(self) -> int:
        """The low-frequency state-conservation sweep: run the structural
        invariants when the interval elapsed, under the ingest lock so
        producers and leadership side-effects are quiesced. Returns the
        violations found this call (0 = clean or not due yet)."""
        if self.auditor is None:
            return 0
        now = self.clock()
        if now < self._next_audit:
            return 0
        self._next_audit = now + self._audit_interval
        with self.loop.lock:
            return len(self.auditor.audit(self.sched))

    def shed_bound(self) -> int:
        """The mutating flow's pressure bound: configured, or auto =
        two full accumulation targets of headroom (one window in
        flight, one accumulating)."""
        if self.config.shed_queue_bound > 0:
            return self.config.shed_queue_bound
        return 2 * self.loop.window.target_bucket

    # -- failover wiring ----------------------------------------------------

    def attach_elector(self, elector, lister=None):
        """Scheduler recovery wiring (fenced binds, takeover
        reconciliation, stopped-leading drain) PLUS the serving layer's
        own transition duty: every leadership change relists this
        replica's watchers — their event stream straddles two write
        histories, so they get 410 Gone + the relist hint rather than a
        silent seam. Returns the elector."""
        self.sched.attach_elector(elector, lister=lister)
        hub = self.hub
        prev_start = elector.on_started_leading
        prev_stop = elector.on_stopped_leading

        def started():
            prev_start()
            hub.evict_all("leadership change (takeover): relist")

        def stopped():
            prev_stop()
            hub.evict_all("leadership change (deposed): relist")

        elector.on_started_leading = started
        elector.on_stopped_leading = stopped
        return elector

    # -- the per-iteration admission gate ------------------------------------

    def warm_if_pending(self, sample_pods=None) -> int:
        """Lazy warmup, first node sync permitting — callers hold the
        ingest lock (the gate below does). ``sample_pods`` overrides the
        queue-derived sample. Returns shapes warmed this call (0 when
        already warm / still no nodes)."""
        if not self._warmup_pending or not self.sched.cache.node_count():
            return 0
        if sample_pods is None:
            pp = getattr(self.sched.queue, "pending_pods", None)
            sample_pods = pp().get("active", [])[:64] if pp else []
        n = self.sched.warmup(sample_pods=sample_pods)
        self._warmup_pending = False
        return n

    def gate(self, stop, elector=None, retry_period_s: float = 1.0):
        """Build the per-iteration admission callable for
        :meth:`ServingLoop.run`: tick the elector and run the lazy
        warmup UNDER THE INGEST LOCK (leadership side-effects —
        reconcile, drain, warmup — mutate the queue/cache that producer
        threads feed through the same lock; ticking unlocked races them
        exactly at takeover)."""
        loop = self.loop

        def _gate() -> bool:
            if elector is not None:
                with loop.lock:
                    leading = elector.tick()
                if not leading:
                    stop.wait(retry_period_s)
                    return False
            if self._warmup_pending:
                # check the flag OUTSIDE the lock: once warm, the gate
                # must not contend with producers on every iteration
                with loop.lock:
                    self.warm_if_pending()
            return True

        return _gate

    def run(self, stop, elector=None, retry_period_s: float = 1.0) -> None:
        """Serve until ``stop``: the composed loop with the gate
        installed (cli.run's serving branch, and the chip smoke test's)."""
        self.loop.run(stop, gate=self.gate(stop, elector, retry_period_s))
