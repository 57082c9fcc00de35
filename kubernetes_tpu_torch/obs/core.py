"""The Observability facade the scheduler owns (the port of
``kubernetes_tpu/obs/core.py``): one object tying the cycle tracer, the
transfer and capture telemetry (:mod:`.jaxtel`), the flight recorder
(:mod:`.recorder`), the pod journeys (:mod:`.journey`), the perf ledger
and its SLO watchdog (:mod:`.ledger`), the device-memory ledger
(:mod:`.memledger`) and the incident recorder (:mod:`.incidents`) to the
typed config (:class:`kubernetes_tpu_torch.config.ObservabilityConfig`)
and the metrics registry.

Lifecycle per scheduling cycle::

    trace = obs.begin_cycle(cycle_no)     # always returns a Trace
    with obs.span("snapshot"): ...        # nested spans on that trace
    obs.note_batch_shape("P8xN5")         # scratch notes for the record
    obs.end_cycle(res)                    # -> CycleRecord + trace ring

Trace retention is SAMPLED (``trace_sampling`` — deterministic,
counter-based: the k-th EVENTFUL cycle is retained when ``floor(k*rate)``
advances; idle polls consume no sampling slot), but the trace itself
always exists so ``log_if_long`` keeps its always-on role. Everything
runs on the injected clock; a span around an enqueue measures the host's
enqueue, never the device. Nothing here synchronises the device: the
Sinkhorn stats ``end_cycle`` observes arrive as host values, read back
on the solve's own payload (``note_sinkhorn``).

Reads that ops/ makes on its own (the round router's decision, the
tolerance-gated Sinkhorn's exit tests) go through ``ops/sync.to_host``
with no site; ``end_cycle`` charges their bytes to the site
``solver-internal`` so a record's ``readback_bytes`` is every byte the
cycle read back.

``note_scenario`` takes a scenario cycle's placement-quality scores
(``Scheduler._publish_scenario_quality``); ``note_mesh`` /
``note_mesh_cycle`` (A.17) are the reference's paths with no caller yet.
"""

from __future__ import annotations

import json
import math
import time
from collections import deque
from contextlib import nullcontext
from typing import Callable, Optional

from kubernetes_tpu_torch.obs.incidents import IncidentRecorder
from kubernetes_tpu_torch.obs.jaxtel import JaxTelemetry
from kubernetes_tpu_torch.obs.journey import JourneyTracker
from kubernetes_tpu_torch.obs.ledger import PerfLedger
from kubernetes_tpu_torch.obs.memledger import MemoryLedger
from kubernetes_tpu_torch.obs.recorder import CycleRecord, FlightRecorder
from kubernetes_tpu_torch.obs.trace import Trace, chrome_trace_json
from kubernetes_tpu_torch.ops.sync import SYNCS
from kubernetes_tpu_torch.sanitize import make_lock

#: the transfer site of the reads ops/ makes without one
INTERNAL_SITE = "solver-internal"


class Observability:
    def __init__(self, config=None, metrics=None,
                 clock: Callable[[], float] = time.monotonic,
                 lock_sanitizer=None) -> None:
        if config is None:
            from kubernetes_tpu_torch.config import ObservabilityConfig

            config = ObservabilityConfig()
        self.config = config
        self.metrics = metrics
        self.clock = clock
        #: runtime lock sanitizer (sanitize.py): when the scheduler armed
        #: one, every obs-side lock is built through it
        self.lock_sanitizer = lock_sanitizer
        lf = lock_sanitizer.factory() if lock_sanitizer is not None else None
        self.jax = JaxTelemetry(
            metrics=metrics,
            storm_threshold=config.retrace_storm_threshold,
            storm_window=config.retrace_storm_window,
            lock_factory=lf,
        )
        self.recorder = FlightRecorder(config.recorder_capacity,
                                       lock_factory=lf)
        #: perf ledger + SLO watchdog (obs/ledger.py): consumes each
        #: eventful cycle's record at end_cycle
        self.ledger = PerfLedger(getattr(config, "ledger", None),
                                 metrics=metrics, clock=clock,
                                 lock_factory=lf)
        #: device-memory ledger (obs/memledger.py): modeled residents,
        #: the cycle-boundary measured sample, the preflight's peak
        #: table and the OOM forensics
        self.memledger = MemoryLedger(getattr(config, "memory_ledger",
                                              None),
                                      metrics=metrics, clock=clock,
                                      lock_factory=lf)
        #: per-pod journey tracer (obs/journey.py): fed by the queue and
        #: the scheduler's seams, read by /debug/journeys and the incident
        #: bundles
        self.journeys = JourneyTracker(getattr(config, "journeys", None),
                                       metrics=metrics, clock=clock,
                                       lock_factory=lf)
        #: incident autopsies (obs/incidents.py): its five triggers are
        #: evaluated against each eventful cycle record at end_cycle
        self.incidents = IncidentRecorder(
            getattr(config, "incidents", None), metrics=metrics,
            clock=clock, lock_factory=lf, recorder=self.recorder,
            ledger=self.ledger, memledger=self.memledger, jaxtel=self.jax,
            journeys=self.journeys)
        self.traces: deque = deque(maxlen=max(1, config.trace_ring_capacity))
        #: guards the traces ring: the scheduler thread appends while the
        #: /debug/traces handler thread snapshots
        self._traces_lock = make_lock(lf, "obs.traces")
        self.current_trace: Optional[Trace] = None
        self.last_trace: Optional[Trace] = None
        #: EVENTFUL cycles seen — the trace-sampling sequence (idle polls
        #: must not consume sampling slots)
        self._eventful_seq = 0
        # per-cycle scratch, reset by begin_cycle
        self._scratch: dict = {}
        #: the cycle's Sinkhorn [iterations, residual], host values
        self._sinkhorn_stats = None
        self._retraces_at_begin = 0
        self._d2h_at_begin = 0
        self._syncs_at_begin = 0
        self._lockfind_at_begin = 0
        #: a takeover reconciliation runs BETWEEN cycles: its epoch parks
        #: here until the next begin_cycle stamps it on that cycle
        self._pending_takeover = 0
        #: the auditor's between-cycles violations (the serving runtime's
        #: sweep), parked for the next record the same way
        self._pending_invariants = 0
        #: a device-loss forensic flag captured between cycles (a warmup
        #: abort), parked for the next record
        self._pending_oom = ""
        #: node-axis mesh size (A.17; 0 = single device)
        self.mesh_devices = 0

    # -- cycle lifecycle ----------------------------------------------------

    def _sampled(self, seq: int) -> bool:
        rate = min(max(float(self.config.trace_sampling), 0.0), 1.0)
        if rate <= 0.0:
            return False
        return math.floor(seq * rate) > math.floor((seq - 1) * rate)

    def begin_cycle(self, cycle: int = 0) -> Trace:
        self._scratch = {"cycle": cycle, "t": self.clock(),
                         "breakers": [], "retries": 0,
                         "deadline_exceeded": False,
                         "takeover": self._pending_takeover,
                         "device_resets": 0, "fenced_binds": 0,
                         "invariant_violations": self._pending_invariants,
                         "ambiguous_binds": 0,
                         "oom_forensic": self._pending_oom}
        self._pending_takeover = 0
        self._pending_invariants = 0
        self._pending_oom = ""
        self._sinkhorn_stats = None
        self._retraces_at_begin = self.jax.retrace_total()
        self._d2h_at_begin = self.jax.d2h_bytes_total()
        self._syncs_at_begin = SYNCS.d2h_bytes
        self._lockfind_at_begin = (
            self.lock_sanitizer.total_findings()
            if self.lock_sanitizer is not None else 0)
        self.current_trace = Trace("Scheduling cycle", clock=self.clock,
                                   cycle=cycle)
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

    # -- scratch notes (cycle-scoped inputs to the flight record) -----------

    def note_cycle(self, cycle: int) -> None:
        """Stamp the real cycle number (known only after pop_batch) on
        the record AND the in-flight trace, so /debug/traces and
        /debug/flightrecorder agree on which cycle a span belongs to."""
        self._scratch["cycle"] = cycle
        tr = self.current_trace
        if tr is not None:
            tr.fields["cycle"] = cycle
            tr.root.fields["cycle"] = cycle

    def note_batch_shape(self, digest: str) -> None:
        self._scratch["batch_shape"] = digest

    def note_breaker(self, target: str, old: str, new: str) -> None:
        if "breakers" in self._scratch:
            self._scratch["breakers"].append((target, old, new))

    def note_retry(self) -> None:
        self._scratch["retries"] = self._scratch.get("retries", 0) + 1

    def note_deadline_exceeded(self) -> None:
        self._scratch["deadline_exceeded"] = True

    def note_snapshot(self, mode: str, rows: int) -> None:
        """How the cycle's device snapshot was produced (full | delta |
        clean | host) and how many node rows it re-packed."""
        self._scratch["snapshot_mode"] = mode
        self._scratch["snapshot_rows"] = rows

    def note_solve_scope(self, scope: str, reuse_frac: float = 0.0) -> None:
        """Which solve the cycle ran (restricted | partitioned | full) and
        how much of the score summary it reused."""
        self._scratch["solve_scope"] = scope
        self._scratch["reuse_frac"] = float(reuse_frac)

    def note_microbatch(self, trigger: str, window_s: float) -> None:
        """The serving loop's micro-batch provenance for this cycle: what
        flushed the accumulation window (bucket-fill | max-wait) and how
        long it held."""
        self._scratch["flush_trigger"] = trigger
        self._scratch["window_s"] = window_s

    def note_takeover(self, epoch: int = 1) -> None:
        """A takeover reconciliation ran (between cycles): the NEXT
        cycle's record carries ``takeover=epoch``."""
        self._pending_takeover = max(int(epoch), 1)

    def note_device_reset(self) -> None:
        """The resident device table was dropped and rebuilt after a
        device error this cycle (``device_reset=`` flag)."""
        if "device_resets" in self._scratch:
            self._scratch["device_resets"] = (
                self._scratch.get("device_resets", 0) + 1)

    def note_fenced_bind(self) -> None:
        """A bind was aborted by the lease fence this cycle."""
        if "fenced_binds" in self._scratch:
            self._scratch["fenced_binds"] = (
                self._scratch.get("fenced_binds", 0) + 1)

    def note_invariant_violations(self, n: int = 1) -> None:
        """The state-conservation auditor (obs/audit.py) found ``n``
        violations: on the in-flight cycle's record, or parked for the
        next one when the audit ran between cycles."""
        if "invariant_violations" in self._scratch and \
                self.current_trace is not None:
            self._scratch["invariant_violations"] = (
                self._scratch.get("invariant_violations", 0) + int(n))
        else:
            self._pending_invariants += int(n)

    def note_ambiguous_bind(self) -> None:
        """A bind timed out ambiguously this cycle and went through the
        read-your-write resolution (``ambig=`` flag)."""
        if "ambiguous_binds" in self._scratch:
            self._scratch["ambiguous_binds"] = (
                self._scratch.get("ambiguous_binds", 0) + 1)

    def note_mesh(self, devices: int) -> None:
        """The sharded backend's mesh size (A.17)."""
        self.mesh_devices = int(devices)

    def note_mesh_cycle(self, devices: int) -> None:
        """What THIS cycle ran on (A.17)."""
        self._scratch["mesh"] = int(devices)

    def note_preflight(self, action: str) -> None:
        """The memory preflight's verdict for this cycle's shape."""
        self._scratch["preflight"] = action

    def note_oom_forensic(self, flag: str) -> None:
        """A device-loss or out-of-memory forensic flag for this cycle,
        parked for the next cycle when the loss came between cycles (a
        warmup abort)."""
        if self.current_trace is not None:
            self._scratch["oom_forensic"] = flag
        else:
            self._pending_oom = flag

    def note_sinkhorn(self, stats) -> None:
        """Stash the solver's [iterations, residual], host values the
        scheduler read back on the solve's own payload (the reference
        stashes the device pair and reads it here at ``end_cycle``)."""
        self._sinkhorn_stats = stats

    def note_scenario(self, scores: dict) -> None:
        """The cycle's scenario placement-quality scores (the flight
        record's ``scenario`` block)."""
        self._scratch["scenario"] = dict(scores)

    def note_explain(self, report) -> None:
        """Stash the cycle's UnschedulableReport; the flight record keeps
        its top-K reasons."""
        self._scratch["explain"] = report

    # -- cycle close --------------------------------------------------------

    def end_cycle(self, res=None) -> Optional[CycleRecord]:
        trace = self.current_trace
        self.current_trace = None
        if trace is None:
            return None
        trace.finish()
        self.last_trace = trace
        sk_iters = sk_resid = -1.0
        if self._sinkhorn_stats is not None:
            stats = self._sinkhorn_stats
            # [-1, -1] is the solver's "plan never engaged" sentinel
            if float(stats[0]) >= 0:
                sk_iters, sk_resid = float(stats[0]), float(stats[1])
                if self.metrics is not None:
                    self.metrics.sinkhorn_iterations.observe(sk_iters)
                    self.metrics.sinkhorn_residual.set(sk_resid)
            self._sinkhorn_stats = None
        internal = ((SYNCS.d2h_bytes - self._syncs_at_begin)
                    - (self.jax.d2h_bytes_total() - self._d2h_at_begin))
        if internal > 0:
            self.jax.record_transfer(INTERNAL_SITE, "d2h", internal)
        if not self.config.enabled:
            return None
        s = self._scratch
        # idle poll cycles (empty batch, nothing attempted, no incident
        # activity) are not black-box material
        attempted = getattr(res, "attempted", 0) if res is not None else 0
        lock_findings = (
            self.lock_sanitizer.total_findings() - self._lockfind_at_begin
            if self.lock_sanitizer is not None else 0)
        eventful = bool(
            attempted
            or s.get("retries", 0)
            or s.get("deadline_exceeded", False)
            or s.get("breakers")
            or s.get("takeover", 0)
            or s.get("device_resets", 0)
            or s.get("fenced_binds", 0)
            or s.get("invariant_violations", 0)
            or s.get("ambiguous_binds", 0)
            or s.get("oom_forensic", "")
            or lock_findings
        )
        if not eventful:
            return None
        rec = CycleRecord(
            cycle=s.get("cycle", 0),
            t=s.get("t", 0.0),
            batch_shape=s.get("batch_shape", ""),
            tier=getattr(res, "solver_tier", "") if res is not None else "",
            fallbacks=(getattr(res, "solver_fallbacks", 0)
                       if res is not None else 0),
            retries=s.get("retries", 0),
            deadline_exceeded=s.get("deadline_exceeded", False),
            breaker_transitions=list(s.get("breakers", ())),
            attempted=attempted,
            scheduled=getattr(res, "scheduled", 0) if res is not None else 0,
            unschedulable=(getattr(res, "unschedulable", 0)
                           if res is not None else 0),
            elapsed_s=getattr(res, "elapsed_s", 0.0) if res is not None else 0.0,
            spans=trace.span_durations(),
            retraces=self.jax.retrace_total() - self._retraces_at_begin,
            readback_bytes=self.jax.d2h_bytes_total() - self._d2h_at_begin,
            sinkhorn_iters=sk_iters,
            sinkhorn_residual=sk_resid,
            top_reasons=(
                s["explain"].top_reasons(
                    getattr(self.config, "explain_top_k", 3))
                if s.get("explain") is not None else []
            ),
            snapshot_mode=s.get("snapshot_mode", ""),
            snapshot_rows=s.get("snapshot_rows", 0),
            solve_scope=s.get("solve_scope", ""),
            reuse_frac=s.get("reuse_frac", 0.0),
            pipeline_chunks=(getattr(res, "pipeline_chunks", 0)
                             if res is not None else 0),
            flush_trigger=s.get("flush_trigger", ""),
            window_s=s.get("window_s", 0.0),
            takeover=s.get("takeover", 0),
            device_resets=s.get("device_resets", 0),
            fenced_binds=s.get("fenced_binds", 0),
            invariant_violations=s.get("invariant_violations", 0),
            ambiguous_binds=s.get("ambiguous_binds", 0),
            lock_findings=lock_findings,
            mesh=s.get("mesh", self.mesh_devices),
            scenario=s.get("scenario", {}),
            preflight=s.get("preflight", ""),
            oom_forensic=s.get("oom_forensic", ""),
        )
        # perf ledger: fold the cycle's phase costs in, confront them
        # with the cost model, run the SLO watchdog, then stamp the
        # verdict on the record, the CycleResult and the trace's counter
        # track. Host math over the spans already collected, no sync;
        # phases use CHILD-EXCLUSIVE durations (a validate nested in
        # solve:batch counts once), the record keeps the inclusive view
        entry = self.ledger.observe_cycle(rec, res,
                                          spans=trace.self_durations())
        if entry is not None:
            rec.slo = entry.slo
            if entry.efficiency >= 0:
                rec.modeled_s = entry.modeled_s
                rec.model_efficiency = entry.efficiency
                rec.model_basis = entry.model_basis
                if res is not None:
                    res.modeled_s = entry.modeled_s
                    res.model_efficiency = entry.efficiency
                trace.counter("model_efficiency", eff=entry.efficiency)
        # memory ledger: the cycle-boundary measured sample (allocator
        # counters on the card, host reads only) against the modeled
        # residents
        mentry = self.memledger.observe_cycle(rec)
        if mentry is not None:
            rec.mem_modeled_bytes = mentry["modeled_bytes"]
            rec.mem_measured_bytes = mentry["measured_bytes"]
            rec.mem_efficiency = mentry["efficiency"]
        self.recorder.record(rec)
        # incident triggers, from state already in hand (the watchdog's
        # burn count, the storm counters, the record's own fields); after
        # recorder.record so the bundle's flight window holds this cycle
        self.incidents.observe_cycle(rec)
        self._eventful_seq += 1
        if self._sampled(self._eventful_seq):
            with self._traces_lock:
                self.traces.append(trace)
        return rec

    # -- export / debug endpoints -------------------------------------------

    def chrome_trace(self) -> dict:
        """Chrome trace-event document over the retained trace ring."""
        with self._traces_lock:
            traces = list(self.traces)
        return chrome_trace_json(traces)

    def export_chrome_trace(self) -> str:
        return json.dumps(self.chrome_trace())

    def debug_payload(self) -> dict:
        """The /debug/flightrecorder body: recorder ring + telemetry."""
        return {
            "flight_recorder": self.recorder.to_json(),
            "jax": self.jax.snapshot(),
        }
