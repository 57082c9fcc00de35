"""The port's copy of ``kubernetes_tpu/metrics.py`` (one family added:
``scheduler_round_loop_captures_total``, the warmup's retrace analog).

Prometheus-compatible metrics, mirroring the reference scheduler's
metric names and shapes (``pkg/scheduler/metrics/metrics.go``) so existing
dashboards/SLO scrapes (e.g. the e2e latency gates,
test/e2e/framework/metrics/latencies.go:257) keep working:

- ``scheduler_schedule_attempts_total{result}`` (counter; result ∈
  scheduled|unschedulable|error — metrics.go:54)
- ``scheduler_scheduling_duration_seconds{operation}`` (summary by phase —
  metrics.go:66; quantiles 0.5/0.9/0.99)
- ``scheduler_e2e_scheduling_duration_seconds`` (histogram, buckets
  exp(0.001, ×2, 15) — metrics.go:88)
- per-phase algorithm histograms, binding latency, preemption counters,
  ``scheduler_pending_pods{queue}`` gauges.

Beyond the reference set: degradation-ladder telemetry (fallbacks,
breaker states, per-tier latency), runtime JAX telemetry
(compile/retrace/transfer counters), and the PR-4 explainability +
queue-observability block —
``scheduler_unschedulable_pods_total{reason}`` /
``scheduler_unschedulable_node_counts{reason}`` (from the batched
why-pending reduction, ``obs/explain.py``),
``scheduler_queue_pod_age_seconds{queue}`` sub-queue residency
histograms, the ``scheduler_pod_scheduling_attempts`` histogram, and
``scheduler_queue_incoming_pods_total{event}`` queue-event counters; plus
the streaming-serving block (``kubernetes_tpu_torch/serving``) —
``scheduler_doorbell_rings_total{reason}``,
``scheduler_microbatch_flushes_total{trigger}`` /
``scheduler_microbatch_window_seconds``,
``scheduler_flowcontrol_{rejected_requests_total,current_inflight_requests}``,
and ``scheduler_watch_evictions_total``; plus the crash/failover
recovery block — ``scheduler_recovery_*_total`` (takeovers, adopted /
forgotten / requeued / drained pods, fenced binds, device resets) and
``scheduler_cache_expired_assumptions_total``; plus the scenario-pack
block (``kubernetes_tpu_torch/scenarios``) —
``scheduler_scenario_quality{score}`` placement-quality gauges and the
in-batch preemption-cascade counters
``scheduler_scenario_{cascade_victims,displaced_replaced}_total``; plus
the incremental-solve block (docs/perf.md §5) —
``scheduler_incremental_cycles_total{scope}`` (restricted | full |
declined | under-placed), the ``scheduler_incremental_reuse_fraction``
gauge, and
``scheduler_incremental_invalidations_total{reason}``; plus the
perf-ledger block (``obs/ledger.py``) —
``scheduler_cycle_model_efficiency`` /
``scheduler_cycle_modeled_cost_seconds`` measured-vs-modeled gauges,
``scheduler_cycle_phase_seconds{phase}`` per-phase attribution (stale
phases read 0, the explain-gauge freshness rule), and
``scheduler_slo_burn_rate{objective,window}``; plus the device-memory
ledger block (``obs/memledger.py``) —
``scheduler_device_memory_bytes{kind,device}`` (resident | peak |
limit measured per device, modeled = the ledger's resident
registrations; stale device series read 0),
``scheduler_memory_model_efficiency`` (modeled/measured bytes at the
last sampled cycle boundary, -1 sentinel on sample-free cycles), and
``scheduler_memory_preflight_total{action}`` (ok | split | shed
capacity-preflight verdicts); plus the network-fault
robustness block (PR 15) —
``scheduler_bind_ambiguous_total{resolution}`` (the ambiguous-RPC bind
protocol's read-your-write verdicts) and
``scheduler_invariant_violations_total{invariant}`` (the
state-conservation auditor, ``obs/audit.py``). Note
``scheduler_e2e_scheduling_duration_seconds`` observes PER-POD
create-to-bind latency (queue-add stamp to bind) since the serving PR,
matching the reference's per-pod scheduleOne observation.

Implementation is a small text-exposition registry (no client library in
the image); histograms use the reference's bucket layouts. Exposition
follows the text-format grammar (HELP/TYPE before samples, cumulative
buckets with ``+Inf`` == ``_count``, label-value escaping) — pinned by
the conformance test in ``tests/test_metrics_exposition.py``.
"""

from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple


def exponential_buckets(start: float, factor: float, count: int) -> List[float]:
    return [start * (factor ** i) for i in range(count)]


_DEF_BUCKETS = exponential_buckets(0.001, 2, 15)  # metrics.go:91 et al.


def escape_label_value(v: str) -> str:
    """Prometheus text-format label escaping (backslash, quote, newline)
    — free-text labels (solver rejection reasons, extender names) must
    never break the exposition line grammar."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class _Metric:
    def __init__(self, name: str, help_: str, label_names: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)

    def _key(self, labels: Dict[str, str]) -> Tuple[str, ...]:
        return tuple(labels.get(k, "") for k in self.label_names)

    def _fmt_labels(self, key: Tuple[str, ...], extra: str = "") -> str:
        parts = [
            f'{k}="{escape_label_value(v)}"'
            for k, v in zip(self.label_names, key)
        ]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_, label_names=()):
        super().__init__(name, help_, label_names)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        k = self._key(labels)
        self._values[k] = self._values.get(k, 0.0) + amount

    def value(self, **labels) -> float:
        return self._values.get(self._key(labels), 0.0)

    def expose(self) -> List[str]:
        out = []
        for k, v in sorted(self._values.items()):
            out.append(f"{self.name}{self._fmt_labels(k)} {v}")
        return out


class Gauge(Counter):
    kind = "gauge"

    def __init__(self, name, help_, label_names=()):
        super().__init__(name, help_, label_names)
        #: monotone write counter — freshness probes (soak sentinels)
        #: need "was this gauge WRITTEN recently", and a value
        #: fingerprint alone can't tell maintained-and-idle (depth set
        #: back to 0 every cycle) from abandoned (nobody sets it)
        self.writes = 0

    def set(self, value: float, **labels) -> None:
        self.writes += 1
        self._values[self._key(labels)] = float(value)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_, label_names=(), buckets: Optional[List[float]] = None):
        super().__init__(name, help_, label_names)
        self.buckets = sorted(buckets or _DEF_BUCKETS)
        self._counts: Dict[Tuple[str, ...], List[int]] = {}
        self._sum: Dict[Tuple[str, ...], float] = {}
        self._n: Dict[Tuple[str, ...], int] = {}

    def observe(self, value: float, **labels) -> None:
        # per-bucket (non-cumulative) storage + one bisect insert: the
        # hot path is O(log buckets), not O(buckets) — per-pod callers
        # (e2e latency, the six journey-phase observes per bound pod)
        # sit on the bind path and pay this on every pod. The slot past
        # the last bucket holds the +Inf overflow; expose()/quantile()
        # rebuild the cumulative view on the cold path.
        k = self._key(labels)
        counts = self._counts.get(k)
        if counts is None:
            counts = self._counts[k] = [0] * (len(self.buckets) + 1)
        counts[bisect.bisect_left(self.buckets, value)] += 1
        self._sum[k] = self._sum.get(k, 0.0) + value
        self._n[k] = self._n.get(k, 0) + 1

    def child(self, **labels):
        """Precomputed-label observe handle for per-pod hot paths (the
        journey tracker's six phase observes per bound pod): binds the
        label key once, so each call is one bisect + three dict writes
        instead of re-deriving the key tuple from kwargs."""
        k = self._key(labels)
        counts = self._counts.get(k)
        if counts is None:
            counts = self._counts[k] = [0] * (len(self.buckets) + 1)
        buckets = self.buckets

        def observe(value: float) -> None:
            counts[bisect.bisect_left(buckets, value)] += 1
            self._sum[k] = self._sum.get(k, 0.0) + value
            self._n[k] = self._n.get(k, 0) + 1

        return observe

    def count(self, **labels) -> int:
        return self._n.get(self._key(labels), 0)

    def quantile(self, q: float, **labels) -> float:
        """Prometheus histogram_quantile analog: linear interpolation
        inside the first bucket whose cumulative count reaches q·n."""
        k = self._key(labels)
        n = self._n.get(k, 0)
        if n == 0:
            return 0.0
        target = q * n
        counts = self._counts[k]
        lo = 0.0
        cum = 0
        for i, b in enumerate(self.buckets):
            prev = cum
            cum += counts[i]
            if cum >= target:
                frac = (target - prev) / max(counts[i], 1)
                return lo + (b - lo) * min(frac, 1.0)
            lo = b
        return self.buckets[-1]

    def expose(self) -> List[str]:
        out = []
        for k in sorted(self._n):
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += self._counts[k][i]
                le = 'le="%s"' % b
                out.append(
                    f"{self.name}_bucket{self._fmt_labels(k, le)} {cum}"
                )
            le_inf = 'le="+Inf"'
            out.append(
                f"{self.name}_bucket{self._fmt_labels(k, le_inf)} {self._n[k]}"
            )
            out.append(f"{self.name}_sum{self._fmt_labels(k)} {self._sum[k]}")
            out.append(f"{self.name}_count{self._fmt_labels(k)} {self._n[k]}")
        return out


class Summary(_Metric):
    """SummaryVec analog (scheduling_duration_seconds is a summary with
    precomputed quantiles, metrics.go:64). Keeps a bounded sample window."""

    kind = "summary"
    objectives = (0.5, 0.9, 0.99)

    def __init__(self, name, help_, label_names=(), max_samples: int = 4096):
        super().__init__(name, help_, label_names)
        self.max_samples = max_samples
        self._samples: Dict[Tuple[str, ...], List[float]] = {}
        self._sum: Dict[Tuple[str, ...], float] = {}
        self._n: Dict[Tuple[str, ...], int] = {}

    def observe(self, value: float, **labels) -> None:
        k = self._key(labels)
        s = self._samples.setdefault(k, [])
        s.append(value)
        if len(s) > self.max_samples:
            del s[: len(s) // 2]
        self._sum[k] = self._sum.get(k, 0.0) + value
        self._n[k] = self._n.get(k, 0) + 1

    def quantile(self, q: float, **labels) -> float:
        s = sorted(self._samples.get(self._key(labels), []))
        if not s:
            return float("nan")
        return s[min(len(s) - 1, int(math.ceil(q * len(s))) - 1)]

    def expose(self) -> List[str]:
        out = []
        for k in sorted(self._n):
            for q in self.objectives:
                qlabel = 'quantile="%s"' % q
                out.append(
                    f"{self.name}{self._fmt_labels(k, qlabel)} "
                    f"{self.quantile(q, **dict(zip(self.label_names, k)))}"
                )
            out.append(f"{self.name}_sum{self._fmt_labels(k)} {self._sum[k]}")
            out.append(f"{self.name}_count{self._fmt_labels(k)} {self._n[k]}")
        return out


class Registry:
    def __init__(self) -> None:
        self._metrics: List[_Metric] = []
        self._lock = threading.Lock()

    def register(self, m):
        with self._lock:
            self._metrics.append(m)
        return m

    def expose(self) -> str:
        lines: List[str] = []
        with self._lock:
            for m in self._metrics:
                lines.append(f"# HELP {m.name} {m.help}")
                lines.append(f"# TYPE {m.name} {m.kind}")
                lines.extend(m.expose())
        return "\n".join(lines) + "\n"


class SchedulerMetrics:
    """The reference's metric set (metrics.Register, metrics.go:186),
    recorded by the driver each cycle."""

    # result labels (metrics.go:41-49)
    SCHEDULED, UNSCHEDULABLE, ERROR = "scheduled", "unschedulable", "error"

    def __init__(self, registry: Optional[Registry] = None) -> None:
        r = self.registry = registry or Registry()
        self.schedule_attempts = r.register(Counter(
            "scheduler_schedule_attempts_total",
            "Number of attempts to schedule pods, by result.",
            ["result"],
        ))
        self.scheduling_duration = r.register(Summary(
            "scheduler_scheduling_duration_seconds",
            "Scheduling latency split by sub-parts of the scheduling operation.",
            ["operation"],
        ))
        self.e2e_scheduling_duration = r.register(Histogram(
            "scheduler_e2e_scheduling_duration_seconds",
            "E2e scheduling latency (scheduling algorithm + binding).",
        ))
        self.algorithm_duration = r.register(Histogram(
            "scheduler_scheduling_algorithm_duration_seconds",
            "Scheduling algorithm latency.",
        ))
        self.predicate_duration = r.register(Histogram(
            "scheduler_scheduling_algorithm_predicate_evaluation_seconds",
            "Scheduling algorithm predicate evaluation duration.",
        ))
        self.priority_duration = r.register(Histogram(
            "scheduler_scheduling_algorithm_priority_evaluation_seconds",
            "Scheduling algorithm priority evaluation duration.",
        ))
        self.preemption_duration = r.register(Histogram(
            "scheduler_scheduling_algorithm_preemption_evaluation_seconds",
            "Scheduling algorithm preemption evaluation duration.",
        ))
        self.binding_duration = r.register(Histogram(
            "scheduler_binding_duration_seconds", "Binding latency.",
        ))
        self.preemption_victims = r.register(Counter(
            "scheduler_pod_preemption_victims", "Number of selected preemption victims",
        ))
        self.preemption_attempts = r.register(Counter(
            "scheduler_total_preemption_attempts",
            "Total preemption attempts in the cluster till now",
        ))
        self.pending_pods = r.register(Gauge(
            "scheduler_pending_pods",
            "Number of pending pods, by the queue type.",
            ["queue"],
        ))
        # -- degradation-ladder observability (no reference analog; the
        # robustness layer around the out-of-process batch solver) -----
        self.solver_fallbacks = r.register(Counter(
            "scheduler_solver_fallback_total",
            "Solve attempts that fell from one ladder tier to the next.",
            ["from_tier", "to_tier"],
        ))
        self.breaker_state = r.register(Gauge(
            "scheduler_circuit_breaker_state",
            "Circuit breaker state per target (0=closed, 1=half-open, "
            "2=open).",
            ["target"],
        ))
        self.solver_tier_duration = r.register(Histogram(
            "scheduler_solver_tier_duration_seconds",
            "Solve latency per degradation-ladder tier.",
            ["tier"],
        ))
        self.solver_rejections = r.register(Counter(
            "scheduler_solver_result_rejections_total",
            "Solver results rejected by validation, by tier and reason.",
            ["tier", "reason"],
        ))
        self.solver_retries = r.register(Counter(
            "scheduler_solver_retries_total",
            "In-cycle solver retries before falling through, by tier.",
            ["tier"],
        ))
        self.extender_degraded = r.register(Counter(
            "scheduler_extender_degraded_total",
            "Extender calls shed by an open breaker or a blown cycle "
            "deadline.",
            ["extender"],
        ))
        self.deadline_exceeded = r.register(Counter(
            "scheduler_cycle_deadline_exceeded_total",
            "Cycles whose deadline expired before the ladder finished.",
        ))
        # -- crash / failover / device-loss recovery (config.Recovery-
        # Config; scheduler.reconcile + fenced binds + resident rebuild)
        self.cache_expired_assumptions = r.register(Counter(
            "scheduler_cache_expired_assumptions_total",
            "Assumed pods whose bind confirmation never arrived within "
            "the assume TTL — capacity freed and the pod requeued.",
        ))
        self.recovery_takeovers = r.register(Counter(
            "scheduler_recovery_takeovers_total",
            "Leadership takeover / cold-start reconciliations run "
            "(relist truth, adopt, forget, requeue, rebuild residents).",
        ))
        self.recovery_adopted = r.register(Counter(
            "scheduler_recovery_adopted_pods_total",
            "Bound pods adopted from the relisted hub truth during a "
            "takeover reconciliation (bound by a dead incarnation or "
            "another writer).",
        ))
        self.recovery_forgotten = r.register(Counter(
            "scheduler_recovery_forgotten_assumptions_total",
            "Cached assumptions the relisted hub truth contradicted "
            "(pod gone, recreated uid, or bound elsewhere) — forgotten "
            "during takeover reconciliation.",
        ))
        self.recovery_requeued = r.register(Counter(
            "scheduler_recovery_requeued_pods_total",
            "Unbound responsible pods (re)queued by a takeover "
            "reconciliation so every schedulable pod is eventually "
            "bound.",
        ))
        self.recovery_drained = r.register(Counter(
            "scheduler_recovery_drained_pods_total",
            "In-flight pods (Permit-parked or assumed) drained and "
            "requeued when this scheduler stopped leading.",
        ))
        self.recovery_fenced_binds = r.register(Counter(
            "scheduler_recovery_fenced_binds_total",
            "Binds aborted by the lease fence (deposed or renew-stalled "
            "leader) instead of racing the new leader at the hub.",
        ))
        self.recovery_device_resets = r.register(Counter(
            "scheduler_recovery_device_resets_total",
            "Resident device snapshot drops + rebuilds after a device "
            "error (device lost / OOM).",
        ))
        # -- network-fault robustness (PR 15): the ambiguous-RPC bind
        # protocol and the state-conservation auditor ------------------
        self.bind_ambiguous = r.register(Counter(
            "scheduler_bind_ambiguous_total",
            "Ambiguously timed-out bind RPCs by read-your-write "
            "resolution: adopted (the hub HAD committed — confirmed, "
            "never re-bound), requeued (verified not committed — safe "
            "retry), conflict (bound elsewhere / recreated uid), gone "
            "(pod deleted mid-bind), deferred (verification itself "
            "unreachable — pod parked assumed, re-probed later). "
            "expired-* variants are the same verdicts reached from an "
            "assume-TTL expiry (lost watch confirmation) instead of an "
            "in-cycle bind timeout.",
            ["resolution"],
        ))
        self.invariant_violations = r.register(Counter(
            "scheduler_invariant_violations_total",
            "State-conservation auditor violations by invariant "
            "(multi-state, capacity, lost-pod, double-bind-risk, "
            "stale-entry — obs/audit.py). Any nonzero value is a "
            "correctness bug, never noise.",
            ["invariant"],
        ))
        self.lock_sanitizer_findings = r.register(Counter(
            "scheduler_lock_sanitizer_findings_total",
            "Instrumented-lock sanitizer findings by kind (order-cycle "
            "= the acquisition-order graph gained a cycle, a potential "
            "deadlock; held-too-long = a lock exceeded its hold budget; "
            "guard-violation = an assert_held declaration was false — "
            "kubernetes_tpu_torch/sanitize.py). Only emitted when "
            "observability.lockSanitizer armed the sanitizer; any "
            "order-cycle or guard-violation is a correctness bug.",
            ["kind"],
        ))
        # -- runtime JAX telemetry (kubernetes_tpu_torch/obs): the dynamic twin
        # of graftlint's static R3 rule, plus host-boundary transfer
        # accounting and Sinkhorn convergence ---------------------------
        self.jax_compile_cache = r.register(Counter(
            "scheduler_jax_compile_cache_total",
            "Jitted-call observations by site and class (hit = abstract "
            "signature seen before; compile = site's first signature; "
            "retrace = NEW signature at a warmed site, i.e. an XLA "
            "recompile).",
            ["site", "result"],
        ))
        self.jax_retraces = r.register(Counter(
            "scheduler_jax_retrace_total",
            "Retraces (new abstract signature at an already-compiled call "
            "site) — each one is a synchronous XLA recompile on the hot "
            "path.",
            ["site"],
        ))
        self.jax_retrace_storms = r.register(Counter(
            "scheduler_jax_retrace_storm_total",
            "Retrace storms: threshold-many retraces at one site within "
            "the call window (bucketed batch shapes exist to keep this 0).",
            ["site"],
        ))
        self.host_transfers = r.register(Counter(
            "scheduler_host_transfer_total",
            "Device<->host transfers at declared host boundaries, by site "
            "and direction (h2d upload / d2h readback).",
            ["site", "direction"],
        ))
        self.host_transfer_bytes = r.register(Counter(
            "scheduler_host_transfer_bytes_total",
            "Bytes moved across the device boundary at declared host "
            "boundaries.",
            ["site", "direction"],
        ))
        self.readback_bytes = r.register(Counter(
            "scheduler_readback_bytes_total",
            "Device->host readback bytes per declared site — the readback "
            "wall's dedicated meter (PR 7 shrank the steady-state cycle "
            "to one small solve-result transfer; this is what keeps it "
            "measurable after the fall).",
            ["site"],
        ))
        self.sinkhorn_iterations = r.register(Histogram(
            "scheduler_sinkhorn_iterations",
            "Sinkhorn scaling iterations until the row-potential delta "
            "dropped under tolerance (== configured iters when it never "
            "converged).",
            buckets=[1, 2, 4, 8, 16, 32, 64, 128],
        ))
        self.sinkhorn_residual = r.register(Gauge(
            "scheduler_sinkhorn_final_residual",
            "Final max row-potential delta of the last Sinkhorn solve "
            "(log-domain; lower is more converged).",
        ))
        # -- incremental snapshot + pipelined executor (PR 5) -----------
        self.snapshot_packs = r.register(Counter(
            "scheduler_snapshot_packs_total",
            "Device snapshot refreshes by mode: full = whole-table pack "
            "+ upload; delta = dirty rows re-packed and scattered into "
            "the resident device table; clean = nothing changed, the "
            "resident arrays were reused untouched.",
            ["mode"],
        ))
        self.snapshot_rows_packed = r.register(Counter(
            "scheduler_snapshot_rows_packed_total",
            "Node rows re-packed on host and uploaded across snapshot "
            "refreshes — steady-state cost proportional to what changed.",
        ))
        self.pipeline_chunks = r.register(Counter(
            "scheduler_pipeline_chunks_total",
            "Sub-batches executed by the pipelined cycle executor "
            "(pack/solve/readback/bind overlapped across chunks).",
        ))
        self.warmup_compiles = r.register(Counter(
            "scheduler_warmup_compiles_total",
            "Bucketed solve shapes compiled ahead of time by the warmup "
            "pass (cli --warmup / Scheduler.warmup).",
        ))
        # the port's analog of scheduler_jax_retrace_total: a captured
        # round-loop graph is the port's compiled program, and a capture
        # outside the warmup is one the warmup did not cover
        self.graph_captures = r.register(Counter(
            "scheduler_round_loop_captures_total",
            "Round-loop CUDA graph captures (ops/device_loop.py), by "
            "phase: warmup, or cycle (a shape the warmup did not cover).",
            ["phase"],
        ))
        # -- incremental solve (restricted candidate-column cycles) -----
        self.incremental_cycles = r.register(Counter(
            "scheduler_incremental_cycles_total",
            "Scheduling cycles by solve scope under the incremental "
            "mode: restricted = solved against the cached score plane's "
            "candidate columns (O(churn)); full = the cold dense solve "
            "(fallback or ineligible); declined = a restricted attempt "
            "that errored/failed validation; under-placed = a restricted "
            "attempt that could not place every pod (both re-solve cold "
            "in the same cycle and ALSO count under full).",
            ["scope"],
        ))
        self.incremental_reuse_fraction = r.register(Gauge(
            "scheduler_incremental_reuse_fraction",
            "Fraction of the score plane's node columns REUSED from the "
            "device-resident cache by the last cycle (1 - recomputed/"
            "live; 0 on full solves) — cost proportional to churn, "
            "measured.",
        ))
        self.incremental_invalidations = r.register(Counter(
            "scheduler_incremental_invalidations_total",
            "Score-cache + warm-potential drops by invalidation edge: "
            "full-snapshot (node-set/interner/pack-epoch growth), "
            "dirty-frac blowout, takeover reconciliation, device-loss "
            "recovery, restricted-error.",
            ["reason"],
        ))
        # -- sharded execution backend (kubernetes_tpu_torch/parallel) --------
        self.mesh_devices = r.register(Gauge(
            "scheduler_mesh_devices",
            "Devices in the node-axis mesh of the sharded execution "
            "backend (parallel.mesh config; 0 = single-device mode).",
        ))
        # -- perf ledger + SLO watchdog (obs/ledger.py) -----------------
        self.cycle_model_efficiency = r.register(Gauge(
            "scheduler_cycle_model_efficiency",
            "Last cycle's modeled/measured solve-cost ratio (1 = the "
            "cost model's prediction matched the measured solve; <1 = "
            "the cycle ran slower than the model claims — the runtime "
            "confrontation of parallel/costmodel.py with reality; -1 = "
            "the last cycle ran no solve, so no verdict).",
        ))
        self.cycle_modeled_cost = r.register(Gauge(
            "scheduler_cycle_modeled_cost_seconds",
            "The cost model's predicted solve seconds for the last "
            "cycle's batch shape (XLA cost_analysis flops when "
            "captured at warmup, analytic P*N plane otherwise, with "
            "the collective model folded in under a mesh; -1 = the "
            "last cycle ran no solve).",
        ))
        self.cycle_phase_seconds = r.register(Gauge(
            "scheduler_cycle_phase_seconds",
            "Last cycle's measured wall seconds per canonical phase "
            "(snapshot, pack, dispatch, solve, validate, readback, "
            "bind, ...) — per-phase attribution of where the cycle "
            "went; phases the last cycle did not run read 0.",
            ["phase"],
        ))
        self.slo_burn_rate = r.register(Gauge(
            "scheduler_slo_burn_rate",
            "Multi-window SLO burn rate per objective (violating "
            "fraction / error budget; >= the configured threshold in "
            "BOTH windows trips SchedulerSLOBurn and engages APF "
            "backpressure).",
            ["objective", "window"],
        ))
        # -- device-memory ledger (obs/memledger.py) --------------------
        self.device_memory_bytes = r.register(Gauge(
            "scheduler_device_memory_bytes",
            "Device memory by kind: resident = measured bytes in use "
            "per device (memory_stats; the bounded live-array census "
            "on backends without it, device=\"census\"), peak = the "
            "allocator's high watermark, limit = the device capacity "
            "(0 = unknown), modeled = the ledger's summed resident "
            "registrations (device=\"all\"). Devices that stop "
            "reporting read 0 (freshness rule).",
            ["kind", "device"],
        ))
        self.memory_model_efficiency = r.register(Gauge(
            "scheduler_memory_model_efficiency",
            "Modeled resident bytes / measured bytes in use at the "
            "last sampled cycle boundary (1 = the byte model explains "
            "everything the allocator holds; low = untracked device "
            "memory — a leak or an unregistered resident; -1 = the "
            "last boundary took no sample, same sentinel rule as "
            "scheduler_cycle_model_efficiency).",
        ))
        self.memory_preflight = r.register(Counter(
            "scheduler_memory_preflight_total",
            "Capacity-preflight verdicts per cycle shape against the "
            "warmed per-bucket memory_analysis table: ok = fits (or "
            "not judgeable), split = trimmed to a smaller warmed "
            "bucket, shed = requeued whole rather than OOMing.",
            ["action"],
        ))
        # -- pod journeys & incident autopsies (obs/journey.py,
        # obs/incidents.py): where each bound pod's e2e seconds went,
        # and the correlated-bundle trigger counts ----------------------
        self.pod_journey_phase_seconds = r.register(Histogram(
            "scheduler_pod_journey_phase_seconds",
            "Per-phase share of each bound pod's create-to-bind "
            "latency (queue-wait | backoff | solve | bind-rpc | "
            "ambiguous | permit — disjoint; a pod's phases sum to its "
            "e2e latency). Every bound pod observes EVERY phase, zeros "
            "included, so per-phase sample counts stay comparable.",
            ["phase"],
            buckets=exponential_buckets(0.001, 2, 15),
        ))
        self.pod_journeys_total = r.register(Counter(
            "scheduler_pod_journeys_total",
            "Completed pod journeys by outcome: bound = confirmed "
            "bind, gone = left unbound (deleted, terminating, pruned "
            "by reconcile, taken by another writer).",
            ["outcome"],
        ))
        self.incidents_total = r.register(Counter(
            "scheduler_incidents_total",
            "Incident bundles captured by trigger (slo-burn | "
            "invariant-violation | oom | retrace-storm | "
            "ladder-fallback); cooldown-suppressed repeats don't "
            "count. Each bundle correlates the flight window, ledger "
            "+ memory + queue snapshots, and the slowest in-flight "
            "journeys at /debug/incidents.",
            ["trigger"],
        ))
        # -- scenario packs (kubernetes_tpu_torch/scenarios) ------------------
        self.scenario_quality = r.register(Gauge(
            "scheduler_scenario_quality",
            "Last cycle's placement-quality scores under the active "
            "scenario pack (nodes_used, headroom, fragmentation, "
            "gang_success_rate, ... — docs/scenarios.md quality table).",
            ["score"],
        ))
        self.scenario_cascade_victims = r.register(Counter(
            "scheduler_scenario_cascade_victims_total",
            "Victims evicted by the in-batch preemption cascade "
            "(scenario packs; the per-pod path counts under "
            "scheduler_preemption_victims_total).",
        ))
        self.scenario_displaced_replaced = r.register(Counter(
            "scheduler_scenario_displaced_replaced_total",
            "Cascade victims that re-placed onto another node in the "
            "SAME cycle's dense re-solve (migrated rather than lost).",
        ))
        self.scenario_repacks = r.register(Counter(
            "scheduler_scenario_repacks_total",
            "Steady-state consolidation re-pack sweeps that drained at "
            "least one pod (scenario.repackInterval cadence).",
        ))
        self.scenario_repack_drained = r.register(Counter(
            "scheduler_scenario_repack_drained_total",
            "Pods drained off under-utilized nodes by the steady-state "
            "re-pack cadence and requeued for consolidation.",
        ))
        # -- schedulability explainer (obs/explain.py): the batched
        # why-pending reduction over the (pod x node) failure bitmask ---
        self.unschedulable_pods = r.register(Counter(
            "scheduler_unschedulable_pods_total",
            "Unschedulable pod observations per cycle, by the predicate "
            "that blocked them on at least one node (one pod can count "
            "under several reasons).",
            ["reason"],
        ))
        self.unschedulable_node_counts = r.register(Gauge(
            "scheduler_unschedulable_node_counts",
            "Last cycle's total (pod, node) predicate-failure pairs per "
            "reason — how many node exclusions each constraint class "
            "caused across the residual queue.",
            ["reason"],
        ))
        # -- streaming serving mode (kubernetes_tpu_torch/serving): doorbell,
        # micro-batch window, APF-style load shedding, watch fan-out ----
        self.doorbell_rings = r.register(Counter(
            "scheduler_doorbell_rings_total",
            "Doorbell rings by source (queue events, informer sweeps, "
            "REST mutations) — what wakes the event-driven serving loop "
            "instead of a fixed-interval timer.",
            ["reason"],
        ))
        self.microbatch_flushes = r.register(Counter(
            "scheduler_microbatch_flushes_total",
            "Micro-batch window flushes by trigger (bucket-fill = the "
            "accumulated depth hit a warmed power-of-two bucket; "
            "max-wait = the latency ceiling expired).",
            ["trigger"],
        ))
        self.microbatch_window = r.register(Histogram(
            "scheduler_microbatch_window_seconds",
            "How long the serving loop's accumulation window held "
            "before flushing into a cycle.",
            buckets=exponential_buckets(0.001, 2, 12),
        ))
        self.apf_rejected = r.register(Counter(
            "scheduler_flowcontrol_rejected_requests_total",
            "Requests shed by the APF-style flow controller (answered "
            "429 + Retry-After), by flow and shed reason (queue-full, "
            "timeout, saturated).",
            ["flow", "reason"],
        ))
        self.apf_inflight = r.register(Gauge(
            "scheduler_flowcontrol_current_inflight_requests",
            "Requests currently holding a seat per flow schema.",
            ["flow"],
        ))
        self.watch_evictions = r.register(Counter(
            "scheduler_watch_evictions_total",
            "Watchers disconnected (410 Gone -> relist) because their "
            "bounded send buffer overflowed — slow consumers are cut "
            "loose instead of stalling the fan-out hub.",
        ))
        # -- queue observability (scheduler_queue.go metrics parity) ----
        self.queue_pod_age = r.register(Histogram(
            "scheduler_queue_pod_age_seconds",
            "Time pods spent in a scheduling sub-queue before leaving it "
            "(observed at queue exit), by sub-queue.",
            ["queue"],
            # residency runs minutes-to-hours (the unschedulable flush
            # alone is 60s), so the default 1ms..16s latency layout
            # would collapse every sample into +Inf — span 10ms..~87min
            buckets=exponential_buckets(0.01, 2, 20),
        ))
        self.pod_scheduling_attempts = r.register(Histogram(
            "scheduler_pod_scheduling_attempts",
            "Number of attempts it took to successfully schedule a pod.",
            buckets=[1, 2, 4, 8, 16],
        ))
        self.queue_incoming_pods = r.register(Counter(
            "scheduler_queue_incoming_pods_total",
            "Pods added to scheduling queues, by the event that moved "
            "them (PodAdd, PodUpdate, ScheduleAttemptFailure, "
            "BackoffComplete, UnschedulableTimeout, MoveAllToActive, "
            "MovePodsToActive).",
            ["event"],
        ))
