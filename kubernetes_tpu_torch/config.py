"""Configuration: feature gates, ComponentConfig, and legacy Policy (the
port's copy of ``kubernetes_tpu/config.py``, over the port's predicate
table, priority registry and lock sanitizer).

Mirrors the reference's three config layers (SURVEY.md §5 config/flag
system):

- **feature gates** — ``pkg/features/kube_features.go`` catalog through
  ``component-base/featuregate``; parsed from ``K=V,K2=V2`` strings.
- **ComponentConfig** — the versioned ``KubeSchedulerConfiguration``
  (``pkg/scheduler/apis/config/types.go:43-101``): algorithm source,
  percentageOfNodesToScore, bindTimeout, leader election, plugins.
- **legacy Policy** — JSON/ConfigMap predicate+priority selection
  (``pkg/scheduler/api/types.go:46``), decoded here from dicts into an
  enabled-predicate bitmask, a priority weights dict (with custom
  registrations for parameterized priorities), and extender configs.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.ops.predicates import BIT, PREDICATE_BITS
from kubernetes_tpu_torch.sanitize import LockSanitizerConfig

# ---------------------------------------------------------------------------
# Feature gates (pkg/features/kube_features.go @ v1.16 defaults, scheduler-
# relevant subset)
# ---------------------------------------------------------------------------

DEFAULT_FEATURE_GATES: Dict[str, bool] = {
    "EvenPodsSpread": False,          # alpha (kube_features.go:479)
    "AttachVolumeLimit": True,        # beta
    "BalanceAttachedNodeVolumes": False,  # alpha
    "ResourceLimitsPriorityFunction": False,  # alpha
    "TaintNodesByCondition": True,    # beta->GA
    "PodOverhead": False,             # alpha
    "NonPreemptingPriority": False,   # alpha
    "PodPriority": True,              # GA
    "CSIMigration": False,            # alpha
    "LocalStorageCapacityIsolation": True,  # beta
}


class FeatureGates:
    """component-base/featuregate/feature_gate.go: known-gate map with
    defaults; Set() parses the --feature-gates=K=V flag format."""

    def __init__(self, overrides: Optional[Dict[str, bool]] = None) -> None:
        self._gates = dict(DEFAULT_FEATURE_GATES)
        if overrides:
            for k, v in overrides.items():
                self._set(k, v)

    def _set(self, name: str, value: bool) -> None:
        if name not in self._gates:
            raise ValueError(f"unknown feature gate {name!r}")
        self._gates[name] = bool(value)

    def set_from_string(self, spec: str) -> None:
        """Parse "K=true,K2=false" (featuregate.Set)."""
        for part in spec.split(","):
            if not part.strip():
                continue
            k, _, v = part.partition("=")
            if v.lower() not in ("true", "false"):
                raise ValueError(f"invalid feature gate value {part!r}")
            self._set(k.strip(), v.lower() == "true")

    def enabled(self, name: str) -> bool:
        if name not in self._gates:
            raise ValueError(f"unknown feature gate {name!r}")
        return self._gates[name]

    # mutable (set_from_string), so equality only — no __hash__
    def __eq__(self, other) -> bool:
        return (isinstance(other, FeatureGates)
                and self._gates == other._gates)

    __hash__ = None

    def overrides(self) -> Dict[str, bool]:
        """Gates differing from the process defaults — the round-trippable
        spec (what a --feature-gates flag or versioned config would need
        to say to reproduce this object)."""
        return {k: v for k, v in self._gates.items()
                if DEFAULT_FEATURE_GATES[k] != v}


#: process-default gates (utilfeature.DefaultFeatureGate analog)
default_feature_gates = FeatureGates()


# ---------------------------------------------------------------------------
# ComponentConfig (apis/config/types.go:43 KubeSchedulerConfiguration)
# ---------------------------------------------------------------------------


@dataclass
class LeaderElectionConfig:
    leader_elect: bool = True
    lease_duration_s: float = 15.0
    renew_deadline_s: float = 10.0
    retry_period_s: float = 2.0
    lock_object_namespace: str = "kube-system"
    lock_object_name: str = "kube-scheduler"


@dataclass
class RobustnessConfig:
    """Degradation-ladder knobs (no reference analog — the resilience
    layer around the out-of-process batch solver, kubernetes_tpu_torch/faults
    + scheduler._solve_ladder). All times ride the scheduler's injected
    clock, so sim/chaos runs stay deterministic."""

    #: wall-clock budget for one scheduling cycle; 0 disables. Once the
    #: deadline passes, the ladder skips intermediate tiers straight to
    #: the terminal sequential oracle, and extender calls are shed.
    cycle_deadline_s: float = 0.0
    #: bounded in-cycle retries per solver tier before falling through
    solver_retries: int = 1
    #: transport retries (HTTP extender / gRPC shim) per request
    transport_retries: int = 2
    retry_backoff_base_s: float = 0.05
    retry_backoff_max_s: float = 2.0
    #: +/- fractional jitter applied to each backoff interval
    retry_jitter: float = 0.2
    #: consecutive failed cycles before a tier's breaker opens
    breaker_failure_threshold: int = 3
    #: how long an open breaker sheds load before half-opening
    breaker_open_duration_s: float = 30.0
    #: trial calls admitted per half-open episode (the health probes)
    breaker_half_open_probes: int = 1
    #: validate solver results (shape/finiteness/range/capacity) before
    #: trusting them — what keeps a lying solver from binding an
    #: infeasible pod
    validate_results: bool = True
    #: route result validation through the HOST checker
    #: (ops/assign.validate_solution — the trust floor and parity oracle)
    #: instead of the fused on-device validator whose verdict rides the
    #: single end-of-solve readback. Host validation re-materializes the
    #: assignment and four tables per attempt (the PR-7 readback wall);
    #: keep it off unless debugging a suspected device-validator bug.
    host_validate: bool = False
    #: tiers tried after the configured solver fails; "greedy" is the
    #: sequential oracle floor and terminates the chain
    fallback_chain: Tuple[str, ...] = ("batch-cpu", "greedy")
    #: an open extender breaker (or blown deadline) skips the extender
    #: like an Ignorable one instead of failing its pods — progress over
    #: strictness while the remote is down
    extender_degrade_to_ignorable: bool = True
    #: read-your-write verification retries when a bind RPC times out
    #: AMBIGUOUSLY (faults.RPCTimeout — the hub may have committed): the
    #: scheduler GETs the pod and compares uid+nodeName to adopt or
    #: requeue instead of blind-retrying a bind that may have landed;
    #: this bounds the verification GETs per attempt (full-jitter
    #: backoff between them). Unresolvable verifications park the pod
    #: (still assumed) and re-probe each cycle / idle tick.
    bind_verify_retries: int = 3
    #: informer stall detection (sim.Reflector and any reflector built
    #: on it): a watch that delivers NOTHING for this long while the hub
    #: has advanced revisions is treated as silently stalled and forced
    #: to relist (with full-jitter backoff between forced relists so
    #: replicas cannot stampede a recovering hub). 0 disables.
    watch_progress_deadline_s: float = 30.0


@dataclass
class RecoveryConfig:
    """Crash/failover/device-loss recovery knobs (no reference analog —
    the process-level resilience layer above the PR-1 solver ladder):
    fenced binds, takeover reconciliation, and resident-snapshot rebuild
    after an accelerator loss. All times ride the scheduler's injected
    clock, so chaos runs stay deterministic."""

    #: gate every hub write (cache assume -> bind) on the elector's
    #: fencing check (LeaderElector.allow_bind): a deposed or
    #: renew-stalled leader's in-flight binds abort and requeue instead
    #: of racing the new leader at the hub CAS
    fenced_binds: bool = True
    #: on (re)gaining leadership, reconcile against the relisted hub
    #: truth: adopt pods a dead incarnation bound, forget assumptions
    #: the API contradicts, requeue unbound pods, rebuild the resident
    #: device snapshot, re-arm warmup
    reconcile_on_takeover: bool = True
    #: CAS an expired lease record on shutdown so the standby takes over
    #: immediately instead of waiting out the full lease duration
    release_lease_on_shutdown: bool = True
    #: consecutive resident-snapshot rebuild attempts per cycle after a
    #: device error before falling back to host-mode snapshots
    device_reset_limit: int = 2
    #: how long to stay on host-mode snapshots after the rebuild budget
    #: is exhausted before probing the device again (the heal probe)
    device_cooloff_s: float = 5.0


@dataclass
class LedgerConfig:
    """Perf ledger + SLO watchdog (obs/ledger.py): per-cycle
    measured-vs-modeled cost accounting and multi-window burn-rate
    objectives. Rides the observability block (``observability.ledger``)
    because it consumes ``end_cycle`` — the recorder's master switch
    gates it too."""

    #: fold each eventful cycle into the ledger (measured phase
    #: distributions, model efficiency, watchdog). Off = zero per-cycle
    #: cost beyond the flight record that already exists.
    enabled: bool = True
    #: ledger entry ring capacity (cycles); oldest entries evict
    history: int = 256
    #: retained samples per (phase x scope x mesh) distribution cell
    dist_window: int = 256
    #: EWMA decay for the phase trends AND the watchdog's rolling
    #: cycle-cost baseline (higher = faster re-basing after a change)
    baseline_decay: float = 0.05
    #: create-to-bind p99 objective, seconds (0 = objective off): the
    #: watchdog burns when more than 1% of bound pods exceed it
    e2e_p99_objective_s: float = 0.0
    #: cycle-cost drift objective (0 = off): a cycle whose solve cost
    #: exceeds ratio x the rolling per-scope baseline is a violation;
    #: more than 10% violating cycles in a window burns
    cost_drift_ratio: float = 0.0
    #: burn-rate windows (seconds, on the scheduler's clock): the
    #: watchdog trips only when BOTH windows burn (SRE multi-window
    #: rule) and recovers when the FAST window clears
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    #: burn rate (violating fraction / error budget) at which a window
    #: counts as burning
    burn_threshold: float = 1.0
    #: while burning, report the scheduler degraded so APF admission
    #: sheds earlier at the same queue depth (backend_pressure)
    engage_pressure: bool = True


@dataclass
class MemoryLedgerConfig:
    """Device-memory ledger (obs/memledger.py): HBM accounting with
    three faces — modeled resident-byte accounting for every
    device-resident structure, a measured side sampled at cycle
    boundaries only (``device.memory_stats()`` where the backend
    provides it, a bounded ``jax.live_arrays`` census otherwise), and
    the warmup-captured per-bucket peak table the capacity preflight
    judges each cycle's shape against. Rides the observability block
    (``observability.memoryLedger``) like the perf ledger does."""

    #: account resident structures + sample the measured side at cycle
    #: boundaries/idle ticks. Off = zero per-cycle cost and the
    #: preflight never engages.
    enabled: bool = True
    #: min seconds (owner clock) between measured-side samples; 0 =
    #: every cycle boundary. The sample is host-only metadata reads —
    #: never a device sync inside jit — but the CPU fallback's
    #: live-array census walk is O(live arrays) (~ms at bench scale),
    #: so the default keeps it off the per-cycle path: watermarks are
    #: a trend instrument, not a per-cycle one.
    sample_interval_s: float = 0.5
    #: capacity preflight: capture ``memory_analysis()`` per warmed
    #: bucket and judge each cycle's (P, N, mesh) against
    #: limit x headroom_frac, splitting to a smaller warmed bucket or
    #: shedding the batch instead of OOMing
    preflight: bool = True
    #: fraction of the device limit the preflight budgets (the rest is
    #: headroom for XLA scratch the per-bucket analysis undercounts)
    headroom_frac: float = 0.9
    #: device memory limit in bytes for the preflight budget and the
    #: ``limit`` gauge series. 0 = take the backend's
    #: ``memory_stats()['bytes_limit']`` when it reports one (CPU
    #: backends report none — the preflight then never fires unless a
    #: limit is configured here)
    limit_bytes: int = 0
    #: ledger entry ring capacity (cycles) and watermark history length
    history: int = 128
    #: max tensors the CPU census holds and counts per sample (the
    #: bounded fallback measured side where no allocator counts: weak
    #: references to the registered residents' CPU tensors)
    census_limit: int = 4096


@dataclass
class JourneysConfig:
    """Per-pod journey tracer (obs/journey.py): decompose each bound
    pod's end-to-end latency into phase shares (queue-wait, backoff,
    solve, bind-rpc, ambiguous, permit) from the driver's existing host
    seams. Rides the observability block (``observability.journeys``)
    because completion feeds the flight-record vocabulary and the
    incident bundles."""

    #: track journeys (pure host bookkeeping, one lock, zero device
    #: syncs). Off = the seams no-op and /debug/journeys 404s.
    enabled: bool = True
    #: completed journeys retained per rolling window: the K slowest
    slow_k: int = 8
    #: unconditional completion sampling — every N-th bound pod is
    #: retained regardless of slowness (0 = off); keeps healthy
    #: representative timelines next to the tail
    sample_every: int = 100
    #: rolling retention window (seconds, owner clock) for the
    #: slowest-K tier
    window_s: float = 300.0
    #: max in-flight journeys tracked; pods beyond the cap are counted
    #: (``dropped``) but not tracked — pending state must stay bounded
    #: even under an unbounded backlog
    max_pending: int = 4096
    #: per-journey event/attempt row cap (beyond: counted as elided)
    max_events: int = 64


@dataclass
class IncidentsConfig:
    """Incident autopsies (obs/incidents.py): on an SLO-watchdog burn,
    auditor violation, OOM forensic, retrace storm, or ladder-fallback
    burst, capture ONE correlated bundle — flight window, ledger +
    memory + queue snapshots, slowest in-flight journeys, top reasons —
    onto a bounded ring (``/debug/incidents``, SIGUSR2). Rides the
    observability block (``observability.incidents``)."""

    #: evaluate triggers at each eventful cycle close. Off = zero cost.
    enabled: bool = True
    #: incident-bundle ring capacity; oldest bundles evict
    capacity: int = 16
    #: flight records kept per bundle: every record within this many
    #: cycles of the trigger cycle
    flight_window: int = 16
    #: slowest in-flight journeys embedded per bundle
    journeys_k: int = 4
    #: per-trigger suppression: a trigger that fired within this many
    #: cycles of its last bundle is dropped (a sustained burn yields
    #: one bundle, not one per cycle)
    cooldown_cycles: int = 64
    #: cycles a single ladder solve may fall back before the
    #: ``ladder-fallback`` trigger fires (0 = trigger off)
    fallback_burst_threshold: int = 3
    #: arm a ``jax.profiler.start_trace`` capture of this many cycles
    #: when an incident fires (0 = never profile automatically;
    #: /debug/profile can still arm one on demand)
    profile_cycles: int = 0
    #: artifact directory for profiler captures; empty = profiling off
    #: entirely (automatic AND on-demand)
    profile_dir: str = ""
    #: max profiler captures per process — the artifact dir is bounded
    #: even under a trigger flood
    max_profiles: int = 4


@dataclass
class ObservabilityConfig:
    """Observability knobs (kubernetes_tpu_torch/obs): cycle tracing, the JAX
    compile/retrace telemetry, and the flight recorder. All times ride
    the scheduler's injected clock; sampling is deterministic
    (counter-based), so traced runs replay bit-identically."""

    #: master switch for the flight recorder + trace retention. The
    #: threshold-gated slow-cycle log (utiltrace LogIfLong) stays on
    #: either way — it is the cheap always-on profiler.
    enabled: bool = True
    #: cycles slower than this log their span breakdown (LogIfLong).
    trace_threshold_s: float = 1.0
    #: fraction of cycles whose full trace is RETAINED for /debug/traces
    #: and the Chrome exporter (1.0 = every cycle, 0 = none). Retention
    #: is deterministic: cycle k keeps its trace when floor(k*rate)
    #: advances.
    trace_sampling: float = 1.0
    #: flight-recorder ring capacity (cycles); oldest records evict.
    recorder_capacity: int = 256
    #: retained-trace ring capacity (traces held for export).
    trace_ring_capacity: int = 64
    #: retraces at one call site within the window that count as a storm
    retrace_storm_threshold: int = 8
    #: storm window, in calls at that site (count-based, no wall clock)
    retrace_storm_window: int = 64
    #: capture per-cycle Sinkhorn convergence stats (iteration count,
    #: final residual) when the sinkhorn tier solves a cycle
    sinkhorn_telemetry: bool = True
    #: batched schedulability explainer (obs/explain.py): reduce the
    #: cycle's (pod x node) failure bitmask into per-pod reason node
    #: counts, the cluster reason histogram, and one-bit-away
    #: relaxations — feeds /debug/why, the flight recorder's top
    #: reasons, and scheduler_unschedulable_* metrics. The reduction is
    #: jitted and read back at the cycle's existing host boundary; off
    #: drops the analytics but keeps the FitError event text.
    explain: bool = True
    #: relaxations kept per pod and reasons kept per flight record
    explain_top_k: int = 3
    #: state-conservation auditor (obs/audit.py): assert every pod sits
    #: in exactly one of {queued, assumed, bound, gone}, node capacity
    #: is never exceeded by committed binds, and no pod is lost or
    #: zombie-queued across audits. >0 = run it inside the serving
    #: runtime every this-many seconds (cheap: O(pods) host dict walks);
    #: 0 = off there (chaos suites run it continuously regardless).
    audit_interval_s: float = 0.0
    #: perf ledger + SLO watchdog (obs/ledger.py): per-cycle
    #: measured-vs-modeled accounting, burn-rate objectives
    ledger: LedgerConfig = field(default_factory=LedgerConfig)
    #: device-memory ledger (obs/memledger.py): modeled-vs-measured
    #: resident-byte accounting, capacity preflight, OOM forensics
    memory_ledger: MemoryLedgerConfig = field(
        default_factory=MemoryLedgerConfig)
    #: per-pod journey tracer (obs/journey.py): e2e latency decomposed
    #: into phase shares, /debug/journeys
    journeys: JourneysConfig = field(default_factory=JourneysConfig)
    #: incident autopsies (obs/incidents.py): correlated trigger
    #: bundles, /debug/incidents, optional profiler capture
    incidents: IncidentsConfig = field(default_factory=IncidentsConfig)
    #: instrumented-lock runtime sanitizer (sanitize.py): acquisition-
    #: order cycle detection, hold budgets, dynamic guarded-by checks —
    #: off by default (plain threading locks, zero overhead)
    lock_sanitizer: LockSanitizerConfig = field(
        default_factory=LockSanitizerConfig)


@dataclass
class WarmupConfig:
    """Ahead-of-time compile warmup (no reference analog): precompile the
    solver at the bucketed batch shapes the driver will hit, so first-pod
    latency never pays an XLA compile and queue-length churn cannot cause
    retraces (the shapes are already in the jit cache). Runs at startup
    (cli.run) / on demand (Scheduler.warmup); zero-valid synthetic pod
    batches make each warm call one cheap no-progress round."""

    enabled: bool = False
    #: pod-axis bucket sizes to precompile; empty = geometric x2 steps
    #: from ``min_bucket`` up to ``bucket_size(max_batch)`` (the same
    #: bucketing pods_to_device applies, so every runtime shape is
    #: covered by construction)
    pod_buckets: Tuple[int, ...] = ()
    #: smallest bucket warmed when ``pod_buckets`` is empty
    min_bucket: int = 256
    #: also warm the standalone filter pass (the failure-reason /
    #: explain path, compiled separately from the solver)
    include_filter: bool = True
    #: under a mesh, ALSO warm the single-device host-mode signatures —
    #: the shapes a device-loss cooloff cycle presents. Without it the
    #: first cycle after a lost shard pays a hot-path compile and reads
    #: as a retrace; the composed serving-on-mesh mode turns this on so
    #: shard loss mid-churn stays retrace-free end to end.
    host_fallback: bool = False
    #: when preemption is enabled, ALSO warm the nominated-pods solve
    #: variant: the cycle after a preemption carries a (P, N)
    #: feasibility mask (podFitsOnNode pass A — nominated pods counted
    #: onto their nodes), and ``extra_mask`` joins the solve's compile
    #: key. Left unwarmed, the FIRST post-preemption cycle pays a
    #: hot-path XLA compile and reads as a retrace — precisely when the
    #: cluster is tightest on capacity.
    nominated_variant: bool = True


@dataclass
class IncrementalConfig:
    """Incremental solve: make the steady-state cycle cost proportional to
    CHURN instead of the full (P x N) plane. Three coupled pieces ride
    this block: the device-resident per-node score summary
    (``cache.py`` + ``ops/fused_score.py``: clean node columns reused
    across cycles, dirty columns patched in the same delta drain as the
    snapshot), the restricted solve (the micro-batch solves against a
    bounded candidate-column bucket gathered from the resident table
    instead of every node), and warm-started Sinkhorn potentials carried
    across rounds and cycles. The dense solve remains the correctness
    fallback: on pack-epoch growth, interner growth, a node-set change or
    a dirty-frac blowout the cache drops and the next cycle solves cold.
    (Fields and defaults of ``kubernetes_tpu_torch/config.py:448``.)"""

    enabled: bool = False
    #: candidate node columns the restricted solve gathers (snapped UP to
    #: a power of two). Cycles where the padded cluster is not strictly
    #: larger than the bucket take the dense solve
    candidate_bucket: int = 256
    #: restricted solves admit at most candidate_bucket * this many pods
    #: per cycle (larger micro-batches could exhaust the candidate
    #: columns' capacity and under-place against the dense solve)
    max_batch_frac: float = 0.5
    #: dirty-column fraction above which the score summary is dropped and
    #: the cycle solves cold
    max_dirty_frac: float = 0.25
    #: carry the previous solve's Sinkhorn potentials across rounds and
    #: cycles when the sinkhorn tier runs the restricted route
    warm_potentials: bool = True
    #: early-exit tolerance of warm-started Sinkhorn scaling: a warm
    #: residual already under it exits after one verification iteration
    warm_tol: float = 1e-3
    #: documented bound on the warm-vs-cold placement-quality delta (mean
    #: lean score, fraction)
    quality_delta: float = 0.02
    #: sparsity-first routing: full-snapshot cycles solve PARTITIONED
    #: (capacity-balanced restricted blocks plus one remainder pass)
    #: before the dense plane is ever built; the dense solve stays the
    #: fallback for declined or under-placed attempts
    primary: bool = False
    #: block count of the partitioned cold solve; 0 = auto (the padded
    #: node bucket over the candidate bucket, capped at 8)
    cold_blocks: int = 0
    #: auto-tune the candidate bucket from observed micro-batch sizes and
    #: placement depth; without a warmed ladder of buckets it stays
    #: pinned to ``candidate_bucket``
    auto_tune: bool = False
    #: fraction of the candidate bucket that group hints may claim
    group_quota_frac: float = 0.5


@dataclass
class ParallelConfig:
    """Sharded execution backend (kubernetes_tpu_torch/parallel): shard the
    node axis of the device-resident snapshot — and with it the (P, N)
    plane of every solve/validate/explain kernel — across a 1-D
    ``jax.sharding.Mesh``. Pods and selector tables replicate; GSPMD
    inserts the cross-device collectives (per-pod vectors only — no
    (P, N) matrix ever crosses ICI, see parallel/costmodel.py)."""

    #: ``"off"`` = single-device (today's behavior); ``"auto"`` = a mesh
    #: over every local device; an integer N = a mesh over the first N
    #: devices. N must be a power of two (validate_config rejects other
    #: counts — they cannot divide the power-of-two node buckets);
    #: ``make_mesh`` additionally falls back to the largest power-of-two
    #: subset when handed an odd device set at runtime.
    mesh: object = "off"  # "off" | "auto" | int


@dataclass
class ScenarioConfig:
    """Scenario packs (kubernetes_tpu_torch/scenarios): swap the solve
    objective for a paper workload — constraint-based consolidation
    packing ("Priority Matters") or topology-aware DL gangs (Tesserae)
    — with device-computed placement-quality scores riding the cycle's
    existing readback (docs/scenarios.md)."""

    #: "" = scenario mode off (the stock spreading objective);
    #: "consolidation" | "gang-topology" select a pack
    pack: str = ""
    #: weight of the pack's extra (P, N) cost term (consolidation's
    #: occupied-node bias; the gang pack's points per ICI hop saved)
    cost_weight: float = 4.0
    #: consolidation only: nodes per fill block of the blocked
    #: fill-order tie-break (ties persist within a block so a round
    #: still admits ~fill_block * perNodeCap pods; smaller packs
    #: tighter, larger solves in fewer rounds)
    fill_block: int = 64
    #: consolidation only: solve priority-aware preemption cascades
    #: IN-BATCH — victims and displaced pods re-enter one dense solve in
    #: the same cycle instead of the per-pod nominate-and-wait loop
    preempt_in_batch: bool = True
    #: cap on preemptors + displaced pods entering one cascade re-solve
    cascade_max_pods: int = 1024
    #: gang pack only: consecutive slice (zone) indices per superpod —
    #: the middle tier of the hierarchical ICI distance
    superpod: int = 4
    #: compute + read back the per-cycle placement-quality vector
    quality: bool = True
    #: steady-state consolidation re-pack cadence (seconds; 0 = off,
    #: the pre-soak behavior where consolidation acts only at
    #: admission): every interval the scheduler drains the least-
    #: utilized occupied nodes whose pods the rest of the cluster can
    #: absorb and requeues them through the normal cycle, so sustained
    #: churn cannot ratchet fragmentation up between admissions
    repack_interval_s: float = 0.0
    #: per-repack cap on drained pods (bounds one repack's requeue
    #: burst; the cascade budget bounds the re-solve the same way)
    repack_max_pods: int = 64


@dataclass
class ServingConfig:
    """Streaming serving mode (kubernetes_tpu_torch/serving): the event-driven
    micro-batch loop that replaces the fixed ``--cycle-interval`` sleep,
    plus the APF-style load-shedding knobs for the REST facades. All
    windows are seconds; the accumulation targets snap to the same
    power-of-two bucket grid the AOT warmup compiles, so steady-state
    churn never retraces."""

    #: run the event-driven serving loop instead of the fixed-interval
    #: legacy loop in cli.run
    enabled: bool = False
    #: shortest accumulation after the first pending pod — the burst-
    #: coalescing debounce (a bucket-fill may still flush at min_wait)
    min_wait_s: float = 0.005
    #: latency ceiling: the window always flushes by max_wait
    max_wait_s: float = 0.05
    #: accumulation cap in pods, snapped DOWN to a warmed bucket; the
    #: window flushes immediately at this depth
    target_bucket: int = 1024
    #: doorbell park time while the queue is idle (each timeout runs
    #: one idle_tick so backoff flushes still happen)
    idle_wait_s: float = 0.5
    #: APF-style per-flow seats (readonly/mutating flows)
    flow_concurrency: int = 16
    #: seats for the watch flow (fan-out is the expensive class)
    watch_concurrency: int = 8
    #: bounded FIFO of waiters per flow; full queue -> 429
    flow_queue_length: int = 64
    #: longest a queued request waits for a seat before shedding
    queue_timeout_s: float = 1.0
    #: Retry-After answered on 429s
    retry_after_s: float = 1.0
    #: per-watcher send-buffer bound: a watcher this far behind is
    #: disconnected with 410 Gone (relist) instead of stalling the hub
    watch_buffer: int = 4096
    #: backend-pressure shed bound for the mutating flow: admission
    #: sheds with 429 while ``Scheduler.backend_pressure()`` (active-
    #: queue depth, inflated when the solver ladder is degraded or the
    #: device is cooling off) exceeds it. 0 = auto: twice the
    #: accumulation target — two full micro-batches of headroom.
    shed_queue_bound: int = 0
    #: multiplier applied to the queue depth inside backend_pressure()
    #: while the backend is degraded (last cycle solved below the
    #: configured tier, or host-mode snapshots during a device cooloff):
    #: a limping solver sheds earlier at the same queue depth
    degraded_pressure_factor: float = 4.0


@dataclass
class KubeSchedulerConfiguration:
    """The typed component config. Reference fields keep their meanings;
    the ``solver``/``per_node_cap``/``max_batch`` block is this
    implementation's addition (batched-solver tuning)."""

    scheduler_name: str = "default-scheduler"
    algorithm_provider: str = "DefaultProvider"
    policy: Optional["Policy"] = None  # overrides algorithm_provider
    hard_pod_affinity_symmetric_weight: int = 1
    #: 100 = score every node (this framework's default: the dense batch
    #: solver evaluates all nodes in one fused pass, so the reference's
    #: default subsampling would only hurt quality); 0 = the reference's
    #: adaptive 50%->5% rule (parity runs); 1-99 = fixed percent.
    percentage_of_nodes_to_score: int = 100
    bind_timeout_seconds: float = 600.0
    leader_election: LeaderElectionConfig = field(default_factory=LeaderElectionConfig)
    feature_gates: FeatureGates = field(default_factory=FeatureGates)
    #: framework plugins to enable, by PLUGIN_REGISTRY name. The
    #: reference's Plugins struct (apis/config/types.go:98) enables per
    #: extension point; this framework's Plugin classes implement points
    #: by METHOD PRESENCE, so a flat enabled list is the honest recast —
    #: a plugin participates at exactly the points it implements.
    plugins: Tuple[str, ...] = ()
    #: per-plugin args (PluginConfig, types.go:127): name -> args mapping
    #: handed to the registered factory.
    plugin_config: Dict[str, dict] = field(default_factory=dict)
    # batched-solver tuning (no reference analog)
    solver: str = "batch"
    per_node_cap: int = 4
    max_rounds: int = 128
    max_batch: int = 8192
    # ---- pipelined cycle executor (scheduler._pipelined_tail) ----------
    #: 1 = today's monolithic cycle (the seqref-parity mode); >= 2 =
    #: batches larger than ``pipeline_chunk`` execute as fixed-size
    #: chunks with host packing of chunk k+1 and binding of chunk k-1
    #: overlapped with chunk k's device solve (double buffering).
    #: Chunking and data dependencies are identical at every depth >= 2,
    #: so placements are depth-invariant by construction.
    pipeline_depth: int = 2
    #: sub-batch size of the pipelined executor; batches at or under it
    #: stay monolithic. One fixed chunk shape per cycle also pins the
    #: solver's jit signature (last chunk pads to the same bucket).
    pipeline_chunk: int = 4096
    # ---- incremental device-resident snapshot (cache.device_snapshot) --
    #: keep the packed NodeTable resident on device across cycles,
    #: patching only dirty rows with a jitted scatter; False = legacy
    #: full host pack + upload every cycle
    device_resident_snapshot: bool = True
    #: dirty-row fraction above which the delta patch falls back to a
    #: full re-upload (patch cost approaches full-pack cost)
    snapshot_max_dirty_frac: float = 0.25
    #: incremental solve: device-resident score/feasibility cache,
    #: restricted candidate-column solves, warm-started potentials —
    #: steady-state cycle cost O(churn), not O(P x N)
    incremental: IncrementalConfig = field(default_factory=IncrementalConfig)
    #: AOT compile warmup of the bucketed solve shapes
    warmup: WarmupConfig = field(default_factory=WarmupConfig)
    #: degradation ladder / fault-tolerance knobs
    robustness: RobustnessConfig = field(default_factory=RobustnessConfig)
    #: crash / failover / device-loss recovery knobs (fenced binds,
    #: takeover reconciliation, resident-snapshot rebuild)
    recovery: RecoveryConfig = field(default_factory=RecoveryConfig)
    #: cycle tracing / JAX telemetry / flight-recorder knobs
    observability: ObservabilityConfig = field(
        default_factory=ObservabilityConfig)
    #: streaming serving mode (event-driven micro-batch loop + APF-style
    #: load shedding)
    serving: ServingConfig = field(default_factory=ServingConfig)
    #: sharded execution backend (node-axis device mesh)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    #: scenario packs (pluggable solve objective + quality scores)
    scenario: ScenarioConfig = field(default_factory=ScenarioConfig)


# ---------------------------------------------------------------------------
# Legacy Policy (pkg/scheduler/api/types.go:46)
# ---------------------------------------------------------------------------

#: policy predicate name -> failure-reason bits it controls
#: (predicates.go:54-111 registration names)
PREDICATE_NAME_BITS: Dict[str, int] = {
    "PodFitsResources": 1 << BIT["PodFitsResources"],
    "PodFitsHostPorts": 1 << BIT["PodFitsHostPorts"],
    "HostName": 1 << BIT["PodFitsHost"],
    "MatchNodeSelector": 1 << BIT["PodMatchNodeSelector"],
    "GeneralPredicates": (
        (1 << BIT["PodFitsResources"]) | (1 << BIT["PodFitsHost"])
        | (1 << BIT["PodFitsHostPorts"]) | (1 << BIT["PodMatchNodeSelector"])
    ),
    "NoDiskConflict": 1 << BIT["NoDiskConflict"],
    "MaxEBSVolumeCount": 1 << BIT["MaxVolumeCount"],
    "MaxGCEPDVolumeCount": 1 << BIT["MaxVolumeCount"],
    "MaxAzureDiskVolumeCount": 1 << BIT["MaxVolumeCount"],
    "MaxCinderVolumeCount": 1 << BIT["MaxVolumeCount"],
    "MaxCSIVolumeCountPred": 1 << BIT["MaxVolumeCount"],
    "NoVolumeZoneConflict": 1 << BIT["NoVolumeZoneConflict"],
    "CheckVolumeBinding": (
        (1 << BIT["VolumeNodeConflict"]) | (1 << BIT["VolumeBindConflict"])
    ),
    "PodToleratesNodeTaints": 1 << BIT["PodToleratesNodeTaints"],
    "CheckNodeMemoryPressure": 1 << BIT["CheckNodeMemoryPressure"],
    "CheckNodeDiskPressure": 1 << BIT["CheckNodeDiskPressure"],
    "CheckNodePIDPressure": 1 << BIT["CheckNodePIDPressure"],
    "CheckNodeCondition": 1 << BIT["CheckNodeCondition"],
    "CheckNodeUnschedulable": 1 << BIT["CheckNodeUnschedulable"],
    "MatchInterPodAffinity": 1 << BIT["MatchInterPodAffinity"],
    "EvenPodsSpread": 1 << BIT["EvenPodsSpread"],
}

#: always-enforced regardless of Policy (RegisterMandatoryFitPredicate:
#: CheckNodeCondition register_predicates.go:119; PodToleratesNodeTaints +
#: CheckNodeUnschedulable under TaintNodesByCondition defaults.go:78-80)
#: plus VolumeError (unresolvable state is never schedulable).
MANDATORY_BITS = (
    (1 << BIT["CheckNodeCondition"])
    | (1 << BIT["PodToleratesNodeTaints"])
    | (1 << BIT["CheckNodeUnschedulable"])
    | (1 << BIT["VolumeError"])
)

ALL_PREDICATE_BITS = (1 << len(PREDICATE_BITS)) - 1

#: default provider predicate set (defaults.go:40 defaultPredicates)
DEFAULT_PREDICATE_NAMES = (
    "NoVolumeZoneConflict",
    "MaxEBSVolumeCount",
    "MaxGCEPDVolumeCount",
    "MaxAzureDiskVolumeCount",
    "MaxCSIVolumeCountPred",
    "MatchInterPodAffinity",
    "NoDiskConflict",
    "GeneralPredicates",
    "CheckNodeMemoryPressure",
    "CheckNodeDiskPressure",
    "CheckNodePIDPressure",
    "CheckNodeCondition",
    "PodToleratesNodeTaints",
    "CheckVolumeBinding",
)

#: default provider priorities (defaults.go:119 defaultPriorities) —
#: single source of truth lives next to the kernels
from kubernetes_tpu_torch.ops.priorities import DEFAULT_WEIGHTS as DEFAULT_PRIORITY_WEIGHTS  # noqa: E402


def default_predicate_mask(gates: Optional[FeatureGates] = None) -> int:
    """Enabled-bit mask of the default provider + feature-gated additions
    (ApplyFeatureGates defaults.go:59: EvenPodsSpread joins when gated
    on)."""
    gates = gates or default_feature_gates
    bits = MANDATORY_BITS
    for name in DEFAULT_PREDICATE_NAMES:
        bits |= PREDICATE_NAME_BITS[name]
    if gates.enabled("EvenPodsSpread"):
        bits |= PREDICATE_NAME_BITS["EvenPodsSpread"]
    return bits


def default_priority_weights(gates: Optional[FeatureGates] = None) -> Dict[str, float]:
    gates = gates or default_feature_gates
    w = dict(DEFAULT_PRIORITY_WEIGHTS)
    if gates.enabled("EvenPodsSpread"):
        w["EvenPodsSpreadPriority"] = 1
    if gates.enabled("ResourceLimitsPriorityFunction"):
        w["ResourceLimitsPriority"] = 1
    return w


@dataclass
class ExtenderConfig:
    """pkg/scheduler/api/types.go:203 — out-of-process extender endpoint."""

    url_prefix: str = ""
    filter_verb: str = ""
    preempt_verb: str = ""
    prioritize_verb: str = ""
    bind_verb: str = ""
    weight: int = 1
    enable_https: bool = False
    http_timeout_s: float = 30.0
    node_cache_capable: bool = False
    managed_resources: Tuple[str, ...] = ()
    ignorable: bool = False


@dataclass
class Policy:
    """Decoded legacy Policy: the effective predicate mask, priority
    weights (custom parameterized priorities pre-registered under their
    policy names), and extenders."""

    predicate_mask: int = ALL_PREDICATE_BITS
    priority_weights: Dict[str, float] = field(default_factory=dict)
    extenders: List[ExtenderConfig] = field(default_factory=list)
    hard_pod_affinity_symmetric_weight: int = 1
    always_check_all_predicates: bool = False


_policy_prio_seq = 0


def _register_unique(name: str, fn) -> str:
    """Register a policy-parameterized priority kernel under a unique
    internal name. Registrations go to a process-global registry (the
    weights dicts must reference hashable names across the jit boundary),
    so two policies configuring the SAME name with different parameters
    must not collide — each load gets its own entry; the Policy's weights
    dict carries the internal name."""
    global _policy_prio_seq
    from kubernetes_tpu_torch.ops import priorities as prio

    _policy_prio_seq += 1
    internal = f"{name}#{_policy_prio_seq}"
    prio.register_priority(internal, fn)
    return internal


def load_policy(
    data, universe=None, gates: Optional[FeatureGates] = None
) -> Policy:
    """Decode a Policy JSON document (dict or JSON string) the way
    CreateFromConfig (factory.go:356) interprets it:

    - predicates **unspecified** -> default provider set; **empty list** ->
      only mandatory predicates;
    - priorities **unspecified** -> default priorities; **empty list** ->
      none;
    - parameterized priorities (LabelPreference,
      RequestedToCapacityRatioArguments) register custom kernels under the
      policy's name (``universe`` — a snapshot Universe — is required to
      intern label keys for LabelPreference).
    """
    from kubernetes_tpu_torch.ops import priorities as prio

    if isinstance(data, str):
        data = json.loads(data)
    gates = gates or default_feature_gates
    out = Policy()
    out.hard_pod_affinity_symmetric_weight = int(
        data.get("hardPodAffinitySymmetricWeight", 1)
    )
    out.always_check_all_predicates = bool(
        data.get("alwaysCheckAllPredicates", False)
    )

    if "predicates" not in data:
        out.predicate_mask = default_predicate_mask(gates)
    else:
        bits = MANDATORY_BITS
        for p in data["predicates"]:
            name = p["name"]
            if name in PREDICATE_NAME_BITS:
                bits |= PREDICATE_NAME_BITS[name]
            # custom predicates (CheckNodeLabelPresence / CheckServiceAffinity)
            # attach as framework plugins — see policy_framework_plugins()
        out.predicate_mask = bits

    if "priorities" not in data:
        out.priority_weights = default_priority_weights(gates)
    else:
        weights: Dict[str, float] = {}
        for p in data["priorities"]:
            name, weight = p["name"], float(p.get("weight", 1))
            arg = p.get("argument") or {}
            if "labelPreference" in arg:
                if universe is None:
                    raise ValueError("LabelPreference needs the packer universe")
                lp = arg["labelPreference"]
                key_id = universe.label_keys.intern(lp["label"])
                name = _register_unique(
                    name, prio.make_node_label(key_id, bool(lp.get("presence", True)))
                )
            elif "requestedToCapacityRatioArguments" in arg:
                pts = arg["requestedToCapacityRatioArguments"]["utilizationShape"]
                shape = tuple(
                    (int(q["utilization"]), int(q["score"])) for q in pts
                )
                name = _register_unique(
                    name, prio.make_requested_to_capacity_ratio(shape)
                )
            elif name not in prio.PRIORITY_REGISTRY:
                raise ValueError(f"unknown priority {name!r}")
            weights[name] = weight
        out.priority_weights = weights

    for e in data.get("extenders", data.get("extenderConfigs", [])) or []:
        out.extenders.append(
            ExtenderConfig(
                url_prefix=e.get("urlPrefix", ""),
                filter_verb=e.get("filterVerb", ""),
                preempt_verb=e.get("preemptVerb", ""),
                prioritize_verb=e.get("prioritizeVerb", ""),
                bind_verb=e.get("bindVerb", ""),
                weight=int(e.get("weight", 1)),
                enable_https=bool(e.get("enableHttps", False)),
                http_timeout_s=float(e.get("httpTimeout", 30.0)),
                node_cache_capable=bool(e.get("nodeCacheCapable", False)),
                managed_resources=tuple(
                    r.get("name", "") for r in e.get("managedResources", []) or []
                ),
                ignorable=bool(e.get("ignorable", False)),
            )
        )
    return out
