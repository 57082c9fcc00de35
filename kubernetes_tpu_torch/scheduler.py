"""The scheduling loop — the batched analog of the reference's control
loop (``pkg/scheduler/scheduler.go:256`` Run / ``:462`` scheduleOne), on
PyTorch tensors (the port of ``kubernetes_tpu/scheduler.py``: the
monolithic cycle and the pipelined cycle executor).

Where the reference pops ONE pod, filters/scores all nodes for it,
assumes and binds, this loop pops the whole activeQ, solves the batch on
the device (filter mask + score matrix + assignment rounds, see
``ops/assign.py``), then assumes + binds every placed pod and routes every
unplaced pod through the reference's error path (record backoff →
AddUnschedulableIfNotPresent):

    cycle():
      queue.tick(); reap expired assumptions         # verified by GET
      re-probe parked ambiguous binds
      batch = queue.pop_batch()                      # NextPod, batched
      PreFilter plugins                              # framework
      nt, dn = cache.device_snapshot()               # resident, patched;
                                                     # rebuilt on a loss
      node-search truncation, extenders              # extra_mask/score
      pass A: nominated pods as phantoms -> extra_mask
      assigned = ladder(batch)                       # tier, batch-cpu, greedy
      device_validate + ONE readback                 # verdict, rounds, rows
      for pod, node in assigned: assume, reserve, permit, bind
      explain_reduce + ONE readback                  # reasons, FitError text
      for pod in unassigned: requeue; explain report
      preemption: evict, nominate                    # failed pods' rows

With the defaults (``pipeline_depth=2, pipeline_chunk=4096``, as in the
reference) a batch of more than ``pipeline_chunk`` pods takes the
pipelined executor instead (``_pipelined_tail``): chunks of
``pipeline_chunk`` pods solve one after another, each against the usage
the chunk before it left, while the host packs the next chunk and binds
the previous one (``pipeline_depth=1`` keeps the monolithic cycle).

With ``incremental=IncrementalConfig(enabled=True)`` two sparsity-first
routes come before the dense ladder (``_restricted_tail``,
``_partitioned_cold_tail``): a steady micro-batch on a clean or delta
snapshot solves RESTRICTED, on the top-C candidate columns picked from
the cache's resident score summary; with ``primary`` a cycle the
restricted route did not take solves PARTITIONED, in B capacity-balanced
(P, C) column blocks plus one remainder pass. Either binds only when the
whole batch placed; anything less falls through to the dense ladder in
the same cycle.

Every cycle goes through the observability facade (``Scheduler.obs``,
:mod:`.obs.core`) as the reference's does: one trace on the scheduler's
clock with spans at the reference's sites and under its names, the
reference's notes, one flight record per eventful cycle
(``obs.recorder``), pod journeys fed from the queue and the bind path
(``obs.journeys``), and the readbacks charged to their sites
(``obs.jax``). It records the reference's metrics (``Scheduler.metrics``,
:mod:`.metrics`); ``state_sizes`` is what the soak's leak sentinels read.

The degradation ladder is the reference's: the configured tier
(``batch``, ``sinkhorn``, ``greedy`` or ``exact``), then
``robustness.fallback_chain`` (``batch-cpu``: the same solve on CPU
tensors; then the greedy oracle), with bounded in-cycle retries, a
circuit breaker per tier and a cycle deadline that skips to the floor.
``Scheduler.from_config`` builds a scheduler from a
KubeSchedulerConfiguration; ``warmup`` builds the kernels and captures
the round-loop graphs of every shape a cycle will present.

The serve loop drives the same cycle (``serving/``, ``cli.run``):
``attach_doorbell`` wires the queue's doorbell, ``idle_tick`` keeps the
queue alive between cycles, ``schedule_cycle(flush_trigger, window_s)``
records a micro-batch's provenance, and ``backend_pressure`` feeds the
APF shedding. Leader election fences every bind (``attach_elector``,
``_fence_ok``): a deposed leader drains its in-flight state
(``on_stopped_leading``) and a new one reconciles against the relisted
truth (``reconcile``) before its first cycle.

Recovery (the reference's network and device faults): a bind that times
out AMBIGUOUSLY (``faults.RPCTimeout``: the hub may have committed before
the answer was lost) is never retried blind. With a ``pod_reader`` (a
GET of the pod from the hub) it is resolved by read-your-write: adopted,
requeued, or, when the GET is unreachable too, parked assumed without a
TTL and re-probed every cycle and idle tick (``_handle_ambiguous_bind``,
``_verify_ambiguous_binds``); without one it stays assumed until its TTL.
The TTL reaper verifies expired assumptions the same way. A device error
in the resident snapshot (a CUDA out-of-memory error, or the injected
``snapshot:device`` faults) drops and rebuilds the resident table up to
``recovery.device_reset_limit`` times a cycle; past that the cycles run
in host mode (the host table uploaded whole every cycle, as
``device_resident_snapshot=False`` does always) for
``recovery.device_cooloff_s``, and ``is_degraded`` says so
(``_device_snapshot_recovering``). A ``kernels.KernelError`` is never
taken for a device loss. ``attach_auditor`` wires the state-conservation
auditor (``obs/audit.py``).

Observability's device backends (``obs/ledger.py``,
``obs/memledger.py``, ``obs/incidents.py``) ride the cycle: before the
batch is uploaded, the capacity preflight judges its padded shape against
the warmed buckets' measured peaks and splits an over-budget batch down
to a warmed bucket that fits, or sheds it back to the queue (a pipelined
batch sheds); a device loss records a ranked forensic snapshot of the
residents before the drop; while the SLO watchdog burns, ``is_degraded``
reads true; warmup anchors the cost model with one timed replay and
measures each bucket's peak.

A scenario pack (``scenario=ScenarioConfig(pack=...)``,
:mod:`.scenarios`) swaps the solve objective: its priority weights
replace the configured set at construction, so every ladder tier sees
them, and its (P, N) cost term joins ``extra_score`` on the dense cycle,
the restricted frame (with the pack's candidate hint) and each pipelined
chunk. With ``scenario.quality`` a device reduction of the final usage
and assignment is read back once after the bind loop
(``CycleResult.scenario_quality``, the flight record, the
``scheduler_scenario_quality`` gauges); such cycles stay monolithic.
Consolidation with ``preemptInBatch`` runs preemption as an in-batch
cascade (``_run_preemption_cascade``): victims are evicted and the
preemptors and displaced pods re-solve in the same cycle. With
``repackInterval`` a sweep before the batch pops (and on the idle tick)
drains the least-used nodes whose pods the rest can absorb
(``maybe_repack``).

With ``parallel=ParallelConfig(mesh=...)`` (``parallel.mesh`` in the
config) the node axis of the resident table shards across a 1-D device
mesh (:mod:`.parallel.mesh`: distinct cards, or one card repeated as a
logical mesh): the cache pads the node bucket to at least the mesh size
and keeps the table placed on the mesh (row block i on device i; on
distinct cards no device holds the whole table). Every node-axis pass
of the cycle runs as one program per shard over its own block
(``parallel/collectives.py`` holds every exchange): the configured
batch tier (the round-loop graph key carries the shard count), the
failure pass and ``explain_reduce``, the preemption rows (only their k
rows gathered), pass A, the usage updates, ``device_validate``,
``quality_reduce``, a scenario pack's cost terms and the sparse
routes' candidate pick and row gather. The batch shape carries
``+mesh{d}``, the flight record its width (0 for a cooloff cycle, which
runs single-device) and the ladder gains the ``batch-single`` rung
before ``batch-cpu``: the identical solve on the whole table gathered
onto the mesh's first device (``collectives.whole_table``, one counted
``gather_nodes``), as the greedy and exact tiers and a framework batch
plugin take it.
"""

from __future__ import annotations

import dataclasses
import operator
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Protocol, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch import resolve_device
from kubernetes_tpu_torch.api.types import Pod, is_pod_terminated
from kubernetes_tpu_torch.cache import SchedulerCache
from kubernetes_tpu_torch.config import (
    IncrementalConfig,
    ObservabilityConfig,
    ParallelConfig,
    RecoveryConfig,
    RobustnessConfig,
    ScenarioConfig,
    WarmupConfig,
)
from kubernetes_tpu_torch.faults import (
    CLOSED,
    OPEN,
    STATE_CODE,
    CircuitBreaker,
    RetryPolicy,
    RPCTimeout,
    SolverFault,
    SolverResultInvalid,
)
from kubernetes_tpu_torch.framework import (
    SKIP,
    WAIT,
    CycleState,
    Framework,
)
from kubernetes_tpu_torch import kernels, native
from kubernetes_tpu_torch.metrics import SchedulerMetrics
from kubernetes_tpu_torch.nodetree import NodeTree, num_feasible_nodes_to_find
from kubernetes_tpu_torch.obs.core import Observability
from kubernetes_tpu_torch.obs.explain import (
    PodExplanation,
    UnschedulableReport,
    build_report,
    explain_rows,
    read_back,
)
from kubernetes_tpu_torch.ops import device_loop
from kubernetes_tpu_torch.parallel import collectives as coll
from kubernetes_tpu_torch.parallel import mesh as pmesh
from kubernetes_tpu_torch.ops.arrays import (
    gather_candidates,
    gather_node_rows,
    map_restricted_assignment,
    nodes_to_device,
    pods_to_device,
    scatter_node_rows,
    selectors_to_device,
    topology_to_device,
    upload,
    volumes_to_device,
)
from kubernetes_tpu_torch.ops.assign import (
    VALIDATE_REASONS,
    _apply_batch,
    batch_assign,
    device_validate,
    greedy_assign,
    nodes_with_usage,
    usage_from_nodes,
    validate_solution,
)
from kubernetes_tpu_torch.ops.fused_score import (
    node_summary,
    partition_columns,
    patch_node_summary,
    use_kernels,
)
from kubernetes_tpu_torch.ops.predicates import (
    BIT,
    decode_reasons,
    fit_error_message_from_counts,
    run_predicates,
    reason_rows,
    static_volume_reasons,
)
from kubernetes_tpu_torch.ops.priorities import (
    DEFAULT_WEIGHTS,
    run_priorities,
    solver_gates,
)
from kubernetes_tpu_torch.ops.scenario_cost import quality_reduce
from kubernetes_tpu_torch.ops.sync import SYNCS, to_cpu
from kubernetes_tpu_torch.preemption import preempt
from kubernetes_tpu_torch.queue import SchedulingQueue
from kubernetes_tpu_torch.sanitize import LockSanitizer
from kubernetes_tpu_torch.scenarios.cascade import select_cascade
from kubernetes_tpu_torch.scenarios.packs import resolve_pack
from kubernetes_tpu_torch.scenarios.quality import decode_quality
from kubernetes_tpu_torch.snapshot import FIXED_RESOURCE_NAMES, RES_PODS
from kubernetes_tpu_torch.utils import klog
from kubernetes_tpu_torch.utils.interner import Interner, bucket_size
from kubernetes_tpu_torch.volumes import VolumeBinder

#: the tiers a scheduler may be configured with (``robustness.
#: fallback_chain`` may add ``batch-cpu``)
TIERS = ("batch", "sinkhorn", "greedy", "exact")


class RecoveryTally:
    """Process-wide running counts of device-loss recovery, over every
    scheduler: resident-table resets (each also counts on its scheduler's
    ``scheduler_recovery_device_resets_total``) and cycles that ran in
    host mode. A caller that injects no fault can zero them before a run
    and hold them at 0 after it, so a real device fault never passes as a
    quiet fallback."""

    def __init__(self) -> None:
        self.device_resets = 0
        self.host_cycles = 0

    def reset(self) -> None:
        self.device_resets = 0
        self.host_cycles = 0


RECOVERY = RecoveryTally()


class Binder(Protocol):
    """The scheduler's only write — POST pods/{name}/binding."""

    def bind(self, pod: Pod, node_name: str) -> None: ...


class RecordingBinder:
    """Test binder capturing bindings."""

    def __init__(self) -> None:
        self.bindings: List[Tuple[str, str]] = []

    def bind(self, pod: Pod, node_name: str) -> None:
        self.bindings.append((pod.key(), node_name))


@dataclass
class CycleResult:
    """What one scheduling cycle did (inputs to metrics + events)."""

    attempted: int = 0
    scheduled: int = 0
    unschedulable: int = 0
    bind_errors: int = 0
    rounds: int = 0
    assignments: Dict[str, str] = field(default_factory=dict)  # pod -> node
    failure_reasons: Dict[str, Tuple[str, ...]] = field(default_factory=dict)
    #: pod key -> FitError.Error()-shaped message with per-reason node
    #: counts (only for pods that failed the filter pass)
    fit_errors: Dict[str, str] = field(default_factory=dict)
    preempted: int = 0  # victims deleted this cycle
    nominations: Dict[str, str] = field(default_factory=dict)  # pod -> node
    waiting: int = 0  # pods parked by Permit plugins this cycle
    elapsed_s: float = 0.0
    #: which ladder tier produced this cycle's placements ("" = no solve)
    solver_tier: str = ""
    #: tier-to-tier fallbacks taken this cycle
    solver_fallbacks: int = 0
    #: how the cycle's snapshot was produced: full | delta | clean (the
    #: resident table), "host" (the host table uploaded whole: the
    #: device-loss cooloff, or device_resident_snapshot off), "" = the
    #: cycle ended before the snapshot
    snapshot_mode: str = ""
    #: host clock seconds from the start of the solve to its readback
    solve_s: float = 0.0
    #: per-pod create-to-bind latency for every pod bound this cycle
    e2e_latency_s: Dict[str, float] = field(default_factory=dict)
    #: device-to-host syncs the cycle made (round-loop conditions, the
    #: router's decision, the validated readback, the explain readback,
    #: the preemption rows)
    host_syncs: int = 0
    #: the cycle's UnschedulableReport (obs/explain.py): why the residual
    #: pods stayed pending. None when explain is off or the cycle ended
    #: before the solve
    explain: Optional[object] = None
    #: host seconds (perf_counter) of the failure pass: filter, explain
    #: reduction, its readback, the failed pods' requeue and the report
    explain_s: float = 0.0
    #: host seconds (perf_counter) of the preemption pass: the reason-row
    #: readback and victim selection, eviction and nomination
    preempt_s: float = 0.0
    #: bytes of the preemption reason rows read back this cycle
    preempt_rows_bytes: int = 0
    #: which solve placed the cycle: "restricted" (candidate columns of
    #: the resident score summary), "partitioned" (the sparsity-first
    #: cold solve in column blocks), "full" (the dense ladder; also a
    #: restricted or partitioned attempt that fell back), "" (no solve)
    solve_scope: str = ""
    #: fraction of the score summary's node columns reused from the cache
    #: this cycle (1 - patched/live; 0.0 unless restricted)
    reuse_frac: float = 0.0
    #: column blocks the partitioned cold solve ran (0 otherwise)
    cold_blocks: int = 0
    #: chunks the pipelined executor solved (0: the monolithic cycle)
    pipeline_chunks: int = 0
    #: the ladder's attempts this cycle, in order: ``tier`` for a solve
    #: that ran (a retry repeats it), ``tier:shed`` for one an open
    #: breaker or a blown deadline skipped
    tier_attempts: List[str] = field(default_factory=list)
    #: round-loop graphs captured during the cycle (0 on a warmed shape)
    graph_captures: int = 0
    #: what flushed the micro-batch window into this cycle
    #: ("bucket-fill" | "max-wait"; "" = not a serving-loop cycle)
    flush_trigger: str = ""
    #: how long the micro-batch window accumulated before flushing
    window_s: float = 0.0
    #: scenario-pack placement-quality scores for this cycle (empty =
    #: scenario mode off or quality off): the device-reduced nodes_used /
    #: headroom / fragmentation vector plus the pack's host-side gang
    #: bookkeeping
    scenario_quality: Dict[str, float] = field(default_factory=dict)
    #: perf-ledger verdict (obs/ledger.py), stamped at end_cycle: the
    #: cost model's predicted solve seconds for this cycle's batch shape
    #: and modeled/measured (-1 = not populated: no solve ran, or the
    #: ledger is off)
    modeled_s: float = -1.0
    model_efficiency: float = -1.0


def _filter_pass(dp, dn, ds, dt, dv=None, sv=None, em=None):
    """One standalone filter evaluation (reasons + mask) — the
    nominated-pods pass-A mask and the failure-reason passes (the
    reference's jitted ``_filter_pass``)."""
    return run_predicates(dp, dn, ds, dt, dv, sv, em)


def _whole_cols(x):
    """A (P, N) plane whole on the mesh's first device: one gather of a
    plane left in column blocks (``parallel.mesh.Blocks``), the plane
    itself otherwise."""
    if not isinstance(x, pmesh.Blocks):
        return x
    return coll.all_gather(list(x.parts), x.axis, (x.mesh.device,))[0]


def _combine(a, b, op):
    """``op(a, b)`` of two (P, N) planes (``&`` of masks, ``+`` of
    scores), either None (the other), either in a mesh's column blocks
    (then block by block)."""
    if a is None or b is None:
        return b if a is None else a
    mesh = next((m.mesh for m in (a, b) if isinstance(m, pmesh.Blocks)),
                None)
    if mesh is not None:
        a, b = pmesh.column_blocks(a, mesh), pmesh.column_blocks(b, mesh)
    return pmesh.per_shard(op, a, b, split=1)


def _static_vol_pass(dp, dn, ds, dv):
    """Usage-independent volume reasons, computed once per cycle (or per
    chunk) and shared by the solver rounds and the reporting passes."""
    return static_volume_reasons(dp, dn, ds, dv)


def _rounds_tensor(rounds, device) -> torch.Tensor:
    """A solver's round count as a (1,) int32 device tensor to ride a
    readback: a batch tier's device scalar, or the greedy tier's host
    int (filled on the device, no upload)."""
    if isinstance(rounds, torch.Tensor):
        return rounds.reshape(1).to(device=device, dtype=torch.int32)
    return torch.full((1,), int(rounds), dtype=torch.int32, device=device)


def _stats_bits(stats, device) -> torch.Tensor:
    """The (2,) f32 Sinkhorn stats as two int32 words (a bit cast), so
    they ride an int32 readback payload unchanged."""
    return stats.to(device=device, dtype=torch.float32).view(torch.int32)


def _stats_host(words) -> List[float]:
    """Decode :func:`_stats_bits`'s two words read back to the host."""
    # graftlint: disable=R7,R8 -- words are host ints the solve's one
    # readback (obs.jax.readback) already brought back
    return np.asarray(words, np.int32).view(np.float32).tolist()


def _has_topo(u) -> bool:
    """Whether the packer's universe holds any inter-pod affinity or
    topology spread term (then the cycle packs the topology tables)."""
    return bool(
        len(u.aff_programs)
        or len(u.pref_aff_programs)
        or len(u.spread_hard_programs)
        or len(u.spread_soft_programs)
        or len(u.anti_terms)
        or len(u.sym_terms)
    )


class Scheduler:
    """Batched scheduler over a cache + queue + device solver.

    ``device`` is where the tables and the solve live: ``cuda`` (the
    default; raises without a card) or ``cpu`` (the plain PyTorch
    versions of every kernel). ``solver`` is the first ladder tier
    (``batch``, ``sinkhorn``, ``greedy`` or ``exact``), then
    ``robustness.fallback_chain``; ``greedy``, the sequential oracle, is
    always the floor. Every tier's result is checked on the device before
    anything binds."""

    def __init__(
        self,
        cache: Optional[SchedulerCache] = None,
        queue: Optional[SchedulingQueue] = None,
        binder: Optional[Binder] = None,
        weights: Optional[Dict[str, float]] = None,
        solver: str = "batch",
        per_node_cap: int = 4,
        max_rounds: int = 128,
        max_batch: int = 8192,
        clock: Callable[[], float] = time.monotonic,
        event_sink: Optional[Callable[[str, Pod, str], None]] = None,
        framework=None,
        pred_mask: Optional[int] = None,
        volume_binder=None,
        scheduler_name: str = "default-scheduler",
        device="cuda",
        enable_preemption: bool = True,
        enable_non_preempting: bool = False,
        max_preemptions_per_cycle: int = 16,
        pdb_lister: Optional[Callable[[], List]] = None,
        victim_deleter: Optional[Callable[[Pod], None]] = None,
        repack_evictor: Optional[Callable[[Pod], None]] = None,
        explain: bool = True,
        explain_top_k: int = 3,
        incremental: Optional[IncrementalConfig] = None,
        pipeline_depth: int = 2,
        pipeline_chunk: int = 4096,
        extenders=(),
        metrics=None,
        trace_threshold_s: float = 1.0,
        percentage_of_nodes_to_score: Optional[int] = None,
        robustness: Optional[RobustnessConfig] = None,
        recovery: Optional[RecoveryConfig] = None,
        fault_injector=None,
        retry_sleep: Callable[[float], None] = time.sleep,
        pod_reader: Optional[Callable[[str], Optional[Pod]]] = None,
        jitter_seed: Optional[int] = None,
        observability: Optional[ObservabilityConfig] = None,
        device_resident_snapshot: bool = True,
        snapshot_max_dirty_frac: Optional[float] = None,
        warmup: Optional[WarmupConfig] = None,
        scenario: Optional[ScenarioConfig] = None,
        parallel: Optional[ParallelConfig] = None,
    ) -> None:
        if solver not in TIERS:
            raise ValueError(f"solver must be one of {TIERS}, got {solver!r}")
        self.device = resolve_device(device)
        # KTPU_PALLAS=0 on a card is refused here, before any cycle (a
        # CPU scheduler takes the plain route it asks for)
        use_kernels(self.device)
        self.scheduler_name = scheduler_name
        self.framework = framework or Framework(clock=clock)
        #: the reference's metric set (metrics.py), recorded every cycle
        self.metrics = metrics or SchedulerMetrics()
        #: observability knobs (config.ObservabilityConfig): the facade,
        #: its flight recorder, journeys and telemetry, the perf and
        #: memory ledgers, the incident recorder, explain and the
        #: Sinkhorn stats
        self.observability = (observability if observability is not None
                              else ObservabilityConfig(
                                  trace_threshold_s=trace_threshold_s))
        self.trace_threshold_s = self.observability.trace_threshold_s
        #: instrumented-lock runtime sanitizer (sanitize.py), armed by
        #: observability.lock_sanitizer.enabled: every lock the facade,
        #: the cache and the serving loop build goes through it, and a
        #: finding counts on scheduler_lock_sanitizer_findings_total{kind}
        self.lock_sanitizer = None
        ls_config = self.observability.lock_sanitizer
        if ls_config.enabled:
            self.lock_sanitizer = LockSanitizer(
                ls_config, clock=clock,
                on_finding=lambda kind: (
                    self.metrics.lock_sanitizer_findings.inc(kind=kind)))
        lock_factory = (self.lock_sanitizer.factory()
                        if self.lock_sanitizer is not None else None)
        #: the observability facade (obs/core.py) on the scheduler's clock
        self.obs = Observability(self.observability, metrics=self.metrics,
                                 clock=clock,
                                 lock_sanitizer=self.lock_sanitizer)
        self.cache = cache or SchedulerCache(clock=clock, device=self.device,
                                             lock_factory=lock_factory)
        self.cache.device = self.device
        # the memory ledger measures this scheduler's device, and its
        # resident accounting rides the cache's own upload and drop edges
        # (duck attach: cache fakes without the attribute stay valid)
        self.obs.memledger.device = self.device
        if getattr(self.cache, "memledger", "absent") is None:
            self.cache.memledger = self.obs.memledger
        if snapshot_max_dirty_frac is not None:
            self.cache.max_dirty_frac = snapshot_max_dirty_frac
        # explicit None check: an empty SchedulingQueue is falsy
        self.queue = queue if queue is not None else SchedulingQueue(
            clock=clock, less=self.framework.queue_sort_less(),
            metrics=self.metrics)
        if getattr(self.queue, "metrics", "absent") is None:
            self.queue.metrics = self.metrics
        # the journey tracer rides the queue's residency seams (add,
        # sub-queue transitions, pop): the same duck attach as metrics
        if getattr(self.queue, "journeys", "absent") is None:
            self.queue.journeys = self.obs.journeys
        # the incident bundles embed the queue depths at trigger time
        self.obs.incidents.queue_snapshot = self.queue.pending_counts
        #: degradation-ladder knobs: cycle deadline, bounded retries,
        #: breaker thresholds, the fallback chain, result validation
        self.robustness = (robustness if robustness is not None
                           else RobustnessConfig())
        #: crash / failover knobs (config.RecoveryConfig): fenced binds,
        #: takeover reconciliation
        self.recovery = recovery if recovery is not None else RecoveryConfig()
        #: the bind fence (a LeaderElector via attach_elector, or any
        #: object with allow_bind()/epoch): None = unfenced
        self.fence = None
        #: truth lister for takeover reconciliation (attach_elector):
        #: () -> iterable of truth Pods; None = local-only reconcile
        self._lister = None
        #: host-mode snapshot window after a device-loss recovery ran out
        #: of its per-cycle rebuild budget (a deadline on ``clock``; 0 =
        #: the device is considered healthy)
        self._device_cooloff_until = 0.0
        #: keep the packed node table on the device across cycles (False:
        #: host mode every cycle, the whole table uploaded each time)
        self.device_resident_snapshot = device_resident_snapshot
        #: hub GET for the ambiguous-bind read-your-write verification
        #: (``key -> Pod | None``, raising on transport failure). None =
        #: no reader: an ambiguous bind waits on the assume TTL instead
        self.pod_reader = pod_reader
        #: ambiguous binds whose verification GET was itself unreachable:
        #: key -> (pod, node_name, cycle_state or None for a park the TTL
        #: reap made). The pod stays ASSUMED (capacity held, no TTL) and
        #: every cycle / idle tick re-probes (_verify_ambiguous_binds)
        self._ambiguous_binds: Dict[str, Tuple] = {}
        #: serving doorbell (serving/doorbell.py) — None until a serving
        #: loop attaches one via attach_doorbell
        self.doorbell = None
        #: state-conservation auditor (obs/audit.py) — None until
        #: attach_auditor; _note_gone reports legitimate exits to it
        self.auditor = None
        #: the ladder tier of the most recent cycle that solved ("" before
        #: the first) and its tier-to-tier fallbacks: is_degraded reads the
        #: fallback COUNT (exact's hazard routing to batch is healthy)
        self.last_solver_tier = ""
        self.last_solver_fallbacks = 0
        #: faults.FaultInjector (or None): the seeded chaos harness wired
        #: into the solver entry and the extender transports
        self.fault_injector = fault_injector
        rc = self.robustness
        # per-replica jitter seed: two replicas sharing one RetryPolicy
        # config must not share the jitter stream (lockstep retry waves)
        if jitter_seed is None:
            import os as _os
            import random as _random

            jitter_seed = (_random.SystemRandom().randrange(1 << 30)
                           ^ _os.getpid() ^ (id(self) & 0xFFFF))
        self._jitter_seed = int(jitter_seed)
        #: bounded-backoff policy of the extender transports; ``sleep``
        #: injectable so fake-clock tests never block
        self._transport_retry = RetryPolicy(
            max_retries=rc.transport_retries, base_s=rc.retry_backoff_base_s,
            max_s=rc.retry_backoff_max_s, jitter=rc.retry_jitter,
            seed=self._jitter_seed, sleep=retry_sleep)
        #: bounded verification GETs per ambiguous bind, full jitter on the
        #: same per-replica stream, offset so the two policies differ
        self._bind_verify_retry = RetryPolicy(
            max_retries=rc.bind_verify_retries,
            base_s=rc.retry_backoff_base_s, max_s=rc.retry_backoff_max_s,
            jitter=rc.retry_jitter, seed=self._jitter_seed + 1,
            sleep=retry_sleep)
        # the device-snapshot chaos seam rides the same injector as the
        # solver and transport seams (duck-typed attach, like extenders)
        if (fault_injector is not None
                and getattr(self.cache, "fault_injector", "absent") is None):
            self.cache.fault_injector = fault_injector
        #: HTTPExtender list (core/extender.go), called after the built-in
        #: filter pass for interested pods
        self.extenders = list(extenders)
        for e in self.extenders:
            # wire retry + fault hooks into transports that expose the
            # seam (HTTPExtender); duck-typed so test fakes stay valid
            if getattr(e, "retry", "absent") is None:
                e.retry = self._transport_retry
            if (fault_injector is not None
                    and getattr(e, "fault_injector", "absent") is None):
                e.fault_injector = fault_injector
            if getattr(e, "_clock_defaulted", False):
                e._clock = clock
                e._clock_defaulted = False
        #: per-target circuit breakers ("solver:batch", "extender:<url>"),
        #: created lazily against this clock
        self._breakers: Dict[str, CircuitBreaker] = {}
        #: absolute deadline of the cycle in flight (None = unbounded)
        self._cycle_deadline: Optional[float] = None
        #: node-search truncation (percentageOfNodesToScore): None scores
        #: every node; 0 is the reference's adaptive 50%->5% rule; 1-99 a
        #: fixed percent. A truncated cycle solves on the next K nodes in
        #: zone round-robin order (NodeTree)
        self.percentage_of_nodes_to_score = percentage_of_nodes_to_score
        self.node_tree = NodeTree()
        #: the warmup's configuration (Scheduler.warmup)
        self.warmup_config = warmup if warmup is not None else WarmupConfig()
        #: count of exact -> batch routings (port / volume / topology
        #: batches the Hungarian cannot model)
        self.exact_fallbacks = 0
        self.binder = binder or RecordingBinder()
        self.weights = weights
        #: the scenario pack (scenarios.resolve_pack): its weight override
        #: lands here, so every ladder tier and the warmup see it, and its
        #: (P, N) cost term joins extra_score each cycle. None = the stock
        #: objective
        self.scenario = scenario if scenario is not None else ScenarioConfig()
        self.scenario_pack = resolve_pack(self.scenario)
        if self.scenario_pack is not None:
            self.weights = self.scenario_pack.weights(self.weights)
        #: score labels ever set on scheduler_scenario_quality: a score a
        #: cycle stops reporting drops to 0 instead of going stale
        self._scenario_scores_seen: set = set()
        self.solver = solver
        self.per_node_cap = per_node_cap
        self.max_rounds = max_rounds
        self.max_batch = max_batch
        self.clock = clock
        #: event_sink(reason, pod, message) — Scheduled / FailedScheduling
        self.event_sink = event_sink or (lambda *_: None)
        # the SLO watchdog emits SchedulerSLOBurn / SchedulerSLORecovered
        # through the same sink, late-bound so a sink attached after
        # construction still receives them
        self.obs.ledger.event_sink = (
            lambda reason, obj, msg: self.event_sink(reason, obj, msg))
        #: enabled-predicate bitmask; None = every predicate enforced
        self.pred_mask = pred_mask
        #: per-pod CycleState, alive from prefilter to bind/fail
        self._cycle_states: Dict[str, CycleState] = {}
        #: delayed-binding PVC lifecycle (volume_binder.go:30)
        self.volume_binder = volume_binder or VolumeBinder(self.cache.packer)
        self.enable_preemption = enable_preemption
        #: NonPreemptingPriority feature gate: honor preemption_policy=Never
        self.enable_non_preempting = enable_non_preempting
        self.max_preemptions_per_cycle = max_preemptions_per_cycle
        #: PDBs come from a lister (the disruption controller maintains
        #: their status in the reference)
        self.pdb_lister = pdb_lister or (lambda: [])
        #: victim_deleter(pod): deletes the victim through the API.
        #: Default: mark it terminating and remove it from the cache at
        #: once (grace period 0)
        self.victim_deleter = victim_deleter
        #: repack_evictor(pod): drains a BOUND pod for the steady-state
        #: re-pack (scenario.repack_interval_s). Default: unbind locally
        #: and requeue (grace period 0); a hub integration posts the
        #: eviction and lets the watch converge the local state
        self.repack_evictor = repack_evictor
        #: clock of the last re-pack sweep; None = cadence not started
        #: (the first interval elapses before the first drain)
        self._last_repack_at: Optional[float] = None
        #: build the per-cycle UnschedulableReport, keeping top_k
        #: relaxations per pod
        self.explain = explain
        self.explain_top_k = explain_top_k
        #: latest explanation per still-pending pod: updated each cycle
        #: from the report, dropped when the pod binds or leaves
        self.why_pending: Dict[str, PodExplanation] = {}
        #: the most recent cycle's UnschedulableReport
        self.last_explain: Optional[UnschedulableReport] = None
        #: the sparsity-first routes (restricted, partitioned) and the
        #: warm Sinkhorn carry
        self.incremental = (incremental if incremental is not None
                            else IncrementalConfig())
        #: warm Sinkhorn potentials: (key, (u, v)) with key (pod bucket,
        #: candidate bucket, cache.summary_generation); every invalidation
        #: edge bumps the generation or clears it
        self._sk_warm_pot = None
        #: restricted service engaged since the last invalidation
        self._incr_active = False
        #: the candidate-bucket tuner: the warmed bucket ladder (filled by
        #: the warmup; empty, it keeps the bucket pinned), recent raw
        #: micro-batch sizes, the deepest frame position placed into
        self._warmed_cbuckets: set = set()
        self._tuner_batch_obs: List[int] = []
        self._tuner_depth_max = 0
        self._summary_flags = self._score_cache_flags()
        if self.incremental.enabled:
            self.cache.enable_score_cache(**self._summary_flags)
        #: the pipelined executor: batches of more than ``pipeline_chunk``
        #: pods solve in chunks of that size; depth 1 is the monolithic
        #: cycle (every depth >= 2 places identically)
        self.pipeline_depth = pipeline_depth
        self.pipeline_chunk = pipeline_chunk
        #: reason labels ever set on scheduler_unschedulable_node_counts:
        #: a reason that stops firing drops to 0 instead of going stale
        self._explain_reasons_seen: set = set()
        #: round-loop graph captures at the start of the cycle in flight
        self._captures0 = 0
        #: the sharded execution backend (config.ParallelConfig): with a
        #: mesh, the node axis of the resident table, and with it the
        #: (P, N) plane of every solve, shards across a 1-D device mesh
        #: built here (parallel/mesh.py: distinct cards, or one card
        #: repeated as a logical mesh); "off" (the default) builds none
        self.parallel = parallel if parallel is not None else ParallelConfig()
        self.mesh = pmesh.mesh_from_spec(
            self.parallel.mesh, pmesh.local_devices(self.device.type))
        if (self.mesh is not None and self.mesh.device
                != pmesh.normalize_device(self.device)):
            raise ValueError(
                f"parallel.mesh: the mesh is on {self.mesh.device}, the "
                f"scheduler on {self.device}")
        set_mesh = getattr(self.cache, "set_mesh", None)
        if set_mesh is not None:  # duck-typed: cache fakes stay valid
            set_mesh(self.mesh)
        mesh_gauge = getattr(self.metrics, "mesh_devices", None)
        if mesh_gauge is not None:  # duck-typed: metrics fakes stay valid
            mesh_gauge.set(pmesh.mesh_size(self.mesh))
        self.obs.note_mesh(pmesh.mesh_size(self.mesh))
        #: whether THIS cycle's tables live on the mesh (False in the
        #: device-loss cooloff, whose host-mode cycles run single-device:
        #: a lost shard is not re-engaged before the heal probe)
        self._mesh_live = False
        #: the mesh placement of the last host table placed
        #: (:meth:`_place_host`)
        self._host_placed = None

    @classmethod
    def from_config(cls, cfg, **kw) -> "Scheduler":
        """Build a Scheduler from a KubeSchedulerConfiguration — the
        CreateFromProvider / CreateFromConfig seam (factory.go:346,:356),
        as the reference's ``from_config``. A setting the port does not
        have yet raises ``cli.ConfigError`` naming its ROADMAP item
        (``cli.unported_features``); ``device`` and the other
        constructor arguments pass through ``kw``."""
        from kubernetes_tpu_torch.cli import ConfigError, unported_features
        from kubernetes_tpu_torch.config import (
            default_predicate_mask,
            default_priority_weights,
        )

        unported = unported_features(cfg)
        if unported:
            raise ConfigError(unported)
        if cfg.policy is not None:
            kw.setdefault("pred_mask", cfg.policy.predicate_mask)
            kw.setdefault("weights", dict(cfg.policy.priority_weights))
            if cfg.policy.extenders:
                from kubernetes_tpu_torch.extender import build_extenders

                kw.setdefault("extenders",
                              build_extenders(cfg.policy.extenders))
        else:
            kw.setdefault("pred_mask",
                          default_predicate_mask(cfg.feature_gates))
            kw.setdefault("weights",
                          default_priority_weights(cfg.feature_gates))
        kw.setdefault("solver", cfg.solver)
        kw.setdefault("enable_non_preempting",
                      cfg.feature_gates.enabled("NonPreemptingPriority"))
        kw.setdefault("per_node_cap", cfg.per_node_cap)
        kw.setdefault("max_rounds", cfg.max_rounds)
        kw.setdefault("max_batch", cfg.max_batch)
        kw.setdefault("scheduler_name", cfg.scheduler_name)
        kw.setdefault("robustness", cfg.robustness)
        kw.setdefault("recovery", cfg.recovery)
        kw.setdefault("observability", cfg.observability)
        kw.setdefault("explain", cfg.observability.explain)
        kw.setdefault("explain_top_k", cfg.observability.explain_top_k)
        kw.setdefault("pipeline_depth", cfg.pipeline_depth)
        kw.setdefault("pipeline_chunk", cfg.pipeline_chunk)
        kw.setdefault("device_resident_snapshot", cfg.device_resident_snapshot)
        kw.setdefault("snapshot_max_dirty_frac", cfg.snapshot_max_dirty_frac)
        kw.setdefault("warmup", cfg.warmup)
        kw.setdefault("scenario", cfg.scenario)
        kw.setdefault("incremental", cfg.incremental)
        kw.setdefault("parallel", cfg.parallel)
        if cfg.plugins and "framework" not in kw:
            # config-driven framework assembly (framework.go:88 NewFramework:
            # registry factories + per-plugin args); unknown names fail
            from kubernetes_tpu_torch.framework import PLUGIN_REGISTRY

            built = []
            for name in cfg.plugins:
                factory = PLUGIN_REGISTRY.get(name)
                if factory is None:
                    raise ValueError(
                        f"plugins: {name!r} is not registered "
                        f"(known: {sorted(PLUGIN_REGISTRY)})")
                built.append(factory(dict(cfg.plugin_config.get(name, {}))))
            kw["framework"] = Framework(
                built, clock=kw.get("clock", time.monotonic))
        # 100 (the config default) = no truncation; 0 = the adaptive rule
        kw.setdefault(
            "percentage_of_nodes_to_score",
            None if cfg.percentage_of_nodes_to_score >= 100
            else cfg.percentage_of_nodes_to_score)
        return cls(**kw)

    # -- informer handlers -------------------------------------------------

    def responsible_for(self, pod: Pod) -> bool:
        """eventhandlers.go:328 responsibleForPod."""
        return pod.scheduler_name == self.scheduler_name

    def on_pod_add(self, pod: Pod) -> None:
        """Unassigned pods queue for scheduling (only this scheduler's);
        assigned pods enter the cache whoever bound them. Terminal pods
        never enter (factory.go nonTerminatedPodSelector)."""
        if is_pod_terminated(pod):
            return
        if pod.node_name:
            self.cache.add_pod(pod)
            self.queue.assigned_pod_added(pod)
        elif self.responsible_for(pod):
            self.queue.add(pod)

    def on_pod_update(self, old: Pod, new: Pod) -> None:
        if is_pod_terminated(new):
            self.on_pod_delete(new)
            return
        if new.node_name:
            wp = self.framework.waiting.get(new.key())
            if wp is not None:
                self.framework.waiting.remove(new.key())
                self.volume_binder.forget_pod_volumes(new.key())
                self.framework.run_unreserve(
                    self._cycle_states.get(new.key()) or CycleState(),
                    wp.pod, wp.node_name)
            self._cycle_states.pop(new.key(), None)
            # add_pod confirms a pending assumption; the pod leaves the
            # scheduling queue (a bind by another writer)
            self.cache.add_pod(new)
            self.queue.delete(new.key())
            # journey: our own bind already closed it (this no-ops); a
            # competing writer's bind closes it here as gone
            self.obs.journeys.note_gone(new.key())
            self.queue.assigned_pod_added(new)
        elif self.responsible_for(new):
            if new != old:
                self.cache.packer.forget_pod(new.key())
            self.queue.update(old.key(), new)
        elif self.responsible_for(old):
            self.queue.delete(old.key())
            self._cycle_states.pop(old.key(), None)
            self.why_pending.pop(old.key(), None)
            self._note_gone(old.key())

    def on_pod_delete(self, pod: Pod) -> None:
        key = pod.key()
        self._note_gone(key)
        # a parked ambiguous bind resolves by deletion: the pod is gone
        # whatever the RPC did, and a park holds no TTL, so nothing else
        # would free its capacity
        parked = self._ambiguous_binds.pop(key, None)
        if parked is not None and self.cache.is_assumed(key):
            apod, anode, ast = parked
            self.cache.forget_pod(key)
            self.volume_binder.forget_pod_volumes(key)
            self.framework.run_unreserve(ast or CycleState(), apod, anode)
        wp = self.framework.waiting.get(key)
        if wp is not None:
            # a Permit-parked pod is assumed and holds capacity
            self.framework.waiting.remove(key)
            self.cache.forget_pod(key)
            self.volume_binder.forget_pod_volumes(key)
            self.framework.run_unreserve(
                self._cycle_states.get(key) or CycleState(), wp.pod,
                wp.node_name)
        if pod.node_name:
            self.cache.remove_pod(key)
            self.queue.move_all_to_active()
        else:
            self.queue.delete(key)
        self.cache.packer.forget_pod(key)
        self._cycle_states.pop(key, None)
        self.why_pending.pop(key, None)

    def on_node_add(self, node) -> None:
        self.cache.add_node(node)
        self.node_tree.add_node(node)
        self.queue.move_all_to_active()

    def on_node_update(self, node) -> None:
        old = self.cache.node(node.name)
        if old is not None:
            self.node_tree.remove_node(old)
        self.cache.update_node(node)
        self.node_tree.add_node(node)
        self.queue.move_all_to_active()

    def on_node_delete(self, name: str) -> None:
        old = self.cache.node(name)
        if old is not None:
            self.node_tree.remove_node(old)
        self.cache.remove_node(name)

    def set_volume_state(self, pvcs=(), pvs=(), classes=()) -> None:
        """PV/PVC/StorageClass informer feed: scheduled pods' volume tokens
        depend on PVC->PV resolution, so the snapshot rebuilds and the
        unschedulable queue resweeps."""
        self.cache.packer.set_volume_state(pvcs, pvs, classes)
        self.cache.invalidate_snapshot()
        self.queue.move_all_to_active()

    def set_attached_residue(self, residue) -> None:
        """Actual-state feed from the attach-detach controller
        (attach_detach_controller.go:102): per-node PV names attached
        without a live pod deriving them (detach-grace stragglers). They
        occupy attach-limit slots, so the snapshot is invalidated and,
        since a detach can free a slot a pending pod waits on, the
        unschedulable queue resweeps like any volume-state change."""
        self.cache.packer.attached_residue = dict(residue)
        self.cache.invalidate_snapshot()
        self.queue.move_all_to_active()

    def _note_gone(self, key: str) -> None:
        """A pod legitimately left the state machine (watch delete,
        responsible-to-not transition, terminating skip, reconcile drop):
        tell the attached state-conservation auditor (no-op without one)
        and close its journey."""
        if self.auditor is not None:
            self.auditor.note_gone(key)
        self.obs.journeys.note_gone(key)

    # -- crash / failover / device-loss recovery -----------------------------

    def attach_auditor(self, auditor):
        """Wire a state-conservation auditor (obs/audit.py): the scheduler
        reports legitimate pod exits (watch deletes, terminating skips,
        reconcile drops) via ``note_gone`` so the auditor's conservation
        rule never counts an explained exit as a lost pod. Attaches
        metrics / event sink / obs when the auditor has none. Returns the
        auditor."""
        self.auditor = auditor
        if getattr(auditor, "metrics", "absent") is None:
            auditor.metrics = self.metrics
        if getattr(auditor, "event_sink", "absent") is None:
            auditor.event_sink = (
                lambda reason, obj, msg: self.event_sink(reason, obj, msg))
        if getattr(auditor, "obs", "absent") is None:
            auditor.obs = self.obs
        return auditor

    def attach_elector(self, elector, lister=None):
        """Wire leader election into the scheduler's recovery protocol:
        the elector becomes the bind fence (its ``allow_bind`` gates
        every bind when ``recovery.fenced_binds``), gaining leadership
        runs takeover reconciliation (:meth:`reconcile`), and losing it
        drains in-flight state (:meth:`on_stopped_leading`). ``lister``
        (optional, ``() -> iterable of truth Pods``) gives the
        reconciliation an authoritative relist source; without one the
        informer feed is trusted and reconciliation is local-only.
        Pre-existing elector callbacks are preserved (chained after
        ours). Returns the elector."""
        self.fence = elector
        self._lister = lister
        prev_start = elector.on_started_leading
        prev_stop = elector.on_stopped_leading

        def started():
            self.on_started_leading()
            prev_start()

        def stopped():
            self.on_stopped_leading()
            prev_stop()

        elector.on_started_leading = started
        elector.on_stopped_leading = stopped
        return elector

    def on_started_leading(self) -> None:
        """OnStartedLeading (app/server.go:261): this incarnation just
        became the writer. Reconcile before the first cycle so a crash
        of the previous leader between its bind and its local
        ``finish_binding`` converges instead of leaking."""
        if not self.recovery.reconcile_on_takeover:
            return
        pods = None
        if self._lister is not None:
            pods = list(self._lister())
        self.reconcile(pods)

    def on_stopped_leading(self) -> None:
        """Deposed (lease lost or released): drain in-flight cycle
        state. Permit-parked pods are rejected and requeued, local
        assumptions are forgotten and their pods requeued (if the bind
        DID commit, the watch MODIFIED event deletes them from the
        queue; if it did not, the new leader binds them). The queues
        themselves stay: informers run on standbys."""
        fw = self.framework
        drained = 0
        res = CycleResult()
        for wp in list(fw.waiting.items()):
            key = wp.pod.key()
            fw.waiting.remove(key)
            self.cache.forget_pod(key)
            self.volume_binder.forget_pod_volumes(key)
            fw.run_unreserve(self._cycle_states.get(key) or CycleState(),
                             wp.pod, wp.node_name)
            self._fail(wp.pod, self.queue.scheduling_cycle, res,
                       ("Permit:lost leadership",))
            self._cycle_states.pop(key, None)
            drained += 1
        self._ambiguous_binds.clear()
        for key in self.cache.assumed_keys():
            pod = self.cache.pod(key)
            self.cache.forget_pod(key)
            self.volume_binder.forget_pod_volumes(key)
            self._cycle_states.pop(key, None)
            if pod is not None and self.responsible_for(pod):
                self.queue.add_if_not_present(
                    dataclasses.replace(pod, node_name=""))
            drained += 1
        if drained:
            klog.warning("stopped leading: drained %d in-flight pods",
                         drained)
            self.metrics.recovery_drained.inc(drained)
            self._record_metrics(res)

    def reconcile(self, pods=None) -> Dict[str, int]:
        """Takeover / cold-start reconciliation — converge local state
        with the truth so the invariant triple holds across a crash: no
        pod double-bound, no assumption leaked, every schedulable pod
        eventually bound.

        With ``pods`` (the relisted truth): adopt bound pods this cache
        does not know, forget assumptions the truth contradicts (pod
        gone, recreated under a new uid, or bound elsewhere), requeue
        responsible unbound pods that fell out of the queues, and drop
        queued pods the truth no longer holds. Always: resweep the
        unschedulable queue, drop the resident device snapshot (the next
        cycle uploads it again on ``self.device``), drop the warm-solve
        state, and re-run the warmup when it is configured (its graphs
        stay cached, so a re-elected incarnation captures nothing new).
        Returns the action counts."""
        adopted = forgotten = requeued = 0
        if pods is not None:
            self._ambiguous_binds.clear()
            truth = {p.key(): p for p in pods}
            for key in list(self.cache.assumed_keys()):
                cached = self.cache.pod(key)
                tp = truth.get(key)
                ok = (tp is not None and tp.node_name
                      and cached is not None and tp.uid == cached.uid
                      and tp.node_name == cached.node_name)
                if ok:
                    # the bind DID commit (possibly by a dead
                    # predecessor): confirm it instead of waiting out
                    # the TTL
                    self.cache.add_pod(tp)
                    adopted += 1
                else:
                    self.cache.forget_pod(key)
                    self.volume_binder.forget_pod_volumes(key)
                    forgotten += 1
            for key, tp in truth.items():
                if is_pod_terminated(tp):
                    continue
                if tp.node_name:
                    cached = self.cache.pod(key)
                    if cached is None or cached.uid != tp.uid \
                            or cached.node_name != tp.node_name:
                        if cached is not None:
                            self.cache.remove_pod(key)
                        self.cache.add_pod(tp)
                        adopted += 1
                    # bound in the truth: never schedule it again here
                    self.queue.delete(key)
                    self.why_pending.pop(key, None)
                    self._cycle_states.pop(key, None)
                    # a bind this incarnation did not make: the journey
                    # closes as gone (no bound outcome, no e2e sample)
                    self.obs.journeys.note_gone(key)
                elif self.responsible_for(tp):
                    queued = self.queue.pod(key)
                    if (queued is not None and queued.uid == tp.uid) \
                            or self.framework.waiting.get(key) is not None:
                        continue  # already queued/parked with the live uid
                    if self.cache.pod(key) is not None:
                        # placed here, unbound in the truth: a
                        # half-crashed bind — forget and retry
                        if self.cache.is_assumed(key):
                            self.volume_binder.forget_pod_volumes(key)
                        self.cache.remove_pod(key)
                        forgotten += 1
                    if queued is not None:
                        # recreated under the same key with a new uid:
                        # the truth object replaces the stale one
                        self.queue.delete(key)
                    self.queue.add_if_not_present(tp)
                    requeued += 1
            for qpods in self.queue.pending_pods().values():
                for p in qpods:
                    if p.key() not in truth:
                        self.queue.delete(p.key())
                        self._note_gone(p.key())
                        self._cycle_states.pop(p.key(), None)
                        self.why_pending.pop(p.key(), None)
                        self.cache.packer.forget_pod(p.key())
        self.queue.move_all_to_active()
        self.cache.invalidate_snapshot()
        self.cache.drop_device_snapshot()
        # warm-solve state summarizes a plane the old incarnation solved
        self._drop_incremental("takeover")
        self._device_cooloff_until = 0.0
        epoch = getattr(self.fence, "epoch", 0) or 1
        self.metrics.recovery_takeovers.inc()
        if adopted:
            self.metrics.recovery_adopted.inc(adopted)
        if forgotten:
            self.metrics.recovery_forgotten.inc(forgotten)
        if requeued:
            self.metrics.recovery_requeued.inc(requeued)
        self.obs.note_takeover(epoch)
        klog.V(2).info(
            "takeover reconciliation (epoch %d): adopted=%d forgotten=%d "
            "requeued=%d", epoch, adopted, forgotten, requeued)
        if self.warmup_config.enabled and self.cache.node_count():
            sample = self.queue.pending_pods().get("active", [])[:64]
            self.warmup(sample_pods=sample)
        return {"adopted": adopted, "forgotten": forgotten,
                "requeued": requeued}

    def _fence_ok(self) -> bool:
        """May a bind go out now? Unfenced schedulers (no elector
        attached / fencing disabled) always may."""
        if self.fence is None or not self.recovery.fenced_binds:
            return True
        return self.fence.allow_bind()

    def _fenced(self, pod: Pod, cycle: int, res: CycleResult) -> None:
        """Abort one pod's bind at the fence: count it, flag the flight
        record and the journey, requeue through the standard error path
        (the NEW leader binds it; this one must not race it)."""
        self.metrics.recovery_fenced_binds.inc()
        self.obs.note_fenced_bind()
        self.obs.journeys.note_fenced(pod.key())
        self._fail(pod, cycle, res, ("FencedBind:lease lost",))

    # -- the serve loop's hooks ----------------------------------------------

    def is_degraded(self) -> bool:
        """Is the backend limping? True while the device is in its
        post-loss cooloff (host-mode snapshots), while the most recent
        solve had to FALL THROUGH the ladder to reach a result, or while
        the configured tier's circuit breaker is open. The fallback COUNT
        is the signal, not the tier name: the exact solver deliberately
        routes hazardous batches to the round solver as a healthy path.
        A sustained SLO burn (the perf ledger's watchdog,
        ``ledger.engage_pressure``) reads degraded too, so APF sheds
        earlier at the same depth."""
        if self.clock() < self._device_cooloff_until:
            return True
        if self.obs.ledger.pressure_engaged():
            return True
        if self.last_solver_fallbacks > 0:
            return True
        br = self._breakers.get(f"solver:{self.solver}")
        return br is not None and br.state == OPEN

    def backend_pressure(self, degraded_factor: float = 4.0) -> float:
        """Backend-pressure probe for APF shedding
        (serving/fairness.FlowController.set_saturation): the active-
        queue depth, multiplied by ``degraded_factor`` while
        :meth:`is_degraded` — a solver running on a fallback tier clears
        its queue slower, so admission must shed EARLIER at the same
        depth."""
        depth = float(self.queue.pending_counts().get("active", 0))
        if depth and self.is_degraded():
            depth *= max(degraded_factor, 1.0)
        return depth

    def attach_doorbell(self, bell):
        """Wire a serving doorbell into this scheduler: the queue rings
        it on every work-adding incoming event (node and volume events
        ring through their move-to-active sweeps), and it gains this
        scheduler's metrics for scheduler_doorbell_rings_total. Returns
        the bell."""
        self.doorbell = bell
        if getattr(bell, "metrics", "absent") is None:
            bell.metrics = self.metrics
        if getattr(self.queue, "doorbell", "absent") is None:
            self.queue.doorbell = bell
        return bell

    def idle_tick(self) -> None:
        """Queue maintenance WITHOUT a scheduling cycle — the idle path
        of both serve loops (legacy fixed-interval and serving mode).
        Runs the periodic flushes (backoff-complete, unschedulable-
        leftover — each rings the doorbell when it moves pods), expires
        stale cache assumptions, and resolves Permit waits, but begins
        no cycle: no trace, no solve, no metrics churn. It re-probes the
        parked ambiguous binds as a cycle does, runs the scenario re-pack
        sweep when it is due (``maybe_repack``), keeps the SLO windows
        (and the recovery transition) live and takes the memory ledger's
        idle sample."""
        self.queue.tick()
        self._reap_expired_assumptions()
        self._verify_ambiguous_binds()
        self.maybe_repack()
        self.obs.ledger.tick()
        self.obs.memledger.tick()
        res = CycleResult()
        self._process_waiting(res)
        if res.unschedulable or res.scheduled:
            # a Permit wait resolved while idle: its outcome still
            # reaches the metrics
            self._record_metrics(res)

    def state_sizes(self) -> Dict[str, int]:
        """Sizes of every unbounded-unless-maintained structure this
        scheduler owns — the leak-sentinel surface (soak.SoakSentinels).
        Pure dict-length reads, with the reference's keys."""
        packer = self.cache.packer
        u = packer.u
        interned = sum(
            len(v) for v in vars(u).values() if isinstance(v, Interner))
        return {
            # per-pod side state — exit paths must pop these
            "why_pending": len(self.why_pending),
            "ambiguous_binds": len(self._ambiguous_binds),
            "cycle_states": len(self._cycle_states),
            "waiting_pods": len(self.framework.waiting),
            # bounded-by-construction state, watched anyway
            "breakers": len(self._breakers),
            "explain_reasons_seen": len(self._explain_reasons_seen),
            "sk_warm_potentials": 0 if self._sk_warm_pot is None else 1,
            "queue_pending": sum(self.queue.pending_counts().values()),
            "cache_assumed": len(self.cache.assumed_keys()),
            "cache_pods": self.cache.pod_count(),
            # packer per-pod caches (forget_pod-cleaned) + LRU memos
            "packer_pod_refs": len(packer._pod_refs),
            "packer_vol_cache": len(packer._vol_cache),
            "packer_vol_pods": len(packer._vol_pods),
            "packer_vec_cache": len(packer._vec_cache),
            "packer_pod_table_memo": len(packer._pod_table_memo),
            "packer_vol_table_memo": len(packer._vol_table_memo),
            # interner dedupe floors grow with vocabulary, not churn
            "interned_items": interned,
            "universe_matcher_memo": len(u._matcher_row_memo),
            "universe_owner_sets_memo": len(u._owner_sets_memo),
            # device-side state: the drop edges must zero these
            "dev_node_table": (
                1 if self.cache.has_device_snapshot() else 0),
            "dev_score_summary": (
                1 if self.cache.has_score_summary() else 0),
            "mem_residents": self.obs.memledger.resident_count(),
            "mem_census_arrays": self.obs.memledger.census_count(),
            # pending journeys drain with traffic; the completed tiers
            # and the incident ring plateau at their caps
            **self.obs.journeys.sizes(),
            **self.obs.incidents.sizes(),
        }

    def run_until_settled(self, max_cycles: int = 50) -> List[CycleResult]:
        """Drive cycles until one neither attempts nor schedules a pod
        (tests and the simulated cluster's harnesses); returns every
        cycle's result, the settled one last."""
        out = []
        for _ in range(max_cycles):
            r = self.schedule_cycle()
            out.append(r)
            if r.scheduled == 0 and r.attempted == 0:
                break
        return out

    # -- the cycle ---------------------------------------------------------

    def _reap_expired_assumptions(self) -> None:
        """Drive cache TTL expiry and converge each expired pod.

        An expired assumption is the SAME ambiguity class as a timed-out
        bind: the commit very likely landed and only the watch
        confirmation was lost. With a ``pod_reader`` the expiry resolves
        by read-your-write verification — adopt a hub-confirmed binding,
        requeue only when verified unbound, park (re-assumed, no TTL)
        while the hub is unreachable — so the reap never blind-requeues a
        pod whose retry would bind it a second time. Without a reader the
        optimistic path remains: requeue, and if the pod IS bound (the
        watch merely slow) the MODIFIED event deletes it from the queue."""
        expired = self.cache.pop_expired()
        if not expired:
            return
        self.metrics.cache_expired_assumptions.inc(len(expired))
        for p in expired:
            key = p.key()
            if self.pod_reader is not None:
                resolution = self._resolve_ambiguous_bind(p, p.node_name)
                self.metrics.bind_ambiguous.inc(
                    resolution=f"expired-{resolution or 'deferred'}")
                if resolution == "adopted":
                    # the hub HAS the binding: re-add it bound
                    self.cache.add_pod(p)
                    klog.V(2).info(
                        "assumed pod %s expired but the hub confirms the "
                        "binding to %s — adopted, not requeued", key,
                        p.node_name)
                    continue
                if resolution is None:
                    # verification unreachable too: park assumed (no TTL)
                    # and re-probe each cycle / idle tick
                    self.cache.assume_pod(p, p.node_name)
                    self._ambiguous_binds[key] = (p, p.node_name, None)
                    self.obs.journeys.note_ambiguous_park(
                        key, "assume-expired")
                    klog.warning("assumed pod %s expired and verification "
                                 "is unreachable; parked assumed", key)
                    continue
                if resolution in ("conflict", "gone"):
                    # deleted, recreated under a new uid, or bound by
                    # another writer: drop the stale local copy; the
                    # watch or a relist delivers the truth object
                    self.volume_binder.forget_pod_volumes(key)
                    self._note_gone(key)
                    continue
                # "requeued": verified unbound, safe to retry below
            klog.warning("assumed pod %s on %s expired (bind confirmation "
                         "never arrived within %.0fs); requeueing", key,
                         p.node_name, self.cache.ttl_s)
            self.volume_binder.forget_pod_volumes(key)
            pending = dataclasses.replace(p, node_name="")
            self.event_sink(
                "AssumptionExpired", pending,
                f"binding to {p.node_name} was never confirmed within "
                f"{self.cache.ttl_s:.0f}s; capacity freed, pod requeued")
            if self.responsible_for(pending):
                self.queue.add_if_not_present(pending)

    def _device_snapshot_recovering(self):
        """``cache.device_snapshot()`` with device-loss recovery: an error
        from the resident path (a CUDA out-of-memory error, a lost card,
        or the injected ``snapshot:device`` faults standing in for one)
        drops the resident tensors and rebuilds them from the host mirror,
        up to ``recovery.device_reset_limit`` times in a cycle; past that
        the scheduler runs host-mode snapshots for
        ``recovery.device_cooloff_s`` (the ladder meanwhile absorbs solve
        failures), then probes the device again. Returns ``(table,
        dev_or_None, mode)``: ``None`` and ``"host"`` on the fallback,
        where the caller uploads the host table itself. A
        ``kernels.KernelError`` is a kernel fault, not a device loss: it
        propagates. An error that leaves the CUDA context unusable (an
        illegal address, a device-side assert) is not recoverable in the
        process; the rebuild then fails again and the cycle raises."""
        if self.clock() < self._device_cooloff_until:
            return self.cache.snapshot(), None, "host"
        attempts = 0
        while True:
            try:
                out = self.cache.device_snapshot()
                if attempts:
                    klog.V(2).info("device snapshot rebuilt after %d "
                                   "reset(s)", attempts)
                return out
            except kernels.KernelError:
                raise
            except Exception as e:  # noqa: BLE001 — a device error
                attempts += 1
                self._note_device_reset("snapshot:device", e)
                klog.warning("device snapshot failed (%s); dropping "
                             "resident table (reset %d/%d)", e, attempts,
                             self.recovery.device_reset_limit)
                self.cache.drop_device_snapshot()
                # the score summary died with the resident table; the
                # potential carry must not survive the device either
                self._drop_incremental("device-loss")
                if attempts > self.recovery.device_reset_limit:
                    self._device_cooloff_until = (
                        self.clock() + self.recovery.device_cooloff_s)
                    klog.warning("device snapshot rebuild budget "
                                 "exhausted; host-mode snapshots for "
                                 "%.1fs", self.recovery.device_cooloff_s)
                    return self.cache.snapshot(), None, "host"

    def _note_device_reset(self, site: str, e: Exception,
                           shapes: str = "") -> None:
        """Count one device reset: the scheduler's metric, the cycle's
        trace (or the next one's, between cycles), the process tally; and
        the memory ledger's ranked forensic record, taken BEFORE the
        caller drops the residents, whose ``oom@<site> top=<name>:<bytes>B``
        flag lands on the cycle's flight record."""
        self.metrics.recovery_device_resets.inc()
        self.obs.note_device_reset()
        ml = self.obs.memledger
        if ml.enabled:
            rec = ml.record_oom(site, error=str(e), shapes=shapes,
                                cycle=self.queue.scheduling_cycle)
            self.obs.note_oom_forensic(ml.oom_flag(rec))
        RECOVERY.device_resets += 1

    def _mesh_width(self) -> int:
        """Devices THIS cycle's tables are sharded over; 0 when the mesh
        is off or the cycle runs single-device (the cooloff)."""
        return self.mesh.size if self._mesh_live else 0

    def _place_host(self, nt, pad_to=None):
        """Place a host node table on the live mesh (the host-mode cycle,
        the cascade and the warmup): the placement itself (a
        ``ShardedNodes`` on a mesh of ``d > 1``), kept for
        :meth:`_solve_nodes`."""
        placed = pmesh.place_node_table(nt, self.mesh, pad_to=pad_to)
        self._host_placed = placed
        return placed

    def _solve_nodes(self, dn):
        """The node table a cycle's node-axis passes run on: on a live
        mesh of ``d > 1`` devices the table's placement (the resident one
        the cache keeps, or the host-mode one), so every pass is
        partitioned; otherwise ``dn`` itself. A placement passes through;
        a whole table the placements do not hold is sharded now."""
        if (not self._mesh_live or self.mesh.size < 2
                or isinstance(dn, pmesh.ShardedNodes)):
            return dn
        for placed in (self.cache.placed_table, self._host_placed):
            if placed is not None and placed.whole is dn:
                return placed
        return pmesh.shard_nodes(dn, self.mesh)

    def _whole(self, dn, *planes):
        """``dn`` and the (P, N) ``planes`` whole on the mesh's first
        device, for the passes that re-pin the cycle off the mesh (the
        ``batch-single`` and ``batch-cpu`` rungs, the greedy and exact
        tiers): one counted ``gather_nodes`` for a placed table and one
        gather per plane left in column blocks; the inputs as they are
        otherwise."""
        if not isinstance(dn, pmesh.ShardedNodes):
            return (dn,) + planes
        return (coll.whole_table(dn),) + tuple(_whole_cols(x)
                                               for x in planes)

    def _node_mask(self, n_pad: int, rows=None, host=None):
        """An (N,) bool node mask on the cycle's node placement: True at
        host rows ``rows`` (or the host array ``host``). Whole on the
        cycle's device off the mesh; in the mesh's row blocks on it, each
        uploaded straight to its shard."""
        if not self._mesh_live or self.mesh.size < 2:
            if host is not None:
                return upload(host, self.device)
            m = torch.zeros((n_pad,), dtype=torch.bool, device=self.device)
            if rows:
                m[upload(rows, self.device, np.int64)] = True
            return m
        if host is None:
            host = np.zeros((n_pad,), bool)
            host[list(rows or ())] = True
        return pmesh.upload_rows(host, self.mesh)

    def _num_shards(self) -> int:
        """The shard count of the sparse routes' candidate pick."""
        return self._mesh_width() or 1

    def _cycle_snapshot(self):
        """The cycle's node snapshot: ``(table, dev, mode)`` with ``dev``
        always on ``self.device``. The resident path (with device-loss
        recovery), or host mode: the host table packed and uploaded whole
        through the pinned non-blocking staging of ``ops/arrays.upload``,
        at the resident table's padded shape, so the warmed round-loop
        graphs serve host-mode cycles too."""
        if self.device_resident_snapshot:
            nt, dn, mode = self._device_snapshot_recovering()
        else:
            nt, dn, mode = self.cache.snapshot(), None, "host"
        # mesh liveness for THIS cycle: a resident table comes back placed
        # on the mesh (cache.set_mesh), the non-resident host pack is
        # placed below; only the device-loss cooloff (resident on, no
        # device table) runs single-device until the heal probe
        self._mesh_live = (self.mesh is not None
                           and (dn is not None
                                or not self.device_resident_snapshot))
        self.obs.note_mesh_cycle(self._mesh_width())
        if dn is None:
            if self._mesh_live:
                dn = self._place_host(nt)
            else:
                dn = nodes_to_device(nt, device=self.device)
            RECOVERY.host_cycles += 1
        dn = self._solve_nodes(dn)
        rows = nt.n if mode == "host" else self.cache.last_upload_rows
        self.metrics.snapshot_packs.inc(mode=mode)
        self.metrics.snapshot_rows_packed.inc(rows)
        return nt, dn, mode

    def schedule_cycle(self, flush_trigger: str = "",
                       window_s: float = 0.0) -> CycleResult:
        """One batched scheduling pass over everything in activeQ.

        ``flush_trigger``/``window_s`` are the serving loop's micro-batch
        provenance (what flushed the accumulation window and how long it
        held), kept on the CycleResult and the cycle's trace."""
        t0 = self.clock()
        syncs0 = SYNCS.count
        self._captures0 = device_loop.CAPTURES.count
        res = CycleResult(flush_trigger=flush_trigger, window_s=window_s)
        # per-cycle deadline (robustness.cycle_deadline_s): the ladder
        # skips to the floor once it is blown, and extender calls shed
        self._cycle_deadline = (
            t0 + self.robustness.cycle_deadline_s
            if self.robustness.cycle_deadline_s > 0 else None)
        self.obs.begin_cycle(self.queue.scheduling_cycle)
        if flush_trigger:
            self.obs.note_microbatch(flush_trigger, window_s)
        self.queue.tick()
        self._reap_expired_assumptions()
        self._verify_ambiguous_binds()
        # the re-pack sweep runs BEFORE the batch pops: the pods it drains
        # re-enter this same cycle's solve under the pack's objective
        self.maybe_repack()
        self._process_waiting(res)
        batch = self.queue.pop_batch(self.max_batch)
        if not batch:
            self._explain_retire_if_drained()
            return self._finish(res, t0, syncs0)
        cycle = self.queue.scheduling_cycle
        self.obs.note_cycle(cycle)
        # skipPodSchedule (scheduler.go:335): pods marked for deletion drop
        for p in batch:
            if p.deletion_timestamp:
                self._note_gone(p.key())
        batch = [p for p in batch if not p.deletion_timestamp]
        res.attempted = len(batch)
        # PreFilter (framework.go RunPrefilterPlugins): a non-success aborts
        # that pod's cycle before it reaches the device
        kept = []
        for p in batch:
            st = CycleState()
            self._cycle_states[p.key()] = st
            status = self.framework.run_prefilter(st, p)
            if status.is_success():
                kept.append(p)
            else:
                self._fail(p, cycle, res, (f"PreFilter:{status.message}",))
        batch = kept
        if not batch:
            # every popped pod failed PreFilter: they still get report
            # rows (status reasons, no device analytics)
            if self.explain:
                self._build_explain_report(cycle, [], None,
                                           len(self.cache.nodes()), res)
            return self._finish(res, t0, syncs0)

        # pack: pods first (their programs grow universes), then snapshot
        pk = self.cache.packer
        nominated = self._nominated_pods(exclude={p.key() for p in batch})
        use_pipeline = self._pipeline_eligible(batch, nominated)
        dev = self.device
        with self.obs.span("snapshot"):
            for p in batch:
                pk.intern_pod(p)
            for p, _ in nominated:
                pk.intern_pod(p)
            nt, dn, res.snapshot_mode = self._cycle_snapshot()
            node_order = self.cache.node_order()
            pt = pk.pack_pods(batch)
            skip_prio, no_ports, no_pod_aff, no_spread = solver_gates(nt, pt)
            # capacity preflight (obs/memledger.py): the cycle's padded
            # solve shape against the warmed buckets' measured peaks,
            # BEFORE the pod batch is uploaded. An over-budget shape
            # splits down to the largest warmed bucket that fits (the
            # tail requeued for the next cycle) or sheds the whole batch:
            # a deliberate requeue beats running out of device memory
            # mid-solve. A pipelined cycle solves at the chunk shape, so
            # it preflights that and sheds rather than splits (the chunk
            # is already the smallest unit)
            preflight_shed = False
            pad_p = 0  # the preflight's padding override (0 = default)
            ml = self.obs.memledger
            if ml.preflight_on and batch:
                eff_p = bucket_size(max(
                    min(len(batch), self.pipeline_chunk) if use_pipeline
                    else len(batch), 1))
                act, split_p, verdict = ml.preflight(
                    eff_p, int(dn.n), self._mesh_width())
                self.obs.note_preflight(act)
                if act == "split" and not use_pipeline and split_p > 0:
                    if split_p < len(batch):
                        for p in batch[split_p:]:
                            self._cycle_states.pop(p.key(), None)
                            self.queue.add_if_not_present(p)
                        self.obs.step(f"preflight split {len(batch)} -> "
                                      f"{split_p} pods ({verdict})")
                        batch = batch[:split_p]
                        res.attempted = len(batch)
                        # re-pack at the trimmed shape (the gates of the
                        # superset's pack stay valid for a subset: they
                        # can only be conservative)
                        pt = pk.pack_pods(batch)
                    # the default padding of the remaining batch may
                    # still round up past the budget: pin the padding to
                    # the warmed bucket the preflight cleared
                    pad_p = split_p
                elif act == "shed" or (act == "split" and use_pipeline):
                    for p in batch:
                        self._cycle_states.pop(p.key(), None)
                        self.queue.add_if_not_present(p)
                    self.obs.step(f"preflight shed {len(batch)} pods "
                                  f"({verdict})")
                    batch = []
                    res.attempted = 0
                    preflight_shed = True
                    use_pipeline = False
            # a pipelined cycle packs and uploads its pods chunk by chunk
            dp = None if use_pipeline or preflight_shed else pods_to_device(
                pt, pad_to=pad_p or bucket_size(max(len(batch), 1)),
                device=dev)
            ds = selectors_to_device(pk.pack_selector_tables(), device=dev)
            # the topology universe only grows: once any affinity or
            # spread term was interned, every cycle packs the tables (the
            # batch gates then skip what this batch provably does not
            # need)
            dt = (topology_to_device(pk.pack_topology_tables(), device=dev)
                  if _has_topo(pk.u) else None)
            dv = sv = None
            if dp is not None and any(p.volumes for p in batch):
                dv = volumes_to_device(pk.pack_volume_tables(batch),
                                       device=dev)
                sv = _static_vol_pass(dp, dn, ds, dv)
            # this cycle's padded operand tables, re-registered every
            # cycle at the current shape
            ml.register_tree("scheduler.pod_batch", dp, ds, dt, dv)
            self.obs.step(f"snapshot packed ({len(batch)} pods, {nt.n} "
                          f"nodes, {res.snapshot_mode})")
        self._note_snapshot(res.snapshot_mode, nt, dn, dp, ds, dt, dv,
                            len(batch), use_pipeline)
        if preflight_shed:
            # the preflight requeued the whole batch: the cycle still
            # closes its snapshot accounting and flight record, and never
            # uploads the pods or touches the solver
            return self._finish(res, t0, syncs0)

        if use_pipeline:
            # the pipelined executor owns the rest of the cycle on the
            # clean fast path (no nominated pods, gangs or plugin terms)
            return self._pipelined_tail(batch, cycle, res, t0, syncs0, nt,
                                        dn, ds, dt, node_order, skip_prio,
                                        no_ports, no_pod_aff, no_spread)

        # the sparsity-first routes: a steady micro-batch solves
        # RESTRICTED on candidate columns of the resident score summary;
        # with ``primary`` a cycle it did not take solves PARTITIONED.
        # Either returns None unless the whole batch placed, and the
        # dense ladder below re-solves the cycle (the fallback)
        if self._incremental_eligible(batch, nominated, dn, dt, dv,
                                      res.snapshot_mode, no_ports,
                                      no_pod_aff, no_spread, nt):
            out = self._restricted_tail(batch, cycle, res, t0, syncs0, nt,
                                        dn, ds, dp, node_order, skip_prio)
            if out is not None:
                return out
        if self._partitioned_cold_eligible(batch, nominated, dn, dt, dv,
                                           no_ports, no_pod_aff, no_spread):
            out = self._partitioned_cold_tail(batch, cycle, res, t0, syncs0,
                                              nt, dn, ds, dp, node_order,
                                              skip_prio)
            if out is not None:
                return out

        extra_mask, extra_score, early_fail = self._plugin_terms(
            batch, dp, dn, ds, node_order)
        # node-search truncation: restrict this cycle's solve to the next
        # K nodes in zone rotation (numFeasibleNodesToFind semantics)
        if self.percentage_of_nodes_to_score is not None:
            k = num_feasible_nodes_to_find(nt.n,
                                           self.percentage_of_nodes_to_score)
            if k < nt.n:
                subset = set(self.node_tree.take(k))
                col = np.zeros((dn.n,), bool)
                for j, name in enumerate(node_order):
                    col[j] = name in subset
                cm = upload(col, dev)[None, :]
                extra_mask = cm if extra_mask is None else extra_mask & cm
        # one shared built-in filter pass against the initial usage, read
        # by the extenders and the exact solver
        base_fr = None
        if self.extenders or self.solver == "exact":
            base_fr = _filter_pass(dp, dn, ds, dt, dv, sv, self.pred_mask)
        # scheduler extenders (generic_scheduler.go:539-566): after the
        # built-in predicates; prioritize adds weight*score to the totals
        if self.extenders:
            with self.obs.span("extenders"):
                em, es = self._run_extenders(batch, base_fr, node_order,
                                             early_fail)
            if em is not None:
                extra_mask = em if extra_mask is None else extra_mask & em
            if es is not None:
                extra_score = es if extra_score is None else extra_score + es
            self.obs.step("extenders done")
        # the scenario pack's (P, N) cost term joins the plugin/extender
        # score seam, so it rides every ladder tier (batch, batch-cpu, the
        # greedy oracle) and the exact solver unchanged
        if self.scenario_pack is not None:
            with self.obs.span("scenario:cost"):
                sc_cost = self.scenario_pack.cost(batch, nt, node_order, dp,
                                                  dn)
            extra_score = _combine(extra_score, sc_cost, operator.add)
        if nominated:
            nom_mask = self._nominated_mask(nominated, node_order, dp, dn,
                                            ds, dt, dv, sv)
            extra_mask = _combine(extra_mask, nom_mask, operator.and_)

        solver = self.solver
        if solver == "exact":
            # the Hungarian models capacity as per-node slots only: in-batch
            # coupling through host ports, volumes or topology terms is not
            # in its constraint matrix, so such batches take the round
            # solver, which models all three
            hazards = []
            if dt is not None and any(
                    p.affinity.pod_affinity_required
                    or p.affinity.pod_anti_affinity_required
                    or p.affinity.pod_affinity_preferred
                    or p.affinity.pod_anti_affinity_preferred
                    or p.topology_spread for p in batch):
                hazards.append("topology")
            if dv is not None:
                hazards.append("volumes")
            if not no_ports:
                hazards.append("host-ports")
            if hazards:
                self.exact_fallbacks += 1
                self.obs.step(f"exact solver unsafe with "
                              f"{'+'.join(hazards)}; using round solver")
                solver = "batch"
        # the solve site's signature (shapes, dtypes and statics; no
        # device read): a new one after warmup is a new round-loop graph
        self.obs.jax.record_call(
            "solve", dp, dn, ds, dt, dv,
            static=(solver, tuple(skip_prio), no_ports, no_pod_aff,
                    no_spread, self.pred_mask, self.per_node_cap,
                    self.max_rounds, extra_mask is None,
                    extra_score is None, self._mesh_live))
        ts = self.clock()
        ladder = self._solve_ladder(solver, batch, dp, dn, ds, dt, dv, sv,
                                    base_fr, extra_mask, extra_score,
                                    skip_prio, no_ports, no_pod_aff,
                                    no_spread, res)
        res.solve_s = self.clock() - ts
        if ladder is None:
            # every tier failed: requeue the whole batch with backoff
            for pod in batch:
                self._fail(pod, cycle, res, ("SolverUnavailable",))
            return self._finish(res, t0, syncs0)
        assigned, usage, res.rounds, res.solver_tier = ladder
        assigned = assigned[: len(batch)].copy()
        self.obs.step(f"solve done ({res.rounds} rounds)")

        # gang scheduling (PodGroup all-or-nothing): a group binds only
        # when ALL its present members placed AND at least minMember are
        # present (members placed in earlier cycles count)
        gang_failed: Dict[int, str] = {}
        groups: Dict[str, List[int]] = {}
        for gi, gp in enumerate(batch):
            if gp.pod_group:
                groups.setdefault(gp.pod_group, []).append(gi)
        for gname, idxs in groups.items():
            need = max([batch[gi].pod_group_min_available for gi in idxs]
                       + [0])
            placed = self.cache.group_members(gname)
            if (len(idxs) + placed < need
                    or any(assigned[gi] < 0 for gi in idxs)):
                for gi in idxs:
                    if assigned[gi] >= 0:
                        assigned[gi] = -1
                        gang_failed[gi] = f"GangIncomplete:{gname}"
        if gang_failed:
            # rebuild usage from the FINAL assignment: rolled-back members
            # must not linger as phantom occupancy in the reason pass or in
            # preemption
            pad = np.full((dp.valid.shape[0],), -1, np.int64)
            pad[: len(batch)] = assigned
            pad_t = upload(pad, dev)
            usage = _apply_batch(usage_from_nodes(dn), dp,
                                 pad_t.clamp_min(0), (pad_t >= 0) & dp.valid)
        # scenario quality: dispatched now (final usage, final assignment,
        # gang rollbacks applied) so the device reduces while the host
        # binds; its (7,) vector is read back after the bind loop
        q_dev = None
        if self.scenario_pack is not None and self.scenario.quality:
            pad_a = np.full((dp.valid.shape[0],), -1, np.int32)
            pad_a[: len(batch)] = assigned
            q_dev = quality_reduce(upload(pad_a, dev), usage.requested, dp,
                                   dn)

        # reasons for the unplaced: one filter pass against the final
        # usage (without the nominated phantoms, as in the reference),
        # reduced on the device by explain_reduce for exactly the failed
        # rows and read back as one transfer; preemption's per-node rows
        # are gathered for the preemptable pods only (on a mesh each
        # shard reduces and takes rows of its own column block)
        failed_idx = [i for i, a in enumerate(assigned) if a < 0]
        preemptable_idx = [i for i in failed_idx if i not in gang_failed]
        ex = rows_dev = None
        if failed_idx:
            tx = time.perf_counter()
            dn_u = nodes_with_usage(dn, usage)
            fr = _filter_pass(dp, dn_u, ds, dt, dv, sv, self.pred_mask)
            ex = explain_rows(fr.reasons, dn_u, dp.req,
                              upload(failed_idx, dev, np.int64))
            if self.enable_preemption and preemptable_idx:
                pre = upload(preemptable_idx, dev, np.int64)
                rows_dev = reason_rows(fr.reasons, pre)[:, : nt.n]
            res.explain_s += time.perf_counter() - tx

        # bind the placed pods first: host work that overlaps the failure
        # reductions still running on the device
        bind_span = self.obs.current_trace.begin_span("bind")
        for i, pod in enumerate(batch):
            if int(assigned[i]) >= 0:
                self._admit_pod(pod, node_order[int(assigned[i])], cycle, res)
        tx = time.perf_counter()
        reasons_row: Dict[int, Tuple[str, ...]] = {}
        fit_msgs: Dict[int, str] = {}
        ex_host = None
        if ex is not None:
            with self.obs.span("pipeline:readback@reasons"):
                ex_host = read_back(ex, self._reader("explain"))
            res_names = (list(FIXED_RESOURCE_NAMES)
                         + pk.u.scalar_resources.items())[: pt.req.shape[1]]
            for j, i in enumerate(failed_idx):
                # a pod's reason set = union over valid nodes of failed
                # bits (zero when no node is valid)
                bits = int(ex_host["pod_bits"][j])
                reasons_row[i] = decode_reasons(bits)
                if bits:
                    fit_msgs[i] = fit_error_message_from_counts(
                        ex_host["per_pod"][j], ex_host["insufficient"][j],
                        ex_host["not_ready"][j], ex_host["net_unavail"][j],
                        nt.n, pt.req[i], res_names)
        for i, pod in enumerate(batch):
            if int(assigned[i]) >= 0:
                continue
            if i in early_fail:
                reasons, msg = (early_fail[i],), None
            elif i in gang_failed:
                reasons, msg = (gang_failed[i],), None
            else:
                reasons, msg = reasons_row.get(i, ()), fit_msgs.get(i)
            self._fail(pod, cycle, res, reasons, message=msg)
        if self.explain:
            self._build_explain_report(
                cycle, [batch[i].key() for i in failed_idx], ex_host, nt.n,
                res)
        res.explain_s += time.perf_counter() - tx
        self.obs.current_trace.end_span(bind_span)
        self.obs.step(f"bound {res.scheduled}, failed {res.unschedulable}")
        if q_dev is not None:
            with self.obs.span("pipeline:readback@quality"):
                qvec = self.obs.jax.readback("scenario-quality", q_dev)
            self._take_scenario_quality(res, qvec, batch, assigned, nt)

        # preemption (scheduler.go:493 -> preempt): failed pods try to
        # evict lower-priority pods; winners get a nominated node and
        # retry. The reason rows cross to the host only here
        if rows_dev is not None:
            tp = time.perf_counter()
            res.preempt_rows_bytes = rows_dev.numel() * rows_dev.element_size()
            with self.obs.span("pipeline:readback@preempt"):
                rows = self.obs.jax.readback("preempt-reasons", rows_dev)
            pt0 = self.clock()
            with self.obs.span("preemption"):
                if (self.scenario_pack is not None
                        and self.scenario_pack.wants_cascade):
                    # victims and displaced pods re-enter one more dense
                    # solve in this same cycle instead of the per-pod
                    # nominate-and-wait loop
                    self._run_preemption_cascade(batch, preemptable_idx,
                                                 rows, node_order, res)
                else:
                    self._run_preemption(batch, preemptable_idx, rows,
                                         node_order, res)
            self.metrics.preemption_duration.observe(self.clock() - pt0)
            res.preempt_s = time.perf_counter() - tp
            self.obs.step(f"preemption ({res.preempted} victims)")
        return self._finish(res, t0, syncs0, cycle)

    def _reader(self, site: str):
        """The telemetry's readback at ``site``, as a one-argument read."""
        return lambda t: self.obs.jax.readback(site, t)

    def _note_snapshot(self, mode, nt, dn, dp, ds, dt, dv, n_batch,
                       use_pipeline) -> None:
        """The cycle's snapshot provenance for its flight record: the
        mode and the rows re-packed, the host-to-device bytes (the whole
        node table on a full or host upload, the delta's rows else) and
        the batch-shape digest."""
        rows = nt.n if mode == "host" else self.cache.last_upload_rows
        self.obs.note_snapshot(mode, rows)
        uploads = [t for t in (dp, ds, dt, dv) if t is not None]
        if mode in ("host", "full"):
            uploads.append(dn)
        elif self.cache.last_upload_nbytes:
            self.obs.jax.record_transfer("snapshot", "h2d",
                                         self.cache.last_upload_nbytes)
        self.obs.jax.record_upload("snapshot", *uploads)
        self.obs.note_batch_shape(
            f"P{dp.valid.shape[0] if dp is not None else n_batch}"
            f"xN{dn.n}"
            + ("+topo" if dt is not None else "")
            + ("+vol" if dv is not None else "")
            + (f"+pipe{self.pipeline_chunk}" if use_pipeline else "")
            + (f"+mesh{self.mesh.size}" if self._mesh_live else ""))

    def _finish(self, res: CycleResult, t0: float, syncs0: int,
                cycle: Optional[int] = None):
        """The shared end of every cycle path. ``cycle`` is given on the
        paths that solved to the bind (the reference's ``_finish_cycle``):
        those note the solve scope, count the incremental cycle and
        backfill the journeys' attempt rows; the early returns (an empty
        batch, a batch lost to PreFilter, a solver outage) do not."""
        res.elapsed_s = self.clock() - t0
        if res.solver_tier and not res.solve_scope:
            res.solve_scope = "full"
        if cycle is not None:
            if res.solve_scope:
                self.obs.note_solve_scope(res.solve_scope, res.reuse_frac)
                if self.incremental.enabled:
                    self.metrics.incremental_cycles.inc(
                        scope=res.solve_scope)
                    self.metrics.incremental_reuse_fraction.set(
                        res.reuse_frac)
            self.obs.journeys.finish_cycle(cycle, res.solver_tier,
                                           res.solve_scope)
        if res.solver_tier:
            self.metrics.algorithm_duration.observe(res.solve_s)
            self.last_solver_tier = res.solver_tier
            self.last_solver_fallbacks = res.solver_fallbacks
        res.host_syncs = SYNCS.count - syncs0
        res.graph_captures = device_loop.CAPTURES.count - self._captures0
        if res.graph_captures:
            self.metrics.graph_captures.inc(res.graph_captures,
                                            phase="cycle")
        self._record_metrics(res, res.solve_s)
        if self.obs.current_trace is not None:
            self.obs.current_trace.log_if_long(self.trace_threshold_s)
        self.obs.end_cycle(res)
        klog.V(3).info(
            "cycle: attempted=%d scheduled=%d unschedulable=%d rounds=%d "
            "syncs=%d %.3fs", res.attempted, res.scheduled,
            res.unschedulable, res.rounds, res.host_syncs, res.elapsed_s)
        return res

    def _record_metrics(self, res: CycleResult, solve_s: float = 0.0) -> None:
        """pkg/scheduler/metrics names: per-pod attempt counts, cycle-level
        durations, queue-depth gauges. Bind errors already passed
        scheduling and count only under "error" (the reference's result
        labels are disjoint per attempt)."""
        m = self.metrics
        m.schedule_attempts.inc(res.scheduled, result=m.SCHEDULED)
        m.schedule_attempts.inc(max(res.unschedulable - res.bind_errors, 0),
                                result=m.UNSCHEDULABLE)
        m.schedule_attempts.inc(res.bind_errors, result=m.ERROR)
        # e2e latency is per pod create-to-bind; a cycle that attempted
        # but bound nothing observes its elapsed time
        if res.e2e_latency_s:
            for v in res.e2e_latency_s.values():
                m.e2e_scheduling_duration.observe(v)
        elif res.attempted:
            m.e2e_scheduling_duration.observe(res.elapsed_s)
        if res.attempted or res.scheduled or res.unschedulable:
            m.scheduling_duration.observe(solve_s,
                                          operation="scheduling_algorithm")
        sync = getattr(self.queue, "_sync_gauges", None)
        if sync is not None:
            sync()
        else:
            for q, depth in self.queue.pending_counts().items():
                m.pending_pods.set(depth, queue=q)

    def _plugin_terms(self, batch, dp, dn, ds, node_order):
        """Framework Filter/Score contributions: batch plugins give whole
        (P, N) tensors; host plugins evaluate per (pod, node name). Returns
        ``(extra_mask, extra_score, early_fail)``; a raising host plugin
        fails only its own pod."""
        fw = self.framework
        state = CycleState()
        n_pad = dn.n
        if fw.has_batch_filters() or fw.has_batch_scores():
            # a batch plugin reads the whole table (one counted gather on
            # a mesh), as a registered custom priority kernel does
            dn = self._whole(dn)[0]
        extra_mask = fw.run_filter_batch(state, dp, dn, ds)
        extra_score = fw.run_score_batch(state, dp, dn, ds)
        early_fail: Dict[int, str] = {}
        if fw.has_host_filters() or fw.has_host_scores():
            shape = (dp.valid.shape[0], n_pad)
            hm = np.ones(shape, bool)
            hs = np.zeros(shape, np.float32)
            for i, p in enumerate(batch):
                st = self._cycle_states[p.key()]
                try:
                    for j, name in enumerate(node_order):
                        if fw.has_host_filters():
                            hm[i, j] = fw.run_host_filter(st, p,
                                                          name).is_success()
                        if fw.has_host_scores() and hm[i, j]:
                            hs[i, j] = fw.run_host_score(st, p, name)
                except Exception as e:  # noqa: BLE001 — plugin boundary
                    hm[i, :] = False
                    early_fail[i] = f"HostPlugin:{e}"
            if fw.has_host_filters():
                m = upload(hm, self.device)
                extra_mask = m if extra_mask is None else (extra_mask & m)
            if fw.has_host_scores():
                s = upload(hs, self.device)
                extra_score = s if extra_score is None else extra_score + s
        return extra_mask, extra_score, early_fail

    # -- nominated pods, preemption, explain reports -----------------------

    def _nominated_pods(self, exclude) -> List[Tuple[Pod, str]]:
        """(pod, node) for every nominated pod not in the current batch and
        whose node still exists."""
        out: List[Tuple[Pod, str]] = []
        for node_name, pods in self.queue.nominated.items():
            if self.cache.node(node_name) is None:
                continue
            for p in pods:
                if p.key() not in exclude:
                    out.append((p, node_name))
        return out

    def _nominated_mask(self, nominated, node_order, dp, dn, ds, dt, dv,
                        sv) -> torch.Tensor:
        """Nominated-pods pass A (podFitsOnNode's two-pass rule,
        generic_scheduler.go:610): the batch's feasibility must also hold
        with the nominated pods counted onto their nodes. As in the JAX
        package, ALL nominated pods are added, not only those of higher or
        equal priority — strictly more conservative than the reference (a
        pod may wait one extra cycle; capacity is never double-promised).
        Returns the (P, N) mask (its column blocks on a mesh)."""
        dev = self.device
        row_of = {name: i for i, name in enumerate(node_order)}
        dpn = pods_to_device(
            self.cache.packer.pack_pods([p for p, _ in nominated]),
            device=dev)
        rows = np.zeros((dpn.valid.shape[0],), np.int64)
        ok = np.zeros((dpn.valid.shape[0],), bool)
        for j, (_, node) in enumerate(nominated):
            r = row_of.get(node, -1)
            rows[j], ok[j] = max(r, 0), r >= 0
        u_nom = _apply_batch(usage_from_nodes(dn), dpn,
                             upload(rows, dev),
                             upload(ok, dev) & dpn.valid)
        return _filter_pass(dp, nodes_with_usage(dn, u_nom), ds, dt, dv,
                            sv, self.pred_mask).mask

    def _run_preemption(self, batch, preemptable_idx, rows, node_order,
                        res: CycleResult) -> None:
        """Failed pods, highest priority first and at most
        ``max_preemptions_per_cycle`` of them successfully, evict
        lower-priority victims and are nominated onto the freed node.
        ``rows[j]`` is the failure pass's reason row of
        ``batch[preemptable_idx[j]]`` over ``node_order``."""
        nodes = self.cache.nodes()
        node_pods_of = {nd.name: self.cache.pods_on(nd.name) for nd in nodes}
        pdbs = list(self.pdb_lister())
        row_of = {i: j for j, i in enumerate(preemptable_idx)}
        order = sorted(preemptable_idx, key=lambda i: -batch[i].priority)
        done = 0
        for i in order:
            if done >= self.max_preemptions_per_cycle:
                break
            pod = batch[i]
            bits = rows[row_of[i]]
            reason_bits = {name: bits[r] for r, name in enumerate(node_order)
                           if name}
            self.metrics.preemption_attempts.inc()
            result = preempt(
                pod, nodes, node_pods_of, reason_bits, pdbs,
                nominated_pods_of=dict(self.queue.nominated.items()),
                vol_state=self.cache.packer.resolve_volumes,
                extenders=[e for e in self.extenders
                           if e.supports_preemption()],
                enable_non_preempting=self.enable_non_preempting)
            if result is None:
                continue
            self.metrics.preemption_victims.inc(len(result.victims))
            now = self.clock()
            for v in result.victims:
                v.deletion_timestamp = now
                self.event_sink("Preempted", v, f"by {pod.key()}")
                self.obs.journeys.note_evicted(v.key(), pod.key())
                if self.victim_deleter is not None:
                    # the deletion goes through the API; the victim stays
                    # cached as terminating until the watch delete arrives
                    self.victim_deleter(v)
                else:
                    self.cache.remove_pod(v.key())
                # either way, later preemptors in this cycle must not
                # re-select (and re-delete) the same victims
                node_pods_of[result.node_name] = [
                    p for p in node_pods_of[result.node_name]
                    if p.key() != v.key()]
            # clear lower-priority nominations on the chosen node
            # (scheduler.go:330 getLowerPriorityNominatedPods)
            for p in result.clear_nominations:
                p.nominated_node_name = ""
                self.queue.nominated.delete(p)
            pod.nominated_node_name = result.node_name
            self.queue.nominated.add(pod, result.node_name)
            res.preempted += len(result.victims)
            res.nominations[pod.key()] = result.node_name
            done += 1
        if res.preempted and self.victim_deleter is None:
            # the victims' deletes happened inline (grace 0): the watch
            # delete -> MoveAllToActiveQueue wakeup happens here, or the
            # nominated preemptor waits out the unschedulable flush
            self.queue.move_all_to_active()

    def _take_scenario_quality(self, res: CycleResult, qvec, batch,
                               assigned, nt) -> None:
        """Decode the read-back quality vector, fold in the pack's host
        scores and publish the cycle's quality dict."""
        quality = decode_quality(qvec)
        quality.update(self.scenario_pack.quality_host(batch, assigned, nt))
        res.scenario_quality = quality
        self._publish_scenario_quality(quality)

    def _publish_scenario_quality(self, quality) -> None:
        """Fan one cycle's quality dict out to the flight record and the
        gauge family: a score that stopped being reported (a gangless
        cycle after a gang cycle) drops to 0 instead of going stale."""
        self.obs.note_scenario(quality)
        for k in self._scenario_scores_seen - set(quality):
            self.metrics.scenario_quality.set(0.0, score=k)
        for k, v in quality.items():
            self.metrics.scenario_quality.set(float(v), score=k)
            self._scenario_scores_seen.add(k)

    def _run_preemption_cascade(self, batch, preemptable_idx, rows,
                                node_order, res: CycleResult) -> None:
        """The in-batch preemption cascade of the scenario packs: victim
        selection runs the port's own ``preemption.preempt`` for every
        preemptor against one shared state (earlier evictions visible to
        later preemptors, ``scenarios/cascade.select_cascade``), then the
        victims are evicted and the preemptors and displaced pods re-solve
        in THIS cycle (``_cascade_solve``) instead of the stock path's
        nominate-and-wait loop. A single-pod batch selects the stock
        path's victim set by construction. ``rows[j]`` is the failure
        pass's reason row of ``batch[preemptable_idx[j]]``."""
        nodes = self.cache.nodes()
        node_pods_of = {nd.name: self.cache.pods_on(nd.name) for nd in nodes}
        pdbs = list(self.pdb_lister())
        row_of = {i: j for j, i in enumerate(preemptable_idx)}
        order = sorted(preemptable_idx, key=lambda i: -batch[i].priority)
        preemptors = [(batch[i], {
            name: rows[row_of[i]][r]
            for r, name in enumerate(node_order) if name
        }) for i in order]
        sel = select_cascade(
            preemptors, nodes, node_pods_of, pdbs,
            nominated_pods_of=dict(self.queue.nominated.items()),
            vol_state=self.cache.packer.resolve_volumes,
            extenders=[e for e in self.extenders if e.supports_preemption()],
            enable_non_preempting=self.enable_non_preempting,
            max_preemptions=self.max_preemptions_per_cycle,
            # the stock loop's per-processed-pod accounting
            on_attempt=self.metrics.preemption_attempts.inc)
        if not sel.chosen:
            return
        now = self.clock()
        if sel.victims:
            self.metrics.preemption_victims.inc(len(sel.victims))
            self.metrics.scenario_cascade_victims.inc(len(sel.victims))
        # the preemptors that re-solve this cycle: never a gang member
        # (binding one member solo would sidestep the all-or-nothing
        # rollback; gang preemptors keep the stock nomination)
        solve_keys = {batch[i].key() for i in order
                      if batch[i].key() in sel.chosen
                      and not batch[i].pod_group}
        displaced = []
        requeue_only = []
        for v in sel.victims:
            v.deletion_timestamp = now
            self.event_sink("Preempted", v,
                            f"by {sel.victim_of[v.key()]} (cascade)")
            self.obs.journeys.note_evicted(v.key(), sel.victim_of[v.key()])
            if self.victim_deleter is not None:
                # the deletion goes through the hub: the victim holds its
                # capacity as terminating until the watch delete lands, so
                # it cannot re-enter this cycle's solve
                self.victim_deleter(v)
            else:
                self.cache.remove_pod(v.key())
                if not self.responsible_for(v):
                    continue
                pending = dataclasses.replace(v, node_name="",
                                              deletion_timestamp=0.0)
                if sel.victim_of[v.key()] in solve_keys:
                    displaced.append(pending)
                else:
                    # the evacuated capacity is promised to a
                    # nominated-only preemptor: re-solving this victim
                    # now could retake it (the cascade solve has no pass-A
                    # phantoms), so it requeues, as the stock path's
                    # victims do
                    requeue_only.append(pending)
        for p in sel.clear_nominations:
            p.nominated_node_name = ""
            self.queue.nominated.delete(p)
        res.preempted += len(sel.victims)
        # the re-solve: preemptors first, displaced victims in the same
        # dense batch, bounded by scenario.cascade_max_pods
        resolve_pods = [batch[i] for i in order
                        if batch[i].key() in solve_keys]
        budget = max(self.scenario.cascade_max_pods, 1)
        overflow = (resolve_pods + displaced)[budget:]
        resolve_pods = (resolve_pods + displaced)[:budget]
        if self.victim_deleter is not None or not sel.victims:
            # nothing newly usable was freed (hub-delete mode holds the
            # victims' capacity; a victimless win evacuated nothing): the
            # re-solve could place nothing the main solve did not, so the
            # preemptors go straight to their nominations
            placed, q2 = set(), None
        else:
            placed, q2 = self._cascade_solve(resolve_pods, res)
        cycle = self.queue.scheduling_cycle
        for p in requeue_only:
            self._fail(p, cycle, res, ("CascadeUnplaced",))
        for p in overflow:
            # a displaced pod the budget cut was already evicted: it
            # requeues through the standard error path (a preemptor in the
            # overflow keeps its failure row and its nomination)
            if p.key() not in res.failure_reasons:
                self._fail(p, cycle, res, ("CascadeUnplaced",))
        for p in displaced:
            if p.key() in placed:
                self.metrics.scenario_displaced_replaced.inc()
        if q2:
            # the cascade changed the cluster: the cluster-state fields
            # come from the cascade solve's final usage; the batch fields
            # (placed, nodes_used_batch, priority_headroom) keep
            # describing the main solve
            for k in ("nodes_used", "headroom", "fragmentation",
                      "free_cpu_frac"):
                res.scenario_quality[k] = q2[k]
            self._publish_scenario_quality(res.scenario_quality)
        # preemptors the re-solve did not place keep the stock semantics:
        # nominated onto the chosen node, retried next cycle
        for i in order:
            key = batch[i].key()
            if key in sel.chosen and key not in placed:
                batch[i].nominated_node_name = sel.chosen[key]
                self.queue.nominated.add(batch[i], sel.chosen[key])
                res.nominations[key] = sel.chosen[key]
        if sel.victims and self.victim_deleter is None:
            # the inline (grace 0) deletes' watch wakeup
            self.queue.move_all_to_active()

    def _cascade_pad(self, n: int) -> int:
        """Pod bucket of a cascade re-solve. With warmup on, snapped up to
        a warmed bucket (the smallest explicit bucket that fits, or at
        least ``min_bucket`` for the geometric sweep), so a cascade never
        captures on the hot path; a cascade larger than every warmed
        bucket keeps its natural one."""
        pad = bucket_size(max(n, 1))
        wu = self.warmup_config
        if not wu.enabled:
            return pad
        explicit = sorted(b for b in wu.pod_buckets if b >= pad)
        if explicit:
            return explicit[0]
        if not wu.pod_buckets:
            return max(pad, bucket_size(max(min(wu.min_bucket,
                                                self.max_batch), 1)))
        return pad

    def _cascade_solve(self, pods_list, res: CycleResult):
        """One dense solve of the cascade's preemptors and displaced pods
        against the evacuated cluster: a fresh snapshot (the victims'
        rows are dirty, so the resident table takes the delta scatter),
        the full ladder with its validation, the pack's cost term, and the
        admission tail for each placed pod. Returns ``(placed keys,
        quality dict or None)``; the quality is reduced from the cascade's
        FINAL usage. A ``KernelError`` propagates."""
        placed: set = set()
        if not pods_list:
            return placed, None
        pk = self.cache.packer
        dev = self.device
        for p in pods_list:
            pk.intern_pod(p)
        if self.device_resident_snapshot:
            nt, dn, _ = self._device_snapshot_recovering()
        else:
            nt, dn = self.cache.snapshot(), None
        if dn is None:
            dn = (self._place_host(nt) if self._mesh_live
                  else nodes_to_device(nt, device=dev))
        dn = self._solve_nodes(dn)
        node_order = self.cache.node_order()
        pt = pk.pack_pods(pods_list)
        skip_prio, no_ports, no_pod_aff, no_spread = solver_gates(nt, pt)
        dp = pods_to_device(pt, pad_to=self._cascade_pad(len(pods_list)),
                            device=dev)
        ds = selectors_to_device(pk.pack_selector_tables(), device=dev)
        dt = (topology_to_device(pk.pack_topology_tables(), device=dev)
              if _has_topo(pk.u) else None)
        dv = sv = None
        if any(p.volumes for p in pods_list):
            dv = volumes_to_device(pk.pack_volume_tables(pods_list),
                                   device=dev)
            sv = _static_vol_pass(dp, dn, ds, dv)
        extra_score = None
        if self.scenario_pack is not None:
            extra_score = self.scenario_pack.cost(pods_list, nt, node_order,
                                                  dp, dn)
        solver = self.solver if self.solver != "exact" else "batch"
        self.obs.jax.record_call(
            "solve", dp, dn, ds, dt, dv,
            static=(solver, tuple(skip_prio), no_ports, no_pod_aff,
                    no_spread, self.pred_mask, self.per_node_cap,
                    self.max_rounds, True, extra_score is None,
                    self._mesh_live))
        ladder = self._solve_ladder(solver, pods_list, dp, dn, ds, dt, dv,
                                    sv, None, None, extra_score, skip_prio,
                                    no_ports, no_pod_aff, no_spread, res)
        cycle = self.queue.scheduling_cycle
        if ladder is None:
            for p in pods_list:
                if p.key() not in res.failure_reasons:
                    self._fail(p, cycle, res, ("SolverUnavailable",))
            return placed, None
        assigned, usage2, _rounds, _tier = ladder
        q2 = None
        if self.scenario.quality:
            pad_a = np.full((dp.valid.shape[0],), -1, np.int32)
            pad_a[: len(pods_list)] = assigned[: len(pods_list)]
            with self.obs.span("pipeline:readback@quality"):
                q2 = decode_quality(self.obs.jax.readback(
                    "scenario-quality",
                    quality_reduce(upload(pad_a, dev), usage2.requested, dp,
                                   dn)))
        assigned = assigned[: len(pods_list)]
        for i, p in enumerate(pods_list):
            t = int(assigned[i])
            if t < 0:
                # a displaced pod requeues through the standard error
                # path; an unplaced preemptor keeps the failure row the
                # main bind loop recorded and gets its nomination from the
                # caller
                if p.key() not in res.failure_reasons:
                    self._fail(p, cycle, res, ("CascadeUnplaced",))
                continue
            # a preemptor was already failed by the main bind loop: its
            # queue entry and failure row are superseded by this bind
            self.queue.delete(p.key())
            had_row = p.key() in res.failure_reasons
            before_sched = res.scheduled
            before_unsched = res.unschedulable
            before_wait = res.waiting
            self._admit_pod(p, node_order[t], cycle, res)
            if res.scheduled > before_sched or res.waiting > before_wait:
                # bound, or parked by a Permit plugin (assumed, capacity
                # held): it left the unschedulable state and must not also
                # be nominated (pass A would count its capacity twice)
                placed.add(p.key())
                if had_row:
                    res.unschedulable -= 1
                    res.failure_reasons.pop(p.key(), None)
                    res.fit_errors.pop(p.key(), None)
                    self.why_pending.pop(p.key(), None)
            elif had_row and res.unschedulable > before_unsched:
                # the admission tail failed a pod the main bind loop
                # already counted: one pod, one unschedulable
                res.unschedulable -= 1
        return placed, q2

    def maybe_repack(self) -> int:
        """The steady-state consolidation re-pack
        (``scenario.repackInterval``): every interval, drain the pods off
        the least-utilized FULLY emptiable nodes (nodes holding only this
        scheduler's bound, non-assumed, non-terminating pods, whose load
        the rest of the occupied cluster can absorb) and requeue them, so
        the next cycles' objective packs them tight again. At most
        ``scenario.repackMaxPods`` pods a sweep; returns the pods drained
        (0 off cadence or without a pack). Called before a cycle pops its
        batch and from :meth:`idle_tick`."""
        interval = self.scenario.repack_interval_s
        if interval <= 0 or self.scenario_pack is None:
            return 0
        now = self.clock()
        if self._last_repack_at is None:
            # the cadence starts at the first observation: a full interval
            # of churn elapses before the first drain
            self._last_repack_at = now
            return 0
        if now - self._last_repack_at < interval:
            return 0
        self._last_repack_at = now
        free: Dict[str, Tuple[float, int]] = {}
        occupied = []
        for nd in self.cache.nodes():
            pods = self.cache.pods_on(nd.name)
            used = sum(p.requests.cpu_milli for p in pods)
            free[nd.name] = (nd.allocatable.cpu_milli - used,
                             nd.allocatable.pods - len(pods))
            if pods:
                occupied.append(
                    (used / max(nd.allocatable.cpu_milli, 1.0), nd.name,
                     pods))
        if len(occupied) < 2:
            return 0  # nothing to consolidate into
        occupied.sort(key=lambda t: (t[0], t[1]))
        budget = max(self.scenario.repack_max_pods, 1)
        emptied: set = set()
        drained = 0
        for _util, name, pods in occupied:
            movable = [p for p in pods
                       if self.responsible_for(p)
                       and not self.cache.is_assumed(p.key())
                       and not p.deletion_timestamp]
            if len(movable) != len(pods):
                continue  # foreign or in-flight pods pin the node
            if not movable or len(movable) > budget - drained:
                continue
            need_cpu = sum(p.requests.cpu_milli for p in movable)
            # a feasibility heuristic only (the solver places): never
            # drain pods the other occupied nodes cannot possibly hold
            absorb_cpu = absorb_slots = 0
            for _u2, n2, _pods2 in occupied:
                if n2 == name or n2 in emptied:
                    continue
                c, sl = free[n2]
                absorb_cpu += max(c, 0)
                absorb_slots += max(sl, 0)
            if need_cpu > absorb_cpu or len(movable) > absorb_slots:
                continue
            for p in movable:
                if self.repack_evictor is not None:
                    self.repack_evictor(p)
                else:
                    self.cache.remove_pod(p.key())
                    self.queue.add_if_not_present(dataclasses.replace(
                        p, node_name="", deletion_timestamp=0.0))
            emptied.add(name)
            drained += len(movable)
            if drained >= budget:
                break
        if drained:
            self.metrics.scenario_repacks.inc()
            self.metrics.scenario_repack_drained.inc(drained)
            self.queue.move_all_to_active()
            klog.V(2).info("steady-state re-pack: drained %d pods off %d "
                           "nodes", drained, len(emptied))
        return drained

    def _run_extenders(self, batch, base_fr, node_order, early_fail):
        """Call each extender's Filter then Prioritize for interested pods
        against the built-in-feasible node set (``base_fr``, the cycle's
        shared filter pass). An open breaker or a blown deadline sheds an
        extender (ignorable, or ``extender_degrade_to_ignorable``: skipped;
        otherwise the pod fails); a failing ignorable extender drops out,
        any other fails its pod (generic_scheduler.go:539-566). Returns
        the (P, N) mask and score terms, or (None, None)."""
        from kubernetes_tpu_torch.extender import ExtenderError

        interested = [(i, p) for i, p in enumerate(batch)
                      if any(e.is_interested(p) for e in self.extenders)]
        if not interested:
            return None, None
        # the built-in-feasible mask crosses to the host for the HTTP
        # fan-out: one counted read
        base = np.asarray(self.obs.jax.readback(
            "extender-mask", _whole_cols(base_fr.mask)), bool)
        rows = {n: j for j, n in enumerate(node_order)}
        nodes_by_name = {nd.name: nd for nd in self.cache.nodes()}
        em = np.ones(base.shape, bool)
        es = np.zeros(base.shape, np.float32)
        rc = self.robustness
        for i, pod in interested:
            feasible = [n for n in node_order if base[i, rows[n]]]
            allowed = set(feasible)
            for ext in self.extenders:
                if not ext.is_interested(pod):
                    continue
                ename = ext.name() if hasattr(ext, "name") else repr(ext)
                br = self._breaker(f"extender:{ename}")
                shed = (self._cycle_deadline is not None
                        and self.clock() >= self._cycle_deadline)
                if shed or not br.allow():
                    # a configured-ignorable extender never fails pods;
                    # shedding it is the "unreachable ignorable" case
                    if rc.extender_degrade_to_ignorable or ext.is_ignorable():
                        self.metrics.extender_degraded.inc(extender=ename)
                        continue
                    allowed = set()
                    early_fail[i] = f"Extender:{ename} unavailable"
                    break
                # clamp the transport timeout to the remaining cycle
                # budget, and clear it on unbounded cycles
                if hasattr(ext, "set_call_budget"):
                    ext.set_call_budget(
                        max(self._cycle_deadline - self.clock(), 1e-3)
                        if self._cycle_deadline is not None else None)
                try:
                    names, _failed = ext.filter(
                        pod, [n for n in feasible if n in allowed],
                        nodes_by_name)
                    allowed &= set(names)
                    scores, weight = ext.prioritize(pod, sorted(allowed),
                                                    nodes_by_name)
                    br.record_success()
                    for n, sc in scores.items():
                        if n in rows:
                            es[i, rows[n]] += weight * sc
                except ExtenderError as e:
                    br.record_failure()
                    if ext.is_ignorable():
                        continue  # skip this extender (extender.go:124)
                    allowed = set()
                    early_fail[i] = f"Extender:{e}"
                    break
            keep = np.zeros(base.shape[1], bool)
            for n in allowed:
                keep[rows[n]] = True
            em[i] = keep
        return upload(em, self.device), upload(es, self.device)

    def _build_explain_report(self, cycle, keys, ex_host, n_nodes,
                              res: CycleResult) -> None:
        """Assemble the cycle's UnschedulableReport from the read-back
        explain arrays (row j belongs to ``keys[j]``) and the scheduler-level
        failure reasons; set it on the result, ``last_explain`` and
        ``why_pending``."""
        report = build_report(cycle, n_nodes, keys, range(len(keys)),
                              ex_host, self.explain_top_k)
        # pods that failed OUTSIDE the filter pass (prefilter, plugins,
        # gang rollback, volume/permit/bind errors) still get a row
        for key in res.failure_reasons:
            if key not in report.pods:
                report.pods[key] = PodExplanation(key=key)
        now = self.clock()
        for key, pe in report.pods.items():
            pe.reasons = res.failure_reasons.get(key, ())
            pe.message = res.fit_errors.get(key, "")
            pe.attempts = self.queue.backoff_map.attempts(key)
            pod = self.queue.pod(key)
            if pod is not None:
                # the queue stamps queued_at on add (0.0 is a valid
                # fake-clock enqueue time, not "unset")
                pe.queue_residency_s = max(
                    now - getattr(pod, "queued_at", now), 0.0)
        res.explain = report
        self.last_explain = report
        self.why_pending.update(report.pods)
        self.obs.note_explain(report)
        m = self.metrics
        for reason, npods in report.reason_pods.items():
            m.unschedulable_pods.inc(npods, reason=reason)
        # the gauges show THIS cycle's exclusion counts; a reason that
        # fired before but not now drops to zero instead of going stale
        for reason in self._explain_reasons_seen - set(
                report.reason_node_counts):
            m.unschedulable_node_counts.set(0, reason=reason)
        for reason, pairs in report.reason_node_counts.items():
            m.unschedulable_node_counts.set(pairs, reason=reason)
            self._explain_reasons_seen.add(reason)

    def _explain_retire_if_drained(self) -> None:
        """An idle cycle popped nothing: when every pod the last report
        analyzed has since left (bind and delete drop their why_pending
        rows), retire the report and zero the reason gauges instead of
        reporting them forever. Pods parked in backoff or unschedulable
        keep their rows."""
        if not self.explain or self.why_pending or self.last_explain is None:
            return
        if not (self.last_explain.pods
                or self.last_explain.reason_node_counts):
            return
        self.last_explain = UnschedulableReport(
            cycle=self.queue.scheduling_cycle,
            n_nodes=self.last_explain.n_nodes)
        for reason in self._explain_reasons_seen:
            self.metrics.unschedulable_node_counts.set(0, reason=reason)

    # -- degradation ladder ------------------------------------------------

    def _breaker(self, target: str) -> CircuitBreaker:
        """Lazily create the circuit breaker for a ladder tier or an
        extender endpoint, wired to the breaker-state gauge and the
        SchedulerDegraded / SchedulerRecovered events."""
        br = self._breakers.get(target)
        if br is None:
            from functools import partial

            rc = self.robustness
            br = CircuitBreaker(
                failure_threshold=rc.breaker_failure_threshold,
                open_duration_s=rc.breaker_open_duration_s,
                half_open_probes=rc.breaker_half_open_probes,
                clock=self.clock,
                on_transition=partial(self._on_breaker_transition, target))
            self._breakers[target] = br
            self.metrics.breaker_state.set(0, target=target)
        return br

    def _on_breaker_transition(self, target: str, old: str, new: str) -> None:
        from kubernetes_tpu_torch.events import (
            REASON_DEGRADED,
            REASON_RECOVERED,
            ObjectRef,
        )

        self.metrics.breaker_state.set(STATE_CODE[new], target=target)
        self.obs.note_breaker(target, old, new)
        ref = ObjectRef(name=self.scheduler_name, involved_kind="Scheduler")
        if new == OPEN:
            klog.warning("circuit breaker %s: %s -> open (degraded mode)",
                         target, old)
            self.event_sink(
                REASON_DEGRADED, ref,
                f"circuit breaker for {target} opened; "
                "routing around it (degraded mode)")
        elif new == CLOSED and old != CLOSED:
            klog.V(2).info("circuit breaker %s: %s -> closed", target, old)
            self.event_sink(
                REASON_RECOVERED, ref,
                f"circuit breaker for {target} closed; full service restored")

    def _run_tier(self, tier, batch, dp, dn, ds, dt, dv, sv, base_fr,
                  extra_mask, extra_score, skip_prio, no_ports, no_pod_aff,
                  no_spread):
        """One solve attempt on one ladder tier. Returns ``((assigned,
        usage, rounds), dp_used, dn_used)``: ``batch-cpu`` solves on CPU
        copies of the tables and hands back the tables it solved against,
        so the validator never mixes devices. Exceptions propagate to the
        ladder."""
        hook = (self.fault_injector.solver_hook
                if self.fault_injector is not None else None)
        if tier in ("greedy", "exact", "batch-single", "batch-cpu"):
            # the tiers that re-pin the cycle off the mesh take the whole
            # table and planes (gathered once per attempt on a mesh)
            dn, sv, extra_mask, extra_score = self._whole(
                dn, sv, extra_mask, extra_score)
            if base_fr is not None and tier == "exact":
                base_fr = base_fr._replace(mask=_whole_cols(base_fr.mask))
        if tier == "greedy":
            a, u = greedy_assign(
                dp, dn, ds, self.weights, topo=dt, extra_mask=extra_mask,
                vol=dv, static_vol=sv, enabled_mask=self.pred_mask,
                extra_score=extra_score, skip_priorities=skip_prio,
                no_ports=no_ports, no_pod_affinity=no_pod_aff,
                no_spread=no_spread, fault_hook=hook,
                fault_site="solve:greedy")
            return (a, u, len(batch)), dp, dn
        if tier == "exact":
            out = self._exact_solve(dp, dn, ds, dt, base_fr, extra_mask,
                                    extra_score)
            if hook is not None:
                out = hook("solve:exact", *out, dn.n)
            return out, dp, dn
        # the mesh rung ``batch-single`` is the identical batch solve
        # re-pinned off the mesh onto its first device, on the table
        # gathered there above (on a mesh of one card the tables already
        # live there, unsharded); a KernelError still escapes it
        if tier == "batch-cpu":
            # the host fallback: every table copied to CPU tensors (one
            # counted transfer) and the identical solve re-run on the
            # plain PyTorch path, as the reference re-pins to its host
            # backend
            (dp, dn, ds, dt, dv, sv, extra_mask, extra_score) = to_cpu(
                (dp, dn, ds, dt, dv, sv, extra_mask, extra_score))
        # the Sinkhorn stats ride the solve as a (2,) device pair and the
        # tier's one readback brings them back (_validated_readback); the
        # re-pinning tiers, as the reference's, solve without them
        repinned = tier in ("batch-single", "batch-cpu")
        sdp, sdn, sds, sdt, sdv = dp, dn, ds, dt, dv
        if not repinned:
            # the configured tier on a live mesh: the partitioned solve
            # over the placed table, the replicated tables on every shard
            # (a mesh of one places nothing)
            sdn = self._solve_nodes(dn)
            if sdn is not dn:
                sdp, sdn, sds = pmesh.shard_cluster(dp, sdn, ds, self.mesh)
                sdt = pmesh.replicate(dt, self.mesh)
                sdv = pmesh.replicate(dv, self.mesh)
        out = batch_assign(
            sdp, sdn, sds, self.weights, max_rounds=self.max_rounds,
            per_node_cap=self.per_node_cap, topo=sdt, extra_mask=extra_mask,
            vol=sdv, static_vol=sv, enabled_mask=self.pred_mask,
            extra_score=extra_score, use_sinkhorn=(tier == "sinkhorn"),
            skip_priorities=skip_prio, no_ports=no_ports,
            no_pod_affinity=no_pod_aff, no_spread=no_spread,
            fault_hook=hook, fault_site=f"solve:{tier}",
            stats_out=(self.observability.sinkhorn_telemetry
                       and not repinned))
        return out, dp, dn

    def _validated_readback(self, tier, out, dp, dn):
        """Validate one tier's result and read the assignment back
        together with the verdict as ONE device-to-host copy, the round
        count riding it. The verdict is computed on the device
        (``device_validate``); the host checker (``validate_solution``)
        takes over when the result cannot reach the device (shape) or
        ``robustness.host_validate`` asks for it. A tier that returned
        its Sinkhorn stats (a fourth element) has them ride the same copy,
        bit-cast to int32, and noted for the cycle's record. Returns
        ``(assigned_host, usage, rounds)`` or raises SolverResultInvalid
        with the host checker's reason vocabulary."""
        rc = self.robustness
        a_dev, u_dev, rounds = out[:3]
        stats = out[3] if len(out) > 3 else None
        verdict = None
        if rc.validate_results:
            with self.obs.span("validate"):
                verdict = (None if rc.host_validate else device_validate(
                    a_dev, u_dev, dp, dn, self.pred_mask))
                if verdict is None:
                    ok, why = validate_solution(a_dev, u_dev, dp, dn,
                                                self.pred_mask)
                    if not ok:
                        self.metrics.solver_rejections.inc(tier=tier,
                                                           reason=why)
                        raise SolverResultInvalid(f"{tier}: {why}")
        # the payload, as the reference's: the assignment and the round
        # count, the device verdict and its valid count when the device
        # rendered it, the Sinkhorn stats when the tier returned them
        dev = a_dev.device
        parts = [a_dev[: dp.valid.shape[0]].to(torch.int32),
                 _rounds_tensor(rounds, dev)]
        if verdict is not None:
            parts.append(torch.stack([v.to(dev, torch.int32)
                                      for v in verdict]))
        if stats is not None:
            parts.append(_stats_bits(stats, dev))
        host = self.obs.jax.readback("solve-result", torch.cat(parts))
        if stats is not None:
            self.obs.note_sinkhorn(_stats_host(host[-2:]))
            host = host[:-2]
        code = 0
        if verdict is not None:
            code, host = host[-2], host[:-2]
        assigned, rounds = np.asarray(host[:-1], np.int64), host[-1]
        if code:
            why = VALIDATE_REASONS[code]
            self.metrics.solver_rejections.inc(tier=tier, reason=why)
            raise SolverResultInvalid(f"{tier}: {why}")
        return assigned, u_dev, rounds

    def _solve_ladder(self, solver, batch, dp, dn, ds, dt, dv, sv, base_fr,
                      extra_mask, extra_score, skip_prio, no_ports,
                      no_pod_aff, no_spread, res):
        """The degradation ladder: the configured tier, then each tier of
        ``robustness.fallback_chain`` (``batch-cpu``, then the greedy
        oracle; under a live mesh ``batch-single`` first), with a circuit
        breaker per tier, bounded in-cycle
        retries, a deadline that skips to the floor, and result
        validation, so a lying solver never binds an infeasible pod. A
        solver fault (``faults.SolverFault``: a timeout, a crash, a lost
        device, a rejected result) or a ``RuntimeError`` (a CUDA OOM is
        one) falls through. A hand kernel that fails to build or launch
        raises ``kernels.KernelError``, which is neither: it propagates
        through every tier, retry and breaker, so a broken kernel never
        hides behind the plain PyTorch tiers. Returns ``(assigned_host,
        usage, rounds, tier)`` or None when every tier failed."""
        rc = self.robustness
        tiers = [solver]
        if self._mesh_live and solver in ("batch", "sinkhorn", "greedy"):
            # the mesh rung: a failing sharded solve retries unsharded on
            # one device of the mesh before the ladder leaves the card
            # (sharded -> batch-single -> batch-cpu -> greedy)
            tiers.append("batch-single")
        for t in rc.fallback_chain:
            if t not in tiers:
                tiers.append(t)
        if "greedy" in tiers:
            # the sequential oracle is the trust floor: nothing below it
            tiers = tiers[: tiers.index("greedy") + 1]
        terminal = tiers[-1]
        m = self.metrics
        deadline = self._cycle_deadline
        deadline_counted = False
        i = 0
        while i < len(tiers):
            tier = tiers[i]
            if (deadline is not None and tier != terminal
                    and self.clock() >= deadline):
                # budget blown: no time for intermediate tiers — jump to
                # the floor so the cycle still makes progress
                if not deadline_counted:
                    m.deadline_exceeded.inc()
                    self.obs.note_deadline_exceeded()
                    deadline_counted = True
                m.solver_fallbacks.inc(from_tier=tier, to_tier=terminal)
                res.solver_fallbacks += 1
                res.tier_attempts.append(f"{tier}:shed")
                i = len(tiers) - 1
                continue
            br = self._breaker(f"solver:{tier}")
            if not br.allow() and i + 1 < len(tiers):
                # an open breaker sheds the tier without burning latency;
                # the terminal tier is always attempted
                m.solver_fallbacks.inc(from_tier=tier, to_tier=tiers[i + 1])
                res.solver_fallbacks += 1
                res.tier_attempts.append(f"{tier}:shed")
                i += 1
                continue
            attempts = 1 + max(0, rc.solver_retries)
            result = last_err = None
            for attempt in range(attempts):
                ts = self.clock()
                res.tier_attempts.append(tier)
                with self.obs.span(f"solve:{tier}", attempt=attempt):
                    try:
                        out, dp_t, dn_t = self._run_tier(
                            tier, batch, dp, dn, ds, dt, dv, sv, base_fr,
                            extra_mask, extra_score, skip_prio, no_ports,
                            no_pod_aff, no_spread)
                        result = self._validated_readback(tier, out, dp_t,
                                                          dn_t)
                    except (SolverFault, RuntimeError) as e:
                        last_err = e
                    finally:
                        m.solver_tier_duration.observe(self.clock() - ts,
                                                       tier=tier)
                if result is not None:
                    break
                if attempt + 1 < attempts and not (
                        deadline is not None and self.clock() >= deadline):
                    m.solver_retries.inc(tier=tier)
                    self.obs.note_retry()
                    continue
                break
            if result is not None:
                br.record_success()
                assigned, usage, rounds = result
                return assigned, self._placed_usage(usage, dn), \
                    int(rounds), tier
            br.record_failure()
            klog.warning("solver tier %s failed (%s); falling back", tier,
                         last_err)
            if i + 1 < len(tiers):
                m.solver_fallbacks.inc(from_tier=tier, to_tier=tiers[i + 1])
                res.solver_fallbacks += 1
            i += 1
        return None

    def _placed_usage(self, usage, dn):
        """A tier's usage placed as the cycle's tables are: a re-pinned
        tier's whole usage goes back into the mesh's row blocks, and
        ``batch-cpu``'s joins the cycle's device (the failure pass reads
        it beside the tables)."""
        if isinstance(dn, pmesh.ShardedNodes):
            if pmesh.is_placed(usage):
                return usage
            return pmesh.shard_usage(usage, dn.mesh)
        dev = dn.requested.device
        if usage.requested.device != dev:
            usage = type(usage)(*(t.to(dev) for t in usage))
        return usage

    # graftlint: disable-scope=R2,R7,R8 -- host oracle by design: the exact
    # tier runs the Hungarian solver on CPU, so the one filter+score result
    # is read back wholesale here (a deliberate full gather when the mesh is
    # on); the ladder only enters this tier when quality beats wall-clock
    # (gang/offline packing)
    def _exact_solve(self, dp, dn, ds, dt, base_fr, extra_mask, extra_score):
        """Exact one-shot assignment: filter and score once on the
        device, read both back, then the Hungarian solver on the host
        with per-node slot capacities (``native.exact_assign``).
        Maximizes the batch's total score instead of running auction
        rounds — for gang / offline packing where quality beats
        wall-clock. Multi-resource feasibility beyond slot counts is
        validated sequentially in queue order, and rejected pods re-solve
        against the updated usage until a fixpoint. In-batch coupling of
        ports / volumes / topology is not modeled (the cycle routes such
        batches to ``batch``)."""
        mask_t = base_fr.mask
        if extra_mask is not None:
            mask_t = mask_t & extra_mask
        score_t = run_priorities(dp, dn, ds, mask_t, self.weights, dt)
        if extra_score is not None:
            score_t = score_t + extra_score
        host = to_cpu((mask_t, score_t, dn.allocatable, dn.valid,
                       dn.requested, dp.valid, dp.req, dp.order,
                       dp.priority))
        mask, score, alloc, node_valid, requested, valid, preq, porder, \
            prio = (x.numpy() for x in host)
        order = np.lexsort((porder, -prio))
        # a Policy bypassing PodFitsResources also bypasses the resource
        # gating here (the batch solver's admission-guard bypass)
        res_on = self.pred_mask is None or bool(
            self.pred_mask & (1 << BIT["PodFitsResources"]))
        P = mask.shape[0]
        assigned_final = np.full((P,), -1, np.int32)
        used = requested.copy()
        active = valid.copy()
        rounds = 0
        for _ in range(16):
            if not active.any():
                break
            rounds += 1
            fit = np.all(
                used[None, :, :] + preq[:, None, :]
                <= alloc[None, :, :] + 1e-6,
                axis=2) if res_on else np.ones((P, alloc.shape[0]), bool)
            # slot capacity: the pod-count column is exact; the other
            # resource columns bound the count via the smallest active
            # request (an upper bound, validated below)
            free = np.maximum(alloc - used, 0.0)
            min_req = np.where(active[:, None], preq, np.inf).min(axis=0)
            with np.errstate(divide="ignore", invalid="ignore",
                             over="ignore"):
                per_res = np.where(
                    min_req > 0,
                    np.floor(free / np.maximum(min_req, 1e-30)), np.inf)
            cap = np.where(node_valid, np.nanmin(per_res, axis=1), 0)
            cap = np.where(np.isfinite(cap), cap,
                           free[:, RES_PODS]).astype(np.int64)
            if not res_on:
                cap = np.where(node_valid, P, 0).astype(np.int64)
            m = mask & fit & active[:, None]
            a = native.exact_assign(score, m, cap)
            progress = False
            for p in order:
                if not active[p] or a[p] < 0:
                    continue
                t = a[p]
                if not res_on or np.all(used[t] + preq[p] <= alloc[t] + 1e-6):
                    used[t] += preq[p]
                    assigned_final[p] = t
                    active[p] = False
                    progress = True
            if not progress:
                break
        dev = dp.req.device
        a_t = upload(assigned_final, dev, np.int64)
        usage = _apply_batch(usage_from_nodes(dn), dp, a_t.clamp_min(0),
                             (a_t >= 0) & dp.valid)
        return a_t.to(torch.int32), usage, rounds

    # -- pipelined cycle executor ------------------------------------------

    def _pipeline_eligible(self, batch, nominated) -> bool:
        """The pipelined executor covers the clean high-throughput path:
        features that need whole-batch host coupling (extenders, host or
        batch plugins, gang groups, nominated-pod pass A, node-search
        truncation) or a host-resident solver (exact) keep the monolithic
        cycle. Depth 1 is the explicit off switch."""
        if self.pipeline_depth < 2 or self.pipeline_chunk < 1:
            return False
        if len(batch) <= self.pipeline_chunk:
            return False
        if self.solver not in ("batch", "sinkhorn", "greedy"):
            return False
        if self.extenders or nominated:
            return False
        if self.percentage_of_nodes_to_score is not None:
            return False
        fw = self.framework
        if (fw.has_host_filters() or fw.has_host_scores()
                or fw.has_batch_filters() or fw.has_batch_scores()):
            return False
        if self.scenario_pack is not None and (
                not self.scenario_pack.restricted_ok
                or self.scenario.quality):
            # a restricted_ok pack's cost term is per column, so it
            # evaluates per chunk exactly and rides the pipeline; the
            # quality reduction wants the whole batch's final usage, so a
            # quality-on scenario cycle stays monolithic, as does a pack
            # whose cost needs the whole node axis
            return False
        # gangs stay monolithic: all-or-nothing groups straddling chunk
        # boundaries would need cross-chunk rollback
        return not any(p.pod_group for p in batch)

    def _pipelined_tail(self, batch, cycle, res, t0, syncs0, nt, dn, ds, dt,
                        node_order, skip_prio, no_ports, no_pod_aff,
                        no_spread) -> CycleResult:
        """Double-buffered pack -> solve -> readback -> bind pipeline over
        fixed sub-batches: while chunk k's solve runs on the device (its
        round loop is one enqueued graph, ``ops/device_loop.py``), the
        host packs chunk k+1 and binds chunk k-1. Chunking and the
        usage-chain data dependencies are identical at every depth >= 2
        (only host scheduling overlaps), so placements are depth-invariant
        by construction. Every chunk pads to ONE bucket, so the whole
        cycle reuses one cached round-loop graph.

        ``dispatch`` sheds a chunk straight to the ladder while the tier's
        breaker is open or the cycle deadline is blown. A chunk whose
        dispatch or readback fails records a breaker failure and re-solves
        through the full ladder (retries, ``batch-cpu``, the greedy
        oracle); a ``KernelError`` is not a solver fault and propagates."""
        pk = self.cache.packer
        C = self.pipeline_chunk
        chunks = [batch[i:i + C] for i in range(0, len(batch), C)]
        res.pipeline_chunks = len(chunks)
        self.metrics.pipeline_chunks.inc(len(chunks))
        chunk_pad = bucket_size(C)
        solver = self.solver
        dev = self.device
        res_names = list(FIXED_RESOURCE_NAMES) + pk.u.scalar_resources.items()
        dn_cur = dn
        solve_s = 0.0
        tier_last = solver
        failed_global: List[int] = []
        reasons_row: Dict[int, Tuple[str, ...]] = {}
        fit_msgs: Dict[int, str] = {}
        rmat_rows: Dict[int, list] = {}
        ex_parts: List[dict] = []
        # a restricted_ok scenario pack's per-column cost joins each
        # chunk's solve as extra_score (the _pipeline_eligible contract);
        # the statics' score flag flips with it, as the warmed signature's
        pack = self.scenario_pack
        statics = (solver, tuple(skip_prio), no_ports, no_pod_aff,
                   no_spread, self.pred_mask, self.per_node_cap,
                   self.max_rounds, True, pack is None, self._mesh_live)

        def pack_chunk(k):
            with self.obs.span(f"pipeline:pack@{k}", pods=len(chunks[k])):
                pt_c = pk.pack_pods(chunks[k])
                dp_c = pods_to_device(pt_c, pad_to=chunk_pad, device=dev)
                dv_c = sv_c = None
                if any(p.volumes for p in chunks[k]):
                    dv_c = volumes_to_device(
                        pk.pack_volume_tables(chunks[k]), device=dev)
                    sv_c = _static_vol_pass(dp_c, dn, ds, dv_c)
                # the pod tables are the steady cycle's largest upload
                self.obs.jax.record_upload(
                    "snapshot", dp_c, *([dv_c] if dv_c is not None else []))
                return pt_c, dp_c, dv_c, sv_c

        def dispatch(k, packed, dn_in):
            """Queue chunk k's solve on the device; None when the breaker
            or the deadline shed it or it failed to enqueue (the chunk
            then takes the ladder in settle)."""
            _pt_c, dp_c, dv_c, sv_c = packed
            if not self._breaker(f"solver:{solver}").allow():
                return None
            if (self._cycle_deadline is not None
                    and self.clock() >= self._cycle_deadline):
                return None
            sc = None
            if pack is not None:
                # the chunk's pack cost against the chunk's node view:
                # per column by the restricted_ok contract, so chunking
                # keeps the objective exactly
                with self.obs.span(f"scenario:cost@{k}"):
                    sc = pack.cost(chunks[k], nt, node_order, dp_c, dn_in)
            with self.obs.span(f"pipeline:dispatch@{k}", tier=solver):
                self.obs.jax.record_call("solve", dp_c, dn_in, ds, dt, dv_c,
                                         static=statics)
                try:
                    return self._run_tier(solver, chunks[k], dp_c, dn_in, ds,
                                          dt, dv_c, sv_c, None, None, sc,
                                          skip_prio, no_ports, no_pod_aff,
                                          no_spread)[0]
                except (SolverFault, RuntimeError) as e:
                    self._breaker(f"solver:{solver}").record_failure()
                    klog.warning("pipelined chunk %d dispatch failed (%s)",
                                 k, e)
                    return None

        def settle(k, packed, out, dn_in):
            """Read chunk k's result back -- validated on the device, the
            verdict and the round count riding the chunk's ONE readback
            -- and fall back to the full ladder on a failure. Returns
            (assigned host array or None, usage, tier)."""
            nonlocal solve_s
            chunk = chunks[k]
            _pt_c, dp_c, dv_c, sv_c = packed
            br = self._breaker(f"solver:{solver}")
            ts = self.clock()
            if out is not None:
                try:
                    with self.obs.span(f"pipeline:readback@{k}"):
                        a, u_dev, rounds = self._validated_readback(
                            solver, out, dp_c, dn_in)
                    br.record_success()
                    res.tier_attempts.append(solver)
                    res.rounds += rounds
                    solve_s += self.clock() - ts
                    return a[: len(chunk)].copy(), u_dev, solver
                except (SolverFault, RuntimeError) as e:
                    br.record_failure()
                    klog.warning("pipelined chunk %d solve failed (%s); "
                                 "ladder", k, e)
            # shed (open breaker / blown deadline) or failed: this chunk
            # re-solves through the full ladder, the pack's cost rebuilt so
            # the objective survives the fallback tiers
            sc = (pack.cost(chunk, nt, node_order, dp_c, dn_in)
                  if pack is not None else None)
            ladder = self._solve_ladder(solver, chunk, dp_c, dn_in, ds, dt,
                                        dv_c, sv_c, None, None, sc,
                                        skip_prio, no_ports, no_pod_aff,
                                        no_spread, res)
            solve_s += self.clock() - ts
            if ladder is None:
                for pod in chunk:
                    self._fail(pod, cycle, res, ("SolverUnavailable",))
                return None, None, ""
            a_host, u_dev, rounds, tier = ladder
            res.rounds += rounds
            return a_host[: len(chunk)].copy(), u_dev, tier

        def chunk_failures(k, offset, a, packed):
            """Failure reasons and explain rows for chunk k's unplaced
            pods, against the post-chunk usage (what the serial loop would
            have seen last), reduced on the device and read back small;
            the per-node reason rows are read for the failed pods only."""
            failed_idx = [i for i, t in enumerate(a) if t < 0]
            if not failed_idx:
                return
            pt_c, dp_c, dv_c, sv_c = packed
            tx = time.perf_counter()
            fr = _filter_pass(dp_c, dn_cur, ds, dt, dv_c, sv_c,
                              self.pred_mask)
            rows = upload(failed_idx, dev, np.int64)
            ex = explain_rows(fr.reasons, dn_cur, dp_c.req, rows)
            ex_h = read_back(ex, self._reader("explain"))
            ex_parts.append(ex_h)
            rmat = None
            if self.enable_preemption:
                rows_dev = reason_rows(fr.reasons, rows)[:, : nt.n]
                res.preempt_rows_bytes += (rows_dev.numel()
                                           * rows_dev.element_size())
                rmat = self.obs.jax.readback("preempt-reasons", rows_dev)
            for j, i in enumerate(failed_idx):
                g = offset + i
                bits = int(ex_h["pod_bits"][j])
                reasons_row[g] = decode_reasons(bits)
                if rmat is not None:
                    rmat_rows[g] = rmat[j]
                failed_global.append(g)
                if bits:
                    fit_msgs[g] = fit_error_message_from_counts(
                        ex_h["per_pod"][j], ex_h["insufficient"][j],
                        ex_h["not_ready"][j], ex_h["net_unavail"][j],
                        nt.n, pt_c.req[i], res_names[: pt_c.req.shape[1]])
            res.explain_s += time.perf_counter() - tx

        def bind_chunk(k, offset, a):
            with self.obs.span(f"pipeline:bind@{k}"):
                for i, pod in enumerate(chunks[k]):
                    t = int(a[i])
                    if t < 0:
                        g = offset + i
                        self._fail(pod, cycle, res, reasons_row.get(g, ()),
                                   message=fit_msgs.get(g))
                    else:
                        self._admit_pod(pod, node_order[t], cycle, res)

        # ---- the pipeline proper ----
        offset = 0
        packed = pack_chunk(0)
        pend = (packed, dispatch(0, packed, dn_cur), dn_cur)
        for k in range(len(chunks)):
            # pack chunk k+1 NOW: the host packs while chunk k's solve
            # runs on the device (the overlap the executor exists for)
            nxt = pack_chunk(k + 1) if k + 1 < len(chunks) else None
            packed_k, out_k, dn_in = pend
            a, u_dev, tier = settle(k, packed_k, out_k, dn_in)
            if tier:
                tier_last = tier
            if u_dev is not None:
                dn_cur = nodes_with_usage(dn_in, u_dev)
            if a is not None:
                # the failure passes ride the device queue BEFORE chunk
                # k+1's solve so their readback never waits behind it
                chunk_failures(k, offset, a, packed_k)
            if nxt is not None:
                pend = (nxt, dispatch(k + 1, nxt, dn_cur), dn_cur)
            if a is not None:
                # bind on the host while chunk k+1 solves on the device
                bind_chunk(k, offset, a)
            offset += len(chunks[k])
        res.solver_tier = tier_last
        res.solve_s = solve_s
        self.obs.step(f"pipeline done ({len(chunks)} chunks, {res.rounds} "
                      f"rounds)")

        if self.explain:
            tx = time.perf_counter()
            ex_host = None
            if ex_parts:
                # the chunks' rows in batch order (chunks and their failed
                # rows both ascend), the cluster roll-up summed
                ex_host = {f: np.concatenate([part[f] for part in ex_parts])
                           for f in ("per_pod", "one_bit", "feasible")}
                for f in ("pair_hist", "pods_blocked"):
                    ex_host[f] = np.sum([part[f] for part in ex_parts], 0)
            self._build_explain_report(
                cycle, [batch[g].key() for g in failed_global], ex_host,
                nt.n, res)
            res.explain_s += time.perf_counter() - tx

        preempt_idx = [g for g in failed_global if g in rmat_rows]
        if self.enable_preemption and preempt_idx:
            tp = time.perf_counter()
            pt0 = self.clock()
            with self.obs.span("preemption"):
                self._run_preemption(batch, preempt_idx,
                                     [rmat_rows[g] for g in preempt_idx],
                                     node_order, res)
            self.metrics.preemption_duration.observe(self.clock() - pt0)
            res.preempt_s = time.perf_counter() - tp
            self.obs.step(f"preemption ({res.preempted} victims)")
        return self._finish(res, t0, syncs0, cycle)

    # -- the sparsity-first routes (restricted, partitioned) ----------------

    def _score_cache_flags(self) -> Dict[str, bool]:
        """The score summary's semantics for this scheduler: candidate
        eligibility honors the node-condition predicates only when the
        Policy enforces them, and the ranking prefers packed columns under
        a packing objective."""
        cond_names = ("CheckNodeCondition", "CheckNodeUnschedulable",
                      "CheckNodeMemoryPressure", "CheckNodeDiskPressure",
                      "CheckNodePIDPressure")
        honor = self.pred_mask is None or all(
            self.pred_mask & (1 << BIT[n]) for n in cond_names)
        w = self.weights if self.weights is not None else DEFAULT_WEIGHTS
        packed = (w.get("MostRequestedPriority", 0)
                  > w.get("LeastRequestedPriority", 0))
        return {"honor_conditions": honor, "prefer_packed": packed}

    def _drop_incremental(self, reason: str) -> None:
        """One invalidation edge for all warm-solve state: the summary
        drops (rebuilt lazily from the resident table) and the Sinkhorn
        carry dies. Reasons: full-snapshot (node-set change, pack-epoch
        or interner growth, explicit invalidation), dirty-frac,
        restricted-error. Counted on
        ``scheduler_incremental_invalidations_total{reason}`` only when
        warm state existed to drop, as the reference counts it."""
        klog.V(4).info("incremental state dropped: %s", reason)
        live = self.cache.has_score_summary()
        had = self._incr_active or self._sk_warm_pot is not None or live
        self._sk_warm_pot = None
        self._incr_active = False
        # the scheduler's own residents (the warm carry, the last pod
        # batch, the candidate frame): gone on a device loss, re-registered
        # by the next cycle otherwise
        self.obs.memledger.deregister_prefix("scheduler.")
        if live:
            self.cache.drop_score_summary()
        if had and self.incremental.enabled:
            self.metrics.incremental_invalidations.inc(reason=reason)

    def _note_tuner_batch(self, raw: int) -> None:
        """Feed one raw micro-batch size into the tuner's window (the last
        64 cycles)."""
        self._tuner_batch_obs.append(raw)
        if len(self._tuner_batch_obs) > 64:
            del self._tuner_batch_obs[:-64]

    def _candidate_bucket(self, n_pad: int) -> int:
        """The candidate-column bucket C: the configured value snapped up
        to a power of two. With ``auto_tune`` and a warmed ladder, the
        smallest warmed C that admits the recent micro-batches under
        ``max_batch_frac`` and leaves 2x headroom over the deepest frame
        position placed into; without a warmed ladder it stays pinned."""
        inc = self.incremental
        c0 = bucket_size(max(inc.candidate_bucket, 1))
        if not inc.auto_tune or not self._warmed_cbuckets:
            return c0
        need = max(max(self._tuner_batch_obs, default=1)
                   / max(inc.max_batch_frac, 1e-6),
                   2 * self._tuner_depth_max, 1)
        ladder = sorted(self._warmed_cbuckets)
        for c in ladder:
            if c >= need:
                return c
        return ladder[-1]

    def _frame_gates_hold(self, batch, nominated, dn, dt, dv, no_ports,
                          no_pod_aff, no_spread) -> bool:
        """The facts that make a candidate frame complete, shared by both
        routes: a batch solver tier, no extender, no nominated pods, no
        node-search truncation, no framework plugin term, and no
        constraint class that couples across the whole node axis (ports
        and volumes; topology unless the batch gates prove it vacuous)."""
        if self.solver not in ("batch", "sinkhorn") or dn is None:
            return False
        if self.extenders or nominated:
            return False
        if self.percentage_of_nodes_to_score is not None:
            return False
        fw = self.framework
        if (fw.has_host_filters() or fw.has_host_scores()
                or fw.has_batch_filters() or fw.has_batch_scores()):
            return False
        if dv is not None or not no_ports:
            return False
        return dt is None or (no_pod_aff and no_spread)

    def _incremental_eligible(self, batch, nominated, dn, dt, dv, snap_mode,
                              no_ports, no_pod_aff, no_spread, nt) -> bool:
        """May this cycle take the restricted route? A clean or delta
        resident snapshot (a full one drops the warm state), the frame
        gates, a micro-batch small enough for the candidate bucket, a
        padded cluster wider than the bucket, and a dirty frontier under
        ``max_dirty_frac`` (a blowout drops the warm state)."""
        inc = self.incremental
        if not inc.enabled or self.solver not in ("batch", "sinkhorn"):
            return False
        if snap_mode == "full":
            self._drop_incremental("full-snapshot")
            return False
        if snap_mode not in ("clean", "delta"):
            return False
        if not self._frame_gates_hold(batch, nominated, dn, dt, dv,
                                      no_ports, no_pod_aff, no_spread):
            return False
        if (self.scenario_pack is not None
                and not self.scenario_pack.restricted_ok):
            # a pack whose cost needs the whole node axis keeps the dense
            # oracle; a restricted_ok pack's cost is per column and joins
            # the frame (its candidate hint reserves quota columns)
            return False
        # the tuner sees the raw batch size before the bucket compare
        self._note_tuner_batch(len(batch))
        n_pad = dn.n
        C = self._candidate_bucket(n_pad)
        if C >= n_pad or len(batch) > inc.max_batch_frac * C:
            return False
        if len(self.cache.last_patched_idx) > inc.max_dirty_frac * max(
                nt.n, 1):
            self._drop_incremental("dirty-frac")
            return False
        return True

    def _solve_frame(self, dp_f, sub_dn, ds, cand, skip_prio, sk_init=None,
                     warm=False, site="solve:restricted",
                     readback_site="solve-result", extra_score=None):
        """One (P, C) frame: solve it with the stock solver (and the
        scenario pack's cost on the frame, ``extra_score``), validate on
        the device, map the candidate-local rows to global node rows and
        read back the mapped rows, the verdict, the deepest frame position,
        the round count and (sinkhorn solver) the Sinkhorn stats as ONE
        transfer at ``readback_site``. Returns ``(assigned (P_pad,) host,
        rounds, depth, potentials or None, (local rows, local usage))``,
        the last two on the device; raises SolverResultInvalid on a failed
        verdict."""
        inc = self.incremental
        want_stats = bool(self.observability.sinkhorn_telemetry
                          and self.solver == "sinkhorn")
        self.obs.jax.record_call(
            "solve", dp_f, sub_dn, ds,
            static=("restricted", self.solver, tuple(skip_prio),
                    self.pred_mask, self.per_node_cap, self.max_rounds,
                    sk_init is None, extra_score is None, self._mesh_live))
        out = batch_assign(
            dp_f, sub_dn, ds, self.weights, max_rounds=self.max_rounds,
            per_node_cap=self.per_node_cap, enabled_mask=self.pred_mask,
            extra_score=extra_score,
            use_sinkhorn=(self.solver == "sinkhorn"),
            skip_priorities=skip_prio, no_ports=True, no_pod_affinity=True,
            no_spread=True, sk_init=sk_init,
            sk_tol=(inc.warm_tol if warm else None), potentials_out=warm,
            stats_out=want_stats,
            fault_hook=(self.fault_injector.solver_hook
                        if self.fault_injector is not None else None),
            fault_site=site)
        a_local, u_local, rounds = out[:3]
        verdict = device_validate(a_local, u_local, dp_f, sub_dn,
                                  self.pred_mask)
        if verdict is None:
            raise SolverResultInvalid("frame: shape")
        code, _count = verdict
        a_local = a_local[: dp_f.valid.shape[0]].to(torch.int32)
        depth = torch.where(dp_f.valid & (a_local >= 0), a_local, -1).amax()
        parts = [map_restricted_assignment(a_local, cand),
                 torch.stack([code.to(torch.int32), depth.to(torch.int32)]),
                 _rounds_tensor(rounds, code.device)]
        if want_stats:
            parts.append(_stats_bits(out[3], code.device))
        host = self.obs.jax.readback(readback_site, torch.cat(parts))
        if want_stats:
            self.obs.note_sinkhorn(_stats_host(host[-2:]))
            host = host[:-2]
        code, depth, rounds = host[-3:]
        if code:
            raise SolverResultInvalid(f"frame: {VALIDATE_REASONS[code]}")
        return (np.asarray(host[:-3], np.int64), rounds, depth,
                out[-1] if warm else None, (a_local, u_local))

    def _restricted_tail(self, batch, cycle, res, t0, syncs0, nt, dn, ds,
                         dp, node_order, skip_prio):
        """The restricted cycle: pick the top-C candidate columns of the
        resident score summary (dirty columns guaranteed a slot), gather
        them into a (C, .) view, solve the batch there, and bind only when
        every pod placed. An under-placed batch (a pod may fit on a column
        outside the frame) or a failed solve returns None and the dense
        ladder re-solves the cycle; a kernel fault (``KernelError``) is
        not a solve failure and propagates."""
        inc = self.incremental
        # a gang that cannot meet its quorum will be rolled back whoever
        # solves it: leave it to the dense ladder's analytics
        gang_need: Dict[str, List[int]] = {}
        for gp in batch:
            if gp.pod_group:
                g = gang_need.setdefault(gp.pod_group, [0, 0])
                g[0] += 1
                g[1] = max(g[1], gp.pod_group_min_available)
        for gname, (cnt, need) in gang_need.items():
            if cnt + self.cache.group_members(gname) < need:
                self.metrics.incremental_cycles.inc(scope="declined")
                return None
        summary = self.cache.score_summary()
        if summary is None:
            return None
        n_pad = dn.n
        C = self._candidate_bucket(n_pad)
        idxs = list(self.cache.last_patched_idx)
        dirty = self._node_mask(n_pad, rows=idxs)
        # a lazy rebuild recomputed the whole summary: no reuse this cycle
        reuse = (0.0 if self.cache.last_summary_rebuilt
                 else max(0.0, 1.0 - len(idxs) / max(nt.n, 1)))
        warm = bool(inc.warm_potentials and self.solver == "sinkhorn")
        pot_key = (dp.valid.shape[0], C, self.cache.summary_generation)
        sk_init = None
        if warm and self._sk_warm_pot is not None \
                and self._sk_warm_pot[0] == pot_key:
            sk_init = self._sk_warm_pot[1]
        # the pack's candidate columns (a gang's home slice) get a reserved
        # split of the frame, capped at groupQuotaFrac so a hinted zone
        # never crowds the plainly ranked candidates out
        hint = hq = None
        if self.scenario_pack is not None:
            hm = self.scenario_pack.candidate_hint(batch, nt, node_order)
            if hm is not None:
                h = np.zeros((n_pad,), bool)
                h[: hm.shape[0]] = hm
                hint = self._node_mask(n_pad, host=h)
                hq = max(int(inc.group_quota_frac * C), 1)
        # the candidate pick is a site of its own, as in the reference;
        # under a live mesh it is the per-shard local top-C over the
        # node-sharded summary and a merge of the (S, C) winners,
        # bit-identical to the reference's sharded pick
        ns = self._num_shards()
        self.obs.jax.record_call("incremental", summary.rank,
                                 static=(C, n_pad, self._mesh_live, ns,
                                         hint is None, hq))
        ts = self.clock()
        try:
            with self.obs.span("solve:restricted"):
                cand, sub_dn = gather_candidates(summary, dirty, dn, C,
                                                 hint_mask=hint,
                                                 num_shards=ns,
                                                 hint_quota=hq or 0)
                # the restricted_ok pack's cost on the gathered frame: the
                # term is per column, so it equals the dense term
                # restricted to the candidate columns
                extra_score = None
                if self.scenario_pack is not None:
                    with self.obs.span("scenario:cost"):
                        extra_score = self.scenario_pack.cost(
                            batch, nt, node_order, dp, sub_dn)
                assigned, rounds, depth, pot, frame = self._solve_frame(
                    dp, sub_dn, ds, cand, skip_prio, sk_init=sk_init,
                    warm=warm, extra_score=extra_score)
        except (SolverFault, RuntimeError) as e:
            klog.warning("restricted solve declined (%s); dense solve", e)
            self._drop_incremental("restricted-error")
            self.metrics.incremental_cycles.inc(scope="declined")
            return None
        self._tuner_depth_max = max(self._tuner_depth_max, depth + 1)
        placed = assigned[: len(batch)]
        if (placed < 0).any():
            # under-placed: the dense ladder decides
            self.metrics.incremental_cycles.inc(scope="under-placed")
            return None
        # the cycle's candidate-frame residents: the gathered (C, .)
        # sub-table and its (C,) index map (the frame's temporaries are in
        # the warmup's measured bucket peak)
        ml = self.obs.memledger
        ml.register_tree("scheduler.candidate_frame", sub_dn, cand,
                         shape=f"C{C}of{n_pad}")
        if warm and pot is not None:
            self._sk_warm_pot = (pot_key, pot)
            ml.register_tree("scheduler.sk_warm_potentials", pot,
                             shape=f"P{pot_key[0]}xC{pot_key[1]}")
        self._incr_active = True
        # scenario quality on the restricted route: reduced over the
        # candidate frame (every placement lands inside it, so the counts
        # and gang scores are exact; the capacity-shaped scores are
        # frame-local), dispatched before the bind and read after it
        q_dev = None
        if self.scenario_pack is not None and self.scenario.quality:
            a_local, u_local = frame
            q_dev = quality_reduce(a_local, u_local.requested, dp, sub_dn)
        res.rounds = rounds
        res.solver_tier = self.solver
        res.solve_scope = "restricted"
        res.reuse_frac = round(reuse, 4)
        res.solve_s = self.clock() - ts
        self.obs.step(f"restricted solve done ({res.rounds} rounds, C={C}, "
                      f"reuse={reuse:.3f})")
        with self.obs.span("bind"):
            for i, pod in enumerate(batch):
                self._admit_pod(pod, node_order[int(placed[i])], cycle, res)
        self.obs.step(f"bound {res.scheduled}, failed {res.unschedulable}")
        if q_dev is not None:
            qvec = self.obs.jax.readback("scenario-quality", q_dev)
            self._take_scenario_quality(res, qvec, batch, placed, nt)
        if self.explain:
            # nothing failed the filter pass (everything placed), but the
            # admission tail's failures still get report rows
            self._build_explain_report(cycle, [], None, nt.n, res)
        return self._finish(res, t0, syncs0, cycle)

    def _cold_blocks(self, n_pad: int, C: int) -> int:
        """Blocks of the partitioned cold solve: ``cold_blocks``, or (0 =
        auto) the padded node bucket over C capped at 8; always clamped so
        that B * C fits the table."""
        b = self.incremental.cold_blocks or min(8, n_pad // max(C, 1))
        return max(min(b, n_pad // max(C, 1)), 0)

    def _partitioned_cold_eligible(self, batch, nominated, dn, dt, dv,
                                   no_ports, no_pod_aff, no_spread) -> bool:
        """May this cycle take the partitioned cold solve? ``primary`` on,
        the frame gates, no scenario pack and no gang (the pack's quality
        and the gang rollback want the dense plane), and at least two
        blocks of C columns in the padded table."""
        inc = self.incremental
        if not (inc.enabled and inc.primary) or not batch:
            return False
        if not self._frame_gates_hold(batch, nominated, dn, dt, dv,
                                      no_ports, no_pod_aff, no_spread):
            return False
        if self.scenario_pack is not None:
            # a pack's cold solve keeps the dense oracle (its quality and
            # the gang rollback want the full plane when solving cold)
            return False
        if any(p.pod_group for p in batch):
            return False
        n_pad = dn.n
        C = self._candidate_bucket(n_pad)
        return C < n_pad and self._cold_blocks(n_pad, C) >= 2

    def _partitioned_cold_tail(self, batch, cycle, res, t0, syncs0, nt, dn,
                               ds, dp, node_order, skip_prio):
        """The partitioned cold solve: rank every column once, deal the top
        B*C round-robin into B column-disjoint blocks of width C, and solve
        them in turn, each block's pod validity masking out the pods
        placed before it. The unplaced remainder takes one more frame: a
        fresh top-C of the usage-overlaid table. Binds only when the whole
        batch placed; otherwise (or on a failed solve) returns None for the
        dense ladder. A ``KernelError`` propagates."""
        inc = self.incremental
        dev = self.device
        n_pad = dn.n
        P_pad = dp.valid.shape[0]
        C = self._candidate_bucket(n_pad)
        B = self._cold_blocks(n_pad, C)
        summary = self.cache.score_summary()
        if summary is None:
            summary = node_summary(dn, **self._summary_flags)
        warm = bool(inc.warm_potentials and self.solver == "sinkhorn")
        pending = np.zeros((P_pad,), bool)
        pending[: len(batch)] = True
        assigned = np.full((len(batch),), -1, np.int64)
        zeros_dirty = self._node_mask(n_pad)
        rounds = 0

        def take(got):
            for i in range(len(batch)):
                if pending[i] and got[i] >= 0:
                    assigned[i] = got[i]
                    pending[i] = False

        def pending_pods():
            return dp._replace(valid=dp.valid & upload(pending, dev))

        ns = self._num_shards()
        self.obs.jax.record_call("partition", summary.rank,
                                 static=(B, C, n_pad, ns, self._mesh_live))
        ts = self.clock()
        solve_span = self.obs.current_trace.begin_span("solve:partitioned",
                                                        blocks=B)
        try:
            blocks = partition_columns(summary, zeros_dirty, B, C, ns)
            for b in range(B):
                if not pending[: len(batch)].any():
                    break
                got, r, _depth, _pot, _frame = self._solve_frame(
                    pending_pods(), gather_node_rows(dn, blocks[b]), ds,
                    blocks[b], skip_prio, warm=warm,
                    site="solve:partitioned", readback_site="cold-block")
                rounds += r
                take(got)
            if pending[: len(batch)].any():
                # the remainder: one fresh top-C frame over the table with
                # every block placement debited (blocks were disjoint, so
                # this is where cross-block usage first meets)
                acc = np.full((P_pad,), -1, np.int64)
                acc[: len(batch)] = assigned
                acc_t = upload(acc, dev)
                u = _apply_batch(usage_from_nodes(dn), dp,
                                 acc_t.clamp_min(0),
                                 (acc_t >= 0) & dp.valid)
                dn_u = nodes_with_usage(dn, u)
                sum_u = node_summary(dn_u, **self._summary_flags)
                self.obs.jax.record_call(
                    "incremental", sum_u.rank,
                    static=(C, n_pad, self._mesh_live, ns, True, None))
                cand, sub_dn = gather_candidates(sum_u, zeros_dirty, dn_u, C,
                                                 num_shards=ns)
                got, r, _depth, _pot, _frame = self._solve_frame(
                    pending_pods(), sub_dn, ds, cand, skip_prio, warm=warm,
                    site="solve:partitioned", readback_site="cold-block")
                rounds += r
                take(got)
        except (SolverFault, RuntimeError) as e:
            klog.warning("partitioned cold solve declined (%s); dense "
                         "solve", e)
            self.metrics.incremental_cycles.inc(scope="declined")
            return None
        finally:
            self.obs.current_trace.end_span(solve_span)
        if pending[: len(batch)].any():
            # under-placed: the dense ladder decides
            self.metrics.incremental_cycles.inc(scope="under-placed")
            return None
        res.rounds = rounds
        res.solver_tier = self.solver
        res.solve_scope = "partitioned"
        res.cold_blocks = B
        res.reuse_frac = 0.0
        res.solve_s = self.clock() - ts
        self.obs.step(f"partitioned cold solve done ({res.rounds} rounds, "
                      f"B={B}, C={C})")
        with self.obs.span("bind"):
            for i, pod in enumerate(batch):
                self._admit_pod(pod, node_order[int(assigned[i])], cycle,
                                res)
        self.obs.step(f"bound {res.scheduled}, failed {res.unschedulable}")
        if self.explain:
            self._build_explain_report(cycle, [], None, nt.n, res)
        return self._finish(res, t0, syncs0, cycle)

    # -- warmup --------------------------------------------------------------

    def warmup(self, sample_pods=(), node_count: Optional[int] = None) -> int:
        """Warm every bucketed pod-batch shape a cycle can present, so the
        first pod never waits for the card's first-use work: build the
        hand kernels, capture the round loop's CUDA graph for every key a
        real cycle will present (pod bucket, node bucket, the batch's
        statics and each route the auto-router can choose in round 0),
        run the filter pass, the nominated-pods variant and, with
        ``incremental`` on, the restricted route's candidate ladder (the
        reference's AOT compile warmup, ``warmup.*`` knobs). The warmed
        graphs stay cached outside the device loop's LRU bound
        (``device_loop.pinning``), so a warmed shape never captures
        again: ``CycleResult.graph_captures`` (and the
        ``scheduler_round_loop_captures_total{phase="cycle"}`` counter)
        stays 0 on it.

        ``sample_pods`` (recommended) seeds the universes and the
        host-side solver gates exactly as real cycles will. The node axis
        is the cache's current cluster, or ``node_count`` before any node
        has synced. Returns the number of bucketed shapes warmed (the
        reference's count)."""
        wu = self.warmup_config
        pk = self.cache.packer
        dev = self.device
        sample = list(sample_pods)
        for p in sample:
            pk.intern_pod(p)
        self._mesh_live = self.mesh is not None
        if self.cache.nodes():
            if self.device_resident_snapshot:
                nt, dn, _mode = self._device_snapshot_recovering()
                if dn is None:
                    # cooling off after a device loss: warm what the
                    # host-mode cycles present, single-device
                    self._mesh_live = False
            else:
                nt, dn = self.cache.snapshot(), None
            if dn is None:
                # host mode (cooling off, or not resident): warm on the
                # host table at the padded shape a host-mode cycle
                # uploads (placed on the mesh when the cycles place it)
                dn = (self._place_host(nt)
                      if self._mesh_live else nodes_to_device(nt, device=dev))
            dn = self._solve_nodes(dn)
        elif node_count:
            # no cluster yet: a widths-complete zero-row table padded to
            # the caller's expected node bucket (and at least the mesh
            # size, as the mesh cycles pad it)
            nt = pk.pack_nodes([])
            pad = bucket_size(max(node_count, 1))
            dn = (self._place_host(nt, pad_to=pad)
                  if self._mesh_live
                  else nodes_to_device(nt, pad_to=pad, device=dev))
        else:
            # warming now would capture shapes with an empty-cluster node
            # bucket no real cycle can match
            klog.warning("warmup skipped: no nodes synced and no "
                         "node_count given — call again after the first "
                         "node sync")
            return 0
        captures0 = device_loop.CAPTURES.count
        if dev.type == "cuda":
            kernels.build()
        ds = selectors_to_device(pk.pack_selector_tables(), device=dev)
        dt = (topology_to_device(pk.pack_topology_tables(), device=dev)
              if _has_topo(pk.u) else None)
        pt_all = pk.pack_pods(sample)
        gates = solver_gates(nt, pt_all)
        solver = self.solver if self.solver != "exact" else "batch"
        buckets = tuple(wu.pod_buckets)
        if not buckets:
            # geometric x2 steps up to bucket_size(max_batch), the largest
            # shape any cycle can present (pipelined chunks pad to
            # bucket_size(pipeline_chunk), a power of two in this sweep)
            top = bucket_size(max(self.max_batch, 1))
            out = []
            b = bucket_size(max(min(wu.min_bucket, top), 1))
            while b <= top:
                out.append(b)
                b *= 2
            buckets = tuple(out)
        has_vol_sample = any(p.volumes for p in sample)
        compiled = 0
        with device_loop.pinning():
            for P in buckets:
                try:
                    if self.fault_injector is not None:
                        self.fault_injector.device_hook("warmup:compile")
                    compiled += self._warm_bucket(P, pk, sample, nt, dn, ds,
                                                  dt, solver, gates,
                                                  has_vol_sample, wu,
                                                  anchor=(compiled == 0))
                except kernels.KernelError:
                    raise
                except Exception as e:  # noqa: BLE001 — a device error
                    # a lost or out-of-memory device (injected, or a CUDA
                    # error; warmup runs inside a takeover reconcile,
                    # where crashing the new leader is the worst outcome):
                    # stop with what warmed so far. The next cycle
                    # rebuilds the resident table through
                    # _device_snapshot_recovering, the ladder absorbs a
                    # solve failure, and the next re-arm warms again
                    self._note_device_reset(
                        "warmup:compile", e,
                        shapes=f"P{P}xN{int(dn.n)}")
                    self.cache.drop_device_snapshot()
                    self._drop_incremental("device-loss")
                    klog.warning("warmup aborted at bucket %d: %s", P, e)
                    return compiled
            if self.device_resident_snapshot:
                # the delta scatter runs only against a resident table
                try:
                    self._warm_delta_scatter(dn)
                except kernels.KernelError:
                    raise
                except Exception as e:  # noqa: BLE001 — a device error
                    klog.warning("delta-scatter warmup aborted: %s", e)
            if self.incremental.enabled:
                try:
                    compiled += self._warm_incremental(buckets, pk, sample,
                                                       nt, dn, ds, gates[0])
                except kernels.KernelError:
                    raise
                except Exception as e:  # noqa: BLE001 — a device error
                    # the restricted buckets' first solves (their peak
                    # captures among them) failed on the device: counted
                    # and recorded like any device reset, never only a
                    # log line; the cold route still serves every cycle
                    self._note_device_reset("warmup:incremental", e)
                    klog.warning("incremental warmup aborted: %s", e)
            if wu.host_fallback and self._mesh_live:
                compiled += self._warm_host_fallback(
                    buckets, pk, sample, nt, node_count, solver, gates,
                    has_vol_sample, wu)
        captures = device_loop.CAPTURES.count - captures0
        if captures:
            self.metrics.graph_captures.inc(captures, phase="warmup")
        klog.V(2).info("warmup: %d bucketed solve shapes, %d graphs "
                       "captured (nodes bucket %d)", compiled, captures,
                       dn.n)
        return compiled

    def _warm_host_fallback(self, buckets, pk, sample, nt, node_count,
                            solver, gates, has_vol_sample, wu) -> int:
        """The host-fallback sweep (``warmup.host_fallback``, under a
        mesh): warm the single-device host-mode shapes too, the ones a
        device-loss cooloff cycle presents (resident table dropped, the
        host mirror uploaded, the mesh not live), so a shard lost
        mid-churn degrades through the cooloff without capturing a
        round-loop graph on the hot path. The cooloff solves the
        unsharded program, another graph than the mesh sweep's
        partitioned one (its key carries the shard count), so the sweep
        captures it and registers the host-mode solve signatures
        (``_mesh_live`` False), as the reference compiles them. A device
        error stops the sweep as the
        mesh sweep's does; a ``KernelError`` propagates. Returns the
        shapes warmed."""
        dev = self.device
        compiled = 0
        self._mesh_live = False
        try:
            host_n = nt.n if nt.n else (node_count or 1)
            dn_h = nodes_to_device(nt, pad_to=bucket_size(max(host_n, 1)),
                                   device=dev)
            ds_h = selectors_to_device(pk.pack_selector_tables(), device=dev)
            dt_h = (topology_to_device(pk.pack_topology_tables(), device=dev)
                    if _has_topo(pk.u) else None)
            for P in buckets:
                try:
                    if self.fault_injector is not None:
                        self.fault_injector.device_hook("warmup:compile")
                    compiled += self._warm_bucket(P, pk, sample, nt, dn_h,
                                                  ds_h, dt_h, solver, gates,
                                                  has_vol_sample, wu)
                except kernels.KernelError:
                    raise
                except Exception as e:  # noqa: BLE001 — a device error
                    self._note_device_reset("warmup:compile", e,
                                            shapes=f"P{P}(host)")
                    self.cache.drop_device_snapshot()
                    self._drop_incremental("device-loss")
                    klog.warning("host-fallback warmup aborted at bucket "
                                 "%d: %s", P, e)
                    return compiled
            if self.incremental.enabled:
                # the restricted shapes in host mode too: the heal
                # boundary's cycles must not capture on the hot path
                try:
                    compiled += self._warm_incremental(
                        buckets, pk, sample, nt, dn_h, ds_h, gates[0])
                except kernels.KernelError:
                    raise
                except Exception as e:  # noqa: BLE001 — a device error
                    self._note_device_reset("warmup:incremental", e)
                    klog.warning("incremental host-fallback warmup "
                                 "aborted: %s", e)
        finally:
            self._mesh_live = self.mesh is not None
        return compiled

    def _warm_bucket(self, P, pk, sample, nt, dn, ds, dt, solver, gates,
                     has_vol_sample, wu, anchor: bool = False) -> int:
        """Warm one bucketed solve shape (the body of the warmup sweep);
        returns 1. The bucket's first solve is measured for the capacity
        preflight's peak table (``_capture_bucket_memory``); with
        ``anchor`` (the sweep's first bucket) one timed warm replay then
        anchors the perf ledger's cost model (``_anchor_cost_model``)."""
        skip_prio, no_ports, no_pod_aff, no_spread = gates
        dev = self.device
        dp = pods_to_device(pk.pack_pods(sample[:P]), pad_to=P, device=dev)
        dv = sv = None
        if has_vol_sample:
            # a volume-bearing sample warms the volume-bearing solve (its
            # row tables scale with the batch's volume rows, so coverage
            # is exact only for a representative sample)
            dv = volumes_to_device(pk.pack_volume_tables(sample[:P]),
                                   device=dev)
            sv = _static_vol_pass(dp, dn, ds, dv)
        extra_score = None
        if self.scenario_pack is not None:
            # a scenario cycle's extra_score is the pack's cost, built the
            # way the cycles build it (dtype and device included): the
            # round loop's graph key carries its presence and shape
            extra_score = self.scenario_pack.cost(
                sample[:P], nt, self.cache.node_order(), dp, dn)
        kw = dict(topo=dt, vol=dv, static_vol=sv,
                  enabled_mask=self.pred_mask, skip_priorities=skip_prio,
                  no_ports=no_ports, no_pod_affinity=no_pod_aff,
                  no_spread=no_spread, extra_score=extra_score)
        # the solve site's signature, as a cycle digests it: the warmup's
        # captures are deliberate, never retraces
        statics = (solver, tuple(skip_prio), no_ports, no_pod_aff,
                   no_spread, self.pred_mask, self.per_node_cap,
                   self.max_rounds, True, extra_score is None,
                   self._mesh_live)

        # the cycles' own solve arguments; the stats flag joins the graph
        # key, so it is the cycles' own too
        solve_kwargs = dict(
            max_rounds=self.max_rounds, per_node_cap=self.per_node_cap,
            use_sinkhorn=(solver == "sinkhorn"),
            stats_out=self.observability.sinkhorn_telemetry, **kw)

        def solve(extra_mask):
            self.obs.jax.record_call(
                "solve", dp, dn, ds, dt, dv,
                static=statics[:8] + (extra_mask is None,) + statics[9:],
                warmup=True)
            if solver == "greedy":
                return greedy_assign(dp, dn, ds, self.weights,
                                     extra_mask=extra_mask, **kw)
            # one graph per route the auto-router can choose in round 0
            # (``sinkhorn`` always plans: the router stays out)
            for route in (False, True) if solver == "batch" else (None,):
                out = batch_assign(dp, self._solve_nodes(dn), ds,
                                   self.weights,
                                   extra_mask=extra_mask, route_plan=route,
                                   **solve_kwargs)
            return out[0], out[1]

        if solver != "greedy" and self.obs.memledger.preflight_on:
            # every bucket feeds the preflight's table, measured on its
            # first solve, which captures the bucket's round-loop graph
            self._capture_bucket_memory(dp, dn, ds, solve_kwargs)
        a, usage = solve(None)
        if anchor and solver != "greedy" and self.obs.ledger.enabled:
            self._anchor_cost_model(dp, dn, ds, solve_kwargs)
        if self.robustness.validate_results and not \
                self.robustness.host_validate:
            device_validate(a, usage, dp, dn, self.pred_mask)
        if self.scenario_pack is not None and self.scenario.quality:
            # the quality reduction rides every scenario cycle's readback:
            # its first run per bucket belongs here, with the uploaded
            # assignment vector the cycles pass
            quality_reduce(upload(np.full((P,), -1, np.int32), dev),
                           usage.requested, dp, dn)
        fr_mask = None
        if wu.include_filter:
            fr_mask = _filter_pass(dp, dn, ds, dt, dv, sv,
                                   self.pred_mask).mask
        if wu.nominated_variant and self.enable_preemption:
            # the nominated-pods variant (pass A): the cycle after a
            # preemption feeds a (P, N) mask, a different round-loop graph
            if fr_mask is None:
                fr_mask = _filter_pass(dp, dn, ds, dt, dv, sv,
                                       self.pred_mask).mask
            solve(fr_mask)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.metrics.warmup_compiles.inc()
        return 1

    def _anchor_cost_model(self, dp, dn, ds, solve_kwargs) -> None:
        """The perf ledger's model side at warmup (obs/ledger.py): the
        analytic work of one round at this (P, N)
        (``ops/assign.solve_cost_analysis``) and ONE timed warm replay of
        the just-captured solve as the per-round rate anchor. The replay
        can take more than one round, so the anchor records the executed
        round count (a warmup-only readback, site ``ledger-anchor``): an
        R-round wall credited to one round would inflate the per-round
        rate R times. Every error propagates: a ``KernelError`` leaves
        ``warmup``, and a device error (a CUDA out-of-memory error
        included) reaches warmup's device-loss handler, as the same
        solve's error would outside the accounting."""
        from kubernetes_tpu_torch.ops.assign import solve_cost_analysis

        ledger = self.obs.ledger
        P_pad = int(dp.valid.shape[0])
        N_pad = int(dn.n)
        ca = solve_cost_analysis(dp, dn, ds, self.weights, **solve_kwargs)
        if ca is not None:
            ledger.model.record_signature(
                P_pad, N_pad, ca["flops"], ca["bytes_accessed"])
        if dp.valid.is_cuda:
            torch.cuda.synchronize(dp.valid.device)  # not the capture
        t0 = time.perf_counter()
        out = batch_assign(dp, self._solve_nodes(dn), ds, self.weights,
                           **solve_kwargs)
        rounds = int(self.obs.jax.readback("ledger-anchor", out[2]))
        elapsed = time.perf_counter() - t0
        ledger.model.record_anchor("full", P_pad, N_pad, self._mesh_width(),
                                   elapsed, rounds=max(rounds, 1))

    def _capture_bucket_memory(self, dp, dn, ds, solve_kwargs) -> None:
        """The memory ledger's per-bucket peak (obs/memledger.py): one
        measured solve at this warmed (P, N)
        (``ops/assign.solve_memory_analysis``) into the preflight's table.
        A measurement that found the bucket's graph already captured (a
        second warmup in the process) reads only a replay: the larger
        entry stays. On CPU tensors nothing is measured and nothing lands
        (the preflight then calls the shape unwarmed). Every error
        propagates: this is the bucket's first real solve, so a device
        error (a CUDA out-of-memory error included) reaches the caller's
        device-loss handler (``warmup``'s ``oom@`` forensics and snapshot
        drop, or the restricted sweep's abort), and a ``KernelError``
        leaves ``warmup``."""
        from kubernetes_tpu_torch.ops.assign import solve_memory_analysis

        ml = self.obs.memledger
        ma = solve_memory_analysis(dp, self._solve_nodes(dn), ds,
                                   self.weights, **solve_kwargs)
        if ma is None:
            return
        key = (int(dp.valid.shape[0]), int(dn.n),
               self._mesh_width())
        cur = ml.bucket_table().get(key)
        if cur is None or cur["total_bytes"] <= ma["total_bytes"]:
            ml.record_bucket_memory(*key, ma)

    def _warm_delta_scatter(self, dn) -> None:
        """Run the resident table's delta scatter once at each dirty-row
        bucket steady churn presents, on a throwaway copy (the first
        launch of each kernel loads its module); on a mesh, on every
        block, as the cache's scatter runs."""
        for blk in pmesh.node_blocks(dn):
            n_pad = blk.n
            dev = blk.valid.device
            for dpb in (4, 8, 16, 32, 64):
                sub = gather_node_rows(blk, torch.zeros(
                    (dpb,), dtype=torch.long, device=dev))
                resident = blk._replace(**{
                    f: getattr(blk, f).clone() for f in blk._fields})
                scatter_node_rows(resident, sub,
                                  np.full((dpb,), n_pad, np.int64))

    def _warm_incremental(self, buckets, pk, sample, nt, dn, ds,
                          skip_prio) -> int:
        """Warm the restricted route for every pod bucket that can take
        it: the candidate pick, the node-row gather, the (P, C) solve
        (cold, and warm-started for the sinkhorn solver), the validator,
        the global mapping, the summary patch and (``primary``) the
        partitioned block deal. With ``incremental.auto_tune`` the sweep
        warms a C ladder {C/2, C, 2C} and records it in
        ``_warmed_cbuckets``: the tuner moves only between warmed rungs.
        Returns the (C, P) shapes warmed."""
        inc = self.incremental
        dev = self.device
        n_pad = dn.n
        c0 = bucket_size(max(inc.candidate_bucket, 1))
        ladder = [c0]
        if inc.auto_tune:
            ladder = sorted({max(c0 // 2, 16), c0, c0 * 2})
        ladder = [c for c in ladder if c < n_pad]
        if not ladder:
            return 0
        ns = self._num_shards()
        flags = self._summary_flags
        summary = node_summary(dn, **flags)
        zeros_dirty = self._node_mask(n_pad)
        for dpb in (4, 8, 16, 32, 64):
            sub = gather_node_rows(dn, torch.zeros((dpb,), dtype=torch.long,
                                                   device=dev))
            patch_node_summary(node_summary(dn, **flags),
                               node_summary(sub, **flags),
                               np.full((dpb,), n_pad, np.int64))
        use_sk = self.solver == "sinkhorn"
        warm = bool(inc.warm_potentials and use_sk)
        want_stats = bool(self.observability.sinkhorn_telemetry and use_sk)
        pack = (self.scenario_pack
                if (self.scenario_pack is not None
                    and self.scenario_pack.restricted_ok) else None)
        node_order = self.cache.node_order()
        compiled = 0
        smallest_bucket = bucket_size(1)
        dps: Dict[int, object] = {}
        for C in ladder:
            self.obs.jax.record_call(
                "incremental", summary.rank,
                static=(C, n_pad, self._mesh_live, ns, True, None),
                warmup=True)
            cand, sub_dn = gather_candidates(summary, zeros_dirty, dn, C,
                                             num_shards=ns)
            if pack is not None:
                # the hinted pick (two disjoint top-k's) is a site of its
                # own: run it once with a placeholder mask
                hq = max(int(inc.group_quota_frac * C), 1)
                self.obs.jax.record_call(
                    "incremental", summary.rank,
                    static=(C, n_pad, self._mesh_live, ns, False, hq),
                    warmup=True)
                gather_candidates(
                    summary, zeros_dirty, dn, C,
                    hint_mask=self._node_mask(n_pad),
                    num_shards=ns, hint_quota=hq)
            part_warm = False
            if inc.primary:
                B = self._cold_blocks(n_pad, C)
                if B >= 2:
                    part_warm = True
                    self.obs.jax.record_call(
                        "partition", summary.rank,
                        static=(B, C, n_pad, ns, self._mesh_live),
                        warmup=True)
                    blocks = partition_columns(summary, zeros_dirty, B, C,
                                               ns)
                    gather_node_rows(dn, blocks[0])
            limit = inc.max_batch_frac * C
            for P in buckets:
                # warm P iff some eligible batch pads to it: the gate
                # compares the raw batch size before padding
                smallest_in_bucket = (1 if P <= smallest_bucket
                                      else P // 2 + 1)
                over_limit = smallest_in_bucket > limit
                if over_limit and not part_warm:
                    continue
                if P not in dps:
                    dps[P] = pods_to_device(pk.pack_pods(sample[:P]),
                                            pad_to=P, device=dev)
                dp = dps[P]
                extra = None
                if pack is not None and not over_limit:
                    # the pack's cost on the gathered frame, as a restricted
                    # cycle feeds it (the partitioned route takes none)
                    extra = pack.cost(sample[:P], nt, node_order, dp, sub_dn)
                zp = None
                if warm and not over_limit:
                    zp = (torch.zeros((P,), dtype=torch.float32, device=dev),
                          torch.zeros((C,), dtype=torch.float32, device=dev))
                variants = [(None, None)]
                if zp is not None:
                    variants.append((zp, None))
                if extra is not None:
                    variants.append((None, extra))
                    if zp is not None:
                        variants.append((zp, extra))
                if self.obs.memledger.preflight_on:
                    # the preflight's table learns the restricted (P, C)
                    # frames too, measured on the cold variant's capture
                    self._capture_bucket_memory(
                        dp, sub_dn, ds, dict(
                            max_rounds=self.max_rounds,
                            per_node_cap=self.per_node_cap,
                            enabled_mask=self.pred_mask,
                            use_sinkhorn=use_sk,
                            skip_priorities=skip_prio, no_ports=True,
                            no_pod_affinity=True, no_spread=True,
                            stats_out=want_stats))
                for sk_init, extra_score in variants:
                    self.obs.jax.record_call(
                        "solve", dp, sub_dn, ds,
                        static=("restricted", self.solver, tuple(skip_prio),
                                self.pred_mask, self.per_node_cap,
                                self.max_rounds, sk_init is None,
                                extra_score is None, self._mesh_live),
                        warmup=True)
                    out = batch_assign(
                        dp, sub_dn, ds, self.weights,
                        max_rounds=self.max_rounds,
                        per_node_cap=self.per_node_cap,
                        enabled_mask=self.pred_mask, use_sinkhorn=use_sk,
                        extra_score=extra_score,
                        skip_priorities=skip_prio, no_ports=True,
                        no_pod_affinity=True, no_spread=True,
                        stats_out=want_stats, sk_init=sk_init,
                        sk_tol=(inc.warm_tol if warm else None),
                        potentials_out=warm)
                    a, usage = out[0], out[1]
                    if (self.robustness.validate_results
                            and not self.robustness.host_validate):
                        device_validate(a, usage, dp, sub_dn, self.pred_mask)
                    map_restricted_assignment(a.to(torch.int32), cand)
                if (pack is not None and self.scenario.quality
                        and not over_limit):
                    # the frame-local quality reduction of a restricted
                    # scenario cycle
                    quality_reduce(a.to(torch.int32), usage.requested, dp,
                                   sub_dn)
                compiled += 1
                self.metrics.warmup_compiles.inc()
            self._warmed_cbuckets.add(C)
        klog.V(2).info("incremental warmup: %d restricted solve shapes "
                       "(C ladder %s)", compiled, ladder)
        return compiled

    # -- assume / bind -----------------------------------------------------

    def _admit_pod(self, pod: Pod, node_name: str, cycle: int,
                   res: CycleResult) -> None:
        """The per-pod admission tail for a PLACED pod: AssumePodVolumes →
        Reserve → cache assume → Permit → bind. Shared by the monolithic
        bind loop, the sparse routes and the pipelined executor's
        per-chunk bind stage."""
        if not self._fence_ok():
            # deposed mid-cycle: abort BEFORE assuming — the new leader
            # owns this pod now; racing its bind at the hub CAS is the
            # exact split-brain window the fence closes
            self._fenced(pod, cycle, res)
            return
        fw = self.framework
        st = self._cycle_states.get(pod.key()) or CycleState()
        # a reservation held from a previous cycle (Permit-parked pod
        # popped again) must survive this attempt's failure paths
        vols_held_before = pod.key() in self.volume_binder.assumed
        vok, vmsg = self.volume_binder.assume_pod_volumes(
            pod, self.cache.node(node_name))
        if not vok:
            self._fail(pod, cycle, res, (f"VolumeBinding:{vmsg}",))
            return
        rs = fw.run_reserve(st, pod, node_name)
        if not rs.is_success():
            if not vols_held_before:
                self.volume_binder.forget_pod_volumes(pod.key())
            fw.run_unreserve(st, pod, node_name)
            self._fail(pod, cycle, res, (f"Reserve:{rs.message}",))
            return
        try:
            self.cache.assume_pod(pod, node_name)
        except Exception:  # noqa: BLE001 — already in cache: requeue
            if not vols_held_before:
                self.volume_binder.forget_pod_volumes(pod.key())
            fw.run_unreserve(st, pod, node_name)
            self._fail(pod, cycle, res, ("AssumeError",))
            return
        ps = fw.run_permit(st, pod, node_name)
        if ps.code == WAIT:
            res.waiting += 1
            self.obs.journeys.note_permit_park(pod.key())
            return
        if not ps.is_success():
            self.cache.forget_pod(pod.key())
            self.volume_binder.forget_pod_volumes(pod.key())
            fw.run_unreserve(st, pod, node_name)
            self._fail(pod, cycle, res, (f"Permit:{ps.message}",))
            return
        self._bind_pod(pod, node_name, st, res)

    def _bind_pod(self, pod: Pod, node_name: str, st,
                  res: CycleResult) -> bool:
        """PreBind -> Bind (plugins, else the default binder) -> PostBind.
        Any failure forgets the assumption and requeues."""
        fw = self.framework
        cycle = self.queue.scheduling_cycle

        def reject(reason: str) -> bool:
            klog.warning("bind of %s to %s failed: %s", pod.key(),
                         node_name, reason)
            self.cache.forget_pod(pod.key())
            self.volume_binder.forget_pod_volumes(pod.key())
            res.bind_errors += 1
            fw.run_unreserve(st, pod, node_name)
            self._fail(pod, cycle, res, (reason,))
            return False

        try:
            committed = self.volume_binder.bind_pod_volumes(pod)
        except Exception as e:  # noqa: BLE001 — volume write boundary
            return reject(f"VolumeBinding:{e}")
        if committed:
            # the pod's volume tokens changed: the snapshot must rebuild
            self.cache.invalidate_snapshot()
        s = fw.run_prebind(st, pod, node_name)
        if not s.is_success():
            return reject(f"PreBind:{s.message}")
        self.obs.journeys.note_bind_start(pod.key())
        bt0 = self.clock()
        bs = fw.run_bind(st, pod, node_name)
        if bs.code == SKIP:
            # an interested binder-extender takes the binding over the
            # default binder (extender.go:360,:382)
            binder = self.binder
            for ext in self.extenders:
                if ext.is_binder() and ext.is_interested(pod):
                    binder = ext
                    break
            if hasattr(binder, "set_call_budget"):
                binder.set_call_budget(
                    max(self._cycle_deadline - self.clock(), 1e-3)
                    if self._cycle_deadline is not None else None)
            try:
                binder.bind(pod, node_name)
            except Exception as e:  # noqa: BLE001 — binder boundary
                if not self._bind_ambiguous(e):
                    # a definite failure: forget and retry
                    return reject(f"BindError:{e}")
                # the AMBIGUOUS class: the hub may have committed before
                # the answer was lost. Never retried blind: resolved by
                # read-your-write (adopt, requeue), parked when the GET
                # is unreachable too, left to the TTL without a reader
                verdict = self._handle_ambiguous_bind(pod, node_name, st,
                                                      e, reject)
                if verdict is not True:
                    return bool(verdict)
                # adopted: the bind did land — the normal success tail
        elif not bs.is_success():
            return reject(f"Bind:{bs.message}")
        self.metrics.binding_duration.observe(self.clock() - bt0)
        self.cache.finish_binding(pod.key())
        self.queue.nominated.delete(pod)
        self.metrics.pod_scheduling_attempts.observe(
            self.queue.backoff_map.attempts(pod.key()) + 1)
        self.queue.backoff_map.clear_pod(pod.key())
        self.why_pending.pop(pod.key(), None)
        res.scheduled += 1
        res.assignments[pod.key()] = node_name
        res.e2e_latency_s[pod.key()] = max(
            self.clock() - getattr(pod, "queued_at", self.clock()), 0.0)
        self.obs.journeys.note_bound(pod.key(), cycle)
        fw.run_postbind(st, pod, node_name)
        self._cycle_states.pop(pod.key(), None)
        self.event_sink("Scheduled", pod, node_name)
        return True

    # -- the ambiguous-outcome bind protocol ----------------------------------

    def _bind_ambiguous(self, e: Exception) -> bool:
        """Is this bind failure the AMBIGUOUS class (the hub may have
        committed before the answer was lost)? ``faults.RPCTimeout``
        always is; a raw transport timeout (``socket.timeout`` /
        ``TimeoutError``) is too, but only a scheduler WITH a reader can
        do better than reject-and-requeue for it."""
        if isinstance(e, RPCTimeout):
            return True
        return self.pod_reader is not None and isinstance(e, TimeoutError)

    def _resolve_ambiguous_bind(self, pod: Pod, node_name: str):
        """Read-your-write verification of an ambiguously timed-out bind:
        GET the pod from the hub (bounded retries, full jitter on the
        per-replica stream) and compare uid and nodeName.

        Returns ``"adopted"`` (the hub HAS our binding — confirm, never
        bind again), ``"requeued"`` (verified unbound — a retry through
        the requeue path is safe), ``"conflict"`` (bound elsewhere or
        recreated under a new uid), ``"gone"`` (deleted mid-bind),
        ``"ttl-parked"`` (no reader — the assume TTL or the watch settles
        it), or ``None`` when the GET itself stayed unreachable (the
        caller parks the pod and re-probes later)."""
        if self.pod_reader is None:
            return "ttl-parked"
        key = pod.key()
        # the cycle deadline bounds IN-CYCLE verification; on the idle
        # paths (parked re-probes, the TTL reap) the last cycle's deadline
        # is stale and would zero the retry budget
        deadline = self._cycle_deadline
        if deadline is not None and self.clock() >= deadline:
            deadline = None
        try:
            cur = self._bind_verify_retry.call(
                lambda: self.pod_reader(key), deadline_s=deadline,
                clock=self.clock)
        except Exception as e:  # noqa: BLE001 — the hub GET boundary
            klog.warning("ambiguous bind of %s -> %s: verification GET "
                         "failed (%s); parking", key, node_name, e)
            return None
        if cur is None:
            return "gone"
        if getattr(cur, "uid", None) != pod.uid:
            return "conflict"
        if cur.node_name == node_name:
            return "adopted"
        if cur.node_name:
            return "conflict"
        return "requeued"

    def _handle_ambiguous_bind(self, pod: Pod, node_name: str, st,
                               exc: Exception, reject) -> object:
        """Resolve one in-cycle ambiguous bind timeout. Returns ``True``
        when the hub turned out to have committed (the caller proceeds to
        the success tail), ``False`` when the pod was requeued, parked or
        dropped here."""
        key = pod.key()
        self.obs.note_ambiguous_bind()
        resolution = self._resolve_ambiguous_bind(pod, node_name)
        self.metrics.bind_ambiguous.inc(resolution=resolution or "deferred")
        if resolution is None:
            # the hub is unreachable for verification too: the pod stays
            # ASSUMED (capacity held, NO TTL — a TTL reap would requeue
            # and risk a second bind) and every cycle / idle tick
            # re-probes until the hub answers
            klog.warning("bind of %s -> %s timed out ambiguously and "
                         "verification is unreachable; parked assumed",
                         key, node_name)
            self._ambiguous_binds[key] = (pod, node_name, st)
            self.obs.journeys.note_ambiguous_park(key, "bind-timeout")
            self._cycle_states.pop(key, None)
            return False
        if resolution == "adopted":
            klog.V(2).info("ambiguous bind of %s -> %s resolved: the hub "
                           "committed — adopted, not bound again", key,
                           node_name)
            return True
        if resolution == "ttl-parked":
            # no reader: arm the assume TTL; the watch MODIFIED confirms
            # a committed bind, the TTL reap requeues an uncommitted one
            self.cache.finish_binding(key)
            self._cycle_states.pop(key, None)
            return False
        if resolution == "requeued":
            reject(f"BindAmbiguous:verified not committed ({exc})")
            return False
        # conflict / gone: the forget-and-requeue path of a definite bind
        # error; the watch (or a reconcile) drops stale queue entries
        reject(f"BindError:ambiguous bind resolved as {resolution}: {exc}")
        return False

    def _verify_ambiguous_binds(self) -> None:
        """Re-probe every parked ambiguous bind (the cycle's head and the
        idle tick): the watch may have settled it meanwhile (a confirmed
        add), else the verification GET is retried and the pod adopted or
        requeued exactly like the in-cycle resolution."""
        if not self._ambiguous_binds:
            return
        res = CycleResult()
        resolved = False
        for key, (pod, node_name, st) in list(self._ambiguous_binds.items()):
            # st is None only for a park the TTL reap made: that pod's
            # original bind already ran the success tail, so an adoption
            # confirms the cache and nothing else, and its verdicts keep
            # the expired-* labels
            reap_origin = st is None
            watch_settled = not self.cache.is_assumed(key)
            if watch_settled:
                # the watch answered first (a delete pops the park in
                # on_pod_delete, a reconcile clears parks wholesale, so
                # a confirmed add is the only live way here); an in-cycle
                # park still owes the success tail its bind never reached
                del self._ambiguous_binds[key]
                if self.cache.pod(key) is None:
                    continue
                resolution = "adopted"
            else:
                resolution = self._resolve_ambiguous_bind(pod, node_name)
                if resolution is None:
                    continue  # the hub is still unreachable: stay parked
                del self._ambiguous_binds[key]
            self.metrics.bind_ambiguous.inc(
                resolution=(f"expired-{resolution}" if reap_origin
                            else resolution))
            resolved = True
            st = st or CycleState()
            if resolution == "ttl-parked":
                # the reader went away: back to TTL semantics
                self.cache.finish_binding(key)
                continue
            if resolution == "adopted":
                if not watch_settled:
                    # the GET is hub truth like a relist: confirm the
                    # binding outright, never arm a TTL whose reap would
                    # requeue a pod the hub provably bound
                    self.cache.add_pod(self.cache.pod(key) or pod)
                if reap_origin:
                    klog.V(2).info("parked expired assumption of %s -> %s "
                                   "resolved: adopted", key, node_name)
                    continue
                self.queue.nominated.delete(pod)
                self.metrics.pod_scheduling_attempts.observe(
                    self.queue.backoff_map.attempts(key) + 1)
                self.queue.backoff_map.clear_pod(key)
                self.why_pending.pop(key, None)
                res.scheduled += 1
                res.assignments[key] = node_name
                res.e2e_latency_s[key] = max(
                    self.clock() - getattr(pod, "queued_at", self.clock()),
                    0.0)
                self.obs.journeys.note_bound(
                    key, self.queue.scheduling_cycle)
                self.framework.run_postbind(st, pod, node_name)
                self.event_sink("Scheduled", pod, node_name)
                klog.V(2).info("parked ambiguous bind of %s -> %s "
                               "resolved: adopted", key, node_name)
                continue
            self.cache.forget_pod(key)
            self.volume_binder.forget_pod_volumes(key)
            self.framework.run_unreserve(st, pod, node_name)
            res.bind_errors += 1
            if resolution == "requeued":
                reasons = ("BindAmbiguous:verified not committed",)
            else:
                reasons = ("BindError:ambiguous bind resolved as "
                           f"{resolution}",)
            self._fail(pod, self.queue.scheduling_cycle, res, reasons)
        if resolved:
            self._record_metrics(res)

    def _process_waiting(self, res: CycleResult) -> None:
        """Resolve Permit waits: allowed pods proceed to binding; rejected
        or timed-out pods are forgotten and requeued."""
        fw = self.framework
        now = self.clock()
        for wp in fw.waiting.items():
            key = wp.pod.key()
            st = self._cycle_states.get(key) or CycleState()
            if wp.rejected is not None or (not wp.allowed
                                           and now >= wp.deadline):
                fw.waiting.remove(key)
                self.cache.forget_pod(key)
                self.volume_binder.forget_pod_volumes(key)
                fw.run_unreserve(st, wp.pod, wp.node_name)
                self._fail(wp.pod, self.queue.scheduling_cycle, res,
                           (f"Permit:{wp.rejected or 'permit timeout'}",))
                self._cycle_states.pop(key, None)
            elif wp.allowed:
                fw.waiting.remove(key)
                self._bind_pod(wp.pod, wp.node_name, st, res)

    def _fail(self, pod: Pod, cycle: int, res: CycleResult, reasons,
              message: Optional[str] = None) -> None:
        res.unschedulable += 1
        res.failure_reasons[pod.key()] = tuple(reasons)
        if message is not None:
            res.fit_errors[pod.key()] = message
        # the journey's attempt row (tier and scope backfilled when the
        # cycle closes); the queue re-add below ends its solve phase
        self.obs.journeys.note_attempt_failed(
            pod.key(), cycle, reasons[0] if reasons else "")
        self._cycle_states.pop(pod.key(), None)
        self.queue.record_failure(pod)
        self.queue.add_unschedulable_if_not_present(pod, cycle)
        self.event_sink("FailedScheduling", pod,
                        message if message is not None else ",".join(reasons))
