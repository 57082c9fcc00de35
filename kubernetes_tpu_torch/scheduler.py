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
      queue.tick(); reap expired assumptions
      batch = queue.pop_batch()                      # NextPod, batched
      PreFilter plugins                              # framework
      nt, dn = cache.device_snapshot()               # resident, patched
      pass A: nominated pods as phantoms -> extra_mask
      assigned = ladder(batch)                       # batch|sinkhorn -> greedy
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

Every cycle opens one trace (``Scheduler.obs``, :mod:`.obs.core`) with
spans at the reference's sites and under its names.

Not ported yet (ROADMAP): warmup (with it the candidate-bucket tuner's
warmed ladder), the circuit breakers and cycle deadline, the scenario
cascade, scenario packs, extenders, observability beyond the cycle trace
(metrics, journeys, the flight recorder, ``/debug/why``), leader fencing,
recovery and the ambiguous-bind protocol, the mesh, and the
``batch-single``/``batch-cpu``/``exact`` tiers.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Protocol, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch import resolve_device
from kubernetes_tpu_torch.api.types import Pod, is_pod_terminated
from kubernetes_tpu_torch.cache import SchedulerCache
from kubernetes_tpu_torch.config import IncrementalConfig
from kubernetes_tpu_torch.framework import (
    SKIP,
    WAIT,
    CycleState,
    Framework,
)
from kubernetes_tpu_torch.kernels import KernelError
from kubernetes_tpu_torch.obs.core import Obs
from kubernetes_tpu_torch.obs.explain import (
    PodExplanation,
    UnschedulableReport,
    build_report,
    explain_reduce,
    read_back,
)
from kubernetes_tpu_torch.ops.arrays import (
    gather_candidates,
    gather_node_rows,
    map_restricted_assignment,
    pods_to_device,
    selectors_to_device,
    topology_to_device,
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
)
from kubernetes_tpu_torch.ops.fused_score import (
    node_summary,
    partition_columns,
)
from kubernetes_tpu_torch.ops.predicates import (
    BIT,
    decode_reasons,
    fit_error_message_from_counts,
    run_predicates,
    static_volume_reasons,
)
from kubernetes_tpu_torch.ops.priorities import DEFAULT_WEIGHTS, solver_gates
from kubernetes_tpu_torch.ops.sync import SYNCS, to_host
from kubernetes_tpu_torch.preemption import preempt
from kubernetes_tpu_torch.queue import SchedulingQueue
from kubernetes_tpu_torch.snapshot import FIXED_RESOURCE_NAMES
from kubernetes_tpu_torch.utils import klog
from kubernetes_tpu_torch.utils.interner import bucket_size
from kubernetes_tpu_torch.volumes import VolumeBinder

#: the ladder tiers this port runs
TIERS = ("batch", "sinkhorn", "greedy")


class Binder(Protocol):
    """The scheduler's only write — POST pods/{name}/binding."""

    def bind(self, pod: Pod, node_name: str) -> None: ...


class RecordingBinder:
    """Test binder capturing bindings."""

    def __init__(self) -> None:
        self.bindings: List[Tuple[str, str]] = []

    def bind(self, pod: Pod, node_name: str) -> None:
        self.bindings.append((pod.key(), node_name))


class SolverResultInvalid(Exception):
    """A tier's result failed validation; the ladder moves on."""


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
    #: how the cycle's snapshot was produced: full | delta | clean
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


def _filter_pass(dp, dn, ds, dt, dv=None, sv=None, em=None):
    """One standalone filter evaluation (reasons + mask) — the
    nominated-pods pass-A mask and the failure-reason passes (the
    reference's jitted ``_filter_pass``)."""
    return run_predicates(dp, dn, ds, dt, dv, sv, em)


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
    (``batch``, ``sinkhorn`` or ``greedy``); ``greedy``, the sequential
    oracle, is always the last. Every tier's result is checked on the
    device before anything binds."""

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
        explain: bool = True,
        explain_top_k: int = 3,
        incremental: Optional[IncrementalConfig] = None,
        pipeline_depth: int = 2,
        pipeline_chunk: int = 4096,
    ) -> None:
        if solver not in TIERS:
            raise ValueError(f"solver must be one of {TIERS}, got {solver!r}")
        self.device = resolve_device(device)
        self.scheduler_name = scheduler_name
        self.framework = framework or Framework(clock=clock)
        self.cache = cache or SchedulerCache(clock=clock, device=self.device)
        self.cache.device = self.device
        # explicit None check: an empty SchedulingQueue is falsy
        self.queue = queue if queue is not None else SchedulingQueue(
            clock=clock, less=self.framework.queue_sort_less())
        self.binder = binder or RecordingBinder()
        self.weights = weights
        self.solver = solver
        self.per_node_cap = per_node_cap
        self.max_rounds = max_rounds
        self.max_batch = max_batch
        self.clock = clock
        #: event_sink(reason, pod, message) — Scheduled / FailedScheduling
        self.event_sink = event_sink or (lambda *_: None)
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
        #: the candidate-bucket tuner: the warmed bucket ladder (empty
        #: until warmup is ported, which keeps the bucket pinned), recent
        #: raw micro-batch sizes, the deepest frame position placed into
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
        #: the cycle tracer (one Trace per cycle, spans on perf_counter)
        self.obs = Obs()

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
            self.queue.assigned_pod_added(new)
        elif self.responsible_for(new):
            if new != old:
                self.cache.packer.forget_pod(new.key())
            self.queue.update(old.key(), new)
        elif self.responsible_for(old):
            self.queue.delete(old.key())
            self._cycle_states.pop(old.key(), None)
            self.why_pending.pop(old.key(), None)

    def on_pod_delete(self, pod: Pod) -> None:
        key = pod.key()
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
        self.queue.move_all_to_active()

    def on_node_update(self, node) -> None:
        self.cache.update_node(node)
        self.queue.move_all_to_active()

    def on_node_delete(self, name: str) -> None:
        self.cache.remove_node(name)

    def set_volume_state(self, pvcs=(), pvs=(), classes=()) -> None:
        """PV/PVC/StorageClass informer feed: scheduled pods' volume tokens
        depend on PVC->PV resolution, so the snapshot rebuilds and the
        unschedulable queue resweeps."""
        self.cache.packer.set_volume_state(pvcs, pvs, classes)
        self.cache.invalidate_snapshot()
        self.queue.move_all_to_active()

    # -- the cycle ---------------------------------------------------------

    def _reap_expired_assumptions(self) -> None:
        """Drive cache TTL expiry: an assumption whose bind confirmation
        never arrived frees its capacity and its pod requeues."""
        for p in self.cache.pop_expired():
            key = p.key()
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

    def schedule_cycle(self) -> CycleResult:
        """One batched scheduling pass over everything in activeQ."""
        t0 = self.clock()
        syncs0 = SYNCS.count
        res = CycleResult()
        self.obs.begin_cycle(self.queue.scheduling_cycle)
        self.queue.tick()
        self._reap_expired_assumptions()
        self._process_waiting(res)
        batch = self.queue.pop_batch(self.max_batch)
        if not batch:
            self._explain_retire_if_drained()
            return self._finish(res, t0, syncs0)
        cycle = self.queue.scheduling_cycle
        # skipPodSchedule (scheduler.go:335): pods marked for deletion drop
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
            nt, dn, res.snapshot_mode = self.cache.device_snapshot()
            node_order = self.cache.node_order()
            pt = pk.pack_pods(batch)
            skip_prio, no_ports, no_pod_aff, no_spread = solver_gates(nt, pt)
            # a pipelined cycle packs and uploads its pods chunk by chunk
            dp = None if use_pipeline else pods_to_device(
                pt, pad_to=bucket_size(max(len(batch), 1)), device=dev)
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
        if nominated:
            nom_mask = self._nominated_mask(nominated, node_order, dp, dn,
                                            ds, dt, dv, sv)
            extra_mask = (nom_mask if extra_mask is None
                          else extra_mask & nom_mask)

        ts = self.clock()
        ladder = self._solve_ladder(batch, dp, dn, ds, dt, dv, sv,
                                    extra_mask, extra_score, skip_prio,
                                    no_ports, no_pod_aff, no_spread, res)
        res.solve_s = self.clock() - ts
        if ladder is None:
            # every tier failed: requeue the whole batch with backoff
            for pod in batch:
                self._fail(pod, cycle, res, ("SolverUnavailable",))
            return self._finish(res, t0, syncs0)
        assigned, usage, res.rounds, res.solver_tier = ladder
        assigned = assigned[: len(batch)].copy()

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
            pad_t = torch.from_numpy(pad).to(dev)
            usage = _apply_batch(usage_from_nodes(dn), dp,
                                 pad_t.clamp_min(0), (pad_t >= 0) & dp.valid)

        # reasons for the unplaced: one filter pass against the final
        # usage (without the nominated phantoms, as in the reference),
        # reduced on the device by explain_reduce for exactly the failed
        # rows and read back as one transfer; preemption's per-node rows
        # are gathered for the preemptable pods only
        failed_idx = [i for i, a in enumerate(assigned) if a < 0]
        preemptable_idx = [i for i in failed_idx if i not in gang_failed]
        ex = rows_dev = None
        if failed_idx:
            tx = time.perf_counter()
            fr = _filter_pass(dp, nodes_with_usage(dn, usage), ds, dt, dv,
                              sv, self.pred_mask)
            rows = torch.tensor(failed_idx, dtype=torch.long, device=dev)
            every = torch.ones((len(failed_idx),), dtype=torch.bool,
                               device=dev)
            ex = explain_reduce(
                fr.reasons.index_select(0, rows), dn.valid, every,
                dp.req.index_select(0, rows), dn.allocatable - usage.requested,
                dn.ready, dn.network_unavailable)
            if self.enable_preemption and preemptable_idx:
                pre = torch.tensor(preemptable_idx, dtype=torch.long,
                                   device=dev)
                rows_dev = fr.reasons.index_select(0, pre)[:, : nt.n]
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
            ex_host = read_back(ex)
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

        # preemption (scheduler.go:493 -> preempt): failed pods try to
        # evict lower-priority pods; winners get a nominated node and
        # retry. The reason rows cross to the host only here
        if rows_dev is not None:
            tp = time.perf_counter()
            res.preempt_rows_bytes = rows_dev.numel() * rows_dev.element_size()
            with self.obs.span("preemption"):
                self._run_preemption(batch, preemptable_idx,
                                     to_host(rows_dev), node_order, res)
            res.preempt_s = time.perf_counter() - tp
        return self._finish(res, t0, syncs0)

    def _finish(self, res: CycleResult, t0: float, syncs0: int):
        res.elapsed_s = self.clock() - t0
        if res.solver_tier and not res.solve_scope:
            res.solve_scope = "full"
        res.host_syncs = SYNCS.count - syncs0
        self.obs.end_cycle()
        klog.V(3).info(
            "cycle: attempted=%d scheduled=%d unschedulable=%d rounds=%d "
            "syncs=%d %.3fs", res.attempted, res.scheduled,
            res.unschedulable, res.rounds, res.host_syncs, res.elapsed_s)
        return res

    def _plugin_terms(self, batch, dp, dn, ds, node_order):
        """Framework Filter/Score contributions: batch plugins give whole
        (P, N) tensors; host plugins evaluate per (pod, node name). Returns
        ``(extra_mask, extra_score, early_fail)``; a raising host plugin
        fails only its own pod."""
        fw = self.framework
        state = CycleState()
        extra_mask = fw.run_filter_batch(state, dp, dn, ds)
        extra_score = fw.run_score_batch(state, dp, dn, ds)
        early_fail: Dict[int, str] = {}
        if fw.has_host_filters() or fw.has_host_scores():
            shape = (dp.valid.shape[0], dn.valid.shape[0])
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
                m = torch.from_numpy(hm).to(self.device)
                extra_mask = m if extra_mask is None else (extra_mask & m)
            if fw.has_host_scores():
                s = torch.from_numpy(hs).to(self.device)
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
        Returns the (P, N) mask."""
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
                             torch.from_numpy(rows).to(dev),
                             torch.from_numpy(ok).to(dev) & dpn.valid)
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
            result = preempt(
                pod, nodes, node_pods_of, reason_bits, pdbs,
                nominated_pods_of=dict(self.queue.nominated.items()),
                vol_state=self.cache.packer.resolve_volumes,
                extenders=[],
                enable_non_preempting=self.enable_non_preempting)
            if result is None:
                continue
            now = self.clock()
            for v in result.victims:
                v.deletion_timestamp = now
                self.event_sink("Preempted", v, f"by {pod.key()}")
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

    def _explain_retire_if_drained(self) -> None:
        """An idle cycle popped nothing: when every pod the last report
        analyzed has since left (bind and delete drop their why_pending
        rows), retire the report instead of reporting them forever. Pods
        parked in backoff or unschedulable keep their rows."""
        if not self.explain or self.why_pending or self.last_explain is None:
            return
        if not (self.last_explain.pods
                or self.last_explain.reason_node_counts):
            return
        self.last_explain = UnschedulableReport(
            cycle=self.queue.scheduling_cycle,
            n_nodes=self.last_explain.n_nodes)

    # -- degradation ladder ------------------------------------------------

    def _run_tier(self, tier, batch, dp, dn, ds, dt, dv, sv, extra_mask,
                  extra_score, skip_prio, no_ports, no_pod_aff, no_spread):
        """One solve attempt on one ladder tier: (assigned, usage, rounds).
        Exceptions propagate to the ladder."""
        if tier == "greedy":
            a, u = greedy_assign(
                dp, dn, ds, self.weights, topo=dt, extra_mask=extra_mask,
                vol=dv, static_vol=sv, enabled_mask=self.pred_mask,
                extra_score=extra_score, skip_priorities=skip_prio,
                no_ports=no_ports, no_pod_affinity=no_pod_aff,
                no_spread=no_spread)
            return a, u, len(batch)
        return batch_assign(
            dp, dn, ds, self.weights, max_rounds=self.max_rounds,
            per_node_cap=self.per_node_cap, topo=dt, extra_mask=extra_mask,
            vol=dv, static_vol=sv, enabled_mask=self.pred_mask,
            extra_score=extra_score, use_sinkhorn=(tier == "sinkhorn"),
            skip_priorities=skip_prio, no_ports=no_ports,
            no_pod_affinity=no_pod_aff, no_spread=no_spread)

    def _validated_readback(self, tier, out, dp, dn):
        """Validate one tier's result on the device and read the
        assignment back together with the verdict as ONE device-to-host
        copy, the round count riding it. Returns ``(assigned_host, usage,
        rounds)`` or raises SolverResultInvalid with the host checker's
        reason vocabulary."""
        a_dev, u_dev, rounds = out
        with self.obs.span("validate"):
            verdict = device_validate(a_dev, u_dev, dp, dn, self.pred_mask)
        if verdict is None:
            raise SolverResultInvalid(f"{tier}: shape")
        code, _count = verdict
        host = to_host(torch.cat([
            a_dev[: dp.valid.shape[0]].to(torch.int32), code[None],
            _rounds_tensor(rounds, code.device)]))
        assigned, code, rounds = np.asarray(host[:-2], np.int64), *host[-2:]
        if code:
            raise SolverResultInvalid(f"{tier}: {VALIDATE_REASONS[code]}")
        return assigned, u_dev, rounds

    def _solve_ladder(self, batch, dp, dn, ds, dt, dv, sv, extra_mask,
                      extra_score, skip_prio, no_ports, no_pod_aff,
                      no_spread, res):
        """Try the configured tier, then the greedy sequential oracle (the
        trust floor). A tier that raises a ``RuntimeError`` or returns a
        result the validator rejects falls through. A hand kernel that
        fails to build or launch raises ``kernels.KernelError``, which is
        not a solver fault: it propagates, so a broken kernel never hides
        behind the greedy tier's plain PyTorch scores. Returns ``(assigned_host, usage, rounds,
        tier)`` or None when every tier failed."""
        tiers = [self.solver] + (["greedy"] if self.solver != "greedy"
                                 else [])
        for i, tier in enumerate(tiers):
            try:
                with self.obs.span(f"solve:{tier}"):
                    out = self._run_tier(tier, batch, dp, dn, ds, dt, dv, sv,
                                         extra_mask, extra_score, skip_prio,
                                         no_ports, no_pod_aff, no_spread)
                    assigned, usage, rounds = self._validated_readback(
                        tier, out, dp, dn)
            except (SolverResultInvalid, RuntimeError) as e:
                klog.warning("solver tier %s failed (%s); falling back",
                             tier, e)
                if i + 1 < len(tiers):
                    res.solver_fallbacks += 1
                continue
            return assigned, usage, rounds, tier
        return None

    # -- pipelined cycle executor ------------------------------------------

    def _pipeline_eligible(self, batch, nominated) -> bool:
        """The pipelined executor covers the clean high-throughput path:
        features that need whole-batch host coupling (host or batch
        plugins, gang groups, nominated-pod pass A) keep the monolithic
        cycle. The reference's extender, scenario-pack and
        ``percentageOfNodesToScore`` checks hold trivially here: the port
        configures none of them. Depth 1 is the explicit off switch."""
        if self.pipeline_depth < 2 or self.pipeline_chunk < 1:
            return False
        if len(batch) <= self.pipeline_chunk:
            return False
        if self.solver not in TIERS or nominated:
            return False
        fw = self.framework
        if (fw.has_host_filters() or fw.has_host_scores()
                or fw.has_batch_filters() or fw.has_batch_scores()):
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

        ``dispatch`` never sheds a chunk: the reference's circuit breaker
        and cycle deadline are not ported yet (ROADMAP A.12). A chunk
        whose dispatch or readback fails re-solves through the full
        ladder; a ``KernelError`` is not a solver fault and propagates."""
        pk = self.cache.packer
        C = self.pipeline_chunk
        chunks = [batch[i:i + C] for i in range(0, len(batch), C)]
        res.pipeline_chunks = len(chunks)
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

        def pack_chunk(k):
            with self.obs.span(f"pipeline:pack@{k}", pods=len(chunks[k])):
                pt_c = pk.pack_pods(chunks[k])
                dp_c = pods_to_device(pt_c, pad_to=chunk_pad, device=dev)
                dv_c = sv_c = None
                if any(p.volumes for p in chunks[k]):
                    dv_c = volumes_to_device(
                        pk.pack_volume_tables(chunks[k]), device=dev)
                    sv_c = _static_vol_pass(dp_c, dn, ds, dv_c)
                return pt_c, dp_c, dv_c, sv_c

        def dispatch(k, packed, dn_in):
            """Queue chunk k's solve on the device; None when it failed
            to enqueue (the chunk then takes the ladder in settle)."""
            _pt_c, dp_c, dv_c, sv_c = packed
            with self.obs.span(f"pipeline:dispatch@{k}", tier=solver):
                try:
                    return self._run_tier(solver, chunks[k], dp_c, dn_in, ds,
                                          dt, dv_c, sv_c, None, None,
                                          skip_prio, no_ports, no_pod_aff,
                                          no_spread)
                except KernelError:
                    raise
                except (SolverResultInvalid, RuntimeError) as e:
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
            ts = self.clock()
            if out is not None:
                try:
                    with self.obs.span(f"pipeline:readback@{k}"):
                        a, u_dev, rounds = self._validated_readback(
                            solver, out, dp_c, dn_in)
                    res.rounds += rounds
                    solve_s += self.clock() - ts
                    return a[: len(chunk)].copy(), u_dev, solver
                except KernelError:
                    raise
                except (SolverResultInvalid, RuntimeError) as e:
                    klog.warning("pipelined chunk %d solve failed (%s); "
                                 "ladder", k, e)
            ladder = self._solve_ladder(chunk, dp_c, dn_in, ds, dt, dv_c,
                                        sv_c, None, None, skip_prio,
                                        no_ports, no_pod_aff, no_spread, res)
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
            rows = torch.tensor(failed_idx, dtype=torch.long, device=dev)
            reasons = fr.reasons.index_select(0, rows)
            ex = explain_reduce(
                reasons, dn_cur.valid,
                torch.ones((len(failed_idx),), dtype=torch.bool, device=dev),
                dp_c.req.index_select(0, rows),
                dn_cur.allocatable - dn_cur.requested, dn_cur.ready,
                dn_cur.network_unavailable)
            ex_h = read_back(ex)
            ex_parts.append(ex_h)
            rmat = None
            if self.enable_preemption:
                rows_dev = reasons[:, : nt.n]
                res.preempt_rows_bytes += (rows_dev.numel()
                                           * rows_dev.element_size())
                rmat = to_host(rows_dev)
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
            with self.obs.span("preemption"):
                self._run_preemption(batch, preempt_idx,
                                     [rmat_rows[g] for g in preempt_idx],
                                     node_order, res)
            res.preempt_s = time.perf_counter() - tp
        return self._finish(res, t0, syncs0)

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
        restricted-error."""
        klog.V(4).info("incremental state dropped: %s", reason)
        self._sk_warm_pot = None
        self._incr_active = False
        if self.cache.has_score_summary():
            self.cache.drop_score_summary()

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
        routes: a batch solver tier, no nominated pods, no framework
        plugin term, and no constraint class that couples across the
        whole node axis (ports and volumes; topology unless the batch
        gates prove it vacuous)."""
        if self.solver not in ("batch", "sinkhorn") or dn is None:
            return False
        if nominated:
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
        # the tuner sees the raw batch size before the bucket compare
        self._note_tuner_batch(len(batch))
        n_pad = dn.valid.shape[0]
        C = self._candidate_bucket(n_pad)
        if C >= n_pad or len(batch) > inc.max_batch_frac * C:
            return False
        if len(self.cache.last_patched_idx) > inc.max_dirty_frac * max(
                nt.n, 1):
            self._drop_incremental("dirty-frac")
            return False
        return True

    def _solve_frame(self, dp_f, sub_dn, ds, cand, skip_prio, sk_init=None,
                     warm=False):
        """One (P, C) frame: solve it with the stock solver, validate on
        the device, map the candidate-local rows to global node rows and
        read back the mapped rows, the verdict, the deepest frame position
        and the round count as ONE transfer. Returns ``(assigned (P_pad,) host,
        rounds, depth, potentials or None)``; raises SolverResultInvalid
        on a failed verdict."""
        inc = self.incremental
        out = batch_assign(
            dp_f, sub_dn, ds, self.weights, max_rounds=self.max_rounds,
            per_node_cap=self.per_node_cap, enabled_mask=self.pred_mask,
            use_sinkhorn=(self.solver == "sinkhorn"),
            skip_priorities=skip_prio, no_ports=True, no_pod_affinity=True,
            no_spread=True, sk_init=sk_init,
            sk_tol=(inc.warm_tol if warm else None), potentials_out=warm)
        a_local, u_local, rounds = out[:3]
        verdict = device_validate(a_local, u_local, dp_f, sub_dn,
                                  self.pred_mask)
        if verdict is None:
            raise SolverResultInvalid("frame: shape")
        code, _count = verdict
        a_local = a_local[: dp_f.valid.shape[0]].to(torch.int32)
        depth = torch.where(dp_f.valid & (a_local >= 0), a_local, -1).amax()
        host = to_host(torch.cat([
            map_restricted_assignment(a_local, cand),
            torch.stack([code.to(torch.int32), depth.to(torch.int32)]),
            _rounds_tensor(rounds, code.device)]))
        code, depth, rounds = host[-3:]
        if code:
            raise SolverResultInvalid(f"frame: {VALIDATE_REASONS[code]}")
        return (np.asarray(host[:-3], np.int64), rounds, depth,
                out[3] if warm else None)

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
                return None
        summary = self.cache.score_summary()
        if summary is None:
            return None
        n_pad = dn.valid.shape[0]
        C = self._candidate_bucket(n_pad)
        idxs = list(self.cache.last_patched_idx)
        dirty = torch.zeros((n_pad,), dtype=torch.bool, device=self.device)
        if idxs:
            dirty[torch.tensor(idxs, dtype=torch.long,
                               device=self.device)] = True
        # a lazy rebuild recomputed the whole summary: no reuse this cycle
        reuse = (0.0 if self.cache.last_summary_rebuilt
                 else max(0.0, 1.0 - len(idxs) / max(nt.n, 1)))
        warm = bool(inc.warm_potentials and self.solver == "sinkhorn")
        pot_key = (dp.valid.shape[0], C, self.cache.summary_generation)
        sk_init = None
        if warm and self._sk_warm_pot is not None \
                and self._sk_warm_pot[0] == pot_key:
            sk_init = self._sk_warm_pot[1]
        ts = self.clock()
        try:
            with self.obs.span("solve:restricted"):
                cand, sub_dn = gather_candidates(summary, dirty, dn, C)
                assigned, rounds, depth, pot = self._solve_frame(
                    dp, sub_dn, ds, cand, skip_prio, sk_init=sk_init,
                    warm=warm)
        except KernelError:
            raise
        except (SolverResultInvalid, RuntimeError) as e:
            klog.warning("restricted solve declined (%s); dense solve", e)
            self._drop_incremental("restricted-error")
            return None
        self._tuner_depth_max = max(self._tuner_depth_max, depth + 1)
        placed = assigned[: len(batch)]
        if (placed < 0).any():
            return None  # under-placed: the dense ladder decides
        if warm and pot is not None:
            self._sk_warm_pot = (pot_key, pot)
        self._incr_active = True
        res.rounds = rounds
        res.solver_tier = self.solver
        res.solve_scope = "restricted"
        res.reuse_frac = round(reuse, 4)
        res.solve_s = self.clock() - ts
        with self.obs.span("bind"):
            for i, pod in enumerate(batch):
                self._admit_pod(pod, node_order[int(placed[i])], cycle, res)
        if self.explain:
            # nothing failed the filter pass (everything placed), but the
            # admission tail's failures still get report rows
            self._build_explain_report(cycle, [], None, nt.n, res)
        return self._finish(res, t0, syncs0)

    def _cold_blocks(self, n_pad: int, C: int) -> int:
        """Blocks of the partitioned cold solve: ``cold_blocks``, or (0 =
        auto) the padded node bucket over C capped at 8; always clamped so
        that B * C fits the table."""
        b = self.incremental.cold_blocks or min(8, n_pad // max(C, 1))
        return max(min(b, n_pad // max(C, 1)), 0)

    def _partitioned_cold_eligible(self, batch, nominated, dn, dt, dv,
                                   no_ports, no_pod_aff, no_spread) -> bool:
        """May this cycle take the partitioned cold solve? ``primary`` on,
        the frame gates, no gang (its rollback wants the dense plane), and
        at least two blocks of C columns in the padded table."""
        inc = self.incremental
        if not (inc.enabled and inc.primary) or not batch:
            return False
        if not self._frame_gates_hold(batch, nominated, dn, dt, dv,
                                      no_ports, no_pod_aff, no_spread):
            return False
        if any(p.pod_group for p in batch):
            return False
        n_pad = dn.valid.shape[0]
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
        n_pad = dn.valid.shape[0]
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
        zeros_dirty = torch.zeros((n_pad,), dtype=torch.bool, device=dev)
        rounds = 0

        def take(got):
            for i in range(len(batch)):
                if pending[i] and got[i] >= 0:
                    assigned[i] = got[i]
                    pending[i] = False

        def pending_pods():
            return dp._replace(valid=dp.valid & torch.from_numpy(
                pending.copy()).to(dev))

        ts = self.clock()
        solve_span = self.obs.current_trace.begin_span("solve:partitioned",
                                                        blocks=B)
        try:
            blocks = partition_columns(summary, zeros_dirty, B, C)
            for b in range(B):
                if not pending[: len(batch)].any():
                    break
                got, r, _depth, _pot = self._solve_frame(
                    pending_pods(), gather_node_rows(dn, blocks[b]), ds,
                    blocks[b], skip_prio, warm=warm)
                rounds += r
                take(got)
            if pending[: len(batch)].any():
                # the remainder: one fresh top-C frame over the table with
                # every block placement debited (blocks were disjoint, so
                # this is where cross-block usage first meets)
                acc = np.full((P_pad,), -1, np.int64)
                acc[: len(batch)] = assigned
                acc_t = torch.from_numpy(acc).to(dev)
                u = _apply_batch(usage_from_nodes(dn), dp,
                                 acc_t.clamp_min(0),
                                 (acc_t >= 0) & dp.valid)
                dn_u = nodes_with_usage(dn, u)
                cand, sub_dn = gather_candidates(
                    node_summary(dn_u, **self._summary_flags), zeros_dirty,
                    dn_u, C)
                got, r, _depth, _pot = self._solve_frame(
                    pending_pods(), sub_dn, ds, cand, skip_prio, warm=warm)
                rounds += r
                take(got)
        except KernelError:
            raise
        except (SolverResultInvalid, RuntimeError) as e:
            klog.warning("partitioned cold solve declined (%s); dense "
                         "solve", e)
            return None
        finally:
            self.obs.current_trace.end_span(solve_span)
        if pending[: len(batch)].any():
            return None  # under-placed: the dense ladder decides
        res.rounds = rounds
        res.solver_tier = self.solver
        res.solve_scope = "partitioned"
        res.cold_blocks = B
        res.reuse_frac = 0.0
        res.solve_s = self.clock() - ts
        with self.obs.span("bind"):
            for i, pod in enumerate(batch):
                self._admit_pod(pod, node_order[int(assigned[i])], cycle,
                                res)
        if self.explain:
            self._build_explain_report(cycle, [], None, nt.n, res)
        return self._finish(res, t0, syncs0)

    # -- assume / bind -----------------------------------------------------

    def _admit_pod(self, pod: Pod, node_name: str, cycle: int,
                   res: CycleResult) -> None:
        """The per-pod admission tail for a PLACED pod: AssumePodVolumes →
        Reserve → cache assume → Permit → bind."""
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
        bs = fw.run_bind(st, pod, node_name)
        if bs.code == SKIP:
            try:
                self.binder.bind(pod, node_name)
            except Exception as e:  # noqa: BLE001 — binder boundary
                return reject(f"BindError:{e}")
        elif not bs.is_success():
            return reject(f"Bind:{bs.message}")
        self.cache.finish_binding(pod.key())
        self.queue.nominated.delete(pod)
        self.queue.backoff_map.clear_pod(pod.key())
        self.why_pending.pop(pod.key(), None)
        res.scheduled += 1
        res.assignments[pod.key()] = node_name
        res.e2e_latency_s[pod.key()] = max(
            self.clock() - getattr(pod, "queued_at", self.clock()), 0.0)
        fw.run_postbind(st, pod, node_name)
        self._cycle_states.pop(pod.key(), None)
        self.event_sink("Scheduled", pod, node_name)
        return True

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
        self._cycle_states.pop(pod.key(), None)
        self.queue.record_failure(pod)
        self.queue.add_unschedulable_if_not_present(pod, cycle)
        self.event_sink("FailedScheduling", pod,
                        message if message is not None else ",".join(reasons))
