"""The scheduling loop — the batched analog of the reference's control
loop (``pkg/scheduler/scheduler.go:256`` Run / ``:462`` scheduleOne), on
PyTorch tensors (the port of ``kubernetes_tpu/scheduler.py``'s monolithic
cycle, ``pipeline_depth=1``).

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
      assigned = ladder(batch)                       # batch|sinkhorn -> greedy
      device_validate + ONE readback                 # verdict, rounds, rows
      for pod, node in assigned: assume, reserve, permit, bind
      for pod in unassigned: reasons, FitError text, requeue

Not ported yet (ROADMAP): the pipelined executor, warmup, preemption,
extenders, the restricted/partitioned routes, topology constraints,
explain reports, observability, leader fencing and the ambiguous-bind
protocol, the mesh, and the ``batch-single``/``batch-cpu``/``exact``
tiers.
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
from kubernetes_tpu_torch.framework import (
    SKIP,
    WAIT,
    CycleState,
    Framework,
)
from kubernetes_tpu_torch.ops.arrays import (
    pods_to_device,
    selectors_to_device,
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
from kubernetes_tpu_torch.ops.predicates import (
    decode_reasons,
    failure_counts,
    fit_error_message_from_counts,
    run_predicates,
    static_volume_reasons,
)
from kubernetes_tpu_torch.ops.priorities import solver_gates
from kubernetes_tpu_torch.ops.sync import SYNCS, to_host
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
    #: router's decision, the validated readback, failure reductions)
    host_syncs: int = 0


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
        self.queue.tick()
        self._reap_expired_assumptions()
        self._process_waiting(res)
        batch = self.queue.pop_batch(self.max_batch)
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
            return self._finish(res, t0, syncs0)

        # pack: pods first (their programs grow universes), then snapshot
        pk = self.cache.packer
        for p in batch:
            pk.intern_pod(p)
        nt, dn, res.snapshot_mode = self.cache.device_snapshot()
        node_order = self.cache.node_order()
        pt = pk.pack_pods(batch)
        skip_prio, no_ports, no_pod_aff, no_spread = solver_gates(nt, pt)
        if not (no_pod_aff and no_spread):
            for p in batch:
                self._cycle_states.pop(p.key(), None)
                self.queue.add_if_not_present(p)
            raise NotImplementedError(
                "topology: ROADMAP A.7 (inter-pod affinity / topology "
                "spread constraints are not ported yet)")
        dev = self.device
        dp = pods_to_device(pt, pad_to=bucket_size(max(len(batch), 1)),
                            device=dev)
        ds = selectors_to_device(pk.pack_selector_tables(), device=dev)
        dv = sv = None
        if any(p.volumes for p in batch):
            dv = volumes_to_device(pk.pack_volume_tables(batch), device=dev)
            sv = static_volume_reasons(dp, dn, ds, dv)

        extra_mask, extra_score, early_fail = self._plugin_terms(
            batch, dp, dn, ds, node_order)

        ts = self.clock()
        ladder = self._solve_ladder(batch, dp, dn, ds, dv, sv, extra_mask,
                                    extra_score, skip_prio, no_ports,
                                    no_pod_aff, no_spread, res)
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
            # must not linger as phantom occupancy in the reason pass
            pad = np.full((dp.valid.shape[0],), -1, np.int64)
            pad[: len(batch)] = assigned
            pad_t = torch.from_numpy(pad).to(dev)
            usage = _apply_batch(usage_from_nodes(dn), dp,
                                 pad_t.clamp_min(0), (pad_t >= 0) & dp.valid)

        # reasons for the unplaced: one filter pass against the final
        # usage, reduced on the device for exactly the failed rows
        failed_idx = [i for i, a in enumerate(assigned) if a < 0]
        counts = None
        if failed_idx:
            fr = run_predicates(dp, nodes_with_usage(dn, usage), ds, None,
                                dv, sv, self.pred_mask)
            rows = torch.tensor(failed_idx, dtype=torch.long, device=dev)
            counts = failure_counts(
                fr.reasons.index_select(0, rows), dn.valid,
                dp.req.index_select(0, rows), dn.allocatable - usage.requested,
                dn.ready, dn.network_unavailable)

        # bind the placed pods first: host work that overlaps the failure
        # reductions still running on the device
        for i, pod in enumerate(batch):
            if int(assigned[i]) >= 0:
                self._admit_pod(pod, node_order[int(assigned[i])], cycle, res)
        reasons_row: Dict[int, Tuple[str, ...]] = {}
        fit_msgs: Dict[int, str] = {}
        if counts is not None:
            host = to_host(torch.cat([
                counts["bits"][:, None], counts["per_reason"],
                counts["insufficient"], counts["not_ready"][:, None],
                counts["net_unavail"][:, None]], 1))
            n_b = counts["per_reason"].shape[1]
            n_r = counts["insufficient"].shape[1]
            res_names = (list(FIXED_RESOURCE_NAMES)
                         + pk.u.scalar_resources.items())[: pt.req.shape[1]]
            for j, i in enumerate(failed_idx):
                row = host[j]
                bits = int(row[0])
                reasons_row[i] = decode_reasons(bits)
                if bits:
                    fit_msgs[i] = fit_error_message_from_counts(
                        row[1:1 + n_b], row[1 + n_b:1 + n_b + n_r],
                        row[1 + n_b + n_r], row[2 + n_b + n_r], nt.n,
                        pt.req[i], res_names)
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
        return self._finish(res, t0, syncs0)

    def _finish(self, res: CycleResult, t0: float, syncs0: int):
        res.elapsed_s = self.clock() - t0
        res.host_syncs = SYNCS.count - syncs0
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

    # -- degradation ladder ------------------------------------------------

    def _run_tier(self, tier, batch, dp, dn, ds, dv, sv, extra_mask,
                  extra_score, skip_prio, no_ports, no_pod_aff, no_spread):
        """One solve attempt on one ladder tier: (assigned, usage, rounds).
        Exceptions propagate to the ladder."""
        if tier == "greedy":
            a, u = greedy_assign(
                dp, dn, ds, self.weights, extra_mask=extra_mask, vol=dv,
                static_vol=sv, enabled_mask=self.pred_mask,
                extra_score=extra_score, skip_priorities=skip_prio,
                no_ports=no_ports, no_pod_affinity=no_pod_aff,
                no_spread=no_spread)
            return a, u, len(batch)
        return batch_assign(
            dp, dn, ds, self.weights, max_rounds=self.max_rounds,
            per_node_cap=self.per_node_cap, extra_mask=extra_mask, vol=dv,
            static_vol=sv, enabled_mask=self.pred_mask,
            extra_score=extra_score, use_sinkhorn=(tier == "sinkhorn"),
            skip_priorities=skip_prio, no_ports=no_ports,
            no_pod_affinity=no_pod_aff, no_spread=no_spread)

    def _validated_readback(self, tier, out, dp, dn):
        """Validate one tier's result on the device and read the
        assignment back together with the verdict as ONE device-to-host
        copy. Returns ``(assigned_host, usage, rounds)`` or raises
        SolverResultInvalid with the host checker's reason vocabulary."""
        a_dev, u_dev, rounds = out
        verdict = device_validate(a_dev, u_dev, dp, dn, self.pred_mask)
        if verdict is None:
            raise SolverResultInvalid(f"{tier}: shape")
        code, _count = verdict
        host = to_host(torch.cat([a_dev[: dp.valid.shape[0]].to(
            torch.int32), code[None]]))
        assigned, code = np.asarray(host[:-1], np.int64), host[-1]
        if code:
            raise SolverResultInvalid(f"{tier}: {VALIDATE_REASONS[code]}")
        return assigned, u_dev, int(rounds)

    def _solve_ladder(self, batch, dp, dn, ds, dv, sv, extra_mask,
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
                out = self._run_tier(tier, batch, dp, dn, ds, dv, sv,
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
