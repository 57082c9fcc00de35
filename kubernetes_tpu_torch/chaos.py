"""Chaos harnesses for crash, failover and network-fault recovery (the
port of ``kubernetes_tpu/chaos.py``).

The fault injector proves the scheduler survives a *solver* that times
out, crashes, or lies. This module proves the *process* layer: the
scheduler can die at any instant — between ``binder.bind()`` committing
and ``cache.finish_binding()`` arming the TTL, mid-solve, between
cycles — and the system still upholds the invariant triple:

1. **no pod is ever double-bound** (the hub CAS is the truth floor;
   fenced binds + takeover reconciliation keep retries from even
   reaching it);
2. **no assumption is ever leaked** (every assumed pod either confirms
   via the watch or is forgotten by reconciliation / TTL reaping);
3. **every schedulable pod is eventually bound** (crashed-over pods
   requeue; nothing is stranded outside all queues).

:class:`CrashLoop` kills and restarts a single scheduler against one
shared hub, with :class:`SchedulerKilled` fired from seeded crash points
(``bind:pre`` / ``bind:post`` / ``solve:mid`` / ``cycle:pre``). Each kill
abandons the incarnation's torn local state — exactly like a SIGKILL —
and a fresh incarnation cold-starts: relist nodes, then
:meth:`Scheduler.reconcile` against the relisted pods.

:class:`HAReplica` is one member of a dual-scheduler failover pair:
elector (``LeaseLock`` CASing the hub), reflector-fed scheduler, and the
full recovery protocol attached (bind fence, takeover reconciliation
with a hub relist, stopped-leading drain).

The NETWORK layer has its own harness trio, deterministic under a seed:

- :class:`AmbiguousBinder` — the hub Binding RPC behind an injected
  network: ``rpc_error`` (definitely not committed), ``rpc_timeout``
  (AMBIGUOUS — the commit-coin decides whether the hub applied the bind
  before the response was lost), ``latency``. Counts every bind RPC that
  reaches the hub for an already-bound pod (``double_bind_attempts``) —
  the invariant the scheduler's read-your-write protocol must keep at 0.
- :class:`FuzzedCursor` — a watch stream that drops, duplicates and
  reorders frames, and can force 410/Compacted (the relist-storm
  trigger).
- :class:`NetChaos` — the composed run: a reflector-fed scheduler over
  the fuzzed stream, ambiguous binds, a mid-run relist storm, periodic
  resync relists, and the state-conservation auditor
  (:class:`~kubernetes_tpu_torch.obs.audit.StateAuditor`) run against
  the hub truth after EVERY cycle.

The hub is duck-typed: ``clock`` (callable, with ``advance``),
``binder`` (``bind`` with a CAS that raises on a stale view, and a
``conflicts`` count), ``sched`` (where the hub delivers watch events),
``truth_nodes`` / ``truth_pods``, ``add_node``, ``create_pod`` and
``bound_total``: the port's simulated cluster (``sim.HollowCluster``),
as in the reference, or any stand-in with that surface; the network
harnesses and ``HAReplica`` need the simulated cluster itself (its watch
cursors, compaction and lease). Schedulers the harnesses build run on
the card unless ``scheduler_kw={"device": "cpu"}`` asks otherwise.
:class:`MeshChaos` loses a shard of a mesh-backed scheduler mid-churn
(the loss -> host-mode cooloff -> sharded heal arc).
"""

from __future__ import annotations

import random
from typing import Dict, Optional

from kubernetes_tpu_torch.faults import RPCError, RPCTimeout
from kubernetes_tpu_torch.testing import make_node, make_pod


class SchedulerKilled(BaseException):
    """A hard process kill at an injected crash point.

    Derives from ``BaseException`` deliberately: every ``except
    Exception`` in the scheduler (bind-error rejects, the solver
    ladder's per-tier catch) must NOT be able to absorb it — the
    incarnation dies with whatever torn local state it had, exactly
    like a SIGKILL between two statements. Only the harness catches it.
    """


class CrashPlan:
    """Seeded crash-point decider shared by every kill site.

    ``fire(site)`` rolls the private RNG stream against ``kill_rate``
    for armed sites; total kills are bounded by ``max_kills`` so a run
    always terminates with a healthy tail that can converge."""

    def __init__(self, seed: int = 0, sites=("bind:pre", "bind:post",
                                             "solve:mid", "cycle:pre"),
                 kill_rate: float = 0.15, max_kills: int = 6) -> None:
        self.rng = random.Random(seed)
        self.sites = set(sites)
        self.kill_rate = kill_rate
        self.max_kills = max_kills
        self.kills = 0
        #: site -> kills fired there (assertable by the chaos tests)
        self.fired: Dict[str, int] = {}

    def fire(self, site: str) -> bool:
        if site not in self.sites or self.kills >= self.max_kills:
            return False
        if self.rng.random() >= self.kill_rate:
            return False
        self.kills += 1
        self.fired[site] = self.fired.get(site, 0) + 1
        return True


class KillingBinder:
    """Binder wrapper with the two bind-side crash windows:

    - ``bind:pre`` — killed before the hub commit: the assumption is
      held locally, nothing is durable. Restart must requeue and bind.
    - ``bind:post`` — killed AFTER ``confirm_binding`` committed at the
      hub but before the scheduler's ``finish_binding``/bookkeeping ran:
      the hub says bound, the dead incarnation's cache said "assumed,
      bind in flight". Restart must ADOPT, never re-bind (a re-bind
      would hit the hub CAS as "already assigned").
    """

    def __init__(self, inner, plan: CrashPlan) -> None:
        self.inner = inner
        self.plan = plan

    def bind(self, pod, node_name: str) -> None:
        if self.plan.fire("bind:pre"):
            raise SchedulerKilled(f"killed before hub commit of "
                                  f"{pod.key()} -> {node_name}")
        self.inner.bind(pod, node_name)
        if self.plan.fire("bind:post"):
            raise SchedulerKilled(f"killed after hub commit of "
                                  f"{pod.key()} -> {node_name}, before "
                                  "finish_binding")


class _KillingInjector:
    """Duck-typed FaultInjector exposing only the hooks the crash loop
    uses: ``solver_hook`` kills at ``solve:mid`` (a process death while
    the device result is in flight); the device seam stays quiet."""

    def __init__(self, plan: CrashPlan) -> None:
        self.plan = plan

    def solver_hook(self, site, assigned, usage, rounds, n_nodes):
        if self.plan.fire("solve:mid"):
            raise SchedulerKilled(f"killed mid-solve at {site}")
        return assigned, usage, rounds

    def device_hook(self, site):
        return None


class CrashLoop:
    """Kill/restart chaos against one shared hub.

    Drives successive ``Scheduler`` incarnations: each runs cycles
    until a seeded crash point fires (:class:`SchedulerKilled`), the
    torn incarnation is abandoned, and a fresh one cold-starts —
    relist nodes from truth, :meth:`Scheduler.reconcile` against the
    relisted pods — with the hub's watch feed re-pointed at it. After
    the kill budget is spent, the final incarnation converges and
    :meth:`run` asserts-by-report the invariant triple."""

    def __init__(self, hub, seed: int = 0, kill_rate: float = 0.2,
                 max_kills: int = 5, scheduler_kw: Optional[dict] = None,
                 ttl_s: float = 30.0) -> None:
        self.hub = hub
        self.plan = CrashPlan(seed=seed, kill_rate=kill_rate,
                              max_kills=max_kills)
        self.scheduler_kw = dict(scheduler_kw or {})
        self.ttl_s = ttl_s
        self.incarnations = 0
        self.sched = None

    def new_incarnation(self):
        """Cold-start a fresh scheduler against the shared hub: new
        cache/queue (the old process's memory is gone), the hub's watch
        feed re-pointed here, relist + reconcile before the first
        cycle."""
        from kubernetes_tpu_torch.cache import SchedulerCache
        from kubernetes_tpu_torch.scheduler import Scheduler

        hub = self.hub
        sched = Scheduler(
            binder=KillingBinder(hub.binder, self.plan),
            clock=hub.clock,
            cache=SchedulerCache(clock=hub.clock, ttl_s=self.ttl_s),
            enable_preemption=False,
            fault_injector=_KillingInjector(self.plan),
            **self.scheduler_kw,
        )
        # the hub delivers watch events to `hub.sched` at emit time —
        # re-pointing it is the "new process connected its informers"
        # step (the dead incarnation receives nothing, like a dead
        # process)
        hub.sched = sched
        for node in hub.truth_nodes.values():
            sched.on_node_add(node)
        sched.reconcile(list(hub.truth_pods.values()))
        self.incarnations += 1
        self.sched = sched
        return sched

    def run(self, n_pods: int = 32, n_nodes: int = 6,
            pod_cpu: float = 500.0, max_steps: int = 400) -> dict:
        """Create ``n_pods`` schedulable pods, then crash-loop until
        every one is bound (or ``max_steps`` cycles elapse). Returns the
        invariant report the chaos tests assert on."""
        hub = self.hub
        for i in range(n_nodes):
            hub.add_node(make_node(f"cl-n{i}", cpu_milli=16000,
                                   pods=max(n_pods, 110)))
        sched = self.new_incarnation()
        for i in range(n_pods):
            hub.create_pod(make_pod(f"cl-p{i}", cpu_milli=pod_cpu))
        steps = 0
        while steps < max_steps:
            steps += 1
            if self.plan.fire("cycle:pre"):
                # killed between cycles — consistent local state, but
                # the restart still must not re-bind anything
                sched = self.new_incarnation()
                continue
            try:
                sched.schedule_cycle()
            except SchedulerKilled:
                sched = self.new_incarnation()
                continue
            hub.clock.advance(0.5)
            if all(p.node_name for p in hub.truth_pods.values()):
                # drain the assume TTLs + settle the cache state machine
                hub.clock.advance(self.ttl_s + 1)
                sched.idle_tick()
                break
        bound = {k: p.node_name for k, p in hub.truth_pods.items()}
        return {
            "steps": steps,
            "incarnations": self.incarnations,
            "kills": self.plan.kills,
            "kill_sites": dict(self.plan.fired),
            # invariant 1: the hub committed each pod exactly once
            "bound_total": hub.bound_total,
            "n_pods": n_pods,
            "all_bound": all(bound.values()),
            "conflicts": hub.binder.conflicts,
            # invariant 2: nothing left assumed after convergence
            "leaked_assumptions": list(self.sched.cache.assumed_keys()),
            "bound": bound,
        }


#: the sites the composed network-fault load arms — the disarm half of
#: the phase window removes exactly these, leaving any other rules
#: (crash plans, device faults) untouched
NET_FAULT_SITES = ("rpc:bind", "rpc:get", "watch:event", "watch:batch")


class MeshChaos:
    """Shard-loss chaos for the sharded backend, arm-able mid-churn.

    Owns a :class:`~kubernetes_tpu_torch.faults.FaultInjector` wired into
    the scheduler's device seam (the scheduler's own, or one attached
    here) and arms a bounded ``shard_lost`` burst on demand: the next
    ``recovery.device_reset_limit + 1`` snapshots raise
    :class:`~kubernetes_tpu_torch.faults.ShardLost`, which exhausts the
    per-cycle rebuild budget and puts the scheduler on host-mode
    snapshots for ``device_cooloff_s``; after it the heal probe
    re-places the resident table on the mesh (the cache's ``set_mesh``
    seam). The fault surfaces inside ``_device_snapshot_recovering``,
    which falls back instead of raising out of the cycle, so a serving
    loop never stalls.

    Arming only appends to the injector's rule list, so a producer
    thread may arm without the ingest lock. :meth:`observe` takes each
    cycle's snapshot provenance; :meth:`report` sums up the arc."""

    def __init__(self, sched, shard: int = 0) -> None:
        from kubernetes_tpu_torch.faults import FaultInjector

        if sched.fault_injector is None:
            sched.fault_injector = FaultInjector(seed=0)
            # the cache hook is attached at construction; a late
            # injector needs the same seam
            if getattr(sched.cache, "fault_injector", "absent") is None:
                sched.cache.fault_injector = sched.fault_injector
        self.sched = sched
        self.injector = sched.fault_injector
        self.shard = shard
        self.lost_at: Optional[float] = None
        self.host_cycles = 0
        self.healed_at: Optional[float] = None
        self._was_lost = False

    def lose_shard(self, clock_now: Optional[float] = None) -> None:
        """Arm the loss: enough one-shot ``shard_lost`` faults at the
        snapshot seam to blow the rebuild budget in one cycle (the
        scheduler rebuilds ``device_reset_limit`` times, then cools off)."""
        shots = self.sched.recovery.device_reset_limit + 1
        self.injector.arm("snapshot:device", "shard_lost", count=shots,
                          shard=self.shard)
        self.lost_at = clock_now
        self._was_lost = True
        self.healed_at = None

    def observe(self, res, clock_now: Optional[float] = None) -> None:
        """Feed one CycleResult: counts host-mode cycles and stamps the
        heal (the first resident snapshot after a loss)."""
        if not self._was_lost or self.healed_at is not None:
            return
        if res.snapshot_mode == "host":
            self.host_cycles += 1
        elif res.snapshot_mode in ("full", "delta", "clean") \
                and self.host_cycles:
            self.healed_at = clock_now

    def report(self) -> dict:
        heal_s = None
        if self.healed_at is not None and self.lost_at is not None:
            heal_s = self.healed_at - self.lost_at
        return {
            "shard": self.shard,
            "shard_losses_fired": self.injector.fired_total(
                "snapshot:device"),
            "host_mode_cycles": self.host_cycles,
            "healed_sharded": self.healed_at is not None,
            "shard_heal_s": (round(heal_s, 3)
                             if heal_s is not None else None),
        }


def arm_net_fault_load(injector, bind_timeout_rate: float = 0.10,
                       bind_error_rate: float = 0.05,
                       get_timeout_rate: float = 0.08,
                       drop_rate: float = 0.04,
                       dup_rate: float = 0.06,
                       reorder_rate: float = 0.15) -> int:
    """Arm the full network-fault load (ambiguous bind timeouts, bind
    errors, read timeouts, watch drop/duplicate/reorder) on an EXISTING
    injector — the entry half of a soak phase's window;
    :func:`disarm_net_fault_load` is the exit half. A zero rate skips its
    rule. Returns the number of rules armed."""
    n0 = len(injector.rules)
    if bind_timeout_rate > 0:
        injector.arm("rpc:bind", "rpc_timeout", rate=bind_timeout_rate)
    if bind_error_rate > 0:
        injector.arm("rpc:bind", "rpc_error", rate=bind_error_rate)
    if get_timeout_rate > 0:
        injector.arm("rpc:get", "rpc_timeout", rate=get_timeout_rate)
    if dup_rate > 0:
        injector.arm("watch:event", "duplicate", rate=dup_rate)
    if drop_rate > 0:
        injector.arm("watch:event", "drop", rate=drop_rate)
    if reorder_rate > 0:
        injector.arm("watch:batch", "reorder", rate=reorder_rate)
    return len(injector.rules) - n0


def disarm_net_fault_load(injector) -> int:
    """Close the network-fault window: remove every rule on the
    :data:`NET_FAULT_SITES` sites (all kinds), whoever armed them. Other
    sites' rules survive. Returns rules removed."""
    return sum(injector.disarm(site) for site in NET_FAULT_SITES)


def raise_injected_rpc(injector, site: str) -> None:
    """Roll the injector at a read/GET RPC site: raise the injected
    :class:`~kubernetes_tpu_torch.faults.RPCError` / ``RPCTimeout``, or
    return for the caller to proceed (the verification GET rides the
    same faulty network as the bind it verifies, which is what exercises
    the parked path)."""
    out = injector.rpc_hook(site)
    if out is None:
        return
    kind = out[0]
    if kind == "rpc_error":
        raise RPCError(f"injected rpc error at {site}")
    if kind == "rpc_timeout":
        raise RPCTimeout(f"injected timeout at {site}")


class AmbiguousBinder:
    """The hub Binding RPC behind an injected network (site
    ``rpc:bind``). ``rpc_error`` raises BEFORE the hub acts;
    ``rpc_timeout`` rolls the rule's commit-coin, applies the bind at the
    hub iff it came up committed, then raises
    :class:`~kubernetes_tpu_torch.faults.RPCTimeout` either way — the
    caller can never tell the two apart, which is the whole point.

    ``double_bind_attempts`` counts bind RPCs that REACH the hub for an
    already-bound pod — the measured no-double-place invariant (a blind
    retry of a committed-but-timed-out bind lands here)."""

    def __init__(self, hub, injector, latency_sleep=None) -> None:
        self.hub = hub
        self.injector = injector
        #: None = never sleep (fake-clock runs); else time.sleep-like
        self.latency_sleep = latency_sleep
        self.double_bind_attempts = 0
        self.commits = 0
        self.binds_attempted = 0
        self.timeouts_committed = 0
        self.timeouts_uncommitted = 0
        self.rpc_errors = 0

    def _commit(self, pod, node_name: str) -> None:
        """Apply the bind at the truth (the override point for a
        different truth store). Counts a double-bind ATTEMPT (a bind RPC
        reaching the truth for an already-bound pod) before the CAS
        rejects it."""
        cur = self.hub.truth_pods.get(pod.key())
        if cur is not None and cur.node_name:
            self.double_bind_attempts += 1
        self.hub.confirm_binding(pod, node_name)
        self.commits += 1

    def bind(self, pod, node_name: str) -> None:
        self.binds_attempted += 1
        out = self.injector.rpc_hook("rpc:bind")
        if out is None:
            self._commit(pod, node_name)
            return
        kind, rule, committed = out
        if kind == "rpc_error":
            self.rpc_errors += 1
            raise RPCError("injected rpc error at rpc:bind (not committed)")
        if kind == "rpc_timeout":
            if committed:
                self.timeouts_committed += 1
                try:
                    self._commit(pod, node_name)
                except Exception:  # noqa: BLE001 — the answer is lost too
                    pass
            else:
                self.timeouts_uncommitted += 1
            raise RPCTimeout("injected ambiguous bind timeout at rpc:bind")
        if kind == "latency" and self.latency_sleep is not None:
            self.latency_sleep(rule.latency_s)
        self._commit(pod, node_name)


class FuzzedCursor:
    """Watch-stream fuzzer over a simulated cluster's watch cursor:
    consults the injector per frame (site ``watch:event``: ``drop`` /
    ``duplicate``) and per poll (site ``watch:batch``: ``reorder`` — a
    seeded shuffle — or ``compacted`` — a forced 410). The Reflector must
    make duplicates and reorders no-ops (resourceVersion-monotonic
    dedupe), heal drops through resync / stall relists, and absorb 410
    storms through its jittered relist backoff."""

    def __init__(self, inner, injector, seed: int = 0) -> None:
        self.inner = inner
        self.injector = injector
        self.rng = random.Random(seed)
        self.dropped = 0
        self.duplicated = 0
        self.reordered = 0
        self.forced_410 = 0

    @property
    def rev(self) -> int:
        return self.inner.rev

    def poll(self):
        from kubernetes_tpu_torch.sim import Compacted

        # the two batch kinds roll SEPARATELY: a 410 can hit any poll,
        # but a reorder rolls only when there are >= 2 frames to shuffle,
        # so a one-shot reorder rule is never burned on an empty poll
        if self.injector.pick("watch:batch",
                              kinds=("compacted",)) == "compacted":
            self.forced_410 += 1
            raise Compacted("injected watch 410 (relist storm)")
        events = self.inner.poll()
        out = []
        for e in events:
            kind = self.injector.pick("watch:event")
            if kind == "drop":
                self.dropped += 1
                continue
            out.append(e)
            if kind == "duplicate":
                self.duplicated += 1
                out.append(e)
        if len(out) > 1 and self.injector.pick(
                "watch:batch", kinds=("reorder",)) == "reorder":
            self.reordered += 1
            self.rng.shuffle(out)
        return out


class NetChaos:
    """Network-fault chaos against one simulated cluster: a reflector-fed
    scheduler whose bind RPCs time out ambiguously, whose watch stream
    drops / duplicates / reorders frames, and whose hub gets one forced
    relist storm mid-run — while the state-conservation auditor checks
    the invariant set against the hub truth after EVERY cycle.

    The run converges iff the ambiguous-bind protocol and the Reflector's
    hardening both work: every schedulable pod eventually bound, zero
    bind RPCs reaching the hub for an already-bound pod, zero auditor
    violations, nothing left assumed."""

    def __init__(self, hub, seed: int = 0,
                 bind_timeout_rate: float = 0.10,
                 bind_error_rate: float = 0.05,
                 get_timeout_rate: float = 0.08,
                 drop_rate: float = 0.04,
                 dup_rate: float = 0.06,
                 reorder_rate: float = 0.15,
                 progress_deadline_s: float = 4.0,
                 resync_every_s: float = 6.0,
                 scheduler_kw=None) -> None:
        from kubernetes_tpu_torch.faults import FaultInjector, RetryPolicy
        from kubernetes_tpu_torch.obs.audit import StateAuditor
        from kubernetes_tpu_torch.scheduler import Scheduler
        from kubernetes_tpu_torch.sim import Reflector

        self.hub = hub
        inj = FaultInjector(seed=seed)
        arm_net_fault_load(
            inj, bind_timeout_rate=bind_timeout_rate,
            bind_error_rate=bind_error_rate,
            get_timeout_rate=get_timeout_rate,
            drop_rate=drop_rate, dup_rate=dup_rate,
            reorder_rate=reorder_rate)
        self.injector = inj
        self.binder = AmbiguousBinder(hub, inj)

        def pod_reader(key):
            raise_injected_rpc(inj, "rpc:get")
            return hub.truth_pods.get(key)

        self.sched = Scheduler(
            binder=self.binder, clock=hub.clock, pod_reader=pod_reader,
            enable_preemption=False, retry_sleep=lambda _s: None,
            jitter_seed=seed, **(scheduler_kw or {}))
        self.auditor = self.sched.attach_auditor(StateAuditor())
        self.reflector = Reflector(
            hub, self.sched, clock=hub.clock,
            progress_deadline_s=progress_deadline_s,
            relist_backoff=RetryPolicy(base_s=0.5, max_s=4.0, jitter=0.5,
                                       seed=seed),
            cursor_wrap=lambda c: FuzzedCursor(c, inj, seed=seed))
        self.reflector.list_and_watch()
        self.resync_every_s = resync_every_s
        self.violations = []

    def relist_storm(self) -> None:
        """Force a 410 on the watch: compact the hub's history AND arm a
        one-shot ``compacted`` rule (a caught-up cursor sits exactly AT
        the compaction floor and would never trip it on its own) — the
        forced-410 storm every replica sees at once."""
        self.hub.compact(self.hub._revision)
        self.injector.arm("watch:batch", "compacted", count=1)

    def run(self, n_pods: int = 48, n_nodes: int = 8,
            pod_cpu: float = 500.0, max_steps: int = 400,
            storm_step: int = 12) -> dict:
        """Create ``n_pods`` schedulable pods (on ``n_nodes`` new nodes)
        and drive reflector-fed cycles under the armed network faults
        until every pod of the hub is bound and no ambiguous bind is left
        parked (or ``max_steps`` elapse); ``n_pods=0, n_nodes=0`` drives a
        hub the caller filled. Returns the invariant report."""
        hub = self.hub
        for i in range(n_nodes):
            hub.add_node(make_node(f"nc-n{i}", cpu_milli=16000,
                                   pods=max(n_pods, 110)))
        for i in range(n_pods):
            hub.create_pod(make_pod(f"nc-p{i}", cpu_milli=pod_cpu))
        steps = 0
        last_resync = hub.clock()
        converged = False
        while steps < max_steps:
            steps += 1
            if steps == storm_step:
                self.relist_storm()
            if hub.clock() - last_resync >= self.resync_every_s:
                # the SharedInformer resync period: the only healer for
                # selectively DROPPED frames
                self.reflector.list_and_watch()
                last_resync = hub.clock()
            self.reflector.pump()
            self.sched.schedule_cycle()
            self.violations.extend(self.auditor.audit(
                self.sched, truth_pods=list(hub.truth_pods.values())))
            hub.clock.advance(0.5)
            if all(p.node_name for p in hub.truth_pods.values()) \
                    and not self.sched._ambiguous_binds:
                converged = True
                break
        # settle: relist once more (heal dropped confirmations), drain
        # the TTLs, and two final truth audits so the two-strike checks
        # get their confirming pass on a stable state
        self.reflector.list_and_watch()
        hub.clock.advance(self.sched.cache.ttl_s + 1)
        self.sched.idle_tick()
        for _ in range(2):
            self.violations.extend(self.auditor.audit(
                self.sched, truth_pods=list(hub.truth_pods.values())))
        bound = {k: p.node_name for k, p in hub.truth_pods.items()}
        return {
            "steps": steps,
            "converged": converged,
            "n_pods": n_pods,
            "all_bound": all(bound.values()),
            "bound_total": hub.bound_total,
            "double_bind_attempts": self.binder.double_bind_attempts,
            "binds_attempted": self.binder.binds_attempted,
            "ambiguous_timeouts": (self.binder.timeouts_committed
                                   + self.binder.timeouts_uncommitted),
            "timeouts_committed": self.binder.timeouts_committed,
            "timeouts_uncommitted": self.binder.timeouts_uncommitted,
            "faults_fired": {f"{s}:{k}": n
                             for (s, k), n in self.injector.fired.items()},
            "watch_deduped": self.reflector.deduped,
            "relists": self.reflector.relists,
            "stalled_relists": self.reflector.stalled_relists,
            "invariant_violations": len(self.violations),
            "violations": [
                {"invariant": v.invariant, "subject": v.subject}
                for v in self.violations[:8]
            ],
            "leaked_assumptions": list(self.sched.cache.assumed_keys()),
            "parked_ambiguous": list(self.sched._ambiguous_binds),
        }


class HAReplica:
    """One member of a dual-scheduler failover pair: elector
    (``LeaseLock`` CASing the hub's coordination Lease), reflector-fed
    scheduler, and the full recovery protocol attached — the elector
    fences every bind, acquiring the lease reconciles against a hub
    relist, losing it drains in-flight state. ``kill()`` stops the
    replica cold (the lease decays; no graceful release), ``shutdown()``
    releases the lease like a clean SIGTERM."""

    def __init__(self, name: str, hub, le_config=None,
                 scheduler_kw: Optional[dict] = None) -> None:
        from kubernetes_tpu_torch.leaderelection import (
            LeaderElector,
            LeaseLock,
        )
        from kubernetes_tpu_torch.scheduler import Scheduler
        from kubernetes_tpu_torch.sim import Reflector

        self.name = name
        self.hub = hub
        self.sched = Scheduler(binder=hub.binder, clock=hub.clock,
                               enable_preemption=False,
                               **(scheduler_kw or {}))
        # clock wired so robustness.watchProgressDeadline (inherited from
        # the sink scheduler's config) can break a silently stalled watch
        self.reflector = Reflector(hub, self.sched, clock=hub.clock)
        self.reflector.list_and_watch()
        self.elector = LeaderElector(name, LeaseLock(hub), le_config,
                                     hub.clock)
        self.sched.attach_elector(
            self.elector, lister=lambda: list(hub.truth_pods.values()))
        self.dead = False
        self.cycles = 0

    def tick(self) -> bool:
        """One replica heartbeat: pump informers (leaders AND standbys run
        them), tick the elector, schedule while leading. Returns whether a
        cycle ran."""
        if self.dead:
            return False
        self.reflector.pump()
        if self.elector.tick():
            self.sched.schedule_cycle()
            self.cycles += 1
            return True
        return False

    def kill(self) -> None:
        """Hard death: stops ticking; the lease decays on its own."""
        self.dead = True

    def revive(self) -> None:
        self.dead = False

    def shutdown(self) -> None:
        """Clean SIGTERM: drain via the elector callbacks and release the
        lease so the standby takes over immediately."""
        self.dead = True
        self.elector.release()
