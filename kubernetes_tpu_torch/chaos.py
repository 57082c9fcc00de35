"""Chaos harness for crash and restart recovery — the crash-loop half
of ``kubernetes_tpu/chaos.py``.

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

The hub is duck-typed: ``clock`` (callable, with ``advance``),
``binder`` (``bind`` with a CAS that raises on a stale view, and a
``conflicts`` count), ``sched`` (where the hub delivers watch events),
``truth_nodes`` / ``truth_pods``, ``add_node``, ``create_pod`` and
``bound_total``. The reference drives it with its simulated cluster
(``sim.HollowCluster``), which the port does not have yet (ROADMAP A.16).
Not ported yet: the mesh, network and HA-replica harnesses
(``MeshChaos``, ``NetChaos``, ``AmbiguousBinder``, ``FuzzedCursor``,
``HAReplica``), which need the simulated cluster, the mesh or the
ambiguous-bind protocol (ROADMAP A.14, A.16, A.17).
"""

from __future__ import annotations

import random
from typing import Dict, Optional

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
