"""Hollow-cluster simulation — the kubemark analog (SURVEY.md §4 item d:
"hollow-node-style simulation for end-to-end queue dynamics: churn,
backoff, preemption").

Where kubemark runs real kubelets with fake runtimes against a real
control plane, this harness runs the real scheduler (queue, cache,
solvers, preemption, volume state) against a simulated hub that owns the
source of truth and feeds the scheduler's event handlers exactly like an
informer pump: pod/node create/delete churn, flaky bindings, node
flapping, replica controllers maintaining workloads. The cache-vs-truth
comparer (``debugger.compare``) is the consistency oracle after every
step.

The hub is an optimistic-concurrency store, not a plain dict (the single
most important architectural fact of the reference, SURVEY.md §1):

- every object write bumps a global revision and the object's
  resourceVersion (etcd3/store.go:236 GuaranteedUpdate);
- the Binding subresource is a CAS: it fails with :class:`Conflict` if
  the pod is gone, was recreated (uid mismatch), or already has a node
  (registry/core/pod/storage/storage.go:154 BindingREST.Create →
  assignPod);
- watch events can be DELAYED (``event_delay_ticks``): the scheduler then
  acts on stale state and its writes hit conflicts, exactly like a real
  informer lagging etcd — per-object event order is always preserved,
  like a real watch stream;
- a competing writer (``competing_bind_rate``) binds pending pods behind
  the scheduler's back — the HA-peer / external-controller race.

The port's copy of ``kubernetes_tpu/sim.py``, with the imports rewired.
The hub builds the port's :class:`~kubernetes_tpu_torch.scheduler.Scheduler`,
which runs on the card unless ``scheduler_kw={"device": "cpu"}`` asks for
the plain PyTorch path (without a card the default raises). Nothing here
catches a kernel fault: a ``KernelError`` from the scheduler's cycle ends
:meth:`HollowCluster.step`.
"""

from __future__ import annotations

import bisect
import heapq
import random
import threading
import weakref
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from kubernetes_tpu_torch.admission import (
    NS_ACTIVE,
    NS_TERMINATING,
    AdmissionError,
    Namespace,
    QuotaController,
    default_chain,
)
from kubernetes_tpu_torch.api.types import (
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    Node,
    OwnerReference,
    Pod,
    Taint,
    Toleration,
)
from kubernetes_tpu_torch.cloud import CloudNodeController
from kubernetes_tpu_torch.debugger import compare
from kubernetes_tpu_torch.proxy import (
    ClusterIPAllocator,
    EndpointsController,
    NodePortAllocator,
    ServiceProxy,
)
from kubernetes_tpu_torch.scheduler import Scheduler
from kubernetes_tpu_torch.testing import (
    make_node,
    make_pod,
    node_affinity_required,
    req,
)


class Conflict(Exception):
    """Optimistic-concurrency write rejection (apierrors.IsConflict)."""


class Compacted(Exception):
    """Watch cursor fell behind the compaction floor — the etcd
    ErrCompacted ("required revision has been compacted") that forces a
    client-go Reflector relist (reflector.go ListAndWatch error path)."""


class SimClock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class FlakyBinder:
    """Binder whose RPC fails with probability ``fail_rate`` — exercising
    the Forget-and-requeue path (scheduler.go:447). Hub-side CAS
    rejections (:class:`Conflict`) propagate through the same surface."""

    def __init__(self, hub: "HollowCluster", fail_rate: float, rng) -> None:
        self.hub = hub
        self.fail_rate = fail_rate
        self.rng = rng
        self.failures = 0
        self.conflicts = 0

    def bind(self, pod: Pod, node_name: str) -> None:
        if self.rng.random() < self.fail_rate:
            self.failures += 1
            raise RuntimeError("simulated bind RPC failure")
        try:
            self.hub.confirm_binding(pod, node_name)
        except Conflict:
            self.conflicts += 1
            raise


@dataclass
class ReplicaSet:
    """A hollow controller: keeps ``replicas`` pods named ``{name}-i``
    alive (recreating deleted ones with fresh uids), the way the
    replicaset controller reconciles."""

    name: str
    replicas: int
    cpu_milli: float = 100
    memory: float = 256 * 2**20
    priority: int = 0
    next_idx: int = 0
    live: Dict[str, Pod] = field(default_factory=dict)
    #: owning Deployment name ("" = standalone) — the ownerReference the
    #: GC pass consults (never inferred from the name)
    owner: str = ""
    #: owning Deployment's template revision this RS realizes (the
    #: pod-template-hash analog); orders old RSes during a rollout
    revision: int = 0
    #: "ReplicaSet" or "ReplicationController" — the reference's RC
    #: controller IS the ReplicaSet controller behind conversion
    #: adapters (pkg/controller/replication/replication_controller.go:58
    #: wraps replicaset.NewBaseController); the kind only changes the
    #: ownerReference stamped on pods and the API group it serves under
    kind: str = "ReplicaSet"


@dataclass
class ServiceAccount:
    """v1.ServiceAccount slice: the identity object the serviceaccounts
    controller guarantees per namespace and the tokens controller mints
    credentials for (pkg/controller/serviceaccount)."""

    name: str
    namespace: str = "default"

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class Attachment:
    """Attach-detach controller actual-state record
    (volume/attachdetach/cache/actual_state_of_world.go): one volume
    attached to one node; ``detaching`` + ``detach_at`` model the
    grace window before the reconciler issues the detach."""

    volume: str
    node: str
    state: str = "attached"  # "attached" | "detaching"
    detach_at: float = 0.0


@dataclass
class Deployment:
    """Hollow deployment controller (pkg/controller/deployment): one
    ReplicaSet per template revision. A template change (:meth:`rollout`)
    bumps the revision; the sync then surges the new RS up and drains the
    old ones under the maxSurge/maxUnavailable budget — the RollingUpdate
    reconciliation of rolling.go:31 (reconcileNewReplicaSet /
    reconcileOldReplicaSets), with "available" = bound in this hollow
    world. ``max_surge``/``max_unavailable`` take ints or "25%" strings
    (intstr.GetValueFromIntOrPercent: surge rounds up, unavailable
    rounds down)."""

    name: str
    replicas: int
    cpu_milli: float = 100
    memory: float = 256 * 2**20
    priority: int = 0
    #: "RollingUpdate" (default) or "Recreate" (deployment strategy,
    #: apps/v1 DeploymentStrategy: Recreate kills ALL old pods before
    #: any new one exists — downtime traded for never-mixed versions)
    strategy: str = "RollingUpdate"
    max_surge: object = 1
    max_unavailable: object = 1
    template_rev: int = 0

    def __post_init__(self):
        # apps/v1 validation rejects unknown strategy values; a typo'd
        # "recreate" silently rolling (and MIXING versions) would be the
        # exact failure Recreate exists to prevent
        if self.strategy not in ("RollingUpdate", "Recreate"):
            raise ValueError(
                f"Deployment.strategy must be 'RollingUpdate' or "
                f"'Recreate', got {self.strategy!r}"
            )
        # apps/v1 validation also rejects maxSurge=0 AND maxUnavailable=0
        # (validation.go ValidateDeploymentStrategy) — but only as
        # LITERAL values: a percentage that merely rounds to 0 at the
        # current replica count is legal there and coerced at sync time
        # (ResolveFenceposts), so the constructor matches that split
        if self.strategy == "RollingUpdate":
            def _literal_zero(v):
                return v in (0, "0", "0%")

            if _literal_zero(self.max_surge) and _literal_zero(
                    self.max_unavailable):
                raise ValueError(
                    "Deployment maxSurge and maxUnavailable cannot both "
                    "be 0 (the rollout could never progress)"
                )

    def rs_name(self) -> str:
        """Name of the CURRENT revision's ReplicaSet."""
        return f"{self.name}-rs-{self.template_rev}"

    def rollout(self, cpu_milli=None, memory=None, priority=None) -> None:
        """Change the pod template -> new revision (the spec update that
        triggers deployment_controller.go getNewReplicaSet + rolling)."""
        if cpu_milli is not None:
            self.cpu_milli = cpu_milli
        if memory is not None:
            self.memory = memory
        if priority is not None:
            self.priority = priority
        self.template_rev += 1


def _int_or_percent(v, total: int, round_up: bool) -> int:
    """intstr.GetValueFromIntOrPercent (apimachinery util/intstr): "25%"
    resolves against ``total``, surge rounds up, unavailable down."""
    import math

    if isinstance(v, str) and v.endswith("%"):
        f = float(v[:-1]) / 100.0 * total
        return int(math.ceil(f) if round_up else math.floor(f))
    return int(v)


@dataclass
class Job:
    """Hollow job controller (pkg/controller/job): keeps up to
    ``parallelism`` active pods until ``completions`` pods have run for
    ``duration_s`` each (the hollow runtime "finishes" them — the
    run-to-completion lifecycle the scheduler must keep feeding)."""

    name: str
    completions: int
    parallelism: int = 1
    duration_s: float = 30.0
    cpu_milli: float = 100
    memory: float = 256 * 2**20
    next_idx: int = 0
    succeeded: int = 0
    active: Dict[str, Pod] = field(default_factory=dict)
    #: owning CronJob name ("" = standalone) — the ownerReference edge
    #: the GC graph walks (cronjob-spawned jobs cascade on its deletion)
    owner: str = ""
    #: spec.ttlSecondsAfterFinished (batch/v1 JobSpec): when set, the
    #: TTL-after-finished controller deletes the Job this many seconds
    #: after it finishes (ttlafterfinished_controller.go:263 needsCleanup:
    #: finished AND ttl non-nil). None = keep forever (the default).
    ttl_seconds_after_finished: Optional[float] = None
    #: status.completionTime analog — stamped by the job sync on the tick
    #: ``done()`` first becomes true; the TTL clock starts here, not at
    #: the last pod's exit (timeLeft computes expiry from CompletionTime,
    #: ttlafterfinished_controller.go:277).
    finished_at: Optional[float] = None

    def done(self) -> bool:
        return self.succeeded >= self.completions


#: the tolerations the daemonset controller stamps on every daemon pod
#: (pkg/controller/daemon/util AddOrUpdateDaemonPodTolerations): NoExecute
#: outage taints never evict daemons, and the NoSchedule condition taints
#: (TaintNodesByCondition) don't keep them out
DAEMON_TOLERATIONS = (
    Toleration(key="node.kubernetes.io/unreachable", operator="Exists",
               effect=EFFECT_NO_EXECUTE),
    Toleration(key="node.kubernetes.io/not-ready", operator="Exists",
               effect=EFFECT_NO_EXECUTE),
    Toleration(key="node.kubernetes.io/unschedulable", operator="Exists",
               effect=EFFECT_NO_SCHEDULE),
    Toleration(key="node.kubernetes.io/disk-pressure", operator="Exists",
               effect=EFFECT_NO_SCHEDULE),
    Toleration(key="node.kubernetes.io/memory-pressure", operator="Exists",
               effect=EFFECT_NO_SCHEDULE),
    Toleration(key="node.kubernetes.io/pid-pressure", operator="Exists",
               effect=EFFECT_NO_SCHEDULE),
)


@dataclass
class DaemonSet:
    """Hollow daemonset controller (pkg/controller/daemon). v1.16 default
    (ScheduleDaemonSetPods GA'd that cycle, daemon_controller.go): daemon
    pods flow through the DEFAULT scheduler, pinned to their node by
    required node affinity — the reference pins on the metadata.name
    field selector; our columnar packer interns the equivalent
    ``kubernetes.io/hostname`` label every node carries, so the pin is a
    hostname In-term. Pods carry :data:`DAEMON_TOLERATIONS` so the
    node-lifecycle NoExecute taint path leaves them in place."""

    name: str
    cpu_milli: float = 50
    memory: float = 128 * 2**20
    priority: int = 0
    #: node-eligibility selector (spec.template.spec.nodeSelector);
    #: empty = every node
    node_selector: Dict[str, str] = field(default_factory=dict)
    #: pod key -> node name it is pinned to
    live: Dict[str, str] = field(default_factory=dict)
    #: current template revision (the controller-revision-hash analog;
    #: daemon pods carry it as a label) — bumped by :meth:`rollout`
    template_rev: int = 1
    #: RollingUpdate maxUnavailable (update.go:48 — v1.16 default 1):
    #: at most this many nodes may be without a CURRENT-revision daemon
    #: pod due to the update at once
    max_unavailable: int = 1
    #: (revision, template) pairs not yet drained into the hub's
    #: ControllerRevision registry — rollout() records SYNCHRONOUSLY
    #: here so a revision current for zero reconcile passes (two
    #: rollouts between ticks) is never lost from history
    pending_revisions: List[Tuple[int, Dict]] = field(default_factory=list)

    def rollout(self, cpu_milli=None, memory=None, priority=None) -> None:
        """Template update (apps/v1 RollingUpdate updateStrategy): stale
        daemon pods are replaced node by node under max_unavailable; the
        history pass records a ControllerRevision per template."""
        self.pending_revisions.append((self.template_rev, self.template()))
        if cpu_milli is not None:
            self.cpu_milli = cpu_milli
        if memory is not None:
            self.memory = memory
        if priority is not None:
            self.priority = priority
        self.template_rev += 1

    def template(self) -> dict:
        return {"cpu_milli": self.cpu_milli, "memory": self.memory,
                "priority": self.priority}

    def should_keep(self, node: Node) -> bool:
        """v1.16 shouldContinueRunning: an existing daemon pod stays
        unless the node left the selector or carries an untolerated
        NoExecute taint — outage (NotReady) and cordon do NOT evict
        daemons (daemon_controller.go nodeShouldRunDaemonPod)."""
        if not all(node.labels.get(k) == v
                   for k, v in self.node_selector.items()):
            return False
        return not any(
            t.effect == EFFECT_NO_EXECUTE
            and not any(tol.tolerates(t) for tol in DAEMON_TOLERATIONS)
            for t in node.taints
        )

    def can_place(self, node: Node) -> bool:
        """v1.16 shouldSchedule: create a NEW daemon pod only where our
        scheduler would actually place it. Deviation from the reference:
        this hub models cordon/pressure/not-ready as spec+condition bits
        which the predicates enforce regardless of tolerations (the
        reference's TaintNodesByCondition taint form is what the daemon
        tolerations bypass), so such nodes are deferred — the next sync
        after recovery creates the pod — instead of parked-on forever."""
        if not self.should_keep(node):
            return False
        if node.unschedulable or node.conditions.disk_pressure \
                or node.conditions.pid_pressure \
                or not node.conditions.ready \
                or node.conditions.network_unavailable:
            return False
        return not any(
            t.effect == EFFECT_NO_SCHEDULE
            and not any(tol.tolerates(t) for tol in DAEMON_TOLERATIONS)
            for t in node.taints
        )


@dataclass
class StatefulSet:
    """Hollow statefulset controller (pkg/controller/statefulset,
    OrderedReady pod management — stateful_set_control.go): ordinal i is
    created only once 0..i-1 are bound (the hollow Running+Ready);
    scale-down removes the highest ordinal first, one per sync; a deleted
    middle ordinal is recreated under the SAME name (stable identity)
    with a fresh apiserver-assigned uid."""

    name: str
    replicas: int
    cpu_milli: float = 100
    memory: float = 256 * 2**20
    priority: int = 0
    #: current template revision (updateRevision); pods carry it as the
    #: controller-revision-hash label analog
    template_rev: int = 1
    #: status.currentRevision: the revision BELOW-partition pods are
    #: recreated at (the canary boundary's other half — reference
    #: recreates them at currentRevision, not updateRevision); advanced
    #: to template_rev when the rollout completes
    current_rev: int = 1
    #: RollingUpdate partition (stateful_set_control.go: only ordinals
    #: >= partition update; a canary knob — 0 = update everything)
    partition: int = 0
    #: see DaemonSet.pending_revisions
    pending_revisions: List[Tuple[int, Dict]] = field(default_factory=list)

    def pod_name(self, ordinal: int) -> str:
        return f"{self.name}-{ordinal}"

    def rollout(self, cpu_milli=None, memory=None, priority=None) -> None:
        """Template update (apps/v1 RollingUpdate): stale pods with
        ordinal >= partition are replaced highest-first, one per sync,
        each waiting for its successor to run (OrderedReady)."""
        self.pending_revisions.append((self.template_rev, self.template()))
        if cpu_milli is not None:
            self.cpu_milli = cpu_milli
        if memory is not None:
            self.memory = memory
        if priority is not None:
            self.priority = priority
        self.template_rev += 1

    def template(self) -> dict:
        return {"cpu_milli": self.cpu_milli, "memory": self.memory,
                "priority": self.priority}


@dataclass
class ControllerRevision:
    """apps/v1 ControllerRevision (pkg/controller/history): an immutable
    template snapshot DS/STS updates key on — the rollback target
    `kubectl rollout undo` resolves. ``data`` is the hollow template
    (cpu/memory/priority)."""

    owner_kind: str
    owner_name: str
    revision: int
    data: Dict = field(default_factory=dict)

    def key(self) -> str:
        return f"{self.owner_kind}/{self.owner_name}/{self.revision}"


@dataclass
class CronJob:
    """Hollow cronjob controller (pkg/controller/cronjob): spawns a Job
    every ``every_s`` sim-seconds. concurrencyPolicy semantics from
    cronjob_controller.go syncOne: Allow runs jobs side by side, Forbid
    skips a tick while the previous job is active, Replace deletes the
    active job's pods and starts fresh. Finished jobs beyond
    ``history_limit`` are GC'd (successfulJobsHistoryLimit)."""

    name: str
    every_s: float
    completions: int = 1
    parallelism: int = 1
    duration_s: float = 15.0
    concurrency: str = "Allow"  # Allow | Forbid | Replace
    history_limit: int = 3
    cpu_milli: float = 100
    memory: float = 256 * 2**20
    next_run: float = 0.0
    runs: int = 0
    #: job names spawned by this cron, oldest first
    spawned: List[str] = field(default_factory=list)


@dataclass
class HorizontalPodAutoscaler:
    """Hollow HPA (pkg/controller/podautoscaler horizontal.go): scales a
    Deployment between min/max replicas toward
    desired = ceil(current * currentUtilization / target), with the 10%
    tolerance dead-band (GetResourceReplicas, replica_calculator.go:89).
    The hollow metric source is ``load_fn`` — a callable returning the
    current average utilization (the sim's stand-in for the metrics
    pipeline the reference scrapes)."""

    name: str
    deployment: str
    min_replicas: int
    max_replicas: int
    target_utilization: float = 0.5
    load_fn: Optional[Callable[[], float]] = None
    tolerance: float = 0.1


class HollowKubelet:
    """Per-node hollow node agent — the kubemark hollow-node analog
    (pkg/kubemark/hollow_kubelet.go:44: real kubelet logic, fake
    runtime), covering the slice of pkg/kubelet the scheduler's
    correctness depends on:

    - **admission** (lifecycle/predicate.go GeneralPredicates at
      arrival): the apiserver accepts double-booked bindings, so two
      schedulers racing on stale views CAN overcommit a node in truth;
      this kubelet admits bound pods in binding-arrival order
      (resourceVersion) and evicts the over-committed tail (OutOfcpu),
      whose controllers then recreate them;
    - **node-status heartbeats** (kubelet_node_status.go): refreshed
      every sync while alive; the node-lifecycle controller CONSUMES the
      age (it never refreshes — killing this kubelet is how the
      unreachable-taint path is exercised);
    - **pressure conditions** (eviction-manager thresholds): memory
      usage beyond ``mem_pressure_frac`` of allocatable reports
      MemoryPressure in node status (MODIFIED event), which the
      scheduler's CheckNodeMemoryPressure then enforces against
      BestEffort pods.
    """

    def __init__(self, hub: "HollowCluster", node_name: str,
                 mem_pressure_frac: float = 0.95) -> None:
        self.hub = hub
        self.name = node_name
        self.alive = True
        self.mem_pressure_frac = mem_pressure_frac

    def pods(self) -> List[Pod]:
        """Live (non-terminal) pods bound here — a Succeeded pod's
        containers have exited, so it holds no resources and exerts no
        memory pressure (the kubelet's podWorkers have released it)."""
        from kubernetes_tpu_torch.api.types import is_pod_terminated

        return [p for p in self.hub.truth_pods.values()
                if p.node_name == self.name and not is_pod_terminated(p)]

    def heartbeat(self) -> None:
        if self.alive:
            self.hub.heartbeats[self.name] = self.hub.clock.t

    def admit(self, keys: Optional[List[str]] = None) -> None:
        """GeneralPredicates at arrival; evict the over-committed tail in
        binding order (latest bindings lose, like late OutOfcpu arrivals).
        ``keys`` lets the hub pass a pre-grouped pod list (one O(P) pass
        for all nodes instead of one scan per node)."""
        from kubernetes_tpu_torch.api.types import is_pod_terminated

        nd = self.hub.truth_nodes.get(self.name)
        if nd is None:
            return
        if keys is None:
            keys = [k for k, p in self.hub.truth_pods.items()
                    if p.node_name == self.name]
        # terminal pods have released their resources (podWorker done) —
        # they neither consume the budget nor get evicted by it
        keys = [k for k in keys
                if not is_pod_terminated(self.hub.truth_pods[k])]
        keys = sorted(
            keys, key=lambda k: self.hub.resource_version.get(f"pods/{k}", 0))
        cpu = mem = cnt = 0.0
        for k in keys:
            p = self.hub.truth_pods[k]
            cpu += p.requests.cpu_milli
            mem += p.requests.memory
            cnt += 1
            if (
                cpu > nd.allocatable.cpu_milli + 1e-6
                or mem > nd.allocatable.memory + 1e-6
                or cnt > nd.allocatable.pods
            ):
                self.hub.delete_pod(k)
                cpu -= p.requests.cpu_milli
                mem -= p.requests.memory
                cnt -= 1

    def update_conditions(self) -> None:
        """Report MemoryPressure when usage crosses the eviction-manager
        threshold; clear it when usage recedes. Status writes go through
        the hub (a node MODIFIED watch event, like a real status PATCH)."""
        import dataclasses

        nd = self.hub.truth_nodes.get(self.name)
        if nd is None or not self.alive:
            return
        used_mem = sum(p.requests.memory for p in self.pods())
        pressured = used_mem > self.mem_pressure_frac * max(
            nd.allocatable.memory, 1e-9
        )
        if pressured != nd.conditions.memory_pressure:
            self.hub._update_node(dataclasses.replace(
                nd,
                conditions=dataclasses.replace(
                    nd.conditions, memory_pressure=pressured
                ),
            ))

    def sync(self) -> None:
        """One syncLoop iteration (kubelet.go:1816 analog, hollow).
        Admission is NOT repeated here — the hub's kubelet_admission pass
        (run from gc_orphaned every tick) already enforced it with one
        grouped scan."""
        self.heartbeat()
        if self.alive:
            self.update_conditions()


class HollowCluster:
    """Owns the truth (pods/nodes) behind a versioned store and pumps
    watch events at the scheduler. All scheduler interaction goes through
    the event-handler surface, like the reference's AddAllEventHandlers
    wiring; all hub writes go through :meth:`_commit`, the GuaranteedUpdate
    analog."""

    def __init__(
        self,
        seed: int = 0,
        bind_fail_rate: float = 0.0,
        scheduler_kw: Optional[dict] = None,
        event_delay_ticks: int = 0,
        competing_bind_rate: float = 0.0,
        node_grace_s: float = 40.0,
        eviction_wait_s: float = 30.0,
        zone_eviction_rate: int = 1000,
        admission: bool = False,
    ) -> None:
        self.rng = random.Random(seed)
        #: serializes hub mutation against concurrent readers (the REST
        #: facade shares this lock; re-entrant because step() nests hub
        #: calls). The sim itself is single-threaded — the lock exists
        #: for the serving facades.
        self.lock = threading.RLock()
        self.clock = SimClock()
        self.truth_pods: Dict[str, Pod] = {}  # key -> pod (node_name = truth)
        self.truth_nodes: Dict[str, Node] = {}
        #: per-object resourceVersion (etcd mod_revision analog)
        self.resource_version: Dict[str, int] = {}
        self._revision = 0  # global etcd revision
        #: coordination Leases ("ns/name" -> opaque record) — leader
        #: election CASes these through the hub (resourcelock
        #: interface.go:100); see get_lease/cas_lease
        self.leases: Dict[str, object] = {}
        #: volume API truth ("ns/name" -> PVC, name -> PV/StorageClass):
        #: owned by the hub so the PV controller pass (reconcile_volumes,
        #: pv_controller.go:236) and the scheduler's volume binder both
        #: write through the versioned store
        self.pvcs: Dict[str, object] = {}
        self.pvs: Dict[str, object] = {}
        self.storage_classes: Dict[str, object] = {}
        #: service accounts + minted bearer tokens (the serviceaccounts
        #: controller guarantees a "default" SA per Active namespace;
        #: the tokens controller mints one token per SA —
        #: tokens_controller.go:73). Tokens are REVOCABLE: namespace
        #: termination deletes its SAs and their tokens, and the live
        #: lookup (sa_token_user) answers None immediately.
        self.service_accounts: Dict[str, ServiceAccount] = {}
        self.sa_tokens: Dict[str, str] = {}  # token -> "ns/name"
        #: rbac.authorization.k8s.io: ClusterRoles (name -> auth.
        #: ClusterRole) + ClusterRoleBindings; the aggregation
        #: controller pass materializes aggregated roles' rules, and
        #: auth.RBACAuthorizer(self.cluster_roles,
        #: self.cluster_role_bindings) resolves them LIVE
        self.cluster_roles: Dict[str, object] = {}
        self.cluster_role_bindings: List = []
        #: certificates.k8s.io: CSR objects + the live credential
        #: registry the authn chain consults (cert -> (UserInfo,
        #: not_after)); expired certs leave the registry — lookup-time
        #: NotAfter (kubernetes_tpu_torch/certificates.py)
        self.csrs: Dict[str, object] = {}
        self.signed_certs: Dict[str, tuple] = {}
        self.cluster_ca = f"ktpu-ca:{seed}"
        #: ConfigMaps ("ns/name" -> {"data": {...}}) — enough surface
        #: for the root-CA publisher; namespace drain removes them
        self.configmaps: Dict[str, dict] = {}
        #: TTL controller hysteresis step (ttl_controller.go boundaryStep)
        self._ttl_step = 0
        #: nodeipam range allocator: cluster CIDR carved into per-node
        #: blocks ("/8 + /24" covers 65536 nodes — the 50k story fits)
        self.cluster_cidr = "10.0.0.0/8"
        self.node_cidr_prefix = 24
        self._cidr_subnets = None  # lazy (ip_network parse on first use)
        self._cidr_alloc: Dict[str, int] = {}
        self._cidr_next = 0
        self._cidr_free: List[int] = []
        self.cidr_exhausted_total = 0
        #: attach-detach controller actual state (attach_detach_
        #: controller.go:102): volume identity -> Attachment. All
        #: attachable volumes are treated single-attach (the PV model
        #: carries no access modes; RWO is the conservative reading).
        self.attachments: Dict[str, Attachment] = {}
        #: detach grace: how long a no-longer-needed volume stays
        #: attached before the reconciler detaches it (the
        #: maxWaitForUnmount/timer analog, reconciler.go)
        self.detach_grace_s: float = 30.0
        self.attaches_total = 0
        self.detaches_total = 0
        self._last_residue: Dict[str, tuple] = {}
        #: hollow prober targets: pod key -> app health (default True);
        #: the fake runtime's answer to readiness probes
        self.app_health: Dict[str, bool] = {}
        #: pod key -> Running transition time (probe initialDelay clock)
        self._started_at: Dict[str, float] = {}
        #: apps/v1 ControllerRevisions (pkg/controller/history): template
        #: snapshots per DS/STS revision, maintained by reconcile_history
        self.controller_revisions: Dict[str, ControllerRevision] = {}
        self.revision_history_limit = 10
        self.replicasets: Dict[str, ReplicaSet] = {}
        #: v1 ReplicationControllers — same machinery as ReplicaSets
        #: (see ReplicaSet.kind), separate registry so the kinds can't
        #: collide on a name
        self.replication_controllers: Dict[str, ReplicaSet] = {}
        self.deployments: Dict[str, Deployment] = {}
        self.jobs: Dict[str, Job] = {}
        self.daemonsets: Dict[str, DaemonSet] = {}
        self.statefulsets: Dict[str, StatefulSet] = {}
        self.cronjobs: Dict[str, CronJob] = {}
        self.hpas: Dict[str, HorizontalPodAutoscaler] = {}
        #: pod key -> bind commit time (job completion clock; set by
        #: confirm_binding)
        self._bound_at: Dict[str, float] = {}
        #: pod key -> create commit time (metadata.creationTimestamp
        #: analog) — the pod GC's oldest-first ordering key
        #: (gc_controller.go:117 byCreationTimestamp)
        self._created_at: Dict[str, float] = {}
        #: keys whose scheduler-side DELETE was already emitted at the
        #: terminal phase hop (the informer field-selector turns
        #: Running->Succeeded into a delete; the later object delete must
        #: not emit a second one)
        self._terminal_gone: set = set()
        #: pod GC: keep at most this many terminal pods
        #: (--terminated-pod-gc-threshold; 0 disables that half, the
        #: controller-manager default — gc_controller.go:94)
        self.terminated_pod_threshold: int = 0
        self.pods_gced_total = 0
        #: pod key -> graceful-deletion grace seconds (mark_terminating)
        self._term_grace: Dict[str, float] = {}
        #: live PDB objects; the disruption-controller analog maintains
        #: their status and the scheduler's pdb_lister reads them directly
        self.pdbs: List = []
        # node-lifecycle state (heartbeats, unreachable taints, eviction)
        self.dead_kubelets: set = set()
        #: per-node hollow agents (kubemark hollow-node registry)
        self.kubelets: Dict[str, HollowKubelet] = {}
        self.heartbeats: Dict[str, float] = {}
        self._taint_time: Dict[str, float] = {}
        self.node_grace_s = node_grace_s
        self.eviction_wait_s = eviction_wait_s
        self.zone_eviction_rate = zone_eviction_rate
        # service dataplane (kube-proxy analog, kubernetes_tpu_torch/proxy.py):
        # Service/Endpoints truth + per-node hollow proxies
        self.services: Dict[str, object] = {}
        self.endpoints: Dict[str, object] = {}
        self.proxies: Dict[str, object] = {}
        self.ip_alloc = ClusterIPAllocator()
        self.nodeport_alloc = NodePortAllocator()
        self.endpoints_controller = EndpointsController(self)
        # apiserver admission chain (kubernetes_tpu_torch/admission.py) —
        # opt-in like --enable-admission-plugins; when off, creates land
        # unexamined (the legacy hub behavior most sims exercise)
        self.namespaces: Dict[str, Namespace] = {
            "default": Namespace("default", NS_ACTIVE),
            "kube-system": Namespace("kube-system", NS_ACTIVE),
            "kube-public": Namespace("kube-public", NS_ACTIVE),
        }
        #: bootstrap tokens (kubeadm bootstraptoken phase mints; the
        #: token-cleaner controller expires; the bootstrap signer signs
        #: cluster-info with them — kubernetes_tpu_torch/bootstrap.py)
        self.bootstrap_tokens: Dict[str, object] = {}
        self.priority_classes: Dict[str, object] = {}
        self.quotas: List = []
        #: v1 LimitRanges — the LimitRanger admission plugin reads this
        #: container live (add_limit_range appends)
        self.limit_ranges: List = []
        self.admission = (
            default_chain(self.namespaces, self.priority_classes,
                          self.quotas, limit_ranges=self.limit_ranges)
            if admission else None
        )
        self.quota_controller = QuotaController(self)
        from kubernetes_tpu_torch.certificates import (
            CertificateController,
            RootCACertPublisher,
        )

        self.cert_controller = CertificateController(self)
        self.root_ca_publisher = RootCACertPublisher(self)
        #: cloud node controller (kubernetes_tpu_torch/cloud.py) — None until
        #: attach_cloud(); once attached, EVERY node is cloud-managed
        #: (instance gone at the provider ⇒ node object removed)
        self.cloud_controller = None
        self.service_lb_controller = None
        self.route_controller = None
        self.binder = FlakyBinder(self, bind_fail_rate, self.rng)
        # stable signature of the caller's scheduler knobs — compared by
        # the checkpoint config guard (callables repr unstably and never
        # round-trip anyway; they are live wiring, not semantics)
        self._scheduler_kw_sig = tuple(sorted(
            (k, repr(v)) for k, v in (scheduler_kw or {}).items()
            if not callable(v)
        ))
        kw = dict(scheduler_kw or {})
        kw.setdefault("pdb_lister", lambda: list(self.pdbs))
        # the scheduler's events land in the hub as API objects (the
        # reference posts Events via client-go and the apiserver stores
        # them; tools/record aggregation happens recorder-side, so the hub
        # sees count-bumped upserts keyed like the events registry)
        from kubernetes_tpu_torch.events import EventRecorder

        self.events_recorder = EventRecorder(
            clock=self.clock, sinks=[self._store_event]
        )
        #: event-key -> Event, the hub's events registry slice
        self.events_v1: Dict[str, object] = {}
        kw.setdefault("event_sink", self.events_recorder.sink())
        self.sched = Scheduler(binder=self.binder, clock=self.clock, **kw)
        # the scheduler's delayed-binding commits (BindPodVolumes) write
        # through the hub store so PVC/PV mutations get revisions and
        # watch events like every other truth write
        self.sched.volume_binder.writer = self._commit_volume_bind
        self.bound_total = 0
        self.competing_bind_rate = competing_bind_rate
        self.competing_bound = 0
        # watch plumbing: events deliver after 0..event_delay_ticks ticks,
        # per-object order preserved (heap keyed by due-tick then seq)
        self.event_delay_ticks = event_delay_ticks
        self._tick = 0
        self._seq = 0
        self._watch_q: List[tuple] = []  # (due, seq, deliver_fn)
        self._obj_last_due: Dict[str, int] = {}
        #: append-only watch history: (rev, obj_key, type, obj-or-None)
        self._history: List[tuple] = []
        self._compacted_rev = 0
        #: open watch cursors (weak: a dropped Reflector frees its history)
        self._cursors: "weakref.WeakSet" = weakref.WeakSet()

    # -- versioned store core ---------------------------------------------

    def _commit(self, obj_key: str, event_type: str, obj) -> int:
        """Bump the global revision, stamp the object, and append the
        event to the watch HISTORY — every truth write funnels through
        here (etcd3/store.go:236 GuaranteedUpdate; the history log is the
        etcd WAL/watchable-store analog that lets any number of watch
        cursors replay from a revision). ``event_type``/``obj`` are
        REQUIRED: a defaulted ('MODIFIED', None) entry would replay as
        on_node_update(None) in a Reflector far from the buggy call site.

        History is recorded only while watch cursors are open — with no
        watcher it would just pin every historical object (etcd compacts
        periodically for the same reason; see :meth:`step`)."""
        self._revision += 1
        self.resource_version[obj_key] = self._revision
        if self._cursors:
            self._history.append((self._revision, obj_key, event_type, obj))
        else:
            self._compacted_rev = self._revision
        return self._revision

    def record_controller_event(self, reason: str, object_key: str,
                                message: str,
                                type_: str = "Normal",
                                involved_kind: str = "Pod") -> None:
        """Controller-manager event seam (the recorder each reference
        controller carries): aggregate-upsert an Event about any object
        into the hub store — visible via the v1 EventList and
        ``ktpu get events`` like every other event."""
        from kubernetes_tpu_torch.events import Event

        now = self.clock.t
        ev = Event(type=type_, reason=reason, object_key=object_key,
                   message=message, first_timestamp=now,
                   last_timestamp=now, involved_kind=involved_kind)
        # aggregate with the stored series (one shared key derivation
        # with _store_event — two copies would silently skew)
        prior = self.events_v1.get(self._event_series_key(ev))
        if prior is not None:
            ev.count = prior.count + 1
            ev.first_timestamp = prior.first_timestamp
        self._store_event(ev)

    @staticmethod
    def _event_series_key(ev) -> str:
        """The store key of an Event's aggregation series: same
        (object, reason, message) => same key, so recurrences bump
        count/resourceVersion instead of multiplying objects."""
        import hashlib

        series = hashlib.sha1(
            f"{ev.object_key}|{ev.reason}|{ev.message}".encode()
        ).hexdigest()[:10]
        ns, _, name = ev.object_key.partition("/")
        return f"{ns}/{name}.{series}"

    def _store_event(self, ev) -> None:
        """Upsert an (aggregated) Event into the hub store — the
        events-registry write client-go's recorder performs; same key for
        the same (object, reason, message) series so aggregation bumps
        resourceVersion instead of multiplying objects."""
        key = self._event_series_key(ev)
        verb = "MODIFIED" if key in self.events_v1 else "ADDED"
        self.events_v1[key] = ev
        # bounded like the recorder (and like etcd's event TTL): evict the
        # stalest series; a later recurrence restarts its count at 1,
        # matching what TTL'd-out reference events do
        if len(self.events_v1) > 10000:
            oldest = min(self.events_v1,
                         key=lambda k: self.events_v1[k].last_timestamp)
            del self.events_v1[oldest]
        self._commit(f"events/{key}", verb, ev)

    def compact(self, rev: Optional[int] = None) -> None:
        """Drop watch history at or below ``rev`` (etcd compaction,
        mvcc/kvstore_compaction.go). Cursors behind the floor get
        :class:`Compacted` on their next poll and must relist."""
        rev = self._revision if rev is None else rev
        self._compacted_rev = max(self._compacted_rev, rev)
        self._history = [e for e in self._history if e[0] > self._compacted_rev]

    def watch(self, since_rev: int) -> "WatchCursor":
        """Open an independent watch cursor starting AFTER ``since_rev``
        (apiserver watch ?resourceVersion= semantics). Any number of
        cursors may be open — the watch-cacher fan-out (cacher.go: N
        watchers cost one history log)."""
        if since_rev < self._compacted_rev:
            raise Compacted(
                f"required revision {since_rev} has been compacted "
                f"(floor {self._compacted_rev})"
            )
        cur = WatchCursor(self, since_rev)
        self._cursors.add(cur)
        return cur

    def list_state(self):
        """LIST at the current revision: (revision, nodes, pods) snapshots
        — the Reflector's relist source (reflector.go:159)."""
        return (
            self._revision,
            dict(self.truth_nodes),
            dict(self.truth_pods),
        )

    def _emit(self, obj_key: str, deliver: Callable[[], None]) -> None:
        """Queue a watch event. Delivery may lag (``event_delay_ticks``)
        but is never reordered for the same object — a later event for an
        object is due no earlier than its previous one, like a per-object
        watch stream."""
        if self.event_delay_ticks <= 0:
            deliver()
            return
        due = self._tick + self.rng.randint(0, self.event_delay_ticks)
        due = max(due, self._obj_last_due.get(obj_key, 0))
        self._obj_last_due[obj_key] = due
        self._seq += 1
        heapq.heappush(self._watch_q, (due, self._seq, deliver))

    def flush_events(self, up_to: Optional[int] = None) -> int:
        """Deliver all watch events due at or before ``up_to`` (default:
        the current tick). Returns how many were delivered."""
        up_to = self._tick if up_to is None else up_to
        n = 0
        while self._watch_q and self._watch_q[0][0] <= up_to:
            _, _, deliver = heapq.heappop(self._watch_q)
            deliver()
            n += 1
        return n

    def settle(self) -> None:
        """Drain every in-flight watch event and GC orphans — the
        'informers caught up' state the consistency oracle compares."""
        while self._watch_q:
            self.flush_events(up_to=self._watch_q[0][0])
        self.gc_orphaned()
        while self._watch_q:
            self.flush_events(up_to=self._watch_q[0][0])

    # -- truth mutations (each pumps the corresponding watch event) --------

    def add_node(self, node: Node) -> None:
        self.truth_nodes[node.name] = node
        self.kubelets[node.name] = HollowKubelet(self, node.name)
        self.proxies[node.name] = ServiceProxy(node.name, self.clock)
        self.heartbeats[node.name] = self.clock.t
        self._commit(f"nodes/{node.name}", "ADDED", node)
        self._emit(f"nodes/{node.name}", lambda: self.sched.on_node_add(node))

    def remove_node(self, name: str) -> None:
        """Node vanishes; its pods are lost and deleted by the hub (the
        node-lifecycle/GC path, heavily simplified)."""
        if self.truth_nodes.pop(name, None) is None:
            return
        self.heartbeats.pop(name, None)
        self.kubelets.pop(name, None)
        self.proxies.pop(name, None)
        self._taint_time.pop(name, None)
        self.dead_kubelets.discard(name)
        self._commit(f"nodes/{name}", "DELETED", None)
        for key, p in list(self.truth_pods.items()):
            if p.node_name == name:
                self.delete_pod(key)
        self._emit(f"nodes/{name}", lambda: self.sched.on_node_delete(name))

    def create_pod(self, pod: Pod) -> None:
        if self.admission is not None:
            pod = self.admission.run(pod)  # raises AdmissionError on 403
        if not pod.uid:
            # the apiserver assigns metadata.uid at create; an empty uid
            # would break the Binding CAS's recreated-pod check for any
            # consumer that round-trips pods through the JSON seam
            pod.uid = f"{pod.key()}#u{self._revision + 1}"
        self.truth_pods[pod.key()] = pod
        self._created_at[pod.key()] = self.clock.t
        self._terminal_gone.discard(pod.key())  # recreated key: fresh pod
        self._commit(f"pods/{pod.key()}", "ADDED", pod)
        self._emit(f"pods/{pod.key()}", lambda: self.sched.on_pod_add(pod))

    def replace_pod(self, new: "Pod") -> None:
        """Metadata-style update of an existing pod (the PATCH/PUT seam:
        apiserver UpdatePodStatus/label updates). Identity and placement
        are IMMUTABLE here — name/namespace/uid/node_name changes must go
        through delete+create or the Binding subresource; violating that
        would bypass the CAS semantics confirm_binding enforces."""
        key = new.key()
        cur = self.truth_pods.get(key)
        if cur is None:
            raise KeyError(f"pods {key!r} not found")
        if new.uid != cur.uid or new.node_name != cur.node_name:
            raise ValueError(
                "replace_pod cannot change uid or nodeName (use the "
                "Binding subresource / delete+create)"
            )
        self.truth_pods[key] = new
        self._commit(f"pods/{key}", "MODIFIED", new)
        self._emit(f"pods/{key}", lambda: self.sched.on_pod_update(cur, new))

    def delete_pod(self, key: str) -> None:
        pod = self.truth_pods.pop(key, None)
        if pod is not None:
            self._bound_at.pop(key, None)
            self._started_at.pop(key, None)
            self._created_at.pop(key, None)
            self._term_grace.pop(key, None)
            self.app_health.pop(key, None)
            self._commit(f"pods/{key}", "DELETED", None)
            if key in self._terminal_gone:
                # the scheduler's field-selected informer already saw the
                # delete at the terminal phase hop — no second event
                self._terminal_gone.discard(key)
            else:
                self._emit(f"pods/{key}",
                           lambda: self.sched.on_pod_delete(pod))
            for rs in self.replicasets.values():
                rs.live.pop(key, None)
            for rc in self.replication_controllers.values():
                rc.live.pop(key, None)
            for ds in self.daemonsets.values():
                ds.live.pop(key, None)

    def confirm_binding(self, pod: Pod, node_name: str) -> None:
        """The Binding subresource: a CAS write (BindingREST.Create →
        assignPod, storage.go:154,:210). Raises :class:`Conflict` when the
        scheduler's view was stale — pod deleted, pod recreated under the
        same key, or already bound by another writer."""
        key = pod.key()
        cur = self.truth_pods.get(key)
        if cur is None:
            raise Conflict(f'pods "{key}" not found (deleted mid-bind)')
        if cur.uid != pod.uid:
            raise Conflict(f'pods "{key}" uid changed (recreated mid-bind)')
        if cur.node_name:
            raise Conflict(
                f'pods "{key}" is already assigned to node "{cur.node_name}"'
            )
        import dataclasses

        new = dataclasses.replace(cur, node_name=node_name)
        self.truth_pods[key] = new
        self._commit(f"pods/{key}", "MODIFIED", new)
        self._bound_at[key] = self.clock.t
        self.bound_total += 1
        self._emit(f"pods/{key}", lambda: self.sched.on_pod_update(cur, new))

    def get_lease(self, namespace: str, name: str):
        """Read a coordination Lease: ``(record, resourceVersion)`` —
        rv 0 means the Lease does not exist yet (leaselock.go:53 Get)."""
        with self.lock:
            return (self.leases.get(f"{namespace}/{name}"),
                    self.resource_version.get(f"leases/{namespace}/{name}", 0))

    def cas_lease(self, namespace: str, name: str, record,
                  expected_rv: int):
        """Create/update a Lease iff its resourceVersion still equals
        ``expected_rv`` (0 = must-not-exist). Returns the new rv, or None
        on conflict — the apiserver CAS leader election rides on
        (resourcelock/interface.go:100; GuaranteedUpdate semantics). The
        check-and-swap is atomic under the hub lock, which is the whole
        point of hub-mediated HA: two candidates racing the same rv
        cannot both win."""
        with self.lock:
            obj_key = f"leases/{namespace}/{name}"
            cur_rv = self.resource_version.get(obj_key, 0)
            if cur_rv != expected_rv:
                return None
            self.leases[f"{namespace}/{name}"] = record
            return self._commit(obj_key,
                                "MODIFIED" if cur_rv else "ADDED", record)

    # -- checkpoint / restore (etcd snapshot + restore analog) -------------

    #: the attrs a checkpoint carries: the full API-state slice (what
    #: etcd holds — objects, controller specs, dataplane truth) plus the
    #: per-node kubelet clocks (the kubelet checkpointmanager analog:
    #: pod lifecycle/probe state survives an agent restart)
    _CHECKPOINT_ATTRS = (
        "truth_nodes", "truth_pods", "resource_version", "leases",
        "pvcs", "pvs", "storage_classes",
        "replicasets", "deployments", "jobs", "daemonsets",
        "statefulsets", "cronjobs", "hpas", "pdbs",
        "services", "endpoints", "namespaces", "priority_classes",
        "quotas", "ip_alloc", "nodeport_alloc", "events_v1",
        "heartbeats", "dead_kubelets", "_taint_time",
        "_bound_at", "_started_at", "app_health",
        "attachments", "service_accounts", "sa_tokens",
        # round-5 state: identity/config registries an etcd restore
        # preserves (losing signed_certs would orphan every node
        # identity; losing configmaps breaks cluster-info discovery),
        # plus pod-GC bookkeeping
        "replication_controllers", "csrs", "signed_certs", "configmaps",
        "bootstrap_tokens", "cluster_roles", "cluster_role_bindings",
        "cluster_ca", "_created_at", "_term_grace", "_terminal_gone",
        "terminated_pod_threshold", "controller_revisions",
        "limit_ranges",
    )

    def _semantic_config(self) -> dict:
        """The construction knobs that change cluster SEMANTICS — stamped
        into checkpoints so restoring into a differently-configured hub
        fails loudly instead of silently diverging (e.g. a hub saved with
        admission on restored into one without would bypass quota)."""
        return {
            "admission": self.admission is not None,
            "node_grace_s": self.node_grace_s,
            "eviction_wait_s": self.eviction_wait_s,
            "zone_eviction_rate": self.zone_eviction_rate,
            "bind_fail_rate": self.binder.fail_rate,
            "event_delay_ticks": self.event_delay_ticks,
            "competing_bind_rate": self.competing_bind_rate,
            "scheduler_kw": self._scheduler_kw_sig,
            # detach_at timestamps inside checkpointed attachments are
            # absolute and derived from this knob — a mismatched restore
            # would silently change grace semantics mid-window
            "detach_grace_s": self.detach_grace_s,
        }

    def save_checkpoint(self, path: str) -> dict:
        """Write a point-in-time snapshot of the hub's state — the etcd
        backup analog (``etcdctl snapshot save``; etcd's snap files are
        opaque binary and so is this one: pickled, because the faithful
        JSON wire forms are deliberately lossy scheduling slices and a
        checkpoint must round-trip EVERY field exactly or restore
        corrupts constraints silently). Returns a small manifest."""
        import pickle

        import dataclasses

        with self.lock:
            state = {"format": "ktpu-checkpoint/1",
                     "revision": self._revision,
                     "clock_t": self.clock.t,
                     "config": self._semantic_config()}
            for attr in self._CHECKPOINT_ATTRS:
                state[attr] = getattr(self, attr)
            # HPA metric sources are live callables (lambdas in every real
            # usage) — unpicklable and meaningless across processes. They
            # are stripped here; restore documents re-wiring (set load_fn
            # after restore, like any live callback).
            state["hpas"] = {
                k: dataclasses.replace(h, load_fn=None)
                for k, h in self.hpas.items()
            }
            blob = pickle.dumps(state)
        with open(path, "wb") as f:
            f.write(blob)
        return {"revision": state["revision"],
                "nodes": len(state["truth_nodes"]),
                "pods": len(state["truth_pods"]),
                "bytes": len(blob)}

    def restore_checkpoint(self, path: str) -> dict:
        """Restore a checkpoint into THIS (freshly constructed) hub —
        the ``etcdctl snapshot restore`` + cold-start analog:

        - object resourceVersions and the global revision are PRESERVED
          (clients' stored rvs stay meaningful);
        - the watch history is empty and the compaction floor sits at
          the restored revision, so any watcher resuming from an old rv
          gets Compacted and relists — exactly post-restore etcd;
        - the scheduler is re-fed through its event-handler surface
          (the informer relist a restarted control plane performs), so
          its cache/queue rebuild from truth;
        - per-node kubelet clocks (bound/started/probe health) come
          back, so pod lifecycle resumes where it stopped;
        - HPA metric sources (``load_fn``) do NOT round-trip (live
          callables): re-wire them after restore or the HPA holds its
          last size.

        Trust boundary: a checkpoint is a pickle stream, and unpickling
        runs constructors — only restore checkpoints YOU saved (the
        reference's etcd snapshots are data-only; this analog is not).
        As a guard, deserialization goes through a restricted Unpickler
        that only resolves framework/stdlib-container classes, so a
        tampered stream referencing e.g. ``os.system`` fails to load
        instead of executing.
        """
        import pickle

        class _CheckpointUnpickler(pickle.Unpickler):
            _SAFE_BUILTINS = frozenset({
                "set", "frozenset", "list", "dict", "tuple", "bytearray",
                "complex", "range", "slice", "object",
            })

            def find_class(self, module, name):
                # dotted names make find_class getattr-WALK from the
                # module (STACK_GLOBAL), so "kubernetes_tpu_torch.x" + name
                # "os.system" would escape the module allowlist through
                # any module-level import — reject them outright
                if "." not in name:
                    if module.split(".")[0] in ("kubernetes_tpu_torch",
                                                "collections"):
                        return super().find_class(module, name)
                    if module == "builtins" and name in self._SAFE_BUILTINS:
                        return super().find_class(module, name)
                raise pickle.UnpicklingError(
                    f"checkpoint references forbidden global "
                    f"{module}.{name} — refusing to load"
                )

        with open(path, "rb") as f:
            state = _CheckpointUnpickler(f).load()
        if state.get("format") != "ktpu-checkpoint/1":
            raise ValueError(f"not a ktpu checkpoint: {path}")
        want = state.get("config", {})
        have = self._semantic_config()
        if want and want != have:
            diff = {k: (want[k], have.get(k))
                    for k in want if want[k] != have.get(k)}
            raise ValueError(
                f"checkpoint/hub config mismatch (saved, this): {diff} — "
                "construct the hub with the same semantics before restoring"
            )
        if self._revision != 0:
            # a non-fresh hub has objects the scheduler already cached;
            # wholesale truth replacement would leave them dangling there
            # (pods assignable to nodes the checkpoint never had) — the
            # same silent-divergence class the config guard refuses
            raise ValueError(
                "restore_checkpoint requires a freshly constructed hub "
                f"(this one is at revision {self._revision})"
            )
        with self.lock:
            self._revision = state["revision"]
            self._compacted_rev = self._revision
            self._history.clear()
            self.clock.t = state["clock_t"]
            for attr in self._CHECKPOINT_ATTRS:
                if attr not in state:
                    # checkpoint predates this attr (same format tag):
                    # keep the fresh hub's empty default instead of a
                    # raw KeyError on a previously-valid file
                    continue
                cur = getattr(self, attr)
                new = state[attr]
                # the admission chain captured the namespaces/priority-
                # class/quota CONTAINERS at construction (default_chain)
                # — those must be updated IN PLACE or admission keeps
                # enforcing against pre-restore state. Same class:
                # RBACAuthorizer reads the cluster_roles/-bindings dicts
                # LIVE and the bootstrap-token authenticator its dict —
                # an authorizer wired before restore must see post-
                # restore state, not the fresh hub's empty containers.
                if attr in ("namespaces", "priority_classes",
                            "cluster_roles", "bootstrap_tokens"):
                    cur.clear()
                    cur.update(new)
                elif attr in ("quotas", "pdbs", "limit_ranges",
                              "cluster_role_bindings"):
                    cur[:] = new  # captured-at-construction containers
                else:
                    setattr(self, attr, new)
            # rebuild the per-node agents (live objects, not state)
            self.kubelets = {name: HollowKubelet(self, name)
                             for name in self.truth_nodes}
            self.proxies = {name: ServiceProxy(name, self.clock)
                            for name in self.truth_nodes}
            for name in self.dead_kubelets:
                if name in self.kubelets:
                    self.kubelets[name].alive = False
            # informer relist into the scheduler
            for node in self.truth_nodes.values():
                self.sched.on_node_add(node)
            for pod in self.truth_pods.values():
                self.sched.on_pod_add(pod)
            if self.pvcs or self.pvs or self.storage_classes:
                self._sync_volume_state()
        return {"revision": self._revision,
                "nodes": len(self.truth_nodes),
                "pods": len(self.truth_pods)}

    # -- pod lifecycle (hollow kubelet SyncPod + prober) -------------------

    def set_app_health(self, pod_key: str, healthy: bool) -> None:
        """Inject the hollow app's probe answer (the fake runtime seam —
        what kubemark's fake CRI would report)."""
        self.app_health[pod_key] = healthy

    def sync_pod_lifecycle(self) -> None:
        """One SyncPod pass over all bound pods (kuberuntime_manager.go:558
        compressed to phase hops; prober/worker.go for readiness):

        - Pending + bound on a live kubelet -> Running (status MODIFIED);
        - probed pods: Ready once past initialDelay AND the injected app
          health is good; a later health flip flips Ready back — the
          probe-failure path the endpoints controller must observe;
        - probe-less pods never write Ready (they are ready-by-default,
          see proxy.pod_endpoint_ready).

        - run-to-completion pods (``run_duration_s``) hop Running ->
          Succeeded after their duration and STAY in the store — the
          kubelet never deletes API pods; terminal cleanup is the pod
          GC controller's (reconcile_pod_gc). The scheduler observes
          the hop as a DELETE (its informer's
          ``status.phase!=Succeeded,...`` field selector, factory.go
          NewPodInformer) and the node's capacity is released.

        One O(P) scan for all nodes, like kubelet_admission."""
        import dataclasses

        from kubernetes_tpu_torch.api.types import (
            POD_PENDING,
            POD_RUNNING,
            POD_SUCCEEDED,
            is_pod_terminated,
        )

        for key, p in list(self.truth_pods.items()):
            if not p.node_name:
                continue
            if is_pod_terminated(p):
                if p.deletion_timestamp:
                    # ran to completion while a graceful delete was
                    # pending: the kill is already complete — finish the
                    # delete now, independent of kubelet liveness
                    self.delete_pod(key)
                continue
            kl = self.kubelets.get(p.node_name)
            if kl is None or not kl.alive:
                continue
            if (p.deletion_timestamp
                    and self.clock.t - p.deletion_timestamp
                    >= self._term_grace.get(key, 30.0)):
                # graceful kill complete: the kubelet's status sync
                # triggers the final grace-0 delete (status_manager
                # syncPod -> deletePod)
                self.delete_pod(key)
                continue
            if (p.phase == POD_RUNNING and p.run_duration_s is not None
                    and self._started_at.get(key) is not None
                    and self.clock.t - self._started_at[key]
                    >= p.run_duration_s):
                done = dataclasses.replace(p, phase=POD_SUCCEEDED,
                                           ready=False)
                self.truth_pods[key] = done
                self._commit(f"pods/{key}", "MODIFIED", done)
                self._terminal_gone.add(key)
                self._emit(f"pods/{key}",
                           lambda pod=p: self.sched.on_pod_delete(pod))
                continue
            changes = {}
            if p.phase == POD_PENDING:
                changes["phase"] = POD_RUNNING
                self._started_at[key] = self.clock.t
            if p.readiness_probe is not None:
                started = self._started_at.get(key)
                ready = (
                    started is not None
                    and self.clock.t - started >= p.readiness_probe.initial_delay_s
                    and self.app_health.get(key, True)
                )
                if ready != p.ready:
                    changes["ready"] = ready
            if changes:
                new = dataclasses.replace(p, **changes)
                self.truth_pods[key] = new
                self._commit(f"pods/{key}", "MODIFIED", new)
                self._emit(f"pods/{key}",
                           lambda old=p, new=new: self.sched.on_pod_update(
                               old, new))

    # -- volume API + PV controller ----------------------------------------

    def add_storage_class(self, sc) -> None:
        self.storage_classes[sc.name] = sc
        self._commit(f"storageclasses/{sc.name}", "ADDED", sc)
        self._sync_volume_state()

    def add_pv(self, pv) -> None:
        self.pvs[pv.name] = pv
        self._commit(f"persistentvolumes/{pv.name}", "ADDED", pv)
        self._sync_volume_state()

    def add_pvc(self, pvc) -> None:
        self.pvcs[f"{pvc.namespace}/{pvc.name}"] = pvc
        self._commit(f"persistentvolumeclaims/{pvc.namespace}/{pvc.name}",
                     "ADDED", pvc)
        self._sync_volume_state()

    def _sync_volume_state(self) -> None:
        """Push the hub's volume truth into the scheduler's listers (the
        PV/PVC/StorageClass informer feed) — invalidates the snapshot and
        resweeps unschedulables, scheduler.set_volume_state semantics."""
        self.sched.set_volume_state(
            list(self.pvcs.values()), list(self.pvs.values()),
            list(self.storage_classes.values()),
        )

    def delete_pvc(self, key: str) -> bool:
        """DELETE of a PVC under the pvc-protection finalizer
        (pvc_protection_controller.go): an in-use claim (some live,
        non-terminal pod references it by name) is marked terminating
        and kept; the protection pass finalizes the removal when the
        last user is gone. Returns True when the object was removed
        NOW, False when protection deferred it."""
        pvc = self.pvcs.get(key)
        if pvc is None:
            return False
        if self._pvc_in_use(key):
            if not pvc.deletion_timestamp:
                pvc.deletion_timestamp = self.clock.t or 1e-6
                self._commit(f"persistentvolumeclaims/{key}",
                             "MODIFIED", pvc)
            return False
        self._finalize_pvc_delete(key)
        return True

    def delete_pv(self, name: str) -> bool:
        """DELETE of a PV under the pv-protection finalizer
        (pv_protection_controller.go): a claimed PV stays terminating
        until its claim releases it."""
        pv = self.pvs.get(name)
        if pv is None:
            return False
        if pv.claim_ref:
            if not pv.deletion_timestamp:
                pv.deletion_timestamp = self.clock.t or 1e-6
                self._commit(f"persistentvolumes/{name}", "MODIFIED", pv)
            return False
        del self.pvs[name]
        self._commit(f"persistentvolumes/{name}", "DELETED", None)
        self._sync_volume_state()
        return True

    def _pvc_in_use(self, key: str) -> bool:
        from kubernetes_tpu_torch.api.types import is_pod_terminated

        ns, name = key.split("/", 1)
        return any(
            p.namespace == ns and not is_pod_terminated(p)
            and any(v.pvc == name for v in p.volumes)
            for p in self.truth_pods.values()
        )

    def _finalize_pvc_delete(self, key: str) -> None:
        pvc = self.pvcs.pop(key)
        if pvc.volume_name and pvc.volume_name in self.pvs:
            # Released -> Available (the hollow reclaim policy); a PV
            # waiting on pv-protection may now finalize too
            self.pvs[pvc.volume_name].claim_ref = ""
            self._commit(f"persistentvolumes/{pvc.volume_name}",
                         "MODIFIED", self.pvs[pvc.volume_name])
        self._commit(f"persistentvolumeclaims/{key}", "DELETED", None)
        self._sync_volume_state()

    def reconcile_volume_protection(self) -> None:
        """The two protection controllers' finalizer passes: terminating
        PVCs whose last pod user is gone are removed (releasing their
        PV); terminating PVs whose claim released them are removed."""
        for key in [k for k, c in self.pvcs.items()
                    if c.deletion_timestamp and not self._pvc_in_use(k)]:
            self._finalize_pvc_delete(key)
        for name in [n for n, pv in self.pvs.items()
                     if pv.deletion_timestamp and not pv.claim_ref]:
            del self.pvs[name]
            self._commit(f"persistentvolumes/{name}", "DELETED", None)
            self._sync_volume_state()

    def _commit_volume_bind(self, pvc, pv) -> None:
        """The scheduler's BindPodVolumes write, routed through the hub
        store: same in-place object mutation as the default writer plus
        revision bumps + watch events for both objects."""
        pv.claim_ref = f"{pvc.namespace}/{pvc.name}"
        pvc.volume_name = pv.name
        self._commit(f"persistentvolumes/{pv.name}", "MODIFIED", pv)
        self._commit(f"persistentvolumeclaims/{pvc.namespace}/{pvc.name}",
                     "MODIFIED", pvc)

    #: TTL controller boundary table (pkg/controller/ttl/ttl_controller
    #: .go:102 ttlBoundaries): (size_min, size_max, ttl_seconds) with
    #: overlapping min/max = the reference's hysteresis — the step only
    #: moves when the count leaves the CURRENT band, so oscillation at a
    #: boundary doesn't thrash every node's annotation
    TTL_BOUNDARIES = ((0, 100, 0), (90, 500, 15), (450, 1000, 30),
                      (900, 2000, 60), (1800, 10000, 300),
                      (9000, 1 << 31, 600))
    TTL_ANNOTATION = "node.alpha.kubernetes.io/ttl"

    def reconcile_ttl(self) -> None:
        """The TTL controller: annotate every node with the secret/
        configmap cache TTL kubelets should use, scaled to cluster size
        with hysteresis (ttl_controller.go:141,:182)."""
        import dataclasses

        count = len(self.truth_nodes)
        while (self._ttl_step + 1 < len(self.TTL_BOUNDARIES)
               and count > self.TTL_BOUNDARIES[self._ttl_step][1]):
            self._ttl_step += 1
        while (self._ttl_step > 0
               and count < self.TTL_BOUNDARIES[self._ttl_step][0]):
            self._ttl_step -= 1
        want = str(self.TTL_BOUNDARIES[self._ttl_step][2])
        for node in list(self.truth_nodes.values()):
            if node.annotations.get(self.TTL_ANNOTATION) != want:
                new = dataclasses.replace(
                    node, annotations={**node.annotations,
                                       self.TTL_ANNOTATION: want})
                self._update_node(new)

    def reconcile_node_ipam(self) -> None:
        """The nodeipam range allocator (ipam/range_allocator.go): carve
        one per-node podCIDR from the cluster CIDR; release a deleted
        node's block back to the set; exhaustion surfaces as a counter
        (the reference emits CIDRNotAvailable), never a crash."""
        import dataclasses
        import ipaddress

        if self._cidr_subnets is None:
            net = ipaddress.ip_network(self.cluster_cidr)
            self._cidr_subnets = list(
                net.subnets(new_prefix=self.node_cidr_prefix))
            self._cidr_index = {str(s): i
                                for i, s in enumerate(self._cidr_subnets)}
            self._cidr_next = 0
            self._cidr_free: List[int] = []
        live = set(self.truth_nodes)
        for name in [n for n in self._cidr_alloc if n not in live]:
            self._cidr_free.append(self._cidr_alloc.pop(name))
        used = set(self._cidr_alloc.values())
        for name, node in list(self.truth_nodes.items()):
            if node.pod_cidr:
                # OCCUPY a pre-set CIDR (range_allocator occupyCIDRs): a
                # node ingested with spec.podCIDR already assigned must
                # claim its block or the allocator would hand the same
                # subnet to the next CIDR-less node
                idx = self._cidr_index.get(node.pod_cidr)
                if idx is not None and name not in self._cidr_alloc:
                    self._cidr_alloc[name] = idx
                    used.add(idx)
                continue
            if name in self._cidr_alloc:
                # same-name delete+re-add (or a write that dropped the
                # field): re-stamp the held block instead of leaking it
                idx = self._cidr_alloc[name]
            else:
                idx = None
                while self._cidr_free:
                    cand = self._cidr_free.pop()
                    if cand not in used:
                        idx = cand
                        break
                if idx is None:
                    while (self._cidr_next < len(self._cidr_subnets)
                           and self._cidr_next in used):
                        self._cidr_next += 1
                    if self._cidr_next < len(self._cidr_subnets):
                        idx = self._cidr_next
                        self._cidr_next += 1
                    else:
                        self.cidr_exhausted_total += 1
                        continue
                self._cidr_alloc[name] = idx
                used.add(idx)
            self._update_node(dataclasses.replace(
                node, pod_cidr=str(self._cidr_subnets[idx])))

    def reconcile_service_accounts(self) -> None:
        """The serviceaccounts + tokens controller pair
        (pkg/controller/serviceaccount/serviceaccounts_controller.go:46,
        tokens_controller.go:73): every ACTIVE namespace carries a
        "default" ServiceAccount, every ServiceAccount carries exactly
        one minted bearer token, and a namespace leaving Active revokes
        both — committed through the versioned store so identity churn
        is watchable like any other object."""
        active = {name for name, ns in self.namespaces.items()
                  if ns.phase == NS_ACTIVE}
        for ns in active:
            sa = ServiceAccount("default", namespace=ns)
            if sa.key() not in self.service_accounts:
                self.service_accounts[sa.key()] = sa
                self._commit(f"serviceaccounts/{sa.key()}", "ADDED", sa)
        # revoke: SAs of gone/terminating namespaces
        for key, sa in list(self.service_accounts.items()):
            if sa.namespace not in active:
                del self.service_accounts[key]
                self._commit(f"serviceaccounts/{key}", "DELETED", None)
        live_keys = set(self.service_accounts)
        for token, key in list(self.sa_tokens.items()):
            if key not in live_keys:
                del self.sa_tokens[token]
        minted = set(self.sa_tokens.values())
        for key in live_keys - minted:
            # opaque, unguessable-enough for the hollow plane; the mint
            # revision makes a re-created namespace's token DIFFERENT
            # from its predecessor's (revocation must stick)
            token = f"sa-token-{key.replace('/', '-')}-{self._revision}"
            self.sa_tokens[token] = key

    def service_account_token(self, namespace: str,
                              name: str = "default") -> str:
        """The minted token for one SA (what a pod's projected token
        volume would carry). KeyError when the controller hasn't minted
        it (namespace missing/terminating)."""
        key = f"{namespace}/{name}"
        for token, k in self.sa_tokens.items():
            if k == key:
                return token
        raise KeyError(f"no token minted for serviceaccount {key!r}")

    def sa_token_user(self, token: str):
        """Live lookup for the authenticators (REST:
        auth.ServiceAccountAuthenticator; gRPC: serve_grpc's callable
        token): UserInfo for a valid token, None for unknown/revoked."""
        key = self.sa_tokens.get(token)
        if key is None:
            return None
        ns, name = key.split("/", 1)
        from kubernetes_tpu_torch.auth import service_account_user

        return service_account_user(ns, name)

    def bootstrap_token_user(self, credential: str):
        """The bootstrap-token authenticator
        (plugin/pkg/auth/authenticator/token/bootstrap): a live,
        authentication-usage, unexpired ``id.secret`` token
        authenticates as ``system:bootstrap:<id>`` in the
        system:bootstrappers group — the identity whose CSRs the
        approver's nodeclient binding admits."""
        tid, dot, secret = credential.partition(".")
        if not dot:
            return None
        tok = self.bootstrap_tokens.get(tid)
        if (tok is None or tok.secret != secret
                or "authentication" not in tok.usages
                or tok.expired(self.clock.t)):
            return None
        from kubernetes_tpu_torch.auth import UserInfo
        from kubernetes_tpu_torch.certificates import BOOTSTRAPPERS_GROUP

        return UserInfo(name=f"system:bootstrap:{tid}",
                        groups=(BOOTSTRAPPERS_GROUP,))

    def credential_user(self, credential: str):
        """One lookup over EVERY live hub-minted identity — SA tokens
        (tokens controller), signed node certificates (CSR signer), and
        bootstrap tokens. Plug into auth.ServiceAccountAuthenticator as
        ``lookup`` to accept all three on one seam."""
        return (self.sa_token_user(credential)
                or self.cert_user(credential)
                or self.bootstrap_token_user(credential))

    # -- certificates.k8s.io (kubernetes_tpu_torch/certificates.py) --------------

    def create_csr(self, csr) -> None:
        """CSR create (the apiserver stamps spec.username from the
        authenticated requestor; callers of this seam have already
        authenticated — node_bootstrap_csr builds the right shape)."""
        if csr.name in self.csrs:
            raise ValueError(
                f'certificatesigningrequests "{csr.name}" already exists')
        csr.created_at = self.clock.t
        self.csrs[csr.name] = csr
        self._commit(f"certificatesigningrequests/{csr.name}", "ADDED", csr)

    def cert_user(self, credential: str):
        """Live lookup for the authn chain: UserInfo for a valid signed
        node credential, None for unknown/expired — the client-cert
        verification path, modeled as a bearer credential (see
        kubernetes_tpu_torch/certificates.py module docstring)."""
        entry = self.signed_certs.get(credential)
        if entry is None:
            return None
        user, not_after = entry
        if self.clock.t >= not_after:
            return None
        return user

    def put_configmap(self, namespace: str, name: str, data: dict) -> None:
        key = f"{namespace}/{name}"
        etype = "MODIFIED" if key in self.configmaps else "ADDED"
        self.configmaps[key] = {"data": dict(data)}
        self._commit(f"configmaps/{key}", etype, self.configmaps[key])

    def delete_configmap(self, key: str) -> None:
        if self.configmaps.pop(key, None) is not None:
            self._commit(f"configmaps/{key}", "DELETED", None)

    def _desired_attachments(self) -> Dict[str, set]:
        """Desired state: volume identity -> set of nodes with bound pods
        whose volumes resolve to an attachable backend (in-tree PD kinds
        or CSI) — the desired_state_of_world populator
        (attach_detach_controller.go podAdd/Update -> desiredStateOfWorld).
        A SET, not last-writer-wins: several live claimants of one PV on
        different nodes are a real state the reconciler must refuse to
        flap on (keep the existing attachment, never steal it). Inline
        attachable volumes count too (identity "inline:kind:handle");
        PVC-backed ones use the PV name so residue can re-resolve."""
        from kubernetes_tpu_torch.volumes import (
            PD_FILTER_INDEX,
            attachable_tokens,
        )

        want: Dict[str, set] = {}
        for p in self.truth_pods.values():
            if not p.node_name or not p.volumes:
                continue
            for v in p.volumes:
                if v.pvc:
                    pvc = self.pvcs.get(f"{p.namespace}/{v.pvc}")
                    pv = (self.pvs.get(pvc.volume_name)
                          if pvc is not None and pvc.volume_name else None)
                    if pv is None:
                        continue  # unbound/missing: nothing to attach yet
                    if attachable_tokens(pv):
                        want.setdefault(pv.name, set()).add(p.node_name)
                elif v.kind in PD_FILTER_INDEX:
                    want.setdefault(f"inline:{v.kind}:{v.handle}",
                                    set()).add(p.node_name)
        return want

    def reconcile_attachments(self) -> None:
        """The attach-detach reconciler (reconciler/reconciler.go):
        converge actual attachments toward desired.

        - attach when desired and unattached;
        - a volume desired on a NEW node while still attached elsewhere
          waits for the old attachment to detach first (the single-
          attach / multi-attach guard — the reference refuses to attach
          an RWO volume to a second node and surfaces FailedAttachVolume
          until the detach completes);
        - a no-longer-desired attachment enters ``detaching`` and is
          removed only after ``detach_grace_s`` (maxWaitForUnmount
          analog) — during the grace it still occupies an attach-limit
          slot, which the scheduler sees via the residue feed;
        - a volume that becomes desired again mid-grace on the SAME node
          re-attaches in place (the reconciler cancels the detach).
        """
        want = self._desired_attachments()
        t = self.clock.t
        # expiry/detach FIRST: a grace window that ends this pass frees
        # the volume for the attach loop below (one-pass convergence;
        # attach-after-expiry ordering also keeps the oracle honest)
        for vol, rec in list(self.attachments.items()):
            desired_here = rec.node in want.get(vol, ())
            if not desired_here:
                if rec.state == "attached":
                    rec.state = "detaching"
                    rec.detach_at = t + self.detach_grace_s
                elif t >= rec.detach_at:
                    del self.attachments[vol]
                    self.detaches_total += 1
        for vol, nodes in want.items():
            rec = self.attachments.get(vol)
            if rec is None:
                # deterministic choice among claimant nodes (several
                # claimants on one unattached volume: lowest name wins,
                # the rest wait on the multi-attach guard)
                self.attachments[vol] = Attachment(volume=vol,
                                                   node=min(nodes),
                                                   state="attached")
                self.attaches_total += 1
            elif rec.node in nodes:
                if rec.state == "detaching":
                    rec.state = "attached"  # needed again: cancel detach
                    rec.detach_at = 0.0
            # rec.node not in nodes: multi-attach guard — the existing
            # attachment is never stolen; it detaches via the loop above
            # (not desired there) and a later pass attaches the claimant
        # residue = attachments the scheduler cannot derive from live
        # bound pods; push only on change (each push invalidates the
        # snapshot and resweeps unschedulables)
        residue: Dict[str, tuple] = {}
        for vol, rec in self.attachments.items():
            if (rec.node not in want.get(vol, ())
                    and not vol.startswith("inline:")):
                residue[rec.node] = residue.get(rec.node, ()) + (vol,)
        if residue != self._last_residue:
            self._last_residue = residue
            self.sched.set_attached_residue(residue)

    def check_attachment_invariants(self) -> None:
        """Fuzz oracle: (a) single-attach — by construction one record
        per volume, asserted against desired duplication; (b) every
        bound pod's attachable volumes are attached to ITS node unless
        blocked by a grace-period detach elsewhere (the multi-attach
        wait); (c) no attachment without a desiring pod outlives the
        grace window.

        Converge-then-check (check_consistency's settle analog): binds
        land at the END of a step, after that step's reconcile pass, so
        the reconciler runs once more here — the invariants are about
        the CONVERGED reconciler, not its one-tick lag."""
        self.reconcile_attachments()
        want = self._desired_attachments()
        t = self.clock.t
        for vol, nodes in want.items():
            rec = self.attachments.get(vol)
            assert rec is not None, f"desired volume {vol} never attached"
            if rec.node not in nodes:
                assert rec.state == "detaching", (
                    f"{vol} attached to {rec.node} but desired on {nodes} "
                    "without a pending detach (multi-attach guard broken)")
        for vol, rec in self.attachments.items():
            if rec.node not in want.get(vol, ()):
                assert rec.state == "detaching", (
                    f"stale attachment {vol}@{rec.node} not detaching")
                assert rec.detach_at <= t + self.detach_grace_s + 1e-6, (
                    f"{vol} grace window exceeds detach_grace_s")

    def reconcile_volumes(self) -> None:
        """The persistent-volume binder controller pass
        (pv_controller.go:236 syncUnboundClaim): bind each pending
        IMMEDIATE-mode PVC to an available compatible PV now; a
        WaitForFirstConsumer claim waits for the scheduler (delayed
        binding — its syncUnboundClaim branch checks the selected-node
        annotation and defers). Newly-satisfiable pods wake via the
        volume-state resweep."""
        from kubernetes_tpu_torch.api.types import BINDING_WAIT_FOR_FIRST_CONSUMER

        bound_any = False
        for key, pvc in self.pvcs.items():
            if pvc.volume_name or pvc.deletion_timestamp:
                continue  # bound, or terminating under pvc-protection
            sc = self.storage_classes.get(pvc.storage_class)
            if (sc is not None
                    and sc.binding_mode == BINDING_WAIT_FOR_FIRST_CONSUMER):
                continue  # the scheduler owns delayed binding
            assumed = self.sched.cache.packer.vol_state.assumed_claims
            pick = None
            for pv in self.pvs.values():
                if (not pv.claim_ref and not pv.deletion_timestamp
                        and pv.name not in assumed
                        and pv.storage_class == pvc.storage_class):
                    pick = pv
                    break
            if pick is not None:
                self._commit_volume_bind(pvc, pick)
                bound_any = True
        if bound_any:
            self._sync_volume_state()

    def gc_owner_graph(self) -> None:
        """The ownerReference dependency-graph GC
        (pkg/controller/garbagecollector/garbagecollector.go:65),
        compressed to the hub's kind registry: an object whose every
        controller owner no longer exists is background-deleted. Edges:
        Pod -> ReplicaSet/Job/DaemonSet/StatefulSet (pod.owner_refs),
        Job -> CronJob (job.owner), ReplicaSet -> Deployment (the
        rs.owner cascade lives in reconcile_controllers). Adoption of
        matching orphans is a deliberate non-goal."""
        for name in [n for n, j in self.jobs.items()
                     if j.owner and j.owner not in self.cronjobs]:
            j = self.jobs.pop(name)
            for key in list(j.active):
                self.delete_pod(key)
        kinds = self._owner_kinds()
        for key, p in list(self.truth_pods.items()):
            refs = p.owner_refs
            if refs and not any(r.name in kinds.get(r.kind, {})
                                for r in refs):
                self.delete_pod(key)

    def _owner_kinds(self) -> Dict[str, dict]:
        return {
            "Deployment": self.deployments,
            "ReplicaSet": self.replicasets,
            "ReplicationController": self.replication_controllers,
            "Job": self.jobs,
            "DaemonSet": self.daemonsets,
            "StatefulSet": self.statefulsets,
            "CronJob": self.cronjobs,
        }

    def gc_orphaned(self) -> None:
        """Delete truth pods bound to nodes that no longer exist — the
        node-lifecycle-controller/GC eviction a real cluster runs when a
        binding lands on a node that died meanwhile (the apiserver accepts
        such bindings; assignPod does not check node existence)."""
        for key, p in list(self.truth_pods.items()):
            if p.node_name and p.node_name not in self.truth_nodes:
                self.delete_pod(key)
        self.kubelet_admission()

    def kubelet_admission(self) -> None:
        """Run every node's kubelet admission pass (the per-node logic
        lives in :class:`HollowKubelet.admit`, lifecycle/predicate.go
        analog). Called from gc_orphaned so consistency holds even
        between sync ticks; runs for dead kubelets too — the truth
        invariant (no over-committed node) predates the agent split."""
        by_node: Dict[str, List[str]] = {}
        for key, p in self.truth_pods.items():
            if p.node_name:
                by_node.setdefault(p.node_name, []).append(key)
        for name, kl in list(self.kubelets.items()):
            kl.admit(by_node.get(name, []))

    def mark_terminating(self, key: str, grace_s: float = 30.0) -> None:
        """Graceful DELETE: stamp metadata.deletionTimestamp and let the
        owning kubelet finish the kill after ``grace_s`` (the apiserver's
        graceful-deletion path, registry/core/pod/strategy.go
        CheckGracefulDelete). An UNBOUND pod has no kubelet to confirm
        termination — that leak is exactly what the pod GC's
        gcUnscheduledTerminating half collects (gc_controller.go:172)."""
        import dataclasses

        from kubernetes_tpu_torch.api.types import is_pod_terminated

        pod = self.truth_pods.get(key)
        if pod is None or pod.deletion_timestamp:
            return
        if is_pod_terminated(pod):
            # registry CheckGracefulDelete (pod/strategy.go): a pod whose
            # containers have exited deletes immediately — grace is for
            # running workloads, and no kubelet kill is pending
            self.delete_pod(key)
            return
        terminating = dataclasses.replace(
            pod, deletion_timestamp=self.clock.t or 1e-6)
        self.truth_pods[key] = terminating
        self._term_grace[key] = grace_s
        self._commit(f"pods/{key}", "MODIFIED", terminating)
        self._emit(f"pods/{key}",
                   lambda old=pod, new=terminating:
                   self.sched.on_pod_update(old, new))

    def reconcile_pod_gc(self) -> None:
        """The pod GC controller (podgc/gc_controller.go:94 gc), minus
        the orphan half which lives in :meth:`gc_orphaned` (it doubles
        as the consistency oracle's precondition so it runs more often):

        - ``terminated_pod_threshold`` > 0: keep at most that many
          terminal (Succeeded/Failed) pods, deleting oldest-by-creation
          first (gc_controller.go:108 gcTerminated sorts
          byCreationTimestamp and deletes count-threshold);
        - unscheduled terminating pods (deletionTimestamp set, no node)
          are force-deleted — no kubelet will ever confirm their
          termination (gc_controller.go:172 gcUnscheduledTerminating).
        """
        from kubernetes_tpu_torch.api.types import is_pod_terminated

        if self.terminated_pod_threshold > 0:
            terminated = [k for k, p in self.truth_pods.items()
                          if is_pod_terminated(p)]
            excess = len(terminated) - self.terminated_pod_threshold
            if excess > 0:
                terminated.sort(
                    key=lambda k: (self._created_at.get(k, 0.0), k))
                for k in terminated[:excess]:
                    self.delete_pod(k)
                    self.pods_gced_total += 1
        for key, p in list(self.truth_pods.items()):
            if p.deletion_timestamp and not p.node_name:
                self.delete_pod(key)
                self.pods_gced_total += 1

    def reconcile_ttl_after_finished(self) -> None:
        """The TTL-after-finished controller
        (ttlafterfinished_controller.go:186 processJob): delete a
        finished Job once ``ttl_seconds_after_finished`` has elapsed
        since its completion time. The Job's leftover pods cascade
        through the ownerRef GC graph (their Job owner is gone); a
        spawning CronJob's bookkeeping entry is dropped so its
        concurrency accounting can't see a ghost."""
        for name in list(self.jobs):
            j = self.jobs[name]
            if (j.ttl_seconds_after_finished is None or not j.done()
                    or j.finished_at is None):
                continue
            if self.clock.t - j.finished_at < j.ttl_seconds_after_finished:
                continue
            del self.jobs[name]
            for cj in self.cronjobs.values():
                if name in cj.spawned:
                    cj.spawned.remove(name)
            self.record_controller_event(
                "SuccessfulDelete", f"default/{name}",
                f"Deleted job {name} past its "
                f"ttlSecondsAfterFinished={j.ttl_seconds_after_finished:g}",
                involved_kind="Job")

    def attach_cloud(self, cloud) -> None:
        """Run the cluster under an external cloud provider: the cloud
        node controller initializes uninitialized-tainted nodes and
        removes nodes whose instance died; the service controller
        provisions LoadBalancer services; the route controller installs
        per-podCIDR cloud routes (kubernetes_tpu_torch/cloud.py)."""
        from kubernetes_tpu_torch.cloud import RouteController, ServiceLBController

        self.cloud_controller = CloudNodeController(self, cloud)
        self.service_lb_controller = ServiceLBController(self, cloud)
        self.route_controller = RouteController(self, cloud)

    # -- namespaces / priority classes / quotas (admission seam) -------------

    def add_namespace(self, name: str) -> None:
        self.namespaces[name] = Namespace(name, NS_ACTIVE)
        self._commit(f"namespaces/{name}", "ADDED", self.namespaces[name])

    #: namespaces every entry point refuses to delete (the apiserver
    #: protects these; one guard here so no seam can bypass it)
    PROTECTED_NAMESPACES = ("default", "kube-system", "kube-public")

    def terminate_namespace(self, name: str) -> None:
        """Mark Terminating; the namespace-controller pass in step() then
        drains its content and removes it (pkg/controller/namespace).
        Raises ValueError for protected system namespaces."""
        if name in self.PROTECTED_NAMESPACES:
            raise ValueError(f'namespaces "{name}" is protected')
        ns = self.namespaces.get(name)
        if ns is not None:
            ns.phase = NS_TERMINATING
            self._commit(f"namespaces/{name}", "MODIFIED", ns)

    def add_priority_class(self, cls) -> None:
        self.priority_classes[cls.name] = cls

    def add_quota(self, quota) -> None:
        self.quotas.append(quota)
        self.quota_controller.reconcile()

    def add_limit_range(self, lr) -> None:
        """Install a LimitRange; the admission chain's LimitRanger reads
        the live container (defaults/bounds apply to the NEXT create)."""
        self.limit_ranges.append(lr)

    def reconcile_namespaces(self) -> None:
        """The namespace controller's deletion pass: drain EVERY
        namespaced resource (pods, services+endpoints, events, leases,
        PVCs — pkg/controller/namespace deletes all namespaced content
        via discovery), then remove the namespace once empty."""
        for name, ns in list(self.namespaces.items()):
            if ns.phase != NS_TERMINATING:
                continue
            prefix = f"{name}/"
            remaining = [k for k, p in self.truth_pods.items()
                         if p.namespace == name]
            for key in remaining:
                self.delete_pod(key)
            for key in [k for k in self.services if k.startswith(prefix)]:
                self.delete_service(key)
            for key in [k for k in self.endpoints if k.startswith(prefix)]:
                self.delete_endpoints(key)
            for key in [k for k in self.events_v1 if k.startswith(prefix)]:
                del self.events_v1[key]
                self._commit(f"events/{key}", "DELETED", None)
            for key in [k for k in self.leases if k.startswith(prefix)]:
                del self.leases[key]
                self._commit(f"leases/{key}", "DELETED", None)
            for key in [k for k in self.configmaps if k.startswith(prefix)]:
                self.delete_configmap(key)
            # namespace pods were deleted above, so no pvc-protection
            # deferral applies — finalize through the one teardown path
            # (release PV claimRef, commit both deletes, volume resync)
            for key in [k for k in self.pvcs if k.startswith(prefix)]:
                self._finalize_pvc_delete(key)
            if not remaining:
                del self.namespaces[name]
                self._commit(f"namespaces/{name}", "DELETED", None)

    # -- services / endpoints (kube-proxy seam) ------------------------------

    def add_service(self, svc) -> None:
        """Create a Service; the hub assigns the ClusterIP like the
        apiserver's service-ip allocator (pkg/registry/core/service),
        and NodePort/LoadBalancer services get node ports from the
        port allocator for every port that didn't pick its own."""
        import dataclasses

        wants_node_ports = getattr(svc, "type", "ClusterIP") in (
            "NodePort", "LoadBalancer")
        # Every allocation this create performs is tracked and rolled
        # back if ANY later step rejects it (ROADMAP bug (c): explicit
        # node-port reservations used to leak when the ClusterIP reserve
        # or a later allocator exhaustion raised) — the reference
        # apiserver releases allocations on failed create the same way.
        reserved_ports = []  # explicit + auto node ports taken here
        allocated_ip = ""  # ClusterIP WE allocated (cleared on rollback)
        reserved_ip = ""  # caller VIP WE reserved (released, field kept)
        try:
            if wants_node_ports:
                # validate explicit picks FIRST (a duplicate raises the
                # apiserver's 'already allocated' 422 analog); a port
                # repeated WITHIN the service is the same 422 (it would
                # double-release on delete otherwise)
                seen = set()
                for p in svc.ports:
                    if p.node_port:
                        if p.node_port in seen:
                            raise ValueError(
                                f"provided node-port range {p.node_port} "
                                "is already allocated (duplicated within "
                                "the service)")
                        seen.add(p.node_port)
                        self.nodeport_alloc.reserve(p.node_port)
                        reserved_ports.append(p.node_port)
            if not svc.cluster_ip:
                svc.cluster_ip = self.ip_alloc.allocate()
                allocated_ip = svc.cluster_ip
            else:
                self.ip_alloc.reserve(svc.cluster_ip)
                reserved_ip = svc.cluster_ip
            if wants_node_ports:
                ports = []
                for p in svc.ports:
                    if not p.node_port:
                        auto = self.nodeport_alloc.allocate()
                        reserved_ports.append(auto)
                        p = dataclasses.replace(p, node_port=auto)
                    ports.append(p)
                svc.ports = tuple(ports)
        except Exception:
            for n in reserved_ports:
                self.nodeport_alloc.release(n)
            if allocated_ip:
                self.ip_alloc.release(allocated_ip)
                svc.cluster_ip = ""
            elif reserved_ip:
                # caller-specified VIP: release OUR reservation (the CIDR
                # slot must not leak) but keep the field — it is the
                # caller's requested spec, not something we minted
                self.ip_alloc.release(reserved_ip)
            raise
        self.services[svc.key()] = svc
        self._commit(f"services/{svc.key()}", "ADDED", svc)

    def delete_service(self, key: str) -> None:
        svc = self.services.pop(key, None)
        if svc is not None:
            if svc.cluster_ip:
                self.ip_alloc.release(svc.cluster_ip)
            for p in svc.ports:
                if p.node_port:
                    self.nodeport_alloc.release(p.node_port)
            self._commit(f"services/{key}", "DELETED", None)

    def put_endpoints(self, ep) -> None:
        verb = "MODIFIED" if ep.key() in self.endpoints else "ADDED"
        self.endpoints[ep.key()] = ep
        self._commit(f"endpoints/{ep.key()}", verb, ep)

    def delete_endpoints(self, key: str) -> None:
        if self.endpoints.pop(key, None) is not None:
            self._commit(f"endpoints/{key}", "DELETED", None)

    def sync_proxies(self) -> None:
        """Every node's proxy recompiles its rule table from the current
        (services, endpoints) snapshot — the per-node syncProxyRules pass
        kubemark's hollow-proxy runs against fake iptables."""
        for pr in self.proxies.values():
            pr.sync(self.services, self.endpoints)

    # -- controllers / churn ------------------------------------------------

    def add_replicaset(self, rs: ReplicaSet) -> None:
        self.replicasets[rs.name] = rs

    def add_deployment(self, d: Deployment) -> None:
        self.deployments[d.name] = d

    def scale_deployment(self, name: str, replicas: int) -> None:
        d = self.deployments.get(name)
        if d is None:
            raise KeyError(f"deployment {name!r} not found")
        d.replicas = replicas

    def delete_deployment(self, name: str) -> None:
        """Cascading delete: the GC pass removes the orphaned ReplicaSet
        and its pods (ownerReference chain, pkg/controller/garbagecollector
        foreground deletion)."""
        self.deployments.pop(name, None)

    def add_job(self, j: Job) -> None:
        self.jobs[j.name] = j

    def add_daemonset(self, ds: DaemonSet) -> None:
        self.daemonsets[ds.name] = ds

    def delete_daemonset(self, name: str) -> None:
        """Foreground cascade: removing the DaemonSet deletes its pods
        (the GC the ownerReference chain drives in the reference)."""
        ds = self.daemonsets.pop(name, None)
        if ds is not None:
            for key in list(ds.live):
                self.delete_pod(key)

    def add_cronjob(self, cj: CronJob) -> None:
        cj.next_run = self.clock.t
        self.cronjobs[cj.name] = cj

    def add_hpa(self, hpa: HorizontalPodAutoscaler) -> None:
        self.hpas[hpa.name] = hpa

    def add_statefulset(self, ss: StatefulSet) -> None:
        self.statefulsets[ss.name] = ss

    def scale_statefulset(self, name: str, replicas: int) -> None:
        self.statefulsets[name].replicas = replicas

    def delete_statefulset(self, name: str) -> None:
        if self.statefulsets.pop(name, None) is not None:
            for key, p in list(self.truth_pods.items()):
                if p.labels.get("ss") == name:
                    self.delete_pod(key)

    def reconcile_history(self) -> None:
        """The history controller (pkg/controller/history
        ControllerRevisions): snapshot every DS/STS template revision,
        GC beyond revisionHistoryLimit (oldest first, never the live
        revision), drop revisions of deleted owners."""
        owners = (
            [("DaemonSet", n, d) for n, d in self.daemonsets.items()]
            + [("StatefulSet", n, s) for n, s in self.statefulsets.items()]
        )
        live = set()
        for kind, name, obj in owners:
            # drain revisions recorded synchronously at rollout() time —
            # a revision current for zero passes is still history
            for rev, data in obj.pending_revisions:
                pkey = f"{kind}/{name}/{rev}"
                if pkey not in self.controller_revisions:
                    self.controller_revisions[pkey] = ControllerRevision(
                        kind, name, rev, data)
            obj.pending_revisions.clear()
            key = f"{kind}/{name}/{obj.template_rev}"
            if key not in self.controller_revisions:
                self.controller_revisions[key] = ControllerRevision(
                    kind, name, obj.template_rev, obj.template())
            per_owner = sorted(
                (cr for cr in self.controller_revisions.values()
                 if cr.owner_kind == kind and cr.owner_name == name),
                key=lambda cr: cr.revision)
            # never GC a revision pods can still be created AT: the
            # update revision, and (STS) the currentRevision a canary
            # partition recreates below-boundary pods from
            keep = {obj.template_rev,
                    getattr(obj, "current_rev", obj.template_rev)}
            while (len(per_owner) > self.revision_history_limit
                   and per_owner[0].revision not in keep):
                del self.controller_revisions[per_owner.pop(0).key()]
            live.update(cr.key() for cr in per_owner)
        for key in [k for k in self.controller_revisions if k not in live]:
            del self.controller_revisions[key]

    def rollback(self, kind: str, name: str, to_revision: int) -> None:
        """``kubectl rollout undo --to-revision`` for DS/STS: re-apply
        the stored revision's template. Like the reference, undo creates
        a NEW revision carrying the old template (history is
        append-only), and the rolling machinery replaces pods."""
        cr = self.controller_revisions.get(f"{kind}/{name}/{to_revision}")
        if cr is None:
            raise KeyError(
                f"{kind.lower()}s {name!r} has no revision {to_revision}")
        obj = (self.daemonsets if kind == "DaemonSet"
               else self.statefulsets)[name]
        if cr.data == obj.template():
            # undo to the template already running: the reference
            # short-circuits ("skipped rollback") — bumping anyway would
            # roll-restart every pod for zero change
            return
        obj.rollout(**cr.data)

    def reconcile_controllers(self) -> None:
        import math

        self.reconcile_history()

        # hpa: scale the target deployment toward the metric target
        # (podautoscaler/horizontal.go; desired = ceil(current * ratio),
        # 10% tolerance dead-band per replica_calculator.go:89) — runs
        # before the deployment sync so the new size propagates this tick
        for hpa in self.hpas.values():
            d = self.deployments.get(hpa.deployment)
            if d is None or hpa.load_fn is None:
                continue
            current = max(1, d.replicas)
            target = hpa.target_utilization
            ratio = (float(hpa.load_fn()) / target) if target > 0 else 1.0
            desired = current if abs(ratio - 1.0) <= hpa.tolerance \
                else math.ceil(current * ratio)
            d.replicas = min(hpa.max_replicas,
                             max(hpa.min_replicas, desired))

        # cronjobs: spawn Jobs on schedule (cronjob_controller.go syncOne);
        # a multi-period clock jump still launches one run per sync — the
        # reference's missed-start accounting compressed to its effect
        for cj in self.cronjobs.values():
            if self.clock.t < cj.next_run:
                continue
            active = [jn for jn in cj.spawned
                      if jn in self.jobs and not self.jobs[jn].done()]
            if active and cj.concurrency == "Forbid":
                # skipped runs are dropped, never queued: catch the
                # schedule up past NOW or a long-running job would be
                # followed by a burst of back-to-back make-up runs
                while cj.next_run <= self.clock.t:
                    cj.next_run += cj.every_s
                continue
            if active and cj.concurrency == "Replace":
                for jn in active:
                    j = self.jobs.pop(jn)
                    for key in list(j.active):
                        self.delete_pod(key)
                    cj.spawned.remove(jn)
            cj.runs += 1
            jn = f"{cj.name}-{cj.runs}"
            while jn in self.jobs:
                # a foreign job already owns this name: the apiserver
                # would reject the duplicate create — never overwrite it
                cj.runs += 1
                jn = f"{cj.name}-{cj.runs}"
            self.jobs[jn] = Job(jn, completions=cj.completions,
                                parallelism=cj.parallelism,
                                duration_s=cj.duration_s,
                                cpu_milli=cj.cpu_milli, memory=cj.memory,
                                owner=cj.name)
            cj.spawned.append(jn)
            cj.next_run += cj.every_s

        # deployment -> replicasets (create/scale/rolling update)
        for d in self.deployments.values():
            new_rs = self.replicasets.get(d.rs_name())
            olds = [rs for rs in self.replicasets.values()
                    if rs.owner == d.name and rs.name != d.rs_name()]
            if new_rs is None:
                # getNewReplicaSet: the new revision's RS starts at 0 when
                # an old RS exists (the rolling path scales it), else at
                # full size (first sync of a fresh deployment)
                new_rs = ReplicaSet(d.rs_name(), 0 if olds else d.replicas,
                                    d.cpu_milli, d.memory, d.priority,
                                    owner=d.name, revision=d.template_rev)
                self.replicasets[new_rs.name] = new_rs
            if not olds:
                new_rs.replicas = d.replicas
                continue
            if d.strategy == "Recreate":
                # recreate.go: scale every old RS to 0 first; the new RS
                # only grows once NO old pod remains (never-mixed
                # versions, at the cost of downtime)
                for rs in olds:
                    rs.replicas = 0
                new_rs.replicas = (
                    d.replicas
                    if not any(rs.live for rs in olds) else 0
                )
                continue
            # ---- RollingUpdate reconciliation (rolling.go:31) ----
            # a mid-rollout SCALE-DOWN must bite immediately: the new RS
            # never holds more than the (new) desired size, even while
            # old RSes are still draining (without this clamp a shrink
            # waits for the old RS to empty, holding quota)
            new_rs.replicas = min(new_rs.replicas, d.replicas)
            surge = _int_or_percent(d.max_surge, d.replicas, round_up=True)
            max_unavail = _int_or_percent(d.max_unavailable, d.replicas,
                                          round_up=False)
            if surge == 0 and max_unavail == 0:
                # a percentage budget that rounds to 0 at this replica
                # count (literal 0/0 is rejected at construction) — the
                # reference coerces unavailable to 1 here so the rollout
                # still progresses (intstr ResolveFenceposts)
                max_unavail = 1
            # old RSes never grow and never replace lost pods mid-rollout
            # (the reference only ever scales them down; a dead old pod
            # is rollout progress, not something to recreate)
            for rs in olds:
                rs.replicas = min(rs.replicas, len(rs.live))
            # reconcileNewReplicaSet: grow the new RS within the surge
            # budget (NewRSNewReplicas: total may reach replicas+surge)
            total = new_rs.replicas + sum(rs.replicas for rs in olds)
            if total < d.replicas + surge:
                new_rs.replicas = min(
                    d.replicas, new_rs.replicas + (d.replicas + surge - total)
                )
            # reconcileOldReplicaSets: unavailable (unbound) old pods are
            # free to delete (cleanupUnhealthyReplicas), then drain down
            # to the availability floor replicas-maxUnavailable
            def available(rs):
                return sum(
                    1 for k in rs.live
                    if k in self.truth_pods and self.truth_pods[k].node_name
                )

            for rs in olds:
                rs.replicas -= min(rs.replicas, len(rs.live) - available(rs))
            avail_total = available(new_rs) + sum(available(rs) for rs in olds)
            can_kill = max(0, avail_total - (d.replicas - max_unavail))
            for rs in sorted(olds, key=lambda r: r.revision):
                if can_kill <= 0:
                    break
                down = min(rs.replicas, can_kill)
                rs.replicas -= down
                can_kill -= down
        # garbage collector: deployment gone -> cascade its RS + pods;
        # drained old-revision RSes are removed once empty (the hollow
        # form of revisionHistoryLimit cleanup)
        for name in list(self.replicasets):
            rs = self.replicasets[name]
            if rs.owner and rs.owner not in self.deployments:
                for key in list(rs.live):
                    self.delete_pod(key)
                del self.replicasets[name]
            elif (rs.owner and rs.replicas == 0 and not rs.live
                  and rs.owner in self.deployments
                  and name != self.deployments[rs.owner].rs_name()):
                del self.replicasets[name]
        # replicaset/RC scale-down (deployment shrink, rolling drain, or
        # direct resize) — unassigned pods are deleted first, the
        # ActivePods ranking of controller_utils.go:722, which is what
        # keeps the rolling availability budget honest
        for rs in (list(self.replicasets.values())
                   + list(self.replication_controllers.values())):
            extra = len(rs.live) - rs.replicas
            if extra > 0:
                victims = sorted(rs.live, key=lambda k: bool(
                    k in self.truth_pods and self.truth_pods[k].node_name))
                for key in victims[:extra]:
                    self.delete_pod(key)
        def spawn(prefix: str, idx: int, labels: dict, cpu, mem, pri=0,
                  owner: "OwnerReference | None" = None):
            pod = make_pod(f"{prefix}-{idx}", cpu_milli=cpu, memory=mem,
                           priority=pri, labels=labels,
                           owner_refs=(owner,) if owner else ())
            pod.uid = f"{prefix}-{idx}#{idx}"
            try:
                self.create_pod(pod)
            except AdmissionError:
                # a real controller gets the 403 and retries next sync
                # (quota may free up as pods finish)
                return None
            return pod

        # jobs: finish pods that ran their duration; keep parallelism fed
        for j in self.jobs.values():
            for key in list(j.active):
                if key not in self.truth_pods:
                    j.active.pop(key)  # evicted/killed: controller re-adds
                    continue
                t0 = self._bound_at.get(key)
                if t0 is not None and self.clock.t - t0 >= j.duration_s:
                    j.succeeded += 1
                    j.active.pop(key)
                    # terminal phase hop is observable in the watch
                    # history BEFORE the delete (Running -> Succeeded ->
                    # DELETED, the full lifecycle chain)
                    import dataclasses

                    from kubernetes_tpu_torch.api.types import POD_SUCCEEDED

                    done = dataclasses.replace(
                        self.truth_pods[key], phase=POD_SUCCEEDED,
                        ready=False)
                    self.truth_pods[key] = done
                    self._commit(f"pods/{key}", "MODIFIED", done)
                    self.delete_pod(key)  # Succeeded -> cleaned up
            if j.done() and j.finished_at is None:
                # status.completionTime — the TTL-after-finished clock
                j.finished_at = self.clock.t
            while (not j.done()
                   and len(j.active) < j.parallelism
                   and j.succeeded + len(j.active) < j.completions):
                j.next_idx += 1
                pod = spawn(j.name, j.next_idx, {"job": j.name},
                            j.cpu_milli, j.memory,
                            owner=OwnerReference("Job", j.name))
                if pod is None:
                    break
                j.active[pod.key()] = pod
        for rs in (list(self.replicasets.values())
                   + list(self.replication_controllers.values())):
            while len(rs.live) < rs.replicas:
                rs.next_idx += 1
                # the owner label is revision-stable: a Service selecting
                # {"deploy": name} spans old and new RSes mid-rollout
                is_rc = rs.kind == "ReplicationController"
                labels = {"rc": rs.name} if is_rc else {"rs": rs.name}
                if rs.owner:
                    labels["deploy"] = rs.owner
                # the reference's generateName random suffix is what
                # keeps same-name RC and RS pods from colliding; the
                # hollow deterministic naming needs a kind discriminator
                # instead
                pod = spawn(f"{rs.name}-rc" if is_rc else rs.name,
                            rs.next_idx, labels,
                            rs.cpu_milli, rs.memory, rs.priority,
                            owner=OwnerReference(rs.kind, rs.name))
                if pod is None:
                    break
                rs.live[pod.key()] = pod

        # daemonsets: exactly one pod per eligible node, pinned by
        # required node affinity and pushed through the regular scheduler
        # (v1.16 ScheduleDaemonSetPods); pods whose node vanished, fell
        # out of the selector, or got bound somewhere other than their pin
        # (a competing writer ignoring affinity — the apiserver accepts
        # such bindings) are deleted — the controller's per-node
        # expectations pass (daemon_controller.go manage())
        for ds in self.daemonsets.values():
            keep = {n.name for n in self.truth_nodes.values()
                    if ds.should_keep(n)}
            for key, node_name in list(ds.live.items()):
                p = self.truth_pods.get(key)
                mispinned = (p is not None and p.node_name
                             and p.node_name != node_name)
                if node_name not in keep or mispinned:
                    self.delete_pod(key)
            # RollingUpdate (daemon/update.go rollingUpdate): delete
            # stale-revision daemon pods while at most max_unavailable
            # nodes lack a RUNNING current-revision pod — the normal
            # create loop below recreates with the new template (one
            # node at a time at the default maxUnavailable=1)
            want_rev = str(ds.template_rev)
            # unavailable = daemon pods not RUNNING (any revision): a
            # stale-but-running pod still serves — it does not charge
            # the budget, it's what the budget lets us kill
            unavail = sum(
                1 for key in ds.live
                if (p := self.truth_pods.get(key)) is None
                or not p.node_name
            )
            budget = ds.max_unavailable - unavail
            for key in sorted(ds.live):
                if budget <= 0:
                    break
                p = self.truth_pods.get(key)
                if p is not None and p.labels.get("rev") != want_rev:
                    self.delete_pod(key)
                    budget -= 1
            have = set(ds.live.values())
            for node_name in sorted(
                    n.name for n in self.truth_nodes.values()
                    if ds.can_place(n) and n.name not in have):
                pod = make_pod(
                    f"{ds.name}-{node_name}",
                    cpu_milli=ds.cpu_milli, memory=ds.memory,
                    priority=ds.priority,
                    labels={"ds": ds.name, "rev": want_rev},
                    affinity=node_affinity_required(
                        [req("kubernetes.io/hostname", "In", node_name)]
                    ),
                    tolerations=DAEMON_TOLERATIONS,
                    owner_refs=(OwnerReference("DaemonSet", ds.name),),
                )
                try:
                    self.create_pod(pod)
                except AdmissionError:
                    continue
                ds.live[pod.key()] = node_name

        # statefulsets: OrderedReady — scale down highest ordinal first
        # (one per sync), otherwise create the lowest missing ordinal only
        # once every predecessor is bound (stateful_set_control.go)
        for ss in self.statefulsets.values():
            by_ord: Dict[int, Pod] = {}
            for p in self.truth_pods.values():
                if p.labels.get("ss") != ss.name:
                    continue
                try:
                    by_ord[int(p.name.rsplit("-", 1)[1])] = p
                except (IndexError, ValueError):
                    continue
            over = [o for o in by_ord if o >= ss.replicas]
            if over:
                self.delete_pod(by_ord[max(over)].key())
                continue  # one termination per sync; creation waits
            # RollingUpdate (stateful_set_control.go updateStatefulSet):
            # ordinals >= partition whose revision is stale are deleted
            # HIGHEST-first, one per sync, only while every pod is bound
            # (OrderedReady never tears down into an unsettled set); the
            # missing-ordinal create below recreates with the new
            # template. Ordinals below the partition keep the old
            # revision — the canary boundary.
            want_rev = str(ss.template_rev)
            if all(p.node_name for p in by_ord.values()):
                stale = [o for o, p in by_ord.items()
                         if o >= ss.partition
                         and p.labels.get("rev") != want_rev]
                if stale:
                    self.delete_pod(by_ord[max(stale)].key())
                    continue
                if (not stale and len(by_ord) == ss.replicas
                        and ss.current_rev != ss.template_rev
                        and ss.partition == 0):
                    # rollout complete: status.currentRevision catches
                    # up to updateRevision (updateStatefulSetStatus)
                    ss.current_rev = ss.template_rev
            for o in range(ss.replicas):
                p = by_ord.get(o)
                if p is None:
                    if o < ss.partition:
                        # below the canary boundary: recreate at the
                        # CURRENT revision's template, not the update's
                        # (the reference recreates at currentRevision)
                        cur = self.controller_revisions.get(
                            f"StatefulSet/{ss.name}/{ss.current_rev}")
                        tpl = cur.data if cur is not None else ss.template()
                        rev_label = str(ss.current_rev)
                    else:
                        tpl = ss.template()
                        rev_label = want_rev
                    pod = make_pod(ss.pod_name(o),
                                   cpu_milli=tpl["cpu_milli"],
                                   memory=tpl["memory"],
                                   priority=tpl["priority"],
                                   labels={"ss": ss.name,
                                           "rev": rev_label},
                                   owner_refs=(OwnerReference(
                                       "StatefulSet", ss.name),))
                    try:
                        self.create_pod(pod)
                    except AdmissionError:
                        pass
                    break
                if not p.node_name:
                    break  # predecessor not Running yet: hold the line

        # cronjob history GC — after the jobs pass above so jobs that
        # finished THIS sync count against successfulJobsHistoryLimit
        for cj in self.cronjobs.values():
            finished = [jn for jn in cj.spawned
                        if jn in self.jobs and self.jobs[jn].done()]
            while len(finished) > cj.history_limit:
                jn = finished.pop(0)
                cj.spawned.remove(jn)
                del self.jobs[jn]

    def churn(self, kill_pods: int = 0, flap_nodes: int = 0) -> None:
        """Random disruption: delete bound pods, bounce nodes."""
        bound = [k for k, p in self.truth_pods.items() if p.node_name]
        for key in self.rng.sample(bound, min(kill_pods, len(bound))):
            self.delete_pod(key)
        names = list(self.truth_nodes)
        for name in self.rng.sample(names, min(flap_nodes, len(names))):
            self.remove_node(name)

    # -- disruption controller (pkg/controller/disruption) ------------------

    def add_replication_controller(self, name: str, replicas: int,
                                   cpu_milli: float = 100,
                                   memory: float = 256 * 2**20,
                                   priority: int = 0) -> "ReplicaSet":
        """v1 ReplicationController create — reconciled by the exact
        ReplicaSet machinery (the reference's RC controller is the RS
        controller behind conversion adapters, replication_controller
        .go:58); pods carry kind=ReplicationController ownerReferences
        so the GC graph keys on the right kind."""
        rc = ReplicaSet(name, replicas, cpu_milli, memory, priority,
                        kind="ReplicationController")
        self.replication_controllers[name] = rc
        return rc

    def add_pdb(self, pdb) -> None:
        self.pdbs.append(pdb)

    def evict_pod(self, key: str):
        """The Eviction subresource's storage half (policy/v1beta1
        Eviction; registry/core/pod/storage/eviction.go:147 checks every
        covering PDB and PATCHes disruptionsAllowed down atomically):
        returns (True, "") and deletes the pod, or (False, message) when
        any covering budget is exhausted — the 429 the apiserver sends.
        The disruption is charged IMMEDIATELY (all covering PDBs
        decrement) so a burst of evictions cannot overshoot the budget
        between disruption-controller passes."""
        import dataclasses

        pod = self.truth_pods.get(key)
        if pod is None:
            return False, f'pods "{key}" not found'
        covering = [pdb for pdb in self.pdbs if pdb.matches(pod)]
        if any(pdb.disruptions_allowed <= 0 for pdb in covering):
            return False, (
                "Cannot evict pod as it would violate the pod's "
                "disruption budget."
            )
        for pdb in covering:
            pdb.disruptions_allowed -= 1
        # observable terminating hop (deletionTimestamp) before the
        # delete — endpoints/watchers see the pod leave rotation first.
        # clock.t can be 0.0 at sim start and deletionTimestamp's unset
        # value is also 0.0, so floor at a positive epsilon or the hop
        # would be invisible to every `not deletion_timestamp` consumer
        terminating = dataclasses.replace(
            pod, deletion_timestamp=self.clock.t or 1e-6)
        self.truth_pods[key] = terminating
        self._commit(f"pods/{key}", "MODIFIED", terminating)
        self.delete_pod(key)
        return True, ""

    def reconcile_pdbs(self) -> None:
        """Maintain PDB status the way the disruption controller does:
        disruptionsAllowed = max(0, currentHealthy - minAvailable), where
        healthy = bound, non-terminating matching pods (updatePdbStatus,
        pkg/controller/disruption/disruption.go)."""
        for pdb in self.pdbs:
            if pdb.min_available is None:
                continue
            healthy = sum(
                1
                for p in self.truth_pods.values()
                if p.node_name and not p.deletion_timestamp and pdb.matches(p)
            )
            pdb.disruptions_allowed = max(0, healthy - pdb.min_available)

    # -- node lifecycle controller (node_lifecycle_controller.go) -----------

    TAINT_UNREACHABLE = "node.kubernetes.io/unreachable"

    def kill_kubelet(self, name: str) -> None:
        """The node's kubelet stops heartbeating — the node object remains
        (unlike :meth:`remove_node`); the lifecycle controller must notice
        via heartbeat age, not via a delete event."""
        self.dead_kubelets.add(name)
        if name in self.kubelets:
            self.kubelets[name].alive = False

    def heal_kubelet(self, name: str) -> None:
        self.dead_kubelets.discard(name)
        if name in self.kubelets:
            self.kubelets[name].alive = True
            self.kubelets[name].heartbeat()

    def _update_node(self, node: Node) -> None:
        self.truth_nodes[node.name] = node
        self._commit(f"nodes/{node.name}", "MODIFIED", node)
        self._emit(f"nodes/{node.name}", lambda: self.sched.on_node_update(node))

    def monitor_node_health(self) -> None:
        """monitorNodeHealth (:660): heartbeat older than the grace period
        ⇒ Ready=Unknown + NoExecute unreachable taint; a fresh heartbeat
        ⇒ restore. Then NoExecute eviction (:579): pods on a tainted node
        that don't tolerate it are evicted once their toleration window
        (here: ``eviction_wait_s``) passes — rate-limited per zone
        (handleDisruption/setLimiterInZone, :998,:1096)."""
        import dataclasses

        now = self.clock.t
        for name, nd in list(self.truth_nodes.items()):
            age = now - self.heartbeats.get(name, now)
            tainted = any(t.key == self.TAINT_UNREACHABLE for t in nd.taints)
            if age > self.node_grace_s and not tainted:
                new = dataclasses.replace(
                    nd,
                    conditions=dataclasses.replace(nd.conditions, ready=False),
                    taints=nd.taints
                    + (Taint(self.TAINT_UNREACHABLE, effect=EFFECT_NO_EXECUTE),),
                )
                self._taint_time[name] = now
                self._update_node(new)
            elif age <= self.node_grace_s and tainted:
                new = dataclasses.replace(
                    nd,
                    conditions=dataclasses.replace(nd.conditions, ready=True),
                    taints=tuple(
                        t for t in nd.taints if t.key != self.TAINT_UNREACHABLE
                    ),
                )
                self._taint_time.pop(name, None)
                self._update_node(new)
        # NoExecute eviction, zone-rate-limited
        evicted_in_zone: Dict[str, int] = {}
        for key, p in list(self.truth_pods.items()):
            if not p.node_name:
                continue
            nd = self.truth_nodes.get(p.node_name)
            if nd is None:
                continue
            t0 = self._taint_time.get(nd.name)
            if t0 is None or now - t0 <= self.eviction_wait_s:
                continue
            # NoExecute taint-manager semantics (taint_manager.go):
            # tolerating without tolerationSeconds = never evicted;
            # with tolerationSeconds = evicted once the window passes
            # (DefaultTolerationSeconds admission stamps 300 s on pods
            # that declare nothing)
            tols = [
                tol for tol in p.tolerations
                if tol.tolerates(Taint(self.TAINT_UNREACHABLE,
                                       effect=EFFECT_NO_EXECUTE))
            ]
            if tols:
                secs = [t.toleration_seconds for t in tols]
                if any(s is None for s in secs):
                    continue
                # getMinTolerationTime (taint_manager.go): the SHORTEST
                # matching window bounds how long the pod may stay
                if now - t0 <= min(secs):
                    continue
            zone = nd.zone() or ""
            if evicted_in_zone.get(zone, 0) >= self.zone_eviction_rate:
                continue
            evicted_in_zone[zone] = evicted_in_zone.get(zone, 0) + 1
            self.delete_pod(key)

    def competing_writer(self) -> None:
        """An HA peer / external controller binding pending pods behind the
        scheduler's back. Every such bind is a legal hub write (capacity
        checked against truth), so any later scheduler bind for the same
        pod MUST hit the CAS conflict and Forget+requeue."""
        if self.competing_bind_rate <= 0:
            return
        free: Dict[str, List[float]] = {}
        for name, nd in self.truth_nodes.items():
            free[name] = [nd.allocatable.cpu_milli, nd.allocatable.memory,
                          nd.allocatable.pods]
        for p in self.truth_pods.values():
            if p.node_name and p.node_name in free:
                f = free[p.node_name]
                f[0] -= p.requests.cpu_milli
                f[1] -= p.requests.memory
                f[2] -= 1
        for key, p in list(self.truth_pods.items()):
            if p.node_name or self.rng.random() >= self.competing_bind_rate:
                continue
            fits = [
                n for n, f in free.items()
                if f[0] >= p.requests.cpu_milli and f[1] >= p.requests.memory
                and f[2] >= 1
            ]
            if not fits:
                continue
            target = self.rng.choice(fits)
            try:
                self.confirm_binding(p, target)
            except Conflict:
                continue
            f = free[target]
            f[0] -= p.requests.cpu_milli
            f[1] -= p.requests.memory
            f[2] -= 1
            self.competing_bound += 1

    # -- run ----------------------------------------------------------------

    def step(self, dt: float = 15.0):
        """One sim tick: deliver due watch events, GC orphans, let the
        competing writer race, reconcile controllers, run a scheduling
        cycle, advance time (so backoffs expire across ticks)."""
        with self.lock:
            return self._step_locked(dt)

    def _step_locked(self, dt: float):
        self._tick += 1
        self.flush_events()
        self.gc_orphaned()
        for kl in list(self.kubelets.values()):  # syncLoop ticks
            kl.sync()
        self.sync_pod_lifecycle()
        self.monitor_node_health()
        self.reconcile_pdbs()
        if self.cloud_controller is not None:
            self.cloud_controller.reconcile()
            self.service_lb_controller.reconcile()
            self.route_controller.reconcile()
        if self.admission is not None:
            self.reconcile_namespaces()
            self.quota_controller.reconcile()
        elif any(ns.phase == NS_TERMINATING
                 for ns in self.namespaces.values()):
            # without the admission chain nothing STOPS creates into a
            # terminating namespace, but a deletion must still drain —
            # a REST DELETE namespace on an admission-less hub would
            # otherwise terminate forever
            self.reconcile_namespaces()
        # unconditional: an (impossible today) empty namespaces dict must
        # still REVOKE — gating here would freeze dead tokens alive
        self.reconcile_service_accounts()
        if any(getattr(r, "aggregation_selectors", ())
               for r in self.cluster_roles.values()):
            from kubernetes_tpu_torch.auth import aggregate_cluster_roles

            aggregate_cluster_roles(self.cluster_roles)
        self.cert_controller.reconcile()
        self.root_ca_publisher.reconcile()
        if self.bootstrap_tokens or (
                f"kube-public/cluster-info" in self.configmaps):
            # bootstrap-token controllers (kubernetes_tpu_torch/bootstrap.py):
            # cleaner expires tokens, signer keeps cluster-info's
            # signature set in lockstep with the live token set
            from kubernetes_tpu_torch.bootstrap import (
                bootstrap_signer,
                token_cleaner,
            )

            token_cleaner(self)
            bootstrap_signer(self)
        self.reconcile_ttl()
        self.reconcile_node_ipam()
        self.reconcile_ttl_after_finished()
        self.reconcile_controllers()
        self.gc_owner_graph()
        self.reconcile_pod_gc()
        if self.pvcs or self.pvs:
            self.reconcile_volume_protection()
            self.reconcile_volumes()
        if (self.pvs or self.attachments
                or any(p.volumes for p in self.truth_pods.values())):
            # the any() covers INLINE attachable volumes (no PV objects
            # in the cluster) — without it that half of the controller
            # would never run
            self.reconcile_attachments()
        if self.services or self.endpoints:
            self.endpoints_controller.reconcile()
            self.sync_proxies()
        # the competing writer races AFTER new pods exist but BEFORE the
        # scheduler's cycle — the window where the scheduler's view goes
        # stale and its binds must CAS-fail
        self.competing_writer()
        res = self.sched.schedule_cycle()
        # periodic compaction to the slowest open cursor (etcd's
        # auto-compaction): history stays bounded by watcher lag, not by
        # sim length
        floor = min((c.rev for c in self._cursors), default=self._revision)
        self.compact(floor)
        self.clock.advance(dt)
        return res

    def check_consistency(self) -> None:
        """Invariants at the settled state (all watch events delivered —
        the comparer in the reference also reads the synced informer view):
        - cache matches truth (comparer),
        - no node over-committed in truth (cpu/memory/pod count),
        - every truth-bound pod landed on a live node."""
        self.settle()
        from kubernetes_tpu_torch.api.types import is_pod_terminated

        # terminal pods are deliberately absent from the scheduler cache
        # (their phase hop reached it as a DELETE — the informer field
        # selector); the comparer sees the same filtered view
        truth = {k: p.node_name for k, p in self.truth_pods.items()
                 if not is_pod_terminated(p)}
        node_diffs, pod_diffs = compare(self.sched, truth, list(self.truth_nodes))
        assert not node_diffs, f"cache/truth node diffs: {node_diffs}"
        assert not pod_diffs, f"cache/truth pod diffs: {pod_diffs}"
        by_node: Dict[str, List[Pod]] = {}
        for p in self.truth_pods.values():
            if p.node_name:
                assert p.node_name in self.truth_nodes, (
                    f"{p.key()} bound to dead node {p.node_name}"
                )
                if is_pod_terminated(p):
                    continue  # exited containers hold no resources
                by_node.setdefault(p.node_name, []).append(p)
        for name, pods in by_node.items():
            nd = self.truth_nodes[name]
            cpu = sum(p.requests.cpu_milli for p in pods)
            mem = sum(p.requests.memory for p in pods)
            assert cpu <= nd.allocatable.cpu_milli + 1e-6, f"{name} cpu overcommit"
            assert mem <= nd.allocatable.memory + 1e-6, f"{name} mem overcommit"
            assert len(pods) <= nd.allocatable.pods, f"{name} pod-count overcommit"
        # service dataplane: endpoints/proxies agree with (services, pods)
        if self.services:
            self.endpoints_controller.reconcile()
            self.sync_proxies()
            for key, svc in self.services.items():
                ep = self.endpoints.get(key)
                assert ep is not None, f"service {key} has no Endpoints"
                from kubernetes_tpu_torch.proxy import pod_endpoint_ready

                want = sorted(
                    p.key() for p in self.truth_pods.values()
                    if svc.selects(p) and pod_endpoint_ready(p)
                )
                got = sorted(a.pod_key for a in ep.ready)
                assert got == want, f"{key} endpoints drift: {got} != {want}"
                for a in ep.ready:
                    assert self.truth_pods[a.pod_key].node_name == a.node_name
        # volume truth: PVC<->PV binding is mutual and exclusive (the
        # pv_controller's own invariant: a bound pair references each
        # other; no PV serves two claims)
        claimants: Dict[str, str] = {}
        for key, pvc in self.pvcs.items():
            if not pvc.volume_name:
                continue
            pv = self.pvs.get(pvc.volume_name)
            assert pv is not None, f"pvc {key} bound to unknown pv"
            assert pv.claim_ref == key, (
                f"pv {pv.name} claimRef {pv.claim_ref!r} != {key!r}"
            )
            assert claimants.setdefault(pvc.volume_name, key) == key, (
                f"pv {pvc.volume_name} double-claimed"
            )
        for pv in self.pvs.values():
            if pv.claim_ref:
                pvc = self.pvcs.get(pv.claim_ref)
                assert pvc is not None and pvc.volume_name == pv.name, (
                    f"pv {pv.name} claimRef not reciprocated"
                )
        # ownerRef graph: at the settled state no object may outlive its
        # every controller owner (the GC pass must have converged)
        kinds = self._owner_kinds()
        for p in self.truth_pods.values():
            if p.owner_refs:
                assert any(r.name in kinds.get(r.kind, {})
                           for r in p.owner_refs), (
                    f"{p.key()} outlives its owners {p.owner_refs}"
                )
        for name, j in self.jobs.items():
            assert not j.owner or j.owner in self.cronjobs, (
                f"job {name} outlives CronJob {j.owner}"
            )

    def pending_count(self) -> int:
        return sum(1 for p in self.truth_pods.values() if not p.node_name)


class WatchCursor:
    """One watcher's position in the hub's history — the apiserver watch
    stream a client holds. Independent cursors = watch fan-out
    (storage/cacher/cacher.go: many watchers, one event source)."""

    def __init__(self, hub: HollowCluster, since_rev: int) -> None:
        self.hub = hub
        self.rev = since_rev

    def poll(self) -> List[tuple]:
        """Events after this cursor's revision, advancing it. Raises
        :class:`Compacted` when the cursor fell behind the compaction
        floor (the relist trigger)."""
        if self.rev < self.hub._compacted_rev:
            raise Compacted(
                f"required revision {self.rev} has been compacted "
                f"(floor {self.hub._compacted_rev})"
            )
        h = self.hub._history
        i = bisect.bisect_right(h, self.rev, key=lambda e: e[0])
        out = h[i:]
        self.rev = max(self.rev, self.hub._revision)
        return out


class Reflector:
    """client-go Reflector.ListAndWatch (tools/cache/reflector.go:159)
    over the hub's versioned store, feeding a scheduler's event-handler
    surface (the SharedInformer seam):

    - LIST at a revision, deliver the snapshot as adds/updates/deletes
      RELATIVE to what this reflector already delivered (DeltaFIFO.Replace
      semantics — a relist must emit deletes for objects that vanished
      while the watch was down);
    - WATCH from that revision, translating history events into
      on_pod_add/on_pod_update/on_pod_delete/on_node_* calls;
    - a :class:`Compacted` watch error relists (reflector.go's
      "too old resource version" path);
    - resync() re-delivers every known object as a no-op update (the
      SharedInformer resync period);
    - ``pod_label_selector``/``pod_field_selector`` scope the POD feed
      the way the reference's ListWatch options do (a kubelet's pod
      informer lists with ``spec.nodeName=<self>``, kubelet/config/
      apiserver.go:32): selection happens at the feed layer before any
      sink delivery, and a MODIFIED pod that leaves the selector is
      delivered as a DELETE (watch-cache selector semantics), never
      silently retained.

    Network-fault hardening:

    - **resourceVersion-monotonic dedupe** — every delivered event
      carries the hub revision; an event at or below the object's last
      delivered revision is a NO-OP (``deduped`` counts them). This is
      what makes duplicated and reordered watch frames harmless: a
      stale MODIFIED reordered after its object's DELETE can never
      resurrect the object (the reference informer's resourceVersion
      comparison in the DeltaFIFO/store seam).
    - **progress deadline** — a watch that delivers NOTHING for
      ``progress_deadline_s`` while the hub has advanced revisions is
      treated as silently stalled (half-open connection class) and
      forced to relist instead of idling forever; forced relists (and
      Compacted storms) back off with FULL JITTER per replica
      (``relist_backoff``) so a fleet can't stampede a recovering hub.
      Both need an injected ``clock``; without one the behavior is
      exactly the pre-hardening Reflector.
    - ``cursor_wrap`` — chaos seam: wraps the watch cursor at relist
      time (chaos.FuzzedCursor injects drop/duplicate/reorder/410).
    """

    def __init__(self, hub: HollowCluster, sink,
                 pod_label_selector: str = "",
                 pod_field_selector: str = "",
                 clock: Optional[Callable[[], float]] = None,
                 progress_deadline_s: Optional[float] = None,
                 relist_backoff=None,
                 cursor_wrap=None) -> None:
        from kubernetes_tpu_torch.api.selectors import (
            match_fields,
            match_labels,
            parse_field_selector,
            parse_label_selector,
            pod_fields,
            validate_field_keys,
        )

        self.hub = hub
        self.sink = sink
        self.pods: Dict[str, Pod] = {}
        self.nodes: Dict[str, Node] = {}
        self.relists = 0
        self._cursor: Optional[WatchCursor] = None
        # -- network-fault hardening state --------------------------------
        self.clock = clock
        if progress_deadline_s is None:
            # robustness.watchProgressDeadline: a Scheduler sink carries
            # its config — the knob governs every reflector built on it
            # unless the caller pins a deadline explicitly (0 = off);
            # sinks without a robustness block keep detection off
            progress_deadline_s = getattr(
                getattr(sink, "robustness", None),
                "watch_progress_deadline_s", 0.0)
        self.progress_deadline_s = float(progress_deadline_s or 0.0)
        progress_deadline_s = self.progress_deadline_s
        if relist_backoff is None and progress_deadline_s > 0:
            # full jitter on a PER-REPLICA stream (SystemRandom seed):
            # two replicas stalling together must not relist in lockstep
            from kubernetes_tpu_torch.faults import RetryPolicy

            relist_backoff = RetryPolicy(
                base_s=1.0, max_s=30.0, jitter=0.5,
                seed=random.SystemRandom().randrange(1 << 30))
        self._relist_backoff = relist_backoff
        self._cursor_wrap = cursor_wrap
        #: per-object last DELIVERED revision (the dedupe floor) —
        #: LIVE objects only; deleted objects move to the tombstone LRU
        self._obj_rev: Dict[str, int] = {}
        #: dedupe floors for objects DELETED since the last relist,
        #: kept apart from the live map and LRU-bounded: between
        #: relists every churned-away pod would otherwise keep a floor
        #: entry forever (growth ∝ total churn — the soak sentinel's
        #: original finding). The floor cannot simply be dropped at the
        #: DELETE: a reordered stale MODIFIED arriving after it would
        #: resurrect the object. Evicting the OLDEST tombstone only
        #: narrows that reorder-protection window to the most recent
        #: ``tombstone_capacity`` deletions — the same bounded-window
        #: trade the jaxtel signature LRU makes.
        self._gone_rev: "OrderedDict[str, int]" = OrderedDict()
        self.tombstone_capacity = 4096
        #: duplicated / reordered-stale events dropped as no-ops
        self.deduped = 0
        #: relists forced by the progress deadline (stalled watch)
        self.stalled_relists = 0
        #: highest revision actually RECEIVED from the stream (the
        #: stall detector compares the hub's head against it — the
        #: cursor position alone can lie when frames are being eaten)
        self._delivered_rev = 0
        #: a 410 observed DURING the relist cool-down: the relist is
        #: owed once the window opens — a real compacted cursor would
        #: re-raise every poll, but an injected one-shot 410
        #: (chaos.FuzzedCursor) fires exactly once and must not be lost
        self._pending_compacted = False
        self._last_progress = clock() if clock is not None else 0.0
        self._next_relist_ok = 0.0
        self._stall_attempts = 0
        self._lsel = parse_label_selector(pod_label_selector)
        self._fsel = parse_field_selector(pod_field_selector)
        validate_field_keys(self._fsel, "pods")
        self._match_labels, self._match_fields = match_labels, match_fields
        self._pod_fields = pod_fields

    def _selects(self, p: Pod) -> bool:
        if not self._lsel and not self._fsel:
            return True
        return (self._match_labels(self._lsel, p.labels)
                and self._match_fields(self._fsel, self._pod_fields(p)))

    # -- list+watch --------------------------------------------------------

    def list_and_watch(self) -> None:
        rev, nodes, pods = self.hub.list_state()
        pods = {k: p for k, p in pods.items() if self._selects(p)}
        # Replace(): adds for new, updates for changed, deletes for gone
        for name, nd in nodes.items():
            if name not in self.nodes:
                self.sink.on_node_add(nd)
            elif self.nodes[name] is not nd:
                self.sink.on_node_update(nd)
        for name in list(self.nodes):
            if name not in nodes:
                self.sink.on_node_delete(name)
        for key, p in pods.items():
            old = self.pods.get(key)
            if old is None:
                self.sink.on_pod_add(p)
            elif old is not p:
                if old.uid != p.uid or (old.node_name and not p.node_name):
                    # deleted-and-recreated while the watch was down: a
                    # single update would leave the stale bound pod in the
                    # sink's cache (scheduler on_pod_update's unassigned
                    # branch never removes) — replay as delete+add
                    self.sink.on_pod_delete(old)
                    self.sink.on_pod_add(p)
                else:
                    self.sink.on_pod_update(old, p)
        for key, old in list(self.pods.items()):
            if key not in pods:
                self.sink.on_pod_delete(old)
        self.nodes, self.pods = nodes, pods
        # the dedupe floor COMPACTS at every relist: the fresh cursor
        # starts AT rev, so no frame at or below rev can ever arrive
        # again — live objects keep a floor of rev and entries for
        # objects gone from the listing (every deleted pod ever seen)
        # are dropped, bounding the map to the live set instead of
        # growing with total objects ever delivered (a reflector
        # under sustained create/delete churn would otherwise leak)
        self._obj_rev = {f"nodes/{n}": rev for n in nodes}
        self._obj_rev.update({f"pods/{k}": rev for k in pods})
        # tombstones compact with the floor: the fresh cursor starts AT
        # rev, so no stale frame for a dead object can arrive either
        self._gone_rev.clear()
        cur = self.hub.watch(rev)
        if self._cursor_wrap is not None:
            cur = self._cursor_wrap(cur)
        self._cursor = cur
        self._delivered_rev = max(self._delivered_rev, rev)
        if self.clock is not None:
            self._last_progress = self.clock()

    def _arm_relist_backoff(self, now) -> None:
        """Jittered cool-down before the NEXT forced relist — the
        anti-stampede half of the stall/storm handling."""
        if now is None or self._relist_backoff is None:
            return
        self._next_relist_ok = now + self._relist_backoff.backoff_s(
            self._stall_attempts)
        self._stall_attempts += 1

    def pump(self) -> int:
        """Deliver pending watch events; relist on compaction or on a
        detected silent stall. Returns the number of events received
        (relist counts as one). Duplicated / reordered-stale events are
        dropped by the per-object resourceVersion dedupe (``deduped``)
        but still count as stream liveness."""
        if self._cursor is None:
            self.list_and_watch()
            return 1
        now = self.clock() if self.clock is not None else None
        if self._pending_compacted:
            if now is not None and now < self._next_relist_ok:
                return 0  # still cooling down; the relist stays owed
            self._pending_compacted = False
            self.relists += 1
            self._arm_relist_backoff(now)
            self.list_and_watch()
            return 1
        try:
            events = self._cursor.poll()
        except Compacted:
            if now is not None and now < self._next_relist_ok:
                # a 410 storm already forced a relist inside this
                # jittered cool-down; wait it out instead of joining
                # the stampede — but REMEMBER the compaction (a one-
                # shot injected 410 will not re-raise next poll)
                self._pending_compacted = True
                return 0
            self.relists += 1
            self._arm_relist_backoff(now)
            self.list_and_watch()
            return 1
        if events:
            self._delivered_rev = max(
                self._delivered_rev, max(e[0] for e in events))
            if now is not None:
                self._last_progress = now
            self._stall_attempts = 0
        elif now is not None:
            if self.hub._revision <= self._delivered_rev:
                # genuinely idle: nothing new exists to deliver
                self._last_progress = now
            elif (self.progress_deadline_s > 0
                    and now - self._last_progress
                    >= self.progress_deadline_s
                    and now >= self._next_relist_ok):
                # SILENT STALL: the hub advanced revisions but this
                # stream delivered nothing past the deadline (half-open
                # connection / event-eating middlebox class). Force a
                # relist with jittered backoff instead of idling forever.
                self.stalled_relists += 1
                self.relists += 1
                self._arm_relist_backoff(now)
                self.list_and_watch()
                return 1
        for rev, obj_key, etype, obj in events:
            floor = self._obj_rev.get(obj_key)
            if floor is None:
                floor = self._gone_rev.get(obj_key, 0)
            if rev <= floor:
                # duplicate or reordered-stale frame: the object already
                # reflects a revision at/after this one — a no-op by the
                # resourceVersion-monotonic rule (NEVER re-applied: a
                # stale MODIFIED after a DELETE would resurrect)
                self.deduped += 1
                continue
            if etype == "DELETED":
                # the floor migrates to the bounded tombstone LRU: live
                # map stays sized to the live set, yet a reordered
                # stale MODIFIED still dedupes against the delete's rev
                self._obj_rev.pop(obj_key, None)
                self._gone_rev.pop(obj_key, None)
                self._gone_rev[obj_key] = rev
                while len(self._gone_rev) > self.tombstone_capacity:
                    self._gone_rev.popitem(last=False)
            else:
                # a frame PAST the tombstone is a recreation (the hub
                # mints monotonic revs): the object is live again
                self._gone_rev.pop(obj_key, None)
                self._obj_rev[obj_key] = rev
            kind, _, ident = obj_key.partition("/")
            if kind not in ("nodes", "pods"):
                # the history is shared across kinds (events, services,
                # endpoints, ...); this reflector only syncs the two kinds
                # the scheduler's informers watch — anything else would
                # otherwise be fed into the pod handlers and crash
                # (reflector filtering = the ListWatch's resource scoping)
                continue
            if kind == "nodes":
                if etype == "ADDED":
                    self.nodes[ident] = obj
                    self.sink.on_node_add(obj)
                elif etype == "MODIFIED":
                    self.nodes[ident] = obj
                    self.sink.on_node_update(obj)
                else:
                    self.nodes.pop(ident, None)
                    self.sink.on_node_delete(ident)
            else:
                if etype == "ADDED":
                    if self._selects(obj):
                        self.pods[ident] = obj
                        self.sink.on_pod_add(obj)
                elif etype == "MODIFIED":
                    was = ident in self.pods
                    now = self._selects(obj)
                    if was and now:
                        old = self.pods[ident]
                        self.pods[ident] = obj
                        self.sink.on_pod_update(old, obj)
                    elif was:  # left the selector → DELETE, never retain
                        self.sink.on_pod_delete(self.pods.pop(ident))
                    elif now:  # entered the selector → ADD
                        self.pods[ident] = obj
                        self.sink.on_pod_add(obj)
                else:
                    old = self.pods.pop(ident, None)
                    if old is not None:
                        self.sink.on_pod_delete(old)
        return len(events)

    def resync(self) -> None:
        """Re-deliver every known object as an update — the SharedInformer
        resync loop (shared_informer.go resyncPeriod); handlers must treat
        it as a no-op when nothing changed."""
        for nd in self.nodes.values():
            self.sink.on_node_update(nd)
        for key, p in self.pods.items():
            self.sink.on_pod_update(p, p)
