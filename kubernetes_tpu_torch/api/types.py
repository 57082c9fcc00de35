"""Lightweight API object model — the slice of the Kubernetes v1 API the
scheduler consumes.

Mirrors (in spirit, not in code) the generated Go types under
``staging/src/k8s.io/api/core/v1`` that the reference scheduler reads:
Pod spec fields consumed by predicates/priorities
(``pkg/scheduler/algorithm/predicates/predicates.go``) and Node status/spec
fields aggregated into ``NodeInfo`` (``pkg/scheduler/nodeinfo/node_info.go``).

These are plain Python dataclasses used at the host boundary only; the hot
path operates on the columnar tensors built from them (see
``kubernetes_tpu_torch.snapshot``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Resources
# ---------------------------------------------------------------------------

#: Default requests used for scoring when a container declares none —
#: reference: priorities/util/non_zero.go:31-33.
DEFAULT_MILLI_CPU_REQUEST = 100
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024

#: MaxPriority for 0-10 score scaling — reference: pkg/scheduler/api/types.go:35.
MAX_PRIORITY = 10


@dataclass
class Resources:
    """Aggregate resource quantities (the reference's ``nodeinfo.Resource``,
    node_info.go:146): milli-CPU, memory bytes, ephemeral-storage bytes,
    allowed pod count, plus named scalar/extended resources."""

    cpu_milli: float = 0
    memory: float = 0
    ephemeral_storage: float = 0
    pods: float = 0
    scalars: Dict[str, float] = field(default_factory=dict)

    def add(self, other: "Resources") -> "Resources":
        out = Resources(
            self.cpu_milli + other.cpu_milli,
            self.memory + other.memory,
            self.ephemeral_storage + other.ephemeral_storage,
            self.pods + other.pods,
            dict(self.scalars),
        )
        for k, v in other.scalars.items():
            out.scalars[k] = out.scalars.get(k, 0) + v
        return out


# ---------------------------------------------------------------------------
# Selectors / affinity
# ---------------------------------------------------------------------------

#: Node-selector operators — apimachinery selection ops used by
#: NodeSelectorRequirement (staging/src/k8s.io/api/core/v1/types.go).
OP_IN = "In"
OP_NOT_IN = "NotIn"
OP_EXISTS = "Exists"
OP_DOES_NOT_EXIST = "DoesNotExist"
OP_GT = "Gt"
OP_LT = "Lt"


@dataclass
class Requirement:
    """One match expression: ``key <op> values``."""

    key: str
    operator: str
    values: Tuple[str, ...] = ()


@dataclass
class NodeSelectorTerm:
    """AND of requirements. Terms are ORed together within a selector."""

    match_expressions: Tuple[Requirement, ...] = ()


@dataclass
class PreferredSchedulingTerm:
    weight: int = 1
    preference: NodeSelectorTerm = field(default_factory=NodeSelectorTerm)


@dataclass
class LabelSelector:
    """Label selector over *pods* (used by pod (anti)affinity, topology
    spread, selector-spread owners, PDBs). ``match_labels`` is AND of
    equality pairs; ``match_expressions`` AND of set requirements."""

    match_labels: Dict[str, str] = field(default_factory=dict)
    match_expressions: Tuple[Requirement, ...] = ()

    def matches(self, labels: Dict[str, str]) -> bool:
        for k, v in self.match_labels.items():
            if labels.get(k) != v:
                return False
        for r in self.match_expressions:
            if r.operator == OP_IN:
                if labels.get(r.key) not in r.values:
                    return False
            elif r.operator == OP_NOT_IN:
                if r.key in labels and labels[r.key] in r.values:
                    return False
            elif r.operator == OP_EXISTS:
                if r.key not in labels:
                    return False
            elif r.operator == OP_DOES_NOT_EXIST:
                if r.key in labels:
                    return False
            else:
                raise ValueError(f"bad pod label selector op {r.operator}")
        return True


@dataclass
class PodAffinityTerm:
    """Reference: v1.PodAffinityTerm — pods matching ``label_selector`` in
    ``namespaces`` co-located by ``topology_key``."""

    label_selector: LabelSelector = field(default_factory=LabelSelector)
    topology_key: str = ""
    namespaces: Tuple[str, ...] = ()  # empty => pod's own namespace


@dataclass
class WeightedPodAffinityTerm:
    weight: int = 1
    term: PodAffinityTerm = field(default_factory=PodAffinityTerm)


@dataclass
class Affinity:
    node_required: Tuple[NodeSelectorTerm, ...] = ()  # ORed terms
    node_preferred: Tuple[PreferredSchedulingTerm, ...] = ()
    pod_affinity_required: Tuple[PodAffinityTerm, ...] = ()
    pod_affinity_preferred: Tuple[WeightedPodAffinityTerm, ...] = ()
    pod_anti_affinity_required: Tuple[PodAffinityTerm, ...] = ()
    pod_anti_affinity_preferred: Tuple[WeightedPodAffinityTerm, ...] = ()


@dataclass
class TopologySpreadConstraint:
    """Reference: v1.TopologySpreadConstraint (EvenPodsSpread feature,
    predicates.go:1720 / priorities/even_pods_spread.go:86)."""

    max_skew: int = 1
    topology_key: str = ""
    when_unsatisfiable: str = "DoNotSchedule"  # or "ScheduleAnyway"
    label_selector: LabelSelector = field(default_factory=LabelSelector)


# ---------------------------------------------------------------------------
# Taints / tolerations
# ---------------------------------------------------------------------------

EFFECT_NO_SCHEDULE = "NoSchedule"
EFFECT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
EFFECT_NO_EXECUTE = "NoExecute"


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = EFFECT_NO_SCHEDULE


@dataclass(frozen=True)
class Toleration:
    """Reference: v1.Toleration. ``operator`` is Exists or Equal; empty key
    with Exists tolerates everything; empty effect matches all effects.
    ``toleration_seconds`` (NoExecute only): None = tolerate forever;
    N = the NoExecute taint manager evicts after N seconds
    (pkg/controller/nodelifecycle/scheduler/taint_manager.go)."""

    key: str = ""
    operator: str = "Equal"
    value: str = ""
    effect: str = ""
    toleration_seconds: Optional[float] = None

    def tolerates(self, taint: Taint) -> bool:
        # Reference: pkg/apis/core/v1/helper/helpers.go ToleratesTaint.
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator == "Exists":
            return True
        return self.value == taint.value


# ---------------------------------------------------------------------------
# Volumes
# ---------------------------------------------------------------------------

#: Volume source kinds the volume predicates recognize (the slice of
#: v1.VolumeSource / v1.PersistentVolumeSource the reference's volume
#: predicates consume — predicates.go:216 isVolumeConflict,
#: :555-620 VolumeFilters, csi_volume_predicate.go).
VOL_GCE_PD = "gce-pd"
VOL_AWS_EBS = "aws-ebs"
VOL_AZURE_DISK = "azure-disk"
VOL_CINDER = "cinder"
VOL_RBD = "rbd"
VOL_ISCSI = "iscsi"
VOL_CSI = "csi"

#: binding modes (storage.k8s.io/v1 VolumeBindingMode)
BINDING_IMMEDIATE = "Immediate"
BINDING_WAIT_FOR_FIRST_CONSUMER = "WaitForFirstConsumer"


@dataclass(frozen=True)
class PodVolume:
    """One spec.volumes entry reduced to what the volume predicates read.

    Either an inline cloud volume (``kind`` + ``handle``: pdName / volumeID /
    diskName / "pool/image" for RBD / IQN for ISCSI) or a PVC reference
    (``pvc`` set; kind/handle then resolve through PVC -> PV)."""

    kind: str = ""
    handle: str = ""
    read_only: bool = False
    pvc: str = ""  # persistentVolumeClaim.claimName


@dataclass
class PersistentVolume:
    """Slice of v1.PersistentVolume: source identity, zone labels
    (VolumeZoneChecker reads only the two failure-domain label keys,
    predicates.go:645), node affinity (volume binder), claim binding."""

    name: str
    kind: str = ""  # VOL_* source kind; VOL_CSI uses ``driver`` too
    handle: str = ""
    driver: str = ""  # CSI driver name when kind == VOL_CSI
    labels: Dict[str, str] = field(default_factory=dict)
    node_affinity: Tuple[NodeSelectorTerm, ...] = ()  # ORed terms
    storage_class: str = ""
    claim_ref: str = ""  # "namespace/name" of bound claim; "" = available
    #: metadata.deletionTimestamp analog (0 = live): the PV-protection
    #: finalizer keeps a claimed PV terminating-but-present until its
    #: claim releases it (pv_protection_controller.go)
    deletion_timestamp: float = 0.0


@dataclass
class PersistentVolumeClaim:
    name: str
    namespace: str = "default"
    volume_name: str = ""  # bound PV name; "" = unbound
    storage_class: str = ""
    #: metadata.deletionTimestamp analog (0 = live): the PVC-protection
    #: finalizer keeps an in-use claim terminating-but-present until no
    #: live pod references it (pvc_protection_controller.go)
    deletion_timestamp: float = 0.0


@dataclass
class StorageClass:
    name: str
    binding_mode: str = BINDING_IMMEDIATE
    #: provisioner name; non-empty and not the no-provisioner sentinel means
    #: dynamic provisioning can satisfy an unbound delayed-binding claim
    #: (volume scheduling lib: checkVolumeProvisions).
    provisioner: str = ""

    def provisionable(self) -> bool:
        return bool(self.provisioner) and self.provisioner != "kubernetes.io/no-provisioner"


# ---------------------------------------------------------------------------
# Pod / Node
# ---------------------------------------------------------------------------


#: v1.PodPhase values (core/v1/types.go PodPhase) — the hollow lifecycle
#: runs Pending -> Running -> Succeeded/Failed; deletion is the terminal
#: observable either way in this hub
POD_PENDING = "Pending"
POD_RUNNING = "Running"
POD_SUCCEEDED = "Succeeded"
POD_FAILED = "Failed"
#: node-unreachable: the pod may well still be running and holding its
#: node's resources — NOT terminal (gc_controller.go:100)
POD_UNKNOWN = "Unknown"


def is_pod_terminated(pod) -> bool:
    """isPodTerminated (pkg/controller/podgc/gc_controller.go:100): any
    phase other than Pending/Running/Unknown is terminal. Terminal pods
    hold no node resources (the kubelet has released them) and are
    invisible to the scheduler — the reference scheduler's informer uses
    a ``status.phase!=Succeeded,status.phase!=Failed`` field selector
    (factory.go NewPodInformer), so a terminal phase hop reaches it as a
    DELETE event."""
    return pod.phase not in (POD_PENDING, POD_RUNNING, POD_UNKNOWN)


@dataclass(frozen=True)
class OwnerReference:
    """The metav1.OwnerReference slice the GC dependency graph consumes
    (garbagecollector.go:65 builds its graph from these): controller
    kind + name. ``uid`` exists for wire-shape parity only — the hub's
    GC matches by (kind, name), so a recreated same-name owner keeps the
    previous incarnation's pods alive. That is a DOCUMENTED deviation
    approximating the reference's adoption semantics (a recreated
    controller with the same selector adopts matching orphans and
    reaches the same end state for controller pods)."""

    kind: str
    name: str
    uid: str = ""


@dataclass
class ReadinessProbe:
    """The slice of v1.Probe the hollow prober consumes
    (prober/worker.go): result gates the pod's Ready condition, which in
    turn gates Endpoints membership. The probe TARGET is hollow — app
    health is injected per pod via ``hub.set_app_health`` (the fake
    runtime's answer), so tests drive readiness flips deterministically."""

    initial_delay_s: float = 0.0


@dataclass
class Pod:
    name: str
    namespace: str = "default"
    uid: str = ""
    labels: Dict[str, str] = field(default_factory=dict)
    node_name: str = ""  # spec.nodeName: set once bound (or pre-pinned)
    node_selector: Dict[str, str] = field(default_factory=dict)
    affinity: Affinity = field(default_factory=Affinity)
    tolerations: Tuple[Toleration, ...] = ()
    priority: int = 0
    #: spec.priorityClassName — resolved to ``priority`` (and
    #: ``preemption_policy``) by the Priority admission plugin
    #: (plugin/pkg/admission/priority/admission.go); the scheduler itself
    #: only ever reads the resolved integer.
    priority_class_name: str = ""
    #: spec.schedulerName — which scheduler is responsible for this pod
    #: (eventhandlers.go:328 responsibleForPod; the multi-scheduler seam,
    #: test/integration/scheduler TestMultipleSchedulers)
    scheduler_name: str = "default-scheduler"
    requests: Resources = field(default_factory=Resources)
    host_ports: Tuple[Tuple[str, str, int], ...] = ()  # (protocol, hostIP, port)
    topology_spread: Tuple[TopologySpreadConstraint, ...] = ()
    images: Tuple[str, ...] = ()  # container image names (ImageLocality)
    #: selectors of owning Services/RCs/RSs/StatefulSets, provided by the
    #: driver's listers — feeds SelectorSpreadPriority
    #: (selector_spreading.go:99).
    spread_selectors: Tuple[LabelSelector, ...] = ()
    #: gang/coscheduling group (PodGroup); empty = no gang.
    pod_group: str = ""
    #: PodGroup minMember: the group schedules only when at least this many
    #: members are present AND all present members place together. 0 =
    #: all-present-members atomicity only (single-batch gangs). Declaring
    #: the true group size makes atomicity hold across batches: a straggler
    #: group fragment (late arrival, backoff desync, max_batch split) rolls
    #: back instead of binding partially.
    pod_group_min_available: int = 0
    #: UID of the controller ownerReference (RC/RS), feeds
    #: NodePreferAvoidPodsPriority (node_prefer_avoid_pods.go).
    owner_uid: str = ""
    #: monotonically increasing arrival stamp used for queue ordering
    #: (the reference orders activeQ by priority then timestamp).
    queued_at: float = 0.0
    #: status.nominatedNodeName — set by preemption so the victim's node
    #: holds capacity for this pod while it retries (scheduler.go:316).
    nominated_node_name: str = ""
    #: status.startTime (seconds) — preemption tie-break tier 5
    #: (generic_scheduler.go:862 pickOneNodeForPreemption: latest start time
    #: of the highest-priority victim wins).
    start_time: float = 0.0
    #: spec.preemptionPolicy: "PreemptLowerPriority" (default) or "Never".
    #: Honored when the NonPreemptingPriority feature gate is on
    #: (podEligibleToPreemptOthers, generic_scheduler.go:1191).
    preemption_policy: str = "PreemptLowerPriority"
    #: metadata.deletionTimestamp analog (0 = live). A terminating
    #: lower-priority pod on the nominated node blocks re-preemption
    #: (generic_scheduler.go:1190 podEligibleToPreemptOthers).
    deletion_timestamp: float = 0.0
    #: spec.volumes reduced to what the volume predicates consume.
    volumes: Tuple[PodVolume, ...] = ()
    #: container resource LIMITS (cpu/mem only) — consumed solely by
    #: ResourceLimitsPriority (priorities/resource_limits.go getResourceLimits:
    #: sum of containers, max'd with init containers).
    limits: Resources = field(default_factory=Resources)
    #: status.phase — maintained by the hollow kubelet lifecycle pass
    #: (kuberuntime_manager.go:558 SyncPod compressed to phase hops)
    phase: str = POD_PENDING
    #: status Ready condition — meaningful only when ``readiness_probe``
    #: is set (probe-less pods are ready the moment they run, the
    #: no-probes default of the reference's status_manager)
    ready: bool = False
    readiness_probe: Optional[ReadinessProbe] = None
    #: metadata.ownerReferences — the GC graph edges; a pod whose every
    #: referenced controller is gone gets background-deleted
    #: (sim.HollowCluster.gc_owner_graph)
    owner_refs: Tuple["OwnerReference", ...] = ()
    #: run-to-completion analog (a container that exits 0 after this many
    #: seconds of Running): the hollow kubelet hops the phase to
    #: Succeeded and LEAVES the object in the store — the real kubelet
    #: never deletes API pods; cleanup of terminal pods is the pod GC
    #: controller's job (podgc/gc_controller.go:94 terminatedPodThreshold).
    #: None = a service-style pod that runs until deleted.
    run_duration_s: Optional[float] = None

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def effective_requests(self) -> Resources:
        r = dataclasses.replace(self.requests, scalars=dict(self.requests.scalars))
        r.pods = 1
        return r

    def nonzero_requests(self) -> Tuple[float, float]:
        """(cpu_milli, memory) with scoring defaults — non_zero.go:42,:48."""
        cpu = self.requests.cpu_milli or DEFAULT_MILLI_CPU_REQUEST
        mem = self.requests.memory or DEFAULT_MEMORY_REQUEST
        return cpu, mem

    def tolerates(self, taint: Taint) -> bool:
        return any(t.tolerates(taint) for t in self.tolerations)


@dataclass
class PodDisruptionBudget:
    """The slice of policy/v1beta1 PodDisruptionBudget preemption consumes:
    selector + status.disruptionsAllowed (checked by
    ``filterPodsWithPDBViolation``, generic_scheduler.go:1129)."""

    name: str = ""
    namespace: str = "default"
    selector: LabelSelector = field(default_factory=LabelSelector)
    disruptions_allowed: int = 0
    #: spec.minAvailable (int form): when set, a disruption controller
    #: (pkg/controller/disruption) maintains ``disruptions_allowed`` =
    #: max(0, currentHealthy - minAvailable); when None the status field
    #: is whatever the feed set (static-lister mode).
    min_available: Optional[int] = None

    def matches(self, pod: Pod) -> bool:
        return pod.namespace == self.namespace and self.selector.matches(pod.labels)


@dataclass
class NodeCondition:
    ready: bool = True
    memory_pressure: bool = False
    disk_pressure: bool = False
    pid_pressure: bool = False
    network_unavailable: bool = False


@dataclass
class Node:
    name: str
    labels: Dict[str, str] = field(default_factory=dict)
    allocatable: Resources = field(default_factory=lambda: Resources(pods=110))
    taints: Tuple[Taint, ...] = ()
    unschedulable: bool = False
    conditions: NodeCondition = field(default_factory=NodeCondition)
    images: Dict[str, int] = field(default_factory=dict)  # name -> size bytes
    #: owner UIDs from the scheduler.alpha.kubernetes.io/preferAvoidPods
    #: annotation (NodePreferAvoidPodsPriority).
    prefer_avoid_owner_uids: Tuple[str, ...] = ()
    #: metadata.annotations slice the hollow controllers write (the TTL
    #: controller's node.alpha.kubernetes.io/ttl lives here)
    annotations: Dict[str, str] = field(default_factory=dict)
    #: spec.podCIDR — allocated by the nodeipam range allocator
    #: (pkg/controller/nodeipam/ipam/range_allocator.go)
    pod_cidr: str = ""

    def zone(self) -> Optional[str]:
        # Reference zone labels: failure-domain.beta.kubernetes.io/zone.
        return self.labels.get("failure-domain.beta.kubernetes.io/zone") or self.labels.get(
            "topology.kubernetes.io/zone"
        )

    def region(self) -> Optional[str]:
        return self.labels.get("failure-domain.beta.kubernetes.io/region") or self.labels.get(
            "topology.kubernetes.io/region"
        )

    def zone_key(self) -> Optional[Tuple[str, str]]:
        """utilnode.GetZoneKey analog: (region, zone), None when unlabeled."""
        z, r = self.zone(), self.region()
        if z is None and r is None:
            return None
        return (r or "", z or "")
