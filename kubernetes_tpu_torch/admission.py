"""Admission chain — the kube-apiserver admission analog (SURVEY §2.2
kube-apiserver row: "REST façade over etcd; admission chain...";
reference ``staging/src/k8s.io/apiserver/pkg/admission`` interfaces and
the in-tree plugins under ``plugin/pkg/admission/``).

The chain runs on every pod CREATE entering the hub (the hollow
apiserver), in the reference's two phases: all mutating plugins first
(``admit``), then all validating plugins (``validate``) — a mutation by
a later plugin re-checked by nothing is the classic webhook-ordering
bug, and the phase split is what prevents it.

Plugins implemented (each cites its reference):

- :class:`NamespaceLifecycle` — rejects creates into terminating (or,
  in strict mode, unknown) namespaces
  (``plugin/pkg/admission/namespace/lifecycle/admission.go``).
- :class:`PriorityAdmission` — resolves ``pod.priority_class_name`` to
  the integer ``pod.priority`` + ``preemption_policy``, applies the
  global-default class, rejects unknown classes
  (``plugin/pkg/admission/priority/admission.go:79`` Admit).
- :class:`DefaultTolerationSeconds` — appends the 300 s
  not-ready/unreachable NoExecute tolerations when the pod declares
  none (``plugin/pkg/admission/defaulttolerationseconds/admission.go``).
- :class:`ResourceQuotaAdmission` — charges the pod against its
  namespace's quotas, rejecting over-quota creates
  (``plugin/pkg/admission/resourcequota/admission.go``); the paired
  :class:`QuotaController` recalculates usage from truth the way
  ``pkg/controller/resourcequota`` replenishes on deletes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from kubernetes_tpu_torch.api.types import EFFECT_NO_EXECUTE, Pod, Toleration

NS_ACTIVE = "Active"
NS_TERMINATING = "Terminating"

#: built-in system classes (pkg/apis/scheduling/types.go:29-37)
SYSTEM_CRITICAL = {
    "system-cluster-critical": 2_000_000_000,
    "system-node-critical": 2_000_001_000,
}

TAINT_NOT_READY = "node.kubernetes.io/not-ready"
TAINT_UNREACHABLE = "node.kubernetes.io/unreachable"
DEFAULT_TOLERATION_SECONDS = 300


class AdmissionError(Exception):
    """Admission rejection — the apiserver's 403 Forbidden with a plugin
    message."""


@dataclass
class Namespace:
    name: str
    phase: str = NS_ACTIVE


@dataclass
class PriorityClass:
    """scheduling.k8s.io/v1 PriorityClass slice: value, global default,
    preemption policy (PreemptionPolicy requires NonPreemptingPriority)."""

    name: str
    value: int
    global_default: bool = False
    preemption_policy: str = "PreemptLowerPriority"


@dataclass
class ResourceQuota:
    """v1.ResourceQuota slice: hard limits on pod count / cpu / memory
    requests, with live usage. ``used`` is maintained by admission
    charges and the :class:`QuotaController` recalculation."""

    name: str
    namespace: str = "default"
    hard_pods: Optional[int] = None
    hard_cpu_milli: Optional[float] = None
    hard_memory: Optional[float] = None
    used_pods: int = 0
    used_cpu_milli: float = 0.0
    used_memory: float = 0.0

    def would_exceed(self, pod: Pod) -> Optional[str]:
        if self.hard_pods is not None and self.used_pods + 1 > self.hard_pods:
            return (f"pods quota exceeded: used {self.used_pods}, "
                    f"limited {self.hard_pods}")
        if (self.hard_cpu_milli is not None
                and self.used_cpu_milli + pod.requests.cpu_milli
                > self.hard_cpu_milli + 1e-9):
            return (f"requests.cpu quota exceeded: used "
                    f"{self.used_cpu_milli}m + {pod.requests.cpu_milli}m, "
                    f"limited {self.hard_cpu_milli}m")
        if (self.hard_memory is not None
                and self.used_memory + pod.requests.memory
                > self.hard_memory + 1e-9):
            return "requests.memory quota exceeded"
        return None

    def charge(self, pod: Pod) -> None:
        self.used_pods += 1
        self.used_cpu_milli += pod.requests.cpu_milli
        self.used_memory += pod.requests.memory


# ---------------------------------------------------------------------------
# Plugins
# ---------------------------------------------------------------------------


class NamespaceLifecycle:
    """lifecycle/admission.go: block creates into namespaces on the way
    out (and, strictly, into namespaces that don't exist)."""

    def __init__(self, namespaces: Dict[str, Namespace],
                 strict: bool = False) -> None:
        self.namespaces = namespaces
        self.strict = strict

    def validate(self, pod: Pod) -> None:
        ns = self.namespaces.get(pod.namespace)
        if ns is None:
            if self.strict:
                raise AdmissionError(
                    f'namespaces "{pod.namespace}" not found')
            return
        if ns.phase == NS_TERMINATING:
            raise AdmissionError(
                f"unable to create new content in namespace "
                f"{pod.namespace} because it is being terminated")


class PriorityAdmission:
    """priority/admission.go Admit: resolve the class name; empty name ⇒
    global default class (or 0); unknown ⇒ reject. The resolved integer
    and preemption policy are what the scheduler/preemption read."""

    def __init__(self, classes: Dict[str, PriorityClass]) -> None:
        self.classes = classes

    def admit(self, pod: Pod) -> Pod:
        name = pod.priority_class_name
        if not name:
            default = next(
                (c for c in self.classes.values() if c.global_default), None)
            if default is None:
                return pod
            return dataclasses.replace(
                pod, priority_class_name=default.name, priority=default.value,
                preemption_policy=default.preemption_policy)
        if name in SYSTEM_CRITICAL:
            return dataclasses.replace(pod, priority=SYSTEM_CRITICAL[name])
        cls = self.classes.get(name)
        if cls is None:
            raise AdmissionError(
                f"no PriorityClass with name {name} was found")
        return dataclasses.replace(
            pod, priority=cls.value,
            preemption_policy=cls.preemption_policy)


class DefaultTolerationSeconds:
    """defaulttolerationseconds/admission.go: every pod gets 300 s
    not-ready/unreachable NoExecute tolerations unless it already
    declares its own for that taint."""

    def admit(self, pod: Pod) -> Pod:
        extra: List[Toleration] = []
        for key in (TAINT_NOT_READY, TAINT_UNREACHABLE):
            declared = any(
                t.key == key or (not t.key and t.operator == "Exists")
                for t in pod.tolerations
            )
            if not declared:
                extra.append(Toleration(
                    key=key, operator="Exists", effect=EFFECT_NO_EXECUTE,
                    toleration_seconds=DEFAULT_TOLERATION_SECONDS))
        if not extra:
            return pod
        return dataclasses.replace(
            pod, tolerations=pod.tolerations + tuple(extra))


@dataclass
class LimitRange:
    """v1.LimitRange slice (plugin/pkg/admission/limitranger): per-
    namespace container defaults and min/max bounds for cpu/memory
    requests. ``default_*`` fill a container that declares nothing;
    ``min_*``/``max_*`` reject out-of-bounds requests (0 = unbounded)."""

    namespace: str = "default"
    default_cpu_milli: float = 0.0
    default_memory: float = 0.0
    min_cpu_milli: float = 0.0
    min_memory: float = 0.0
    max_cpu_milli: float = 0.0
    max_memory: float = 0.0


class LimitRanger:
    """limitranger/admission.go Admit: apply the namespace's LimitRange
    defaults to request-less pods, then validate min/max. Runs BEFORE
    quota (the reference's ordering) so defaulted requests are what
    quota charges — without that ordering a request-less pod would
    charge zero and then consume a defaulted amount."""

    def __init__(self, limit_ranges: List[LimitRange]) -> None:
        self.limit_ranges = limit_ranges

    def admit(self, pod: Pod) -> Pod:
        for lr in self.limit_ranges:
            if lr.namespace != pod.namespace:
                continue
            req = pod.requests
            cpu, mem = req.cpu_milli, req.memory
            if not cpu and lr.default_cpu_milli:
                cpu = lr.default_cpu_milli
            if not mem and lr.default_memory:
                mem = lr.default_memory
            if lr.min_cpu_milli and cpu < lr.min_cpu_milli:
                raise AdmissionError(
                    f"pods \"{pod.name}\" is forbidden: minimum cpu "
                    f"usage per Container is {lr.min_cpu_milli:g}m")
            if lr.max_cpu_milli and cpu > lr.max_cpu_milli:
                raise AdmissionError(
                    f"pods \"{pod.name}\" is forbidden: maximum cpu "
                    f"usage per Container is {lr.max_cpu_milli:g}m")
            if lr.min_memory and mem < lr.min_memory:
                raise AdmissionError(
                    f"pods \"{pod.name}\" is forbidden: minimum memory "
                    f"usage per Container is {lr.min_memory:g}")
            if lr.max_memory and mem > lr.max_memory:
                raise AdmissionError(
                    f"pods \"{pod.name}\" is forbidden: maximum memory "
                    f"usage per Container is {lr.max_memory:g}")
            if (cpu, mem) != (req.cpu_milli, req.memory):
                pod = dataclasses.replace(
                    pod, requests=dataclasses.replace(
                        req, cpu_milli=cpu, memory=mem,
                        scalars=dict(req.scalars)))
        return pod


class ResourceQuotaAdmission:
    """resourcequota/admission.go: evaluate the pod against every quota
    in its namespace; any breach rejects; success charges them all."""

    def __init__(self, quotas: List[ResourceQuota]) -> None:
        self.quotas = quotas

    def validate(self, pod: Pod) -> None:
        for q in self.quotas:
            if q.namespace != pod.namespace:
                continue
            reason = q.would_exceed(pod)
            if reason:
                raise AdmissionError(
                    f"exceeded quota: {q.name}, {reason}")

    def charge(self, pod: Pod) -> None:
        for q in self.quotas:
            if q.namespace == pod.namespace:
                q.charge(pod)


# ---------------------------------------------------------------------------
# Chain
# ---------------------------------------------------------------------------


class AdmissionChain:
    """Ordered two-phase runner (apiserver/pkg/admission/chain.go):
    every plugin's ``admit`` (mutate) runs before any ``validate``."""

    def __init__(self, plugins: List[object]) -> None:
        self.plugins = plugins
        self.admitted = 0
        self.rejected = 0

    def run(self, pod: Pod) -> Pod:
        try:
            for p in self.plugins:
                admit = getattr(p, "admit", None)
                if admit is not None:
                    pod = admit(pod)
            for p in self.plugins:
                validate = getattr(p, "validate", None)
                if validate is not None:
                    validate(pod)
        except AdmissionError:
            self.rejected += 1
            raise
        # post-validation side effects (quota charge) — the apiserver
        # commits usage only once every validating plugin passed
        for p in self.plugins:
            charge = getattr(p, "charge", None)
            if charge is not None:
                charge(pod)
        self.admitted += 1
        return pod


class QuotaController:
    """pkg/controller/resourcequota replenishment: recompute ``used``
    from the live truth so deletes release quota (admission only ever
    charges)."""

    def __init__(self, hub) -> None:
        self.hub = hub

    def reconcile(self) -> None:
        for q in self.hub.quotas:
            q.used_pods = 0
            q.used_cpu_milli = 0.0
            q.used_memory = 0.0
        for pod in self.hub.truth_pods.values():
            for q in self.hub.quotas:
                if q.namespace == pod.namespace:
                    q.charge(pod)


def default_chain(namespaces: Dict[str, Namespace],
                  classes: Dict[str, PriorityClass],
                  quotas: List[ResourceQuota],
                  strict_namespaces: bool = False,
                  limit_ranges: Optional[List[LimitRange]] = None,
                  ) -> AdmissionChain:
    """The default plugin order — the slice of
    ``kubeapiserver/options/plugins.go`` AllOrderedPlugins this hub
    enforces (NamespaceLifecycle first, LimitRanger BEFORE quota so
    defaulted requests are what quota charges, quota last — the real
    ordering)."""
    return AdmissionChain([
        NamespaceLifecycle(namespaces, strict_namespaces),
        PriorityAdmission(classes),
        DefaultTolerationSeconds(),
        LimitRanger(limit_ranges if limit_ranges is not None else []),
        ResourceQuotaAdmission(quotas),
    ])
