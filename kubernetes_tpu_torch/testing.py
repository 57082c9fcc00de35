"""Test object builders — the analog of the reference's
``pkg/scheduler/testing/wrappers.go`` pod/node wrappers used throughout its
unit suites."""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence, Tuple

from kubernetes_tpu_torch.api.types import (
    Affinity,
    LabelSelector,
    Node,
    NodeCondition,
    NodeSelectorTerm,
    Pod,
    PreferredSchedulingTerm,
    Requirement,
    Resources,
    Taint,
    Toleration,
    TopologySpreadConstraint,
)


def make_node(
    name: str,
    cpu_milli: float = 32000,
    memory: float = 64 * 2**30,
    pods: int = 110,
    labels: Optional[Dict[str, str]] = None,
    taints: Sequence[Taint] = (),
    zone: Optional[str] = None,
    **kw,
) -> Node:
    labels = dict(labels or {})
    labels.setdefault("kubernetes.io/hostname", name)
    if zone is not None:
        labels["failure-domain.beta.kubernetes.io/zone"] = zone
    return Node(
        name=name,
        labels=labels,
        allocatable=Resources(cpu_milli=cpu_milli, memory=memory, pods=pods),
        taints=tuple(taints),
        **kw,
    )


def make_pod(
    name: str,
    cpu_milli: float = 0,
    memory: float = 0,
    namespace: str = "default",
    node_name: str = "",
    labels: Optional[Dict[str, str]] = None,
    node_selector: Optional[Dict[str, str]] = None,
    affinity: Optional[Affinity] = None,
    tolerations: Sequence[Toleration] = (),
    priority: int = 0,
    host_ports: Sequence[Tuple[str, str, int]] = (),
    scalars: Optional[Dict[str, float]] = None,
    **kw,
) -> Pod:
    return Pod(
        name=name,
        namespace=namespace,
        node_name=node_name,
        labels=dict(labels or {}),
        node_selector=dict(node_selector or {}),
        affinity=affinity or Affinity(),
        tolerations=tuple(tolerations),
        priority=priority,
        requests=Resources(cpu_milli=cpu_milli, memory=memory, scalars=dict(scalars or {})),
        host_ports=tuple(host_ports),
        **kw,
    )


def req(key: str, op: str, *values: str) -> Requirement:
    return Requirement(key=key, operator=op, values=tuple(values))


def node_affinity_required(*terms: Sequence[Requirement]) -> Affinity:
    return Affinity(
        node_required=tuple(NodeSelectorTerm(tuple(t)) for t in terms)
    )


def node_affinity_preferred(*weighted: Tuple[int, Sequence[Requirement]]) -> Affinity:
    return Affinity(
        node_preferred=tuple(
            PreferredSchedulingTerm(weight=w, preference=NodeSelectorTerm(tuple(t)))
            for w, t in weighted
        )
    )


