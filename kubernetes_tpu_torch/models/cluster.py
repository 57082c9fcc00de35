"""Synthetic cluster/workload generators mirroring the reference's perf
fixtures: ``test/utils/runners.go`` node/pod strategies and the
scheduler_perf templates (``test/integration/scheduler_perf``):

- base node = 4 CPU / 32Gi / 110 pods (scheduler_test.go:49-58)
- base pod  = 100m CPU / 500Mi (runners.go:1233 MakePodSpec)

These drive unit benches, the fake-cluster E2E tests, and bench.py.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.api.types import (
    Affinity,
    LabelSelector,
    Node,
    NodeSelectorTerm,
    Pod,
    PreferredSchedulingTerm,
    Requirement,
    Resources,
    TopologySpreadConstraint,
)

GI = 2**30
MI = 2**20


def base_node(name: str, zone: Optional[str] = None, labels: Optional[Dict[str, str]] = None) -> Node:
    lab = dict(labels or {})
    lab.setdefault("kubernetes.io/hostname", name)
    if zone:
        lab["failure-domain.beta.kubernetes.io/zone"] = zone
    return Node(
        name=name,
        labels=lab,
        allocatable=Resources(cpu_milli=4000, memory=32 * GI, pods=110),
    )


def base_pod(name: str, namespace: str = "default", **kw) -> Pod:
    kw.setdefault("requests", Resources(cpu_milli=100, memory=500 * MI))
    return Pod(name=name, namespace=namespace, **kw)


def make_nodes(
    n: int,
    zones: int = 0,
    label_strategy: Optional[Tuple[str, str]] = None,
) -> List[Node]:
    """TrivialNodePrepareStrategy / LabelNodePrepareStrategy analogs."""
    out = []
    for i in range(n):
        labels = {}
        if label_strategy:
            labels[label_strategy[0]] = label_strategy[1]
        zone = f"zone-{i % zones}" if zones else None
        out.append(base_node(f"node-{i}", zone=zone, labels=labels))
    return out


def make_pods(
    n: int,
    name_prefix: str = "pod",
    assigned_round_robin_over: int = 0,
    rng: Optional[random.Random] = None,
) -> List[Pod]:
    """Uniform base pods; optionally pre-bound round-robin over nodes (the
    'existing pods' population of BenchmarkScheduling)."""
    out = []
    for i in range(n):
        p = base_pod(f"{name_prefix}-{i}")
        if assigned_round_robin_over:
            p.node_name = f"node-{i % assigned_round_robin_over}"
        out.append(p)
    return out


def make_spread_pods(
    n: int,
    n_services: int,
    name_prefix: str = "svc-pod",
) -> List[Pod]:
    """Pods owned by services (SelectorSpread workload): n pods spread over
    n_services label selectors."""
    out = []
    for i in range(n):
        svc = i % n_services
        labels = {"app": f"svc-{svc}"}
        sel = LabelSelector(match_labels=dict(labels))
        p = base_pod(f"{name_prefix}-{i}", labels=labels)
        p.spread_selectors = (sel,)
        out.append(p)
    return out


def make_affinity_pods(
    n: int,
    zones: int,
    name_prefix: str = "aff-pod",
    rng: Optional[random.Random] = None,
) -> List[Pod]:
    """NodeAffinity benchmark analog (scheduler_bench_test.go:251
    BenchmarkSchedulingNodeAffinity: pods requiring a random zone)."""
    rng = rng or random.Random(0)
    out = []
    for i in range(n):
        z = rng.randrange(zones)
        aff = Affinity(
            node_required=(
                NodeSelectorTerm(
                    (
                        Requirement(
                            "failure-domain.beta.kubernetes.io/zone",
                            "In",
                            (f"zone-{z}",),
                        ),
                    )
                ),
            )
        )
        p = base_pod(f"{name_prefix}-{i}")
        p.affinity = aff
        out.append(p)
    return out


def make_anti_affinity_pods(
    n: int,
    n_groups: int = 8,
    topology_key: str = "kubernetes.io/hostname",
    name_prefix: str = "anti-pod",
) -> List[Pod]:
    """BenchmarkSchedulingPodAntiAffinity analog
    (scheduler_bench_test.go:71): pods with required anti-affinity against
    their own group label on a topology key — at most one pod per group per
    topology domain."""
    from kubernetes_tpu_torch.api.types import PodAffinityTerm

    out = []
    for i in range(n):
        g = i % max(n_groups, 1)
        labels = {"anti-group": f"g{g}"}
        p = base_pod(f"{name_prefix}-{i}", labels=labels)
        p.affinity = Affinity(
            pod_anti_affinity_required=(
                PodAffinityTerm(
                    label_selector=LabelSelector(match_labels=dict(labels)),
                    topology_key=topology_key,
                ),
            )
        )
        out.append(p)
    return out


def make_spread_constraint_pods(
    n: int,
    topology_key: str = "failure-domain.beta.kubernetes.io/zone",
    max_skew: int = 1,
    hard: bool = True,
    name_prefix: str = "spread-pod",
) -> List[Pod]:
    """EvenPodsSpread workload: every pod carries one spread constraint over
    ``topology_key`` against the shared app label."""
    out = []
    for i in range(n):
        labels = {"spread-app": "app"}
        p = base_pod(f"{name_prefix}-{i}", labels=labels)
        p.topology_spread = (
            TopologySpreadConstraint(
                max_skew=max_skew,
                topology_key=topology_key,
                when_unsatisfiable="DoNotSchedule" if hard else "ScheduleAnyway",
                label_selector=LabelSelector(match_labels=dict(labels)),
            ),
        )
        out.append(p)
    return out


def make_gang_pods(
    n_groups: int,
    group_size: int,
    name_prefix: str = "gang",
) -> List[Pod]:
    """Gang/coscheduling workload (BASELINE config 4): groups of pods that
    must schedule all-or-nothing."""
    out = []
    for g in range(n_groups):
        for i in range(group_size):
            p = base_pod(f"{name_prefix}-{g}-{i}")
            p.pod_group = f"{name_prefix}-{g}"
            out.append(p)
    return out


def make_pod_affinity_pods(
    n: int,
    n_groups: int = 8,
    topology_key: str = "failure-domain.beta.kubernetes.io/zone",
    name_prefix: str = "aff2-pod",
) -> List[Pod]:
    """BenchmarkSchedulingPodAffinity analog (scheduler_bench_test.go:224):
    pods with required pod affinity to their OWN group label on a topology
    key — the first pod of a group seeds a domain (the self-match escape),
    the rest co-locate."""
    from kubernetes_tpu_torch.api.types import PodAffinityTerm

    out = []
    for i in range(n):
        g = i % max(n_groups, 1)
        labels = {"aff-group": f"g{g}"}
        p = base_pod(f"{name_prefix}-{i}", labels=labels)
        p.affinity = Affinity(
            pod_affinity_required=(
                PodAffinityTerm(
                    label_selector=LabelSelector(match_labels=dict(labels)),
                    topology_key=topology_key,
                ),
            )
        )
        out.append(p)
    return out


def make_secret_pods(
    n: int,
    name_prefix: str = "secret-pod",
) -> List[Pod]:
    """BenchmarkSchedulingSecrets analog (scheduler_bench_test.go:97):
    base pods whose spec.volumes carry a Secret — a volume that needs NO
    scheduling predicate handling (resolve_pod_volumes classifies the
    kind as neither conflict- nor limit-checked), so the variant
    measures the per-pod volume FAN-IN cost (volume tables packed and
    the volume kernels invoked per batch) against the base workload."""
    from kubernetes_tpu_torch.api.types import PodVolume

    out = []
    for i in range(n):
        p = base_pod(f"{name_prefix}-{i}")
        # the reference's strategy mounts one shared secret named
        # "secret" in every pod
        p.volumes = (PodVolume(kind="secret", handle="secret"),)
        out.append(p)
    return out


def make_pv_pods(
    n: int,
    kind: str = "gce-pd",
    name_prefix: str = "pv-pod",
) -> Tuple[List[Pod], List["PersistentVolumeClaim"], List["PersistentVolume"]]:
    """BenchmarkSchedulingInTreePVs / BenchmarkSchedulingCSIPVs analog
    (scheduler_bench_test.go:120,:184): one pre-bound PVC/PV pair per pod
    (immediate binding), exercising the attach-limit and zone kernels.
    Returns (pods, pvcs, pvs)."""
    from kubernetes_tpu_torch.api.types import (
        PersistentVolume,
        PersistentVolumeClaim,
        PodVolume,
    )

    pods, pvcs, pvs = [], [], []
    for i in range(n):
        pv = PersistentVolume(
            name=f"{name_prefix}-pv-{i}",
            kind=kind,
            handle=f"{name_prefix}-disk-{i}",
            driver="test.csi.driver" if kind == "csi" else "",
            claim_ref=f"default/{name_prefix}-pvc-{i}",
        )
        pvc = PersistentVolumeClaim(
            name=f"{name_prefix}-pvc-{i}",
            namespace="default",
            volume_name=pv.name,
        )
        p = base_pod(f"{name_prefix}-{i}")
        p.volumes = (PodVolume(pvc=pvc.name),)
        pods.append(p)
        pvcs.append(pvc)
        pvs.append(pv)
    return pods, pvcs, pvs
