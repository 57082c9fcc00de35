"""A tiny, faithful Python port of the reference scheduler's *semantics*
(the port's own copy of ``kubernetes_tpu/seqref.py``): preemption's
what-if checks run on it, and it is the serial differential-test oracle
(SURVEY.md §4: "differential tests against a tiny Go-faithful Python
reference implementation").

Each function mirrors one Go predicate/priority
(pkg/scheduler/algorithm/{predicates,priorities}) evaluated the reference
way: per (pod, node), object-at-a-time, no tensors. Deliberately slow and
obvious.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from kubernetes_tpu_torch.api.types import (
    EFFECT_NO_EXECUTE,
    EFFECT_NO_SCHEDULE,
    EFFECT_PREFER_NO_SCHEDULE,
    MAX_PRIORITY,
    Node,
    Pod,
    Requirement,
)


def _match_expressions(node: Node, exprs: Sequence[Requirement]) -> bool:
    labels = node.labels
    for r in exprs:
        if r.operator == "In":
            if labels.get(r.key) not in r.values:
                return False
        elif r.operator == "NotIn":
            if r.key in labels and labels[r.key] in r.values:
                return False
        elif r.operator == "Exists":
            if r.key not in labels:
                return False
        elif r.operator == "DoesNotExist":
            if r.key in labels:
                return False
        elif r.operator in ("Gt", "Lt"):
            if r.key not in labels:
                return False
            try:
                v = int(labels[r.key])
            except ValueError:
                return False
            lit = int(r.values[0])
            if r.operator == "Gt" and not v > lit:
                return False
            if r.operator == "Lt" and not v < lit:
                return False
        else:
            raise ValueError(r.operator)
    return True


def pod_match_node_selector(pod: Pod, node: Node) -> bool:
    """predicates.go:904 PodMatchNodeSelector."""
    for k, v in pod.node_selector.items():
        if node.labels.get(k) != v:
            return False
    terms = pod.affinity.node_required
    if terms:
        return any(_term_matches(node, t) for t in terms)
    return True


def pod_fits_host(pod: Pod, node: Node) -> bool:
    """predicates.go:916 PodFitsHost."""
    return not pod.node_name or pod.node_name == node.name


def _term_matches(node: Node, term) -> bool:
    # empty term matches no objects (apimachinery helpers semantics)
    if not term.match_expressions:
        return False
    return _match_expressions(node, term.match_expressions)


def pod_fits_resources(pod: Pod, node: Node, node_pods: Sequence[Pod]) -> bool:
    """predicates.go:779 PodFitsResources."""
    if len(node_pods) + 1 > node.allocatable.pods:
        return False
    req = pod.requests
    if (
        req.cpu_milli == 0
        and req.memory == 0
        and req.ephemeral_storage == 0
        and not req.scalars
    ):
        # all-zero request short-circuits after the pod-count cap
        # (predicates.go:803-809)
        return True
    used_cpu = sum(p.requests.cpu_milli for p in node_pods)
    used_mem = sum(p.requests.memory for p in node_pods)
    used_eph = sum(p.requests.ephemeral_storage for p in node_pods)
    if node.allocatable.cpu_milli < req.cpu_milli + used_cpu:
        return False
    if node.allocatable.memory < req.memory + used_mem:
        return False
    if node.allocatable.ephemeral_storage < req.ephemeral_storage + used_eph:
        return False
    for name, q in req.scalars.items():
        used = sum(p.requests.scalars.get(name, 0) for p in node_pods)
        if node.allocatable.scalars.get(name, 0) < q + used:
            return False
    return True


def pod_tolerates_node_taints(pod: Pod, node: Node) -> bool:
    """predicates.go:1546 — only NoSchedule/NoExecute taints are checked."""
    for t in node.taints:
        if t.effect in (EFFECT_NO_SCHEDULE, EFFECT_NO_EXECUTE) and not pod.tolerates(t):
            return False
    return True


def pod_fits_host_ports(pod: Pod, node_pods: Sequence[Pod]) -> bool:
    """predicates.go:1084 + nodeinfo/host_ports.go conflict semantics."""
    existing: List[Tuple[str, str, int]] = []
    for p in node_pods:
        for proto, ip, port in p.host_ports:
            existing.append((proto, ip or "0.0.0.0", port))
    for proto, ip, port in pod.host_ports:
        ip = ip or "0.0.0.0"
        for eproto, eip, eport in existing:
            if proto == eproto and port == eport:
                if ip == "0.0.0.0" or eip == "0.0.0.0" or ip == eip:
                    return False
    return True


def feasible(pod: Pod, node: Node, node_pods: Sequence[Pod]) -> bool:
    return (
        node.conditions.ready
        and not node.conditions.network_unavailable
        and not node.unschedulable
        and not node.conditions.disk_pressure
        and not node.conditions.pid_pressure
        and not (
            node.conditions.memory_pressure
            and pod.requests.cpu_milli == 0
            and pod.requests.memory == 0
            and pod.requests.ephemeral_storage == 0
            and not pod.requests.scalars
        )
        and pod_tolerates_node_taints(pod, node)
        and pod_fits_host(pod, node)
        and pod_fits_host_ports(pod, node_pods)
        and pod_match_node_selector(pod, node)
        and pod_fits_resources(pod, node, node_pods)
    )


# -- inter-pod affinity / topology spread (predicates.go:1211,:1720) --------


def _term_matches_pod(defining_pod: Pod, term, target: Pod) -> bool:
    """PodMatchesTermsNamespaceAndSelector: empty namespaces default to the
    defining pod's namespace."""
    ns = term.namespaces or (defining_pod.namespace,)
    return target.namespace in ns and term.label_selector.matches(target.labels)


def _same_topology(a: Node, b: Node, key: str) -> bool:
    """priorityutil.NodesHaveSameTopologyKey."""
    return key in a.labels and key in b.labels and a.labels[key] == b.labels[key]


def _pod_has_affinity(p: Pod) -> bool:
    a = p.affinity
    return bool(
        a.pod_affinity_required
        or a.pod_anti_affinity_required
        or a.pod_affinity_preferred
        or a.pod_anti_affinity_preferred
    )


def inter_pod_affinity_feasible(
    pod: Pod, node: Node, nodes: Sequence[Node], node_pods: Dict[str, List[Pod]]
) -> bool:
    """InterPodAffinityMatches via the metadata path (merged pair maps)."""
    by_name = {nd.name: nd for nd in nodes}
    existing = [(e, by_name[n]) for n in node_pods for e in node_pods[n] if n in by_name]

    # satisfiesExistingPodsAntiAffinity: merged (key, value) pairs from
    # existing pods' required anti terms that match the incoming pod
    anti_pairs = set()
    for e, en in existing:
        for t in e.affinity.pod_anti_affinity_required:
            if _term_matches_pod(e, t, pod):
                v = en.labels.get(t.topology_key)
                if v is not None:
                    anti_pairs.add((t.topology_key, v))
    for k, v in node.labels.items():
        if (k, v) in anti_pairs:
            return False

    aff_terms = pod.affinity.pod_affinity_required
    if aff_terms:
        pairs = set()
        for e, en in existing:
            for t in aff_terms:
                if _term_matches_pod(pod, t, e):
                    v = en.labels.get(t.topology_key)
                    if v is not None:
                        pairs.add((t.topology_key, v))
        match_all = all(
            t.topology_key in node.labels
            and (t.topology_key, node.labels[t.topology_key]) in pairs
            for t in aff_terms
        )
        if not match_all:
            self_ok = all(_term_matches_pod(pod, t, pod) for t in aff_terms)
            if not (len(pairs) == 0 and self_ok):
                return False

    anti_terms = pod.affinity.pod_anti_affinity_required
    if anti_terms:
        pairs = set()
        for e, en in existing:
            for t in anti_terms:
                if _term_matches_pod(pod, t, e):
                    v = en.labels.get(t.topology_key)
                    if v is not None:
                        pairs.add((t.topology_key, v))
        for t in anti_terms:
            v = node.labels.get(t.topology_key)
            if v is not None and (t.topology_key, v) in pairs:
                return False
    return True


def even_pods_spread_feasible(
    pod: Pod, node: Node, nodes: Sequence[Node], node_pods: Dict[str, List[Pod]]
) -> bool:
    """EvenPodsSpreadPredicate via getTPMapMatchingSpreadConstraints."""
    constraints = [c for c in pod.topology_spread if c.when_unsatisfiable == "DoNotSchedule"]
    if not constraints:
        return True

    def candidate(nd: Node) -> bool:
        return pod_match_node_selector(pod, nd) and all(
            c.topology_key in nd.labels for c in constraints
        )

    # pair -> SET of pods (union across same-key constraints, metadata.go
    # addTopologyPair uses a pod set)
    pair_pods: Dict[Tuple[str, str], set] = {}
    for nd in nodes:
        if not candidate(nd):
            continue
        for c in constraints:
            pair = (c.topology_key, nd.labels[c.topology_key])
            s = pair_pods.setdefault(pair, set())
            for e in node_pods.get(nd.name, []):
                if e.namespace == pod.namespace and c.label_selector.matches(e.labels):
                    s.add((e.namespace, e.name))
    min_match: Dict[str, int] = {}
    for (k, _v), s in pair_pods.items():
        if k not in min_match or len(s) < min_match[k]:
            min_match[k] = len(s)

    for c in constraints:
        v = node.labels.get(c.topology_key)
        if v is None:
            return False
        if c.topology_key not in min_match:
            continue  # MaxInt32 sentinel: skew can't exceed
        self_match = 1 if c.label_selector.matches(pod.labels) else 0
        match_num = len(pair_pods.get((c.topology_key, v), set()))
        if match_num + self_match - min_match[c.topology_key] > c.max_skew:
            return False
    return True


def interpod_affinity_scores(
    pods: Sequence[Pod],
    nodes: Sequence[Node],
    node_pods: Dict[str, List[Pod]],
    feasible_mask,
    hard_weight: float = 1.0,
) -> List[List[int]]:
    """CalculateInterPodAffinityPriority with full symmetry."""
    by_name = {nd.name: nd for nd in nodes}
    existing = [(e, by_name[n]) for n in node_pods for e in node_pods[n] if n in by_name]
    out = []
    for i, pod in enumerate(pods):
        has_aff = _pod_has_affinity(pod)
        counted = {
            nd.name
            for nd in nodes
            if has_aff or any(_pod_has_affinity(e) for e in node_pods.get(nd.name, []))
        }
        counts: Dict[str, float] = {n: 0.0 for n in counted}
        for e, en in existing:
            for nd in nodes:
                if nd.name not in counts:
                    continue
                a = pod.affinity
                for wt in a.pod_affinity_preferred:
                    if _term_matches_pod(pod, wt.term, e) and _same_topology(nd, en, wt.term.topology_key):
                        counts[nd.name] += wt.weight
                for wt in a.pod_anti_affinity_preferred:
                    if _term_matches_pod(pod, wt.term, e) and _same_topology(nd, en, wt.term.topology_key):
                        counts[nd.name] -= wt.weight
                ea = e.affinity
                for t in ea.pod_affinity_required:
                    if hard_weight > 0 and _term_matches_pod(e, t, pod) and _same_topology(nd, en, t.topology_key):
                        counts[nd.name] += hard_weight
                for wt in ea.pod_affinity_preferred:
                    if _term_matches_pod(e, wt.term, pod) and _same_topology(nd, en, wt.term.topology_key):
                        counts[nd.name] += wt.weight
                for wt in ea.pod_anti_affinity_preferred:
                    if _term_matches_pod(e, wt.term, pod) and _same_topology(nd, en, wt.term.topology_key):
                        counts[nd.name] -= wt.weight
        idx = [j for j in range(len(nodes)) if feasible_mask[i][j] and nodes[j].name in counts]
        mx = max([counts[nodes[j].name] for j in idx], default=0.0)
        mn = min([counts[nodes[j].name] for j in idx], default=0.0)
        mx, mn = max(mx, 0.0), min(mn, 0.0)
        row = [0] * len(nodes)
        for j in range(len(nodes)):
            if nodes[j].name in counts and mx - mn > 0:
                row[j] = int(MAX_PRIORITY * (counts[nodes[j].name] - mn) / (mx - mn))
        out.append(row)
    return out


def even_pods_spread_scores(
    pods: Sequence[Pod],
    nodes: Sequence[Node],
    node_pods: Dict[str, List[Pod]],
    feasible_mask,
) -> List[List[int]]:
    """CalculateEvenPodsSpreadPriority (even_pods_spread.go:86)."""
    out = []
    for i, pod in enumerate(pods):
        constraints = [c for c in pod.topology_spread if c.when_unsatisfiable == "ScheduleAnyway"]
        row = [0] * len(nodes)
        if not constraints:
            out.append(row)
            continue
        filtered = [nodes[j] for j in range(len(nodes)) if feasible_mask[i][j]]
        keyed = lambda nd: all(c.topology_key in nd.labels for c in constraints)
        # initialize(): eligibility + pair init from filtered keyed nodes
        eligible = {nd.name for nd in filtered if keyed(nd)}
        pair_counts: Dict[Tuple[str, str], float] = {}
        for nd in filtered:
            if keyed(nd):
                for c in constraints:
                    pair_counts.setdefault((c.topology_key, nd.labels[c.topology_key]), 0.0)
        # processAllNode: count from ALL selector-passing keyed nodes
        for nd in nodes:
            if not (pod_match_node_selector(pod, nd) and keyed(nd)):
                continue
            for c in constraints:
                pair = (c.topology_key, nd.labels[c.topology_key])
                if pair not in pair_counts:
                    continue
                pair_counts[pair] += sum(
                    1 for e in node_pods.get(nd.name, [])
                    if c.label_selector.matches(e.labels)  # NO namespace check
                )
        node_counts: Dict[str, float] = {}
        total = 0.0
        for nd in nodes:
            if nd.name not in eligible:
                continue
            s = 0.0
            for c in constraints:
                v = nd.labels.get(c.topology_key)
                if v is not None:
                    s += pair_counts.get((c.topology_key, v), 0.0)
            node_counts[nd.name] = s
            total += s
        min_count = min(node_counts.values(), default=0.0)
        diff = total - min_count
        for j, nd in enumerate(nodes):
            if nd.name not in node_counts:
                continue
            if diff == 0:
                row[j] = MAX_PRIORITY
            else:
                row[j] = int(MAX_PRIORITY * (total - node_counts[nd.name]) / diff)
        out.append(row)
    return out


# -- priorities -------------------------------------------------------------


def _nonzero_used(node_pods: Sequence[Pod]) -> Tuple[float, float]:
    cpu = sum(p.nonzero_requests()[0] for p in node_pods)
    mem = sum(p.nonzero_requests()[1] for p in node_pods)
    return cpu, mem


def least_requested_score(pod: Pod, node: Node, node_pods: Sequence[Pod]) -> int:
    """least_requested.go: int truncation preserved."""
    ucpu, umem = _nonzero_used(node_pods)
    pcpu, pmem = pod.nonzero_requests()
    rc, rm = ucpu + pcpu, umem + pmem

    def score(req, cap):
        if cap == 0 or req > cap:
            return 0
        return int((cap - req) * MAX_PRIORITY // cap)

    return (
        score(rc, node.allocatable.cpu_milli) + score(rm, node.allocatable.memory)
    ) // 2


def most_requested_score(pod: Pod, node: Node, node_pods: Sequence[Pod]) -> int:
    """most_requested.go: (requested * 10 / capacity), capped."""
    ucpu, umem = _nonzero_used(node_pods)
    pcpu, pmem = pod.nonzero_requests()
    rc, rm = ucpu + pcpu, umem + pmem

    def score(req, cap):
        if cap == 0 or req > cap:
            return 0
        return int(req * MAX_PRIORITY // cap)

    return (score(rc, node.allocatable.cpu_milli) + score(rm, node.allocatable.memory)) // 2


def balanced_allocation_score(pod: Pod, node: Node, node_pods: Sequence[Pod]) -> int:
    """balanced_resource_allocation.go (two-resource form)."""
    ucpu, umem = _nonzero_used(node_pods)
    pcpu, pmem = pod.nonzero_requests()
    rc, rm = ucpu + pcpu, umem + pmem
    cf = rc / node.allocatable.cpu_milli if node.allocatable.cpu_milli else 1.0
    mf = rm / node.allocatable.memory if node.allocatable.memory else 1.0
    if cf >= 1 or mf >= 1:
        return 0
    return int((1 - abs(cf - mf)) * MAX_PRIORITY)


def taint_toleration_scores(
    pods: Sequence[Pod], nodes: Sequence[Node], feasible_mask
) -> List[List[int]]:
    """taint_toleration.go: count intolerable PreferNoSchedule taints over
    the pod's *feasible* nodes, then NormalizeReduce(max=10, reverse=true)."""
    out = []
    for i, pod in enumerate(pods):
        idx = [j for j in range(len(nodes)) if feasible_mask[i][j]]
        counts = {}
        for j in idx:
            c = 0
            for t in nodes[j].taints:
                if t.effect == EFFECT_PREFER_NO_SCHEDULE and not pod.tolerates(t):
                    c += 1
            counts[j] = c
        mx = max(counts.values(), default=0)
        row = [0] * len(nodes)
        for j in idx:
            if mx == 0:
                row[j] = MAX_PRIORITY
            else:
                row[j] = MAX_PRIORITY - (counts[j] * MAX_PRIORITY // mx)
        out.append(row)
    return out


def node_affinity_scores(
    pods: Sequence[Pod], nodes: Sequence[Node], feasible_mask
) -> List[List[int]]:
    """node_affinity.go: weight-sum of matched preferred terms over feasible
    nodes, then NormalizeReduce(max=10, reverse=false)."""
    out = []
    for i, pod in enumerate(pods):
        idx = [j for j in range(len(nodes)) if feasible_mask[i][j]]
        raw = {}
        for j in idx:
            s = 0
            for p in pod.affinity.node_preferred:
                if p.weight and _match_expressions(nodes[j], p.preference.match_expressions):
                    s += p.weight
            raw[j] = s
        mx = max(raw.values(), default=0)
        row = [0] * len(nodes)
        for j in idx:
            row[j] = raw[j] * MAX_PRIORITY // mx if mx else 0
        out.append(row)
    return out


def selector_spread_scores(
    pods: Sequence[Pod],
    nodes: Sequence[Node],
    node_pods: Dict[str, List[Pod]],
    feasible_mask,
) -> List[List[float]]:
    """selector_spreading.go map+reduce over each pod's feasible nodes."""
    out = []
    for i, pod in enumerate(pods):
        idx = [j for j in range(len(nodes)) if feasible_mask[i][j]]
        counts = {}
        for j in idx:
            nd = nodes[j]
            c = 0
            if pod.spread_selectors:
                for q in node_pods[nd.name]:
                    if q.namespace == pod.namespace and all(
                        s.matches(q.labels) for s in pod.spread_selectors
                    ):
                        c += 1
            counts[j] = c
        max_node = max(counts.values(), default=0)
        zcounts: Dict[Tuple[str, str], int] = {}
        for j in idx:
            zk = nodes[j].zone_key()
            if zk is not None:
                zcounts[zk] = zcounts.get(zk, 0) + counts[j]
        max_zone = max(zcounts.values(), default=0)
        have_zones = len(zcounts) > 0
        row = [0.0] * len(nodes)
        for j in idx:
            f = float(MAX_PRIORITY)
            if max_node > 0:
                f = MAX_PRIORITY * (max_node - counts[j]) / max_node
            zk = nodes[j].zone_key()
            if have_zones and zk is not None:
                zs = float(MAX_PRIORITY)
                if max_zone > 0:
                    zs = MAX_PRIORITY * (max_zone - zcounts[zk]) / max_zone
                f = f * (1.0 / 3.0) + zs * (2.0 / 3.0)
            row[j] = float(int(f))
        out.append(row)
    return out


def image_locality_scores(pods: Sequence[Pod], nodes: Sequence[Node]) -> List[List[int]]:
    """image_locality.go with meta.totalNumNodes = len(nodes)."""
    mb = 1024 * 1024
    lo, hi = 23 * mb, 1000 * mb
    total = len(nodes)
    num_nodes = {}
    for nd in nodes:
        for img in nd.images:
            num_nodes[img] = num_nodes.get(img, 0) + 1
    out = []
    for pod in pods:
        row = []
        for nd in nodes:
            s = 0
            for img in pod.images:
                if img in nd.images:
                    spread = num_nodes[img] / total
                    s += int(nd.images[img] * spread)
            s = min(max(s, lo), hi)
            row.append(int(MAX_PRIORITY * (s - lo) // (hi - lo)))
        out.append(row)
    return out


def prefer_avoid_scores(pods: Sequence[Pod], nodes: Sequence[Node]) -> List[List[int]]:
    """node_prefer_avoid_pods.go."""
    return [
        [
            0 if pod.owner_uid and pod.owner_uid in nd.prefer_avoid_owner_uids else MAX_PRIORITY
            for nd in nodes
        ]
        for pod in pods
    ]


DEFAULT_WEIGHTS = {
    "SelectorSpreadPriority": 1,
    "LeastRequestedPriority": 1,
    "BalancedResourceAllocation": 1,
    "NodePreferAvoidPodsPriority": 10000,
    "NodeAffinityPriority": 1,
    "TaintTolerationPriority": 1,
    "ImageLocalityPriority": 1,
}


def serial_schedule(
    pending: Sequence[Pod],
    nodes: Sequence[Node],
    scheduled: Sequence[Pod],
) -> List[Tuple[int, float]]:
    """The reference's serial scheduling loop (scheduler.go:462 scheduleOne):
    pods in activeQ order (priority desc, arrival asc), each scoring the
    cluster as it stands, argmax with lowest-index tie-break. Returns
    (node_index or -1, winning score) per pod, in the original pod order.
    Base predicates/priorities only; :func:`serial_schedule_full` adds the
    topology + volume surface over the same loop."""
    return _serial_schedule(pending, nodes, scheduled, full=False,
                            vol_state=None)


def serial_schedule_full(
    pending: Sequence[Pod],
    nodes: Sequence[Node],
    scheduled: Sequence[Pod],
    vol_state=None,
) -> List[Tuple[int, float]]:
    """:func:`serial_schedule` with the FULL default surface — inter-pod
    affinity, topology spread, and (when ``vol_state`` is given) the five
    volume predicates — the end-to-end oracle for the differential fuzz
    campaign (SURVEY §4 implication (a)). Metadata is recomputed per pod
    against the live node_pods state, exactly like scheduleOne's
    GetMetadata each cycle (predicates/metadata.go:152)."""
    return _serial_schedule(pending, nodes, scheduled, full=True,
                            vol_state=vol_state)


def _oracle_assume_volumes(pod: Pod, node: Node, state) -> None:
    """Mirror VolumeBinder.assume_pod_volumes' PV picks (volumes.py:332):
    after the oracle places a pod, unbound WaitForFirstConsumer claims take
    the first compatible available PV so later pods in the same run see it
    as spoken for — without this, delayed-binding PV capacity would be
    double-spent and the oracle would diverge from the scheduler's
    assume-then-commit flow."""
    from kubernetes_tpu_torch.volumes import (
        BINDING_WAIT_FOR_FIRST_CONSUMER,
        match_node_selector_terms,
    )

    for v in pod.volumes:
        if not v.pvc:
            continue
        pvc = state.pvc(pod.namespace, v.pvc)
        if pvc is None or pvc.volume_name:
            continue
        sc = state.storage_class(pvc.storage_class) if pvc.storage_class else None
        if (sc is None or sc.binding_mode != BINDING_WAIT_FOR_FIRST_CONSUMER
                or sc.provisionable()):
            continue
        for pv in state.available_pvs(pvc.storage_class):
            if not pv.node_affinity or match_node_selector_terms(
                node.labels, pv.node_affinity
            ):
                state.assumed_claims[pv.name] = f"{pod.namespace}/{pvc.name}"
                break


def _serial_schedule(
    pending: Sequence[Pod],
    nodes: Sequence[Node],
    scheduled: Sequence[Pod],
    full: bool,
    vol_state,
) -> List[Tuple[int, float]]:
    """One shared loop for both oracles (the score blend and tie-break live
    HERE only). ``full`` adds interpod-affinity + spread feasibility and
    the InterPodAffinityPriority score (weight 1, defaults.go:119);
    ``vol_state`` adds the five volume predicates plus assume-tracking.
    Placed pods keep their full spec (dataclasses.replace) so later pods
    see their labels/affinity/volumes as existing state."""
    import dataclasses

    if vol_state is not None:
        # private assumed-claims ledger: the oracle mutates it as it places
        vol_state = dataclasses.replace(
            vol_state, assumed_claims=dict(vol_state.assumed_claims)
        )
    node_pods: Dict[str, List[Pod]] = {nd.name: [] for nd in nodes}
    for p in scheduled:
        if p.node_name in node_pods:
            node_pods[p.node_name].append(p)

    order = sorted(range(len(pending)), key=lambda i: (-pending[i].priority, i))
    out: List[Tuple[int, float]] = [(-1, 0.0)] * len(pending)
    for i in order:
        pod = pending[i]
        row = []
        for nd in nodes:
            ok = feasible(pod, nd, node_pods[nd.name])
            if ok and full:
                ok = (
                    inter_pod_affinity_feasible(pod, nd, nodes, node_pods)
                    and even_pods_spread_feasible(pod, nd, nodes, node_pods)
                )
            if ok and vol_state is not None:
                ok = volumes_feasible(pod, nd, node_pods[nd.name], vol_state)
            row.append(ok)
        if not any(row):
            continue
        mask = [row]
        w = DEFAULT_WEIGHTS
        taint = taint_toleration_scores([pod], nodes, mask)[0]
        aff = node_affinity_scores([pod], nodes, mask)[0]
        spread = selector_spread_scores([pod], nodes, node_pods, mask)[0]
        img = image_locality_scores([pod], nodes)[0]
        avoid = prefer_avoid_scores([pod], nodes)[0]
        ipa = (
            interpod_affinity_scores([pod], nodes, node_pods, mask)[0]
            if full
            else [0] * len(nodes)
        )
        best_j, best_s = -1, None
        for j, nd in enumerate(nodes):
            if not row[j]:
                continue
            s = (
                w["LeastRequestedPriority"] * least_requested_score(pod, nd, node_pods[nd.name])
                + w["BalancedResourceAllocation"] * balanced_allocation_score(pod, nd, node_pods[nd.name])
                + w["TaintTolerationPriority"] * taint[j]
                + w["NodeAffinityPriority"] * aff[j]
                + w["SelectorSpreadPriority"] * spread[j]
                + w["ImageLocalityPriority"] * img[j]
                + w["NodePreferAvoidPodsPriority"] * avoid[j]
                + ipa[j]  # InterPodAffinityPriority weight 1 (defaults.go:119)
            )
            if best_s is None or s > best_s:
                best_j, best_s = j, s
        placed = dataclasses.replace(pod, node_name=nodes[best_j].name)
        node_pods[nodes[best_j].name].append(placed)
        if vol_state is not None:
            _oracle_assume_volumes(placed, nodes[best_j], vol_state)
        out[i] = (best_j, float(best_s))
    return out


# -- volume predicates (predicates.go:275,:404,:632,:1666; csi_volume_ -------
# predicate.go:54) — sequential oracles over the same VolumeState model


def _resolved(pod: Pod, state):
    """``state`` is either a VolumeState or a cached resolver callable
    (e.g. SnapshotPacker.resolve_volumes) — preemption what-ifs re-check
    the same pods many times, so the scheduler passes the memoized form."""
    if callable(state):
        return state(pod)
    from kubernetes_tpu_torch.volumes import resolve_pod_volumes

    return resolve_pod_volumes(pod, state)


def no_disk_conflict(pod: Pod, node_pods: Sequence[Pod], state) -> bool:
    """NoDiskConflict (predicates.go:275): inline GCE-PD/EBS/RBD/ISCSI
    volumes vs volumes of pods already on the node; read-only mounts escape
    for every kind but EBS (isVolumeConflict :216)."""
    from kubernetes_tpu_torch.volumes import CONFLICT_RO_ESCAPE

    mine = _resolved(pod, state).conflict
    for ep in node_pods:
        theirs = _resolved(ep, state).conflict
        for kind, handle, ro in mine:
            for ekind, ehandle, ero in theirs:
                if kind == ekind and handle == ehandle:
                    if not (CONFLICT_RO_ESCAPE[kind] and ro and ero):
                        return False
    return True


def max_pd_volume_count(
    pod: Pod, node: Node, node_pods: Sequence[Pod], state
) -> bool:
    """All four MaxPDVolumeCountChecker instances (predicates.go:404)."""
    from kubernetes_tpu_torch.volumes import N_PD_FILTERS, node_pd_limits

    limits = node_pd_limits(node)
    new = _resolved(pod, state).pd
    if not new:
        return True
    existing: set = set()
    for ep in node_pods:
        existing.update(_resolved(ep, state).pd)
    for t in range(N_PD_FILTERS):
        if not any(v[0] == t for v in new):
            continue  # this checker quick-returns (predicates.go:471)
        n_existing = sum(1 for e in existing if e[0] == t)
        n_new = sum(1 for v in set(new) if v[0] == t and v not in existing)
        if n_existing + n_new > limits[t]:
            return False
    return True


def csi_max_volume_count(
    pod: Pod, node: Node, node_pods: Sequence[Pod], state
) -> bool:
    """CSIMaxVolumeLimitChecker (csi_volume_predicate.go:54)."""
    from kubernetes_tpu_torch.volumes import CSI_LIMIT_PREFIX

    new = set(_resolved(pod, state).csi)
    if not new:
        return True
    existing: set = set()
    for ep in node_pods:
        existing.update(_resolved(ep, state).csi)
    new -= existing
    csi_names = {d for d, _ in new} | {d for d, _ in existing}
    for d in csi_names:
        limit = node.allocatable.scalars.get(CSI_LIMIT_PREFIX + d)
        if limit is None:
            continue
        cur = sum(1 for e in existing if e[0] == d)
        add = sum(1 for v in new if v[0] == d)
        if add and cur + add > limit:
            return False
    return True


def volume_zone(pod: Pod, node: Node, state) -> Tuple[bool, bool]:
    """NoVolumeZoneConflict (predicates.go:632). Returns (ok, error)."""
    from kubernetes_tpu_torch.volumes import node_has_zone_label

    rv = _resolved(pod, state)
    if rv.error:
        return False, True
    if not node_has_zone_label(node):
        return True, False
    for key, allowed in rv.zone_rows:
        if node.labels.get(key, "") not in allowed:
            return False, False
    return True, False


def volume_binding(pod: Pod, node: Node, state) -> Tuple[bool, bool, bool]:
    """CheckVolumeBinding (predicates.go:1666 -> FindPodVolumes).
    Returns (bound_satisfied, unbound_satisfied, error)."""
    rv = _resolved(pod, state)
    if rv.error:
        return False, False, True
    bound_ok = True
    for terms in rv.bound_affinity:
        if not any(
            t.match_expressions and _match_expressions(node, t.match_expressions)
            for t in terms
        ):
            bound_ok = False
    unbound_ok = True
    for cands in rv.unbound_clauses:
        satisfied = False
        for terms in cands:
            if not terms or any(
                t.match_expressions and _match_expressions(node, t.match_expressions)
                for t in terms
            ):
                satisfied = True
                break
        if not satisfied:
            unbound_ok = False
    return bound_ok, unbound_ok, False


def volumes_feasible(
    pod: Pod, node: Node, node_pods: Sequence[Pod], state
) -> bool:
    """AND of all five volume predicates (the default-provider volume set,
    defaults.go:40)."""
    vz_ok, vz_err = volume_zone(pod, node, state)
    b_ok, u_ok, vb_err = volume_binding(pod, node, state)
    return (
        not vz_err
        and not vb_err
        and vz_ok
        and b_ok
        and u_ok
        and no_disk_conflict(pod, node_pods, state)
        and max_pd_volume_count(pod, node, node_pods, state)
        and csi_max_volume_count(pod, node, node_pods, state)
    )


# -- RequestedToCapacityRatio / NodeLabel / ResourceLimits priorities --------
# (requested_to_capacity_ratio.go, node_label.go, resource_limits.go)


def _go_div(a: int, b: int) -> int:
    """Go int64 division: truncation toward zero."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def broken_linear(shape) -> "callable":
    """buildBrokenLinearFunction (requested_to_capacity_ratio.go:110)."""
    def f(p: int) -> int:
        n = len(shape)
        for i in range(n):
            if p <= shape[i][0]:
                if i == 0:
                    return shape[0][1]
                x0, y0 = shape[i - 1]
                x1, y1 = shape[i]
                return y0 + _go_div((y1 - y0) * (p - x0), (x1 - x0))
        return shape[n - 1][1]

    return f


def requested_to_capacity_score(
    pod: Pod, node: Node, node_pods: Sequence[Pod],
    shape=((0, 10), (100, 0)),
) -> int:
    """RequestedToCapacityRatioResourceAllocationPriority scorer
    (requested_to_capacity_ratio.go:87-103) on exact integer math."""
    raw = broken_linear(shape)

    def one(req: int, cap: int) -> int:
        if cap == 0 or req > cap:
            return raw(100)
        return raw(100 - _go_div((cap - req) * 100, cap))

    used_cpu, used_mem = _nonzero_used(node_pods)
    p_cpu, p_mem = pod.nonzero_requests()
    cpu = one(int(used_cpu + p_cpu), int(node.allocatable.cpu_milli))
    mem = one(int(used_mem + p_mem), int(node.allocatable.memory))
    return _go_div(cpu + mem, 2)


def node_label_score(node: Node, label: str, presence: bool) -> int:
    """NodeLabelPriority (node_label.go:47)."""
    exists = label in node.labels
    return MAX_PRIORITY if exists == presence else 0


def resource_limits_score(pod: Pod, node: Node) -> int:
    """ResourceLimitsPriority (resource_limits.go:44): 1 when a declared
    cpu OR memory limit fits within allocatable."""
    cpu_ok = 0 < pod.limits.cpu_milli <= node.allocatable.cpu_milli
    mem_ok = 0 < pod.limits.memory <= node.allocatable.memory
    return 1 if (cpu_ok or mem_ok) else 0
