"""Preemption — exact host-side victim selection over the cache, mirroring
``genericScheduler.Preempt`` (``pkg/scheduler/core/generic_scheduler.go:316``)
and its helpers (the port of ``kubernetes_tpu/preemption.py``):

- eligibility (``:1190`` podEligibleToPreemptOthers)
- candidate pruning (``:1167`` nodesWherePreemptionMightHelp — only nodes
  whose filter failures are *resolvable by removing pods* qualify)
- victim selection with the reprieve loop (``:1079`` selectVictimsOnNode:
  remove all lower-priority pods, verify the preemptor fits, then try to
  re-add each candidate victim highest-priority-first — PDB-violating pods
  reprieved first — keeping those whose return doesn't break the fit)
- the 6-tier lexicographic node pick (``:862`` pickOneNodeForPreemption)

The device's failure pass gives the per-(pod, node) reason bits that
prune the candidates; the what-if checks run host-side on the sequential
reference predicates (:mod:`kubernetes_tpu_torch.seqref`).

The what-if is node-local when it can be: see :func:`what_if_is_local`.
The reference re-evaluates inter-pod affinity and topology spread against
the whole cluster on every check and copies the node-to-pods map once per
candidate, so one preemptor costs O(nodes x pods); on the local path it
costs O(nodes x pods per node), with the same answers.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch import seqref
from kubernetes_tpu_torch.api.types import Node, Pod, PodDisruptionBudget
from kubernetes_tpu_torch.ops.predicates import BIT

#: Failure bits that deleting pods can possibly clear. Complement of the
#: reference's unresolvable list (generic_scheduler.go:65-84): node
#: conditions, unschedulable flag, taints, selector/hostname mismatches
#: cannot be fixed by preemption.
RESOLVABLE_BITS = (
    (1 << BIT["PodFitsResources"])
    | (1 << BIT["PodFitsHostPorts"])
    | (1 << BIT["MatchInterPodAffinity"])
    | (1 << BIT["EvenPodsSpread"])
    # disk conflicts and attach-count limits clear when mounting pods are
    # evicted; zone/node-affinity/bind conflicts do not (the reference lists
    # ErrVolume{Zone,Node,Bind}Conflict as unresolvable)
    | (1 << BIT["NoDiskConflict"])
    | (1 << BIT["MaxVolumeCount"])
)


@dataclass
class PreemptionResult:
    node_name: str
    victims: List[Pod] = field(default_factory=list)
    num_pdb_violations: int = 0
    #: lower-priority pods nominated on the chosen node whose nomination
    #: must be cleared (scheduler.go:330 getLowerPriorityNominatedPods)
    clear_nominations: List[Pod] = field(default_factory=list)


def pod_eligible_to_preempt_others(
    pod: Pod, node_pods_of: Dict[str, List[Pod]],
    enable_non_preempting: bool = False,
) -> bool:
    """generic_scheduler.go:1190 — a pod that already triggered a preemption
    (has a nominated node) waits while any lower-priority pod there is still
    terminating; with the NonPreemptingPriority gate on, a PreemptNever
    policy disqualifies outright (:1191-1194)."""
    if enable_non_preempting and pod.preemption_policy == "Never":
        return False
    nom = pod.nominated_node_name
    if nom and nom in node_pods_of:
        for p in node_pods_of[nom]:
            if p.deletion_timestamp and p.priority < pod.priority:
                return False
    return True


def nodes_where_preemption_might_help(
    reason_bits_by_node: Dict[str, int]
) -> List[str]:
    """generic_scheduler.go:1167 — keep nodes whose every failure bit is
    resolvable by removing pods. Nodes with no failure bits (feasible or
    padding) are not candidates."""
    return [
        n
        for n, bits in reason_bits_by_node.items()
        if bits and (bits & ~RESOLVABLE_BITS) == 0
    ]


def what_if_is_local(
    pod: Pod,
    node_pods_of: Dict[str, List[Pod]],
    nominated_pods_of: Optional[Dict[str, List[Pod]]] = None,
) -> bool:
    """Whether every what-if fit check of ``pod`` depends only on the
    candidate node's own pod list.

    It does when the preemptor has no required pod (anti-)affinity and no
    ``DoNotSchedule`` spread constraint, and no pod that can appear in a
    hypothetical state carries a required pod anti-affinity term. Those
    states are drawn from ``node_pods_of`` and the nominated phantoms
    only, so both are scanned. Then, in
    :func:`seqref.inter_pod_affinity_feasible`, the existing pods' anti
    pairs are empty and the preemptor's affinity and anti-affinity terms
    are empty, and :func:`seqref.even_pods_spread_feasible` has no
    constraint: both return True whatever the rest of the cluster holds,
    so skipping them changes no answer."""
    a = pod.affinity
    if a.pod_affinity_required or a.pod_anti_affinity_required:
        return False
    if any(c.when_unsatisfiable == "DoNotSchedule"
           for c in pod.topology_spread):
        return False
    for pods_of in (node_pods_of, nominated_pods_of or {}):
        for pods in pods_of.values():
            for p in pods:
                if p.affinity.pod_anti_affinity_required:
                    return False
    return True


def _fits_with(
    pod: Pod,
    node: Node,
    nodes: Sequence[Node],
    node_pods_of: Dict[str, List[Pod]],
    vol_state=None,
    local: bool = False,
) -> bool:
    """Full predicate check of ``pod`` on ``node`` against the given
    hypothetical cluster state (podFitsOnNode's predicate set as evaluated
    during preemption what-ifs). ``local`` (see :func:`what_if_is_local`)
    skips the cluster-wide checks, which then cannot fail, and reads only
    ``node_pods_of[node.name]``."""
    here = node_pods_of.get(node.name, [])
    return (
        seqref.feasible(pod, node, here)
        and (local or (
            seqref.inter_pod_affinity_feasible(pod, node, nodes,
                                               node_pods_of)
            and seqref.even_pods_spread_feasible(pod, node, nodes,
                                                 node_pods_of)))
        and (vol_state is None
             or seqref.volumes_feasible(pod, node, here, vol_state))
    )


def select_victims_on_node(
    pod: Pod,
    node: Node,
    nodes: Sequence[Node],
    node_pods_of: Dict[str, List[Pod]],
    pdbs: Sequence[PodDisruptionBudget] = (),
    nominated_pods_of: Optional[Dict[str, List[Pod]]] = None,
    vol_state=None,
    local: bool = False,
) -> Optional[Tuple[List[Pod], int]]:
    """selectVictimsOnNode (generic_scheduler.go:1079). Returns
    (victims, num_pdb_violations) or None when preemption can't help.

    ``nominated_pods_of`` — pods nominated onto nodes by earlier
    preemptions. The reference's what-if fit check passes the scheduling
    queue into podFitsOnNode, so higher/equal-priority nominated pods count
    as phantom occupants (they are never selectable as victims): without
    this, a second preemptor would claim capacity already promised to the
    first.

    ``local`` — :func:`what_if_is_local` holds for ``pod``: the
    hypothetical state is the candidate node's list alone, not a copy of
    the whole map."""
    pods_here = list(node_pods_of.get(node.name, []))
    potential = [p for p in pods_here if p.priority < pod.priority]
    keep = [p for p in pods_here if p.priority >= pod.priority]
    phantoms = [
        p
        for p in (nominated_pods_of or {}).get(node.name, [])
        if p.priority >= pod.priority and p.key() != pod.key()
    ]

    # hypothetical state: all lower-priority pods gone, phantoms present
    state = {} if local else dict(node_pods_of)
    state[node.name] = keep + phantoms
    if not _fits_with(pod, node, nodes, state, vol_state, local):
        return None

    violating, non_violating = filter_pods_with_pdb_violation(potential, pdbs)
    victims: List[Pod] = []
    num_violations = 0

    def reprieve(p: Pod) -> bool:
        state[node.name] = state[node.name] + [p]
        if _fits_with(pod, node, nodes, state, vol_state, local):
            return True  # keep it — not a victim
        state[node.name] = state[node.name][:-1]
        return False

    # highest-priority first within each group; PDB-violating group first so
    # it gets the best chance of reprieve (generic_scheduler.go:1110-1125)
    for p in sorted(violating, key=lambda q: -q.priority):
        if not reprieve(p):
            victims.append(p)
            num_violations += 1
    for p in sorted(non_violating, key=lambda q: -q.priority):
        if not reprieve(p):
            victims.append(p)
    return victims, num_violations


def filter_pods_with_pdb_violation(
    pods: Sequence[Pod], pdbs: Sequence[PodDisruptionBudget]
) -> Tuple[List[Pod], List[Pod]]:
    """generic_scheduler.go:1129 — split pods into (would violate a PDB,
    would not): a pod violates when any matching PDB has no disruptions
    left."""
    violating, ok = [], []
    for p in pods:
        if any(pdb.matches(p) and pdb.disruptions_allowed <= 0 for pdb in pdbs):
            violating.append(p)
        else:
            ok.append(p)
    return violating, ok


def pick_one_node(
    candidates: Dict[str, Tuple[List[Pod], int]]
) -> Optional[str]:
    """pickOneNodeForPreemption (generic_scheduler.go:862): lexicographic
    tie-break —
      1. fewest PDB violations
      2. lowest highest-victim priority
      3. smallest sum of victim priorities
      4. fewest victims
      5. latest start time of the highest-priority victim
      6. first remaining (stable iteration order).
    A node with NO victims wins immediately (the reference returns it)."""
    if not candidates:
        return None
    names = list(candidates)
    for n in names:
        if not candidates[n][0]:
            return n

    def metrics(n: str):
        victims, pdb = candidates[n]
        high = max(v.priority for v in victims)
        return (
            pdb,
            high,
            # each victim contributes priority + (MaxInt32+1) so the count
            # of victims dominates negative priorities — a node with few
            # negative-priority victims must not lose to one with fewer
            # total-priority but more pods (generic_scheduler.go:921-928)
            sum(v.priority + 2**31 for v in victims),
            len(victims),
            -max(v.start_time for v in victims if v.priority == high),
        )

    m = {n: metrics(n) for n in names}
    for tier in range(5):
        best = min(v[tier] for v in (m[n] for n in names))
        names = [n for n in names if m[n][tier] == best]
        if len(names) == 1:
            return names[0]
    return names[0]


def preempt(
    pod: Pod,
    nodes: Sequence[Node],
    node_pods_of: Dict[str, List[Pod]],
    reason_bits_by_node: Dict[str, int],
    pdbs: Sequence[PodDisruptionBudget] = (),
    nominated_pods_of: Optional[Dict[str, List[Pod]]] = None,
    vol_state=None,
    extenders: Sequence = (),
    enable_non_preempting: bool = False,
) -> Optional[PreemptionResult]:
    """The full Preempt flow for one unschedulable pod. ``node_pods_of``
    maps node name -> pods (from the cache); ``reason_bits_by_node`` is the
    pod's row of the device filter pass; ``nominated_pods_of`` maps node
    name -> pods currently nominated there (phantom occupants for the
    what-if checks, and the source for nomination clearing)."""
    if not pod_eligible_to_preempt_others(pod, node_pods_of,
                                          enable_non_preempting):
        return None
    by_name = {nd.name: nd for nd in nodes}
    local = what_if_is_local(pod, node_pods_of, nominated_pods_of)
    candidates: Dict[str, Tuple[List[Pod], int]] = {}
    for name in nodes_where_preemption_might_help(reason_bits_by_node):
        nd = by_name.get(name)
        if nd is None:
            continue
        r = select_victims_on_node(
            pod, nd, nodes, node_pods_of, pdbs,
            nominated_pods_of=nominated_pods_of,
            vol_state=vol_state,
            local=local,
        )
        if r is not None:
            candidates[name] = r
    # extender.ProcessPreemption (generic_scheduler.go:350): preemption-
    # capable extenders may drop candidate nodes or shrink victim lists;
    # ignorable extenders drop out on error
    for ext in extenders:
        if not candidates:
            break
        try:
            candidates = ext.process_preemption(pod, candidates)
        except Exception:
            if getattr(ext, "is_ignorable", lambda: False)():
                continue
            return None
    chosen = pick_one_node(candidates)
    if chosen is None:
        return None
    victims, pdb_violations = candidates[chosen]
    clear = [
        p
        for p in (nominated_pods_of or {}).get(chosen, [])
        if p.priority < pod.priority
    ]
    return PreemptionResult(
        node_name=chosen,
        victims=victims,
        num_pdb_violations=pdb_violations,
        clear_nominations=clear,
    )
