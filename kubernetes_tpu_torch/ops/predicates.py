"""Vectorized Filter predicates — the reference's boolean node checks
(``pkg/scheduler/algorithm/predicates/predicates.go``) as one fused
(pods x nodes) pass (the port of ``kubernetes_tpu/ops/predicates.py``).

Every check produces a (P, N) boolean and failures are recorded as
per-predicate bits so the scheduler can emit the reference's failure
reasons. Set-membership checks evaluate as f32 matmuls over multihot
matrices (labels/taints/ports); the counts are exact in f32 because the
package pins full-precision f32 matmuls (no TF32) at import.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from kubernetes_tpu_torch.ops.arrays import (
    DeviceNodes,
    DevicePods,
    DeviceSelectors,
)
from kubernetes_tpu_torch.snapshot import (
    RES_PODS,
    XOP_EXISTS,
    XOP_GT,
    XOP_IN,
    XOP_LT,
    XOP_NOT_EXISTS,
    XOP_NOT_IN,
)

# Failure-reason bit per predicate, ordered like predicatesOrdering
# (predicates.go:147). Names mirror the reference's registration names.
PREDICATE_BITS = (
    "CheckNodeCondition",        # bit 0
    "CheckNodeUnschedulable",    # bit 1
    "PodToleratesNodeTaints",    # bit 2
    "CheckNodeMemoryPressure",   # bit 3
    "CheckNodeDiskPressure",     # bit 4
    "CheckNodePIDPressure",      # bit 5
    "PodFitsHost",               # bit 6 (part of GeneralPredicates)
    "PodFitsHostPorts",          # bit 7
    "PodMatchNodeSelector",      # bit 8
    "PodFitsResources",          # bit 9
    "MatchInterPodAffinity",     # bit 10
    "EvenPodsSpread",            # bit 11
    "NoDiskConflict",            # bit 12
    "MaxVolumeCount",            # bit 13 (all four in-tree checkers + CSI)
    "NoVolumeZoneConflict",      # bit 14
    "VolumeNodeConflict",        # bit 15 (CheckVolumeBinding, bound PVCs)
    "VolumeBindConflict",        # bit 16 (CheckVolumeBinding, unbound PVCs)
    "VolumeError",               # bit 17 (unresolvable PVC/PV state)
)
BIT = {name: i for i, name in enumerate(PREDICATE_BITS)}

# Human-readable failure text per predicate bit, mirroring the reference's
# error vars (algorithm/predicates/error.go:35-79) so FitError events read
# identically. CheckNodeCondition and PodFitsResources are special-cased in
# :func:`fit_error_message_from_counts`.
REASON_MESSAGES = {
    "CheckNodeUnschedulable": "node(s) were unschedulable",
    "PodToleratesNodeTaints": "node(s) had taints that the pod didn't tolerate",
    "CheckNodeMemoryPressure": "node(s) had memory pressure",
    "CheckNodeDiskPressure": "node(s) had disk pressure",
    "CheckNodePIDPressure": "node(s) had pid pressure",
    "PodFitsHost": "node(s) didn't match the requested hostname",
    "PodFitsHostPorts": "node(s) didn't have free ports for the requested pod ports",
    "PodMatchNodeSelector": "node(s) didn't match node selector",
    "MatchInterPodAffinity": "node(s) didn't match pod affinity/anti-affinity",
    "EvenPodsSpread": "node(s) didn't match pod topology spread constraints",
    "NoDiskConflict": "node(s) had no available disk",
    "MaxVolumeCount": "node(s) exceed max volume count",
    "NoVolumeZoneConflict": "node(s) had no available volume zone",
    "VolumeNodeConflict": "node(s) had volume node affinity conflict",
    "VolumeBindConflict": "node(s) didn't find available persistent volumes to bind",
    "VolumeError": "node(s) had unresolvable volume state",
}

_I32_MAX = 2**31 - 1
_I32_MIN = -(2**31)


def fit_error_message_from_counts(counts_row, insufficient_row, not_ready,
                                  net_unavail, n_valid, req,
                                  res_names) -> str:
    """FitError.Error() parity (core/generic_scheduler.go:105-122): build
    "0/N nodes are available: <count> <reason>, ..." with per-reason node
    counts (sorted as strings, like sortReasonsHistogram), from reductions
    made on the device (:func:`failure_counts`) — the per-node bit matrix
    never crosses the device boundary.

    ``counts_row`` (B,) per-reason valid-node counts; ``insufficient_row``
    (R,) the per-resource "Insufficient <res>" counts (error.go:111);
    ``not_ready``/``net_unavail`` the CheckNodeCondition splits
    (error.go:67,:69); ``n_valid`` the valid-node count; ``req`` (R,) the
    pod's request row (host pack table)."""
    hist: dict = {}
    for name, b in BIT.items():
        cnt = int(counts_row[b])
        if not cnt:
            continue
        if name == "PodFitsResources":
            # all-zero-request pods fail ONLY on the pod-count cap
            # (resource_fit_mask's pods_only branch; predicates.go:803-809)
            nonzero = any(
                req[ri] > 0 for ri in range(len(res_names))
                if res_names[ri] != "pods"
            )
            cols = (
                range(len(res_names)) if nonzero
                else [res_names.index("pods")]
            )
            for ri in cols:
                c = int(insufficient_row[ri])
                if c:
                    key = f"Insufficient {res_names[ri]}"
                    hist[key] = hist.get(key, 0) + c
        elif name == "CheckNodeCondition":
            c_nr, c_nu = int(not_ready), int(net_unavail)
            if c_nr:
                hist["node(s) were not ready"] = (
                    hist.get("node(s) were not ready", 0) + c_nr
                )
            if c_nu:
                hist["node(s) had unavailable network"] = (
                    hist.get("node(s) had unavailable network", 0) + c_nu
                )
        else:
            msg = REASON_MESSAGES[name]
            hist[msg] = hist.get(msg, 0) + cnt
    parts = sorted(f"{v} {k}" for k, v in hist.items())
    return f"0/{n_valid} nodes are available: {', '.join(parts)}."


def failure_counts(reasons, node_valid, req, free, ready, net_unavail):
    """The device reductions behind a failed pod's reasons and FitError
    text, for the (F, N) reasons rows of the F pods that failed: ``bits``
    (F,) the OR of every valid node's failure bits; ``per_reason`` (F, B)
    valid nodes each predicate excluded; ``insufficient`` (F, R) valid
    nodes where PodFitsResources fired and the request exceeds the free
    amount; ``not_ready``/``net_unavail`` (F,) the CheckNodeCondition
    splits. A view of :func:`kubernetes_tpu_torch.obs.explain.explain_reduce`'s
    FitError fields over every row; ``req`` (F, R), ``free`` (N, R)."""
    from kubernetes_tpu_torch.obs.explain import explain_reduce

    every = torch.ones((reasons.shape[0],), dtype=torch.bool,
                       device=reasons.device)
    ex = explain_reduce(reasons, node_valid, every, req, free, ready,
                        net_unavail)
    return dict(bits=ex.pod_bits, per_reason=ex.per_pod,
                insufficient=ex.insufficient, not_ready=ex.not_ready,
                net_unavail=ex.net_unavail)


def _bits(cond: torch.Tensor, name: str) -> torch.Tensor:
    """int32 tensor with predicate ``name``'s bit set where ``cond``."""
    return cond.to(torch.int32) << BIT[name]


def _row_ids(ids: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Segment ids broadcast over ``data``'s trailing axes."""
    return ids.long().view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)


def _segment_min(data: torch.Tensor, ids: torch.Tensor, n: int):
    """jax.ops.segment_min over rows: empty segments hold int32 max."""
    out = torch.full((n,) + data.shape[1:], _I32_MAX, dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce_(0, _row_ids(ids, data), data, "amin",
                               include_self=True)


def _segment_max(data: torch.Tensor, ids: torch.Tensor, n: int):
    """jax.ops.segment_max over rows: empty segments hold int32 min."""
    out = torch.full((n,) + data.shape[1:], _I32_MIN, dtype=data.dtype,
                     device=data.device)
    return out.scatter_reduce_(0, _row_ids(ids, data), data, "amax",
                               include_self=True)


def _gather_rows(table: torch.Tensor, ids: torch.Tensor, fill):
    """``table[clip(ids)]`` with rows of negative ``ids`` set to ``fill``."""
    idx = ids.clamp(0, table.shape[0] - 1).long()
    return torch.where((ids >= 0)[:, None], table[idx], fill)


def selector_program_match(sel: DeviceSelectors,
                           nodes: DeviceNodes) -> torch.Tensor:
    """(G, N) bool: does node satisfy required selector program g?

    Program semantics (predicates.go:904 PodMatchNodeSelector →
    v1helper.MatchNodeSelectorTerms): OR over terms, AND over a term's
    expressions. Evaluated as flat expression rows + segment reductions.
    """
    return _program_eval(
        nodes,
        sel.expr_valid, sel.expr_term, sel.expr_op, sel.expr_pairs_mh,
        sel.expr_key, sel.expr_lit, sel.term_valid, sel.term_prog,
        n_progs=sel.prog_valid.shape[0],
        weights=None,
    )


def preferred_program_score(sel: DeviceSelectors,
                            nodes: DeviceNodes) -> torch.Tensor:
    """(Gp, N) f32: sum of weights of matched preferred terms per node
    (priorities/node_affinity.go CalculateNodeAffinityPriorityMap)."""
    return _program_eval(
        nodes,
        sel.p_expr_valid, sel.p_expr_term, sel.p_expr_op, sel.p_expr_pairs_mh,
        sel.p_expr_key, sel.p_expr_lit, sel.p_term_valid, sel.p_term_prog,
        n_progs=sel.p_prog_valid.shape[0],
        weights=sel.p_term_weight,
    )


def _program_eval(nodes, e_valid, e_term, e_op, e_pairs, e_key, e_lit,
                  t_valid, t_prog, n_progs, weights):
    # (E, N) match per expression
    in_count = e_pairs @ nodes.pair_mh.T
    key_idx = e_key.clamp(0, nodes.key_mh.shape[1] - 1).long()
    has_key = nodes.key_mh[:, key_idx].T  # (E, N)
    val = nodes.key_val[:, key_idx].T  # (E, N)
    is_num = nodes.key_num[:, key_idx].T > 0  # (E, N)
    lit = e_lit[:, None]
    op = e_op[:, None]
    match = (op == XOP_IN) & (in_count > 0)
    match = torch.where(op == XOP_NOT_IN, in_count == 0, match)
    match = torch.where(op == XOP_EXISTS, has_key > 0, match)
    match = torch.where(op == XOP_NOT_EXISTS, has_key == 0, match)
    # Gt/Lt require an integer-parsed label value (reference: int-parse
    # error => predicate failure) — explicit mask, no NaN sentinels
    match = torch.where(op == XOP_GT, is_num & (val > lit), match)
    match = torch.where(op == XOP_LT, is_num & (val < lit), match)
    # padded expr rows are neutral for the AND
    match = match | ~e_valid[:, None]

    n_terms = t_valid.shape[0]
    term_match = _segment_min(match.to(torch.int32), e_term, n_terms)
    term_match = torch.clamp_max(term_match, 1)  # empty segment -> 1
    # a term with no expressions matches vacuously ONLY if it is a real
    # term (the packer only emits terms with >= 1 expression)
    term_match = torch.where(t_valid[:, None], term_match, 0)

    if weights is None:
        prog = _segment_max(term_match, t_prog, n_progs)
        return prog > 0  # (G, N) bool
    w = torch.where(t_valid, weights, 0.0)
    out = torch.zeros((n_progs, term_match.shape[1]), dtype=torch.float32,
                      device=term_match.device)
    return out.index_add_(0, t_prog.long(),
                          term_match.to(torch.float32) * w[:, None])


class FilterResult(NamedTuple):
    mask: torch.Tensor  # (P, N) bool — feasible
    reasons: torch.Tensor  # (P, N) int32 — failed-predicate bitmask


def static_predicate_reasons(pods: DevicePods, nodes: DeviceNodes,
                             sel: DeviceSelectors):
    """Usage-invariant predicate bits plus the node-selector program match
    table, as ``(reasons (P,N) int32, prog (G,N) bool)``.

    Everything here reads only node fields the round loops never replace
    — conditions, spec.unschedulable, pressure flags, taints, hostname
    and label membership — so the solvers compute it once per batch and
    pass it back via ``run_predicates(hoisted=)`` (metadata.go:152
    GetMetadata: compute shared state once, reuse across the cycle)."""
    P, N = pods.req.shape[0], nodes.allocatable.shape[0]
    reasons = torch.zeros((P, N), dtype=torch.int32, device=pods.req.device)

    # CheckNodeCondition (predicates.go:1625): not-ready or
    # network-unavailable fails all pods (v1.16 consults only NodeReady
    # and NodeNetworkUnavailable; spec.unschedulable is its own bit)
    reasons |= _bits(~nodes.ready | nodes.network_unavailable,
                     "CheckNodeCondition")[None, :]
    reasons |= _bits(~nodes.schedulable, "CheckNodeUnschedulable")[None, :]
    # CheckNode{Disk,PID}Pressure fail for every pod (predicates.go:1605,:1615)
    reasons |= _bits(nodes.disk_pressure, "CheckNodeDiskPressure")[None, :]
    reasons |= _bits(nodes.pid_pressure, "CheckNodePIDPressure")[None, :]

    # CheckNodeMemoryPressure (predicates.go:1583): only BestEffort pods
    # (zero requests) are rejected
    best_effort = pods.req.sum(1) <= 1.0  # only the pods column (==1)
    reasons |= _bits(best_effort[:, None] & nodes.mem_pressure[None, :],
                     "CheckNodeMemoryPressure")

    # PodToleratesNodeTaints (predicates.go:1546): any NoSchedule/NoExecute
    # taint not tolerated fails; tolerated-count via matmul
    tol_rows = _gather_rows(sel.tol_hard_mh, pods.tolset_id, 0.0)  # (P, Ut)
    hard_count = nodes.taint_hard_mh.sum(1)  # (N,)
    tolerated = tol_rows @ nodes.taint_hard_mh.T  # (P, N)
    reasons |= _bits((hard_count[None, :] - tolerated) > 0,
                     "PodToleratesNodeTaints")

    # PodFitsHost (predicates.go:916). name_req: -1 = unconstrained,
    # -2 = pinned to an unknown node (fails everywhere), >=0 = must equal
    host_fail = (pods.name_req != -1)[:, None] & (
        pods.name_req[:, None] != nodes.name_id[None, :])
    reasons |= _bits(host_fail, "PodFitsHost")

    # PodMatchNodeSelector (predicates.go:904) via selector programs
    prog = selector_program_match(sel, nodes)  # (G, N)
    sel_ok = _gather_rows(prog, pods.selprog_id, True)
    reasons |= _bits(~sel_ok, "PodMatchNodeSelector")
    return reasons, prog


def run_predicates(
    pods: DevicePods,
    nodes: DeviceNodes,
    sel: DeviceSelectors,
    topo=None,
    vol=None,
    static_reasons: torch.Tensor | None = None,
    enabled_mask=None,
    hoisted=None,
    no_ports: bool = False,
    no_pod_affinity: bool = False,
    no_spread: bool = False,
) -> FilterResult:
    """The fused Filter pass: all predicates, all (pod, node) pairs
    (findNodesThatFit, generic_scheduler.go:460, with the default predicate
    set). ``vol`` (a :class:`~kubernetes_tpu_torch.ops.arrays.DeviceVolumes`)
    adds the usage-dependent volume predicates, ``static_reasons`` ORs in
    precomputed usage-independent bits. ``enabled_mask`` (int bitmask over
    PREDICATE_BITS) clears disabled predicates' bits before the mask forms
    (CreateFromConfig semantics, factory.go:356). ``hoisted`` takes
    :func:`static_predicate_reasons` output computed once per batch.
    ``no_ports`` skips the three port-conflict matmuls (exact when no
    pending pod declares host ports). ``topo`` (a
    :class:`~kubernetes_tpu_torch.ops.arrays.DeviceTopology`) adds the
    inter-pod affinity and topology spread predicates; ``no_pod_affinity``
    / ``no_spread`` skip each of them where the batch gates prove its mask
    all-true."""
    if hoisted is None:
        reasons, prog = static_predicate_reasons(pods, nodes, sel)
    else:
        reasons, prog = hoisted
        reasons = reasons.clone()

    # PodFitsHostPorts (predicates.go:1084, host_ports.go conflict rules):
    # wildcard-IP pod ports conflict with any same-(proto,port) use;
    # specific-IP ports conflict with wildcard uses of (proto,port) or
    # identical (proto,ip,port) uses. Usage-dependent.
    if not no_ports:
        conflicts = (pods.port_wild_pp @ nodes.port_any_mh.T
                     + pods.port_spec_pp @ nodes.port_wild_mh.T
                     + pods.port_spec_pip @ nodes.port_spec_mh.T)
        reasons |= _bits(conflicts > 0, "PodFitsHostPorts")

    if topo is not None:
        from kubernetes_tpu_torch.ops.topology import (
            even_pods_spread_mask,
            inter_pod_affinity_mask,
        )

        # the topology universe only grows over a packer's life, so the
        # batch-scoped gates matter for long-lived drivers: no_pod_affinity
        # (no (anti)affinity pod in the batch AND all-zero node-side
        # anti/sym counts) and no_spread (no spread constraint in the
        # batch) each prove their mask all-true
        if not no_pod_affinity:
            # MatchInterPodAffinity (predicates.go:1211)
            reasons |= _bits(~inter_pod_affinity_mask(pods, nodes, topo),
                             "MatchInterPodAffinity")
        if not no_spread:
            # EvenPodsSpread (predicates.go:1720)
            reasons |= _bits(~even_pods_spread_mask(pods, nodes, topo, prog),
                             "EvenPodsSpread")

    if vol is not None:
        reasons |= _dynamic_volume_reasons(pods, nodes, vol)
    if static_reasons is not None:
        reasons |= static_reasons

    # PodFitsResources (predicates.go:779): the pod-count cap always
    # applies; the other columns only when the pod requests anything
    reasons |= _bits(~resource_fit_mask(pods.req, nodes.allocatable,
                                        nodes.requested), "PodFitsResources")

    if enabled_mask is not None:
        reasons &= int(enabled_mask)
    # padding: invalid nodes/pods are infeasible with no reasons surfaced
    mask = (reasons == 0) & nodes.valid[None, :] & pods.valid[:, None]
    return FilterResult(mask=mask, reasons=reasons)


def _dynamic_volume_reasons(pods: DevicePods, nodes: DeviceNodes,
                            vol) -> torch.Tensor:
    """Usage-dependent volume predicates (they read node volume state that
    changes as pods land, so they re-evaluate every assignment round):

    - NoDiskConflict (predicates.go:275): shared conflict token where not
      both mounts are read-only.
    - MaxPDVolumeCount (:404) + CSI limits (csi_volume_predicate.go:54):
      per-kind unique-volume counts vs per-node attach limits.
    """
    P, N = pods.req.shape[0], nodes.allocatable.shape[0]
    reasons = torch.zeros((P, N), dtype=torch.int32, device=pods.req.device)

    esc = vol.conflict_escape  # (Uv,)
    conflicts = ((pods.vol_any_mh * (1.0 - esc)) @ nodes.vol_any_mh.T
                 + (pods.vol_any_mh * esc) @ nodes.vol_rw_mh.T
                 + (pods.vol_rw_mh * esc) @ nodes.vol_any_mh.T)
    reasons |= _bits(conflicts > 0, "NoDiskConflict")

    # MaxPDVolumeCount: each checker quick-returns when the pod has no
    # relevant volumes (predicates.go:471), so limits only bind pods that
    # carry that kind
    count_fail = torch.zeros((P, N), dtype=torch.bool, device=reasons.device)
    for t in range(vol.pd_type_onehot.shape[1]):
        tm = vol.pd_type_onehot[:, t]  # (Uvd,)
        podt = pods.pd_mh * tm
        nodet = nodes.pd_mh * tm
        has_t = podt.sum(1) > 0  # (P,)
        node_cnt = nodet.sum(1)  # (N,)
        new = podt.sum(1)[:, None] - podt @ nodet.T  # (P, N)
        over = node_cnt[None, :] + new > nodes.pd_limit[:, t][None, :]
        count_fail |= has_t[:, None] & over

    # CSI: only drivers the pod ADDS volumes for (csi_volume_predicate.go:104)
    for d in range(vol.csi_driver_onehot.shape[1]):
        dm = vol.csi_driver_onehot[:, d]
        podd = pods.csi_mh * dm
        noded = nodes.csi_mh * dm
        node_cnt = noded.sum(1)
        new = podd.sum(1)[:, None] - podd @ noded.T
        over = node_cnt[None, :] + new > nodes.csi_limit[:, d][None, :]
        count_fail |= (new > 0) & over
    reasons |= _bits(count_fail, "MaxVolumeCount")
    return reasons


def static_volume_reasons(pods: DevicePods, nodes: DeviceNodes,
                          sel: DeviceSelectors, vol,
                          prog: torch.Tensor | None = None) -> torch.Tensor:
    """Usage-independent volume predicates, computed once per cycle and
    ORed into every round's reasons via ``static_reasons``:

    - NoVolumeZoneConflict (predicates.go:632): bound PVs' failure-domain
      labels vs node labels.
    - CheckVolumeBinding (:1666): PV node-affinity CNF over selector
      programs.
    - VolumeError: unresolvable PVC/PV state fails the pod everywhere.

    ``prog`` accepts the selector table from
    :func:`static_predicate_reasons` so it is evaluated once."""
    P = pods.req.shape[0]
    N = nodes.allocatable.shape[0]
    reasons = torch.zeros((P, N), dtype=torch.int32, device=pods.req.device)
    if prog is None:
        prog = selector_program_match(sel, nodes)  # (G, N)

    # NoVolumeZoneConflict: a row passes where the node carries an allowed
    # (key, value) pair or has no zone labels at all
    row_hit = (vol.vz_pairs_mh @ nodes.pair_mh.T) > 0  # (Rv, N)
    row_bad = (~row_hit) & nodes.has_zone_label[None, :] \
        & vol.vz_valid[:, None]
    vz_bad = _segment_max(row_bad.to(torch.int32), vol.vz_pod, P)
    reasons |= _bits(vz_bad > 0, "NoVolumeZoneConflict")

    # CheckVolumeBinding (CNF over PV-affinity programs)
    Cb = vol.vb_clause_pod.shape[0]
    row_m = prog[vol.vb_row_prog.clamp(0, prog.shape[0] - 1).long()]
    row_m = row_m & vol.vb_row_valid[:, None]
    # a clause with no rows (no candidate PV) stays False
    clause_ok = _segment_max(row_m.to(torch.int32), vol.vb_row_clause, Cb) > 0
    clause_bad = (~clause_ok) & vol.vb_clause_valid[:, None]
    bound_bad = _segment_max(
        (clause_bad & vol.vb_clause_bound[:, None]).to(torch.int32),
        vol.vb_clause_pod, P)
    unbound_bad = _segment_max(
        (clause_bad & ~vol.vb_clause_bound[:, None]).to(torch.int32),
        vol.vb_clause_pod, P)
    reasons |= _bits(bound_bad > 0, "VolumeNodeConflict")
    reasons |= _bits(unbound_bad > 0, "VolumeBindConflict")

    # unresolvable volume state: fails everywhere
    reasons |= _bits(pods.vol_error, "VolumeError")[:, None]
    return reasons


def resource_fit_mask(pod_req: torch.Tensor, allocatable: torch.Tensor,
                      requested: torch.Tensor) -> torch.Tensor:
    """(P, N) bool resource-only fit — reused by the assignment rounds,
    where usage changes as pods land. Iterates the small resource axis so
    no (P, N, R) intermediate is materialized."""
    free = allocatable - requested  # (N, R)
    full = None
    nonzero = None
    for r in range(pod_req.shape[1]):
        col = pod_req[:, r:r + 1] <= free[None, :, r] + 1e-6
        full = col if full is None else (full & col)
        if r != RES_PODS:
            nz = pod_req[:, r] > 0
            nonzero = nz if nonzero is None else (nonzero | nz)
    pods_only = pod_req[:, RES_PODS:RES_PODS + 1] \
        <= free[None, :, RES_PODS] + 1e-6
    return torch.where(nonzero[:, None], full, pods_only)


def pods_have_no_ports(pod_table) -> bool:
    """Host-side gate companion to ``run_predicates(no_ports=)``: True when
    no pending pod in the packed table declares host ports."""
    return bool(pod_table.port_wild_pp.sum() == 0
                and pod_table.port_spec_pp.sum() == 0
                and pod_table.port_spec_pip.sum() == 0)


def decode_reasons(bitmask: int) -> Tuple[str, ...]:
    """Host helper: failure-reason names from a reasons bitmask entry."""
    return tuple(n for i, n in enumerate(PREDICATE_BITS) if bitmask >> i & 1)
