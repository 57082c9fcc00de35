"""Batched assignment — whole-queue placement instead of the reference's
one-pod-at-a-time control loop (``pkg/scheduler/scheduler.go:462``
scheduleOne → ``selectHost``, ``generic_scheduler.go:292``). The port of
``kubernetes_tpu/ops/assign.py``.

Two solvers:

- ``greedy_assign`` — the **parity path**: pods in activeQ order
  (priority desc, arrival asc), recomputing predicates + priorities for
  one pod against the current usage each step — the reference's serial
  semantics with the lowest node index as the deterministic tie-break.
- ``batch_assign`` — the **fast path**: assign-and-mask rounds. Every
  round, all unplaced pods score all nodes at once, pick their best node
  (rotating among exactly tied bests), and per-node acceptance admits the
  highest-priority prefix that fits capacity; usage updates by
  scatter-add and the next round re-masks.

The reference runs its round loops on the device
(``jax.lax.while_loop``); so does the port on a CUDA tensor: round 0 runs
eagerly, the later rounds loop as one CUDA graph (:mod:`.device_loop`),
and the only host read is the transport-plan router's round-0 decision
(one counted sync, :mod:`.sync`). On CPU tensors the plain Python loop
stays.

On a node-axis mesh of ``d > 1`` devices (``batch_assign(*shard_cluster(
pods, nodes, sel, mesh))``, :mod:`kubernetes_tpu_torch.parallel.mesh`) the
batch solve is partitioned: each round is one program per shard over its
row block — the same round functions, written as generators that yield
their per-shard partials where the reference's partitioner inserts a
collective (``parallel/collectives.py``) — and the placements come back
as global node rows on the mesh's first device.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.ops import device_loop
from kubernetes_tpu_torch.ops.arrays import (
    DeviceNodes,
    DevicePods,
    DeviceSelectors,
)
from kubernetes_tpu_torch.ops.fused_score import use_kernels
from kubernetes_tpu_torch.ops.predicates import (
    BIT,
    resource_fit_mask,
    run_predicates,
    run_predicates_g,
    static_predicate_reasons,
    static_volume_reasons,
)
from kubernetes_tpu_torch.ops.priorities import (
    _EPS,
    _idiv,
    MAX_PRIORITY,
    hoist_priorities_g,
    run_priorities,
    run_priorities_g,
)
from kubernetes_tpu_torch.ops.topology import (
    self_escape_active_g,
    sensitive_keys,
)
from kubernetes_tpu_torch.parallel import collectives as coll

NEG = -1e30

#: auto-routing thresholds: route a batch to the transport plan only when
#: round 0 shows a real tie-contention cohort — at least this many bidders
#: whose multi-way-tied best columns are oversubscribed...
AUTO_TIE_MIN_COHORT = 8
#: ...AND whose runner-up gaps differ by at least this many score steps
AUTO_TIE_GAP_MARGIN = 2.0

#: kernels that can create the asymmetric-second-choice signature the
#: auto-router hunts; when the host gates prove ALL of them absent, the
#: router (and the plan branch) is left out for the batch
_PREFERENCE_KERNELS = (
    "NodeAffinityPriority", "SelectorSpreadPriority",
    "InterPodAffinityPriority", "EvenPodsSpreadPriority",
    "TaintTolerationPriority", "ImageLocalityPriority",
)

#: lean-score support: the usage-dependent resource kernels the fused
#: round inlines, plus EqualPriority (a constant)
_LEAN_DYNAMIC = ("LeastRequestedPriority", "MostRequestedPriority",
                 "BalancedResourceAllocation")


class UsageState(NamedTuple):
    """The mutable slice of node state — what AddPod touches in the
    reference's NodeInfo (requested, nonZeroRequest, usedPorts, pod list)
    plus spread counts."""

    requested: torch.Tensor  # (N, R)
    nonzero_req: torch.Tensor  # (N, 2)
    port_any: torch.Tensor  # (N, Upp)
    port_wild: torch.Tensor  # (N, Upp)
    port_spec: torch.Tensor  # (N, Upip)
    owner_counts: torch.Tensor  # (N, Uo)
    matcher_counts: torch.Tensor  # (N, M)
    anti_counts: torch.Tensor  # (N, Ua)
    sym_counts: torch.Tensor  # (N, Us)
    aff_pod_count: torch.Tensor  # (N,)
    vol_any: torch.Tensor  # (N, Uv)
    vol_rw: torch.Tensor  # (N, Uv)
    pd_mh: torch.Tensor  # (N, Uvd)
    csi_mh: torch.Tensor  # (N, Uvc)


def usage_from_nodes(nodes: DeviceNodes) -> UsageState:
    """The usage slice of a node table; of a ``parallel.mesh.
    ShardedNodes``, a ``UsageState`` of its blocks' slices (each field a
    ``parallel.mesh.Blocks``)."""
    from kubernetes_tpu_torch.parallel.mesh import ShardedNodes, per_shard

    if isinstance(nodes, ShardedNodes):
        return per_shard(usage_from_nodes, nodes, split=0)
    return UsageState(
        requested=nodes.requested,
        nonzero_req=nodes.nonzero_req,
        port_any=nodes.port_any_mh,
        port_wild=nodes.port_wild_mh,
        port_spec=nodes.port_spec_mh,
        owner_counts=nodes.owner_counts,
        matcher_counts=nodes.matcher_counts,
        anti_counts=nodes.anti_counts,
        sym_counts=nodes.sym_counts,
        aff_pod_count=nodes.aff_pod_count,
        vol_any=nodes.vol_any_mh,
        vol_rw=nodes.vol_rw_mh,
        pd_mh=nodes.pd_mh,
        csi_mh=nodes.csi_mh,
    )


def nodes_with_usage(nodes: DeviceNodes, u: UsageState) -> DeviceNodes:
    """The node table with ``u`` as its usage; a ``parallel.mesh.
    ShardedNodes`` takes a ``UsageState`` of ``parallel.mesh.Blocks``,
    block by block (a derived table: no whole)."""
    from kubernetes_tpu_torch.parallel.mesh import ShardedNodes, part

    if isinstance(nodes, ShardedNodes):
        return ShardedNodes(nodes.mesh, tuple(
            nodes_with_usage(b, part(u, i))
            for i, b in enumerate(nodes.blocks)))
    return nodes._replace(
        requested=u.requested,
        nonzero_req=u.nonzero_req,
        port_any_mh=u.port_any,
        port_wild_mh=u.port_wild,
        port_spec_mh=u.port_spec,
        owner_counts=u.owner_counts,
        matcher_counts=u.matcher_counts,
        anti_counts=u.anti_counts,
        sym_counts=u.sym_counts,
        aff_pod_count=u.aff_pod_count,
        vol_any_mh=u.vol_any,
        vol_rw_mh=u.vol_rw,
        pd_mh=u.pd_mh,
        csi_mh=u.csi_mh,
    )


def _scatter_add(base, idx, vals):
    return base.clone().index_add_(0, idx, vals)


def _scatter_max(base, idx, vals):
    if base.ndim == 1:
        return base.clone().scatter_reduce_(0, idx, vals, "amax")
    return base.clone().scatter_reduce_(
        0, idx[:, None].expand_as(vals), vals, "amax")


def _apply_batch(u: UsageState, pods: DevicePods, node_idx: torch.Tensor,
                 accepted: torch.Tensor) -> UsageState:
    """Scatter accepted pods into the usage state (new tensors; ``u`` is
    left as it was): :func:`_apply_usage`, or on a mesh (``u`` a
    ``UsageState`` of ``parallel.mesh.Blocks``; ``node_idx`` and
    ``accepted`` on the mesh's first device) per block: each block takes
    the pods whose node it owns, at its local rows, in the same order,
    so every node's sums are the unsharded ones."""
    from kubernetes_tpu_torch.parallel.mesh import is_placed, per_shard

    if not is_placed(u):
        return _apply_usage(u, pods, node_idx, accepted)
    return per_shard(_apply_local, u, pods, node_idx, accepted,
                     shard=True, split=0)


def _apply_usage(u: UsageState, pods: DevicePods, node_idx: torch.Tensor,
                 accepted: torch.Tensor) -> UsageState:
    """Scatter accepted pods into the usage state (new tensors; ``u`` is
    left as it was). ``node_idx`` (P,) row per pod; ``accepted`` (P,) bool
    gates contributions (rejected rows scatter zeros into row 0).

    The adds are exact only while every partial sum is an exactly
    representable f32 (integer-valued requests, the reference's own
    argument); the CUDA scatter-add's order varies from run to run, so
    anything inexact would show up as run-to-run noise."""
    tgt = torch.where(accepted, node_idx, 0).long()
    w = accepted.to(torch.float32)[:, None]
    return UsageState(
        requested=_scatter_add(u.requested, tgt, pods.req * w),
        nonzero_req=_scatter_add(u.nonzero_req, tgt, pods.nonzero_req * w),
        port_any=_scatter_max(
            u.port_any, tgt,
            torch.maximum(pods.port_wild_pp, pods.port_spec_pp) * w),
        port_wild=_scatter_max(u.port_wild, tgt, pods.port_wild_pp * w),
        port_spec=_scatter_max(u.port_spec, tgt, pods.port_spec_pip * w),
        owner_counts=_scatter_add(u.owner_counts, tgt,
                                  pods.owner_match_mh * w),
        matcher_counts=_scatter_add(u.matcher_counts, tgt,
                                    pods.matcher_mh * w),
        anti_counts=_scatter_add(u.anti_counts, tgt, pods.anti_term_mh * w),
        sym_counts=_scatter_add(u.sym_counts, tgt, pods.sym_term_mh * w),
        aff_pod_count=_scatter_add(
            u.aff_pod_count, tgt, pods.has_aff.to(torch.float32) * w[:, 0]),
        vol_any=_scatter_max(u.vol_any, tgt, pods.vol_any_mh * w),
        vol_rw=_scatter_max(u.vol_rw, tgt, pods.vol_rw_mh * w),
        pd_mh=_scatter_max(u.pd_mh, tgt, pods.pd_mh * w),
        csi_mh=_scatter_max(u.csi_mh, tgt, pods.csi_mh * w),
    )


def _lexsort(secondary: torch.Tensor, primary: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((secondary, primary))``: order by ``primary``, ties
    by ``secondary`` — two stable sorts."""
    o = torch.argsort(secondary, stable=True)
    return o[torch.argsort(primary[o], stable=True)]


def _inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """inv[perm[i]] = i for a permutation ``perm``."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype,
                             device=perm.device)
    return inv


def queue_order(pods: DevicePods) -> torch.Tensor:
    """activeQ comparator: priority desc, then arrival (row order) asc —
    scheduling_queue.go's less func. Invalid (padding) rows sort last."""
    pri = torch.where(pods.valid, pods.priority.long(), -(2**31))
    return _lexsort(pods.order.long(), -pri)


def _pod_row(pods: DevicePods, p: torch.Tensor) -> DevicePods:
    """One-row DevicePods view at device index ``p`` (shape (1,))."""
    return DevicePods(*[f.index_select(0, p) for f in pods])


def _first_true(x: torch.Tensor) -> torch.Tensor:
    """Per-row index of the first True (0 when none) — jnp.argmax on a
    boolean row."""
    return x.to(torch.uint8).argmax(1)


def greedy_assign(
    pods: DevicePods,
    nodes: DeviceNodes,
    sel: DeviceSelectors,
    weights: Optional[Dict[str, float]] = None,
    topo=None,
    extra_mask: Optional[torch.Tensor] = None,
    vol=None,
    static_vol: Optional[torch.Tensor] = None,
    enabled_mask: Optional[int] = None,
    extra_score: Optional[torch.Tensor] = None,
    skip_priorities=(),
    no_ports: bool = False,
    no_pod_affinity: bool = False,
    no_spread: bool = False,
    fault_hook=None,
    fault_site: str = "solve:greedy",
) -> Tuple[torch.Tensor, UsageState]:
    """Serial-parity solver. Returns (assigned node row per pod or -1,
    final usage). ``extra_mask`` (P, N) ANDs into feasibility;
    ``skip_priorities`` names kernels replaced by their exact constants.
    The pod loop stays on the device: no host sync.

    ``fault_hook(site, assigned, usage, rounds, n_nodes)`` is the
    solver-entry fault-injection seam (:mod:`kubernetes_tpu_torch.faults`):
    called with the would-be result, it may raise a solver fault or
    return a poisoned triple. On a mesh the serial oracle runs on the
    whole table, gathered onto the mesh's first device
    (``collectives.whole_table``)."""
    from kubernetes_tpu_torch.parallel.mesh import ShardedNodes, unreplicated

    if isinstance(nodes, ShardedNodes):
        nodes = coll.whole_table(nodes)
    pods, sel = unreplicated(pods), unreplicated(sel)
    topo, vol = unreplicated(topo), unreplicated(vol)
    P = pods.req.shape[0]
    dev = pods.req.device
    perm = queue_order(pods)
    u = usage_from_nodes(nodes)
    static_bits, prog = static_predicate_reasons(pods, nodes, sel)
    if vol is not None and static_vol is None:
        static_vol = static_volume_reasons(pods, nodes, sel, vol, prog=prog)
    picks = torch.empty((P,), dtype=torch.int32, device=dev)
    for i in range(P):
        p = perm[i:i + 1]
        pod = _pod_row(pods, p)
        cur = nodes_with_usage(nodes, u)
        sv = static_vol.index_select(0, p) if static_vol is not None else None
        mask = run_predicates(
            pod, cur, sel, topo, vol, sv, enabled_mask,
            hoisted=(static_bits.index_select(0, p), prog),
            no_ports=no_ports, no_pod_affinity=no_pod_affinity,
            no_spread=no_spread).mask  # (1, N)
        if extra_mask is not None:
            mask = mask & extra_mask.index_select(0, p)
        score = run_priorities(pod, cur, sel, mask, weights, topo,
                               skip=skip_priorities)
        if extra_score is not None:
            score = score + extra_score.index_select(0, p)
        best = torch.where(mask, score, NEG).argmax(1)  # (1,)
        ok = mask.gather(1, best[:, None])[:, 0] & pod.valid
        u = _apply_usage(u, pod, best, ok)
        picks[i:i + 1] = torch.where(ok, best, -1).to(torch.int32)
    assigned = torch.full((P,), -1, dtype=torch.int32, device=dev)
    assigned[perm] = picks
    if fault_hook is not None:
        assigned, u, _ = fault_hook(fault_site, assigned, u, 0,
                                    nodes.allocatable.shape[0])
    return assigned, u


def _segment_prefix(values: torch.Tensor,
                    seg_starts: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sums within contiguous segments. ``values`` (P, R)
    sorted by segment; ``seg_starts`` (P,) index of each row's segment
    start. f32 sums: exact while the running totals are exactly
    representable (integer requests, as in the reference)."""
    excl = torch.cumsum(values, dim=0) - values
    return excl - excl[seg_starts]


def _lean_score_plan(weights, skip):
    """Scoring plan for the fused lean round: ``(const_total, terms)`` —
    the exact scalar sum of all gated/constant kernels plus the ordered
    (name, weight) list of live resource kernels — or None when any
    active kernel falls outside the provably exact lean set (integer
    weights, stock kernels)."""
    from kubernetes_tpu_torch.ops.priorities import (
        _ALL_STOCK_KERNELS,
        _STOCK_KERNELS,
        DEFAULT_WEIGHTS,
        EMPTY_CONSTANTS,
        PRIORITY_REGISTRY,
    )

    weights = DEFAULT_WEIGHTS if weights is None else weights
    const_total = 0.0
    terms = []
    for name, w in weights.items():
        if not w:
            continue
        if float(w) != int(w):
            return None
        if PRIORITY_REGISTRY.get(name) is not _ALL_STOCK_KERNELS.get(name):
            return None  # rebound kernel: empty/lean behavior unknown
        if (name in skip and name in EMPTY_CONSTANTS
                and PRIORITY_REGISTRY[name] is _STOCK_KERNELS[name]):
            const_total += w * EMPTY_CONSTANTS[name]
        elif name == "EqualPriority":
            const_total += w * 1.0
        elif name in _LEAN_DYNAMIC:
            terms.append((name, float(w)))
        else:
            return None
    return const_total, tuple(terms)


def _lean_masked_score(pods, nodes, u, active, static_ok, res_on, plan):
    """The lean round's single (P, N) pass: feasibility and weighted score
    in one ``where(mask, score, NEG)``. Arithmetic is verbatim
    priorities.least_requested / most_requested / balanced_allocation
    with the shared request fractions computed once."""
    from kubernetes_tpu_torch.ops.priorities import _balanced, _capped

    const_total, terms = plan
    mask = static_ok & active[:, None]
    if res_on:
        mask = mask & resource_fit_mask(pods.req, nodes.allocatable,
                                        u.requested)
    score = torch.full((pods.req.shape[0], nodes.allocatable.shape[0]),
                       float(const_total), dtype=torch.float32,
                       device=pods.req.device)
    if terms:
        cpu_req = pods.nonzero_req[:, 0:1] + u.nonzero_req[None, :, 0]
        mem_req = pods.nonzero_req[:, 1:2] + u.nonzero_req[None, :, 1]
        cpu_cap = nodes.allocatable[None, :, 0]
        mem_cap = nodes.allocatable[None, :, 1]
        for name, w in terms:
            if name == "LeastRequestedPriority":
                t = _idiv(
                    _capped(cpu_req, cpu_cap,
                            _idiv((cpu_cap - cpu_req) * MAX_PRIORITY,
                                  cpu_cap))
                    + _capped(mem_req, mem_cap,
                              _idiv((mem_cap - mem_req) * MAX_PRIORITY,
                                    mem_cap)),
                    2.0)
            elif name == "MostRequestedPriority":
                t = _idiv(
                    _capped(cpu_req, cpu_cap,
                            _idiv(cpu_req * MAX_PRIORITY, cpu_cap))
                    + _capped(mem_req, mem_cap,
                              _idiv(mem_req * MAX_PRIORITY, mem_cap)),
                    2.0)
            else:  # BalancedResourceAllocation
                t = _balanced(cpu_req, mem_req, cpu_cap, mem_cap)
            score = score + w * t
    return torch.where(mask, score, NEG)


def _rotated_pick(tied: torch.Tensor, arank: torch.Tensor, sh=None):
    """Each row picks its ``(arank % tcount + 1)``-th tied column — the
    deterministic tie-break spread, the batched analog of selectHost's
    randomized round-robin among max-scoring nodes
    (generic_scheduler.go:292). Returns (choice, tcount); choice is 0
    where a row has no tied column. (The reference's blocked two-level
    selection picks the same column.)

    A shard program (generator). On a mesh (``sh``) the tie counts are
    per block: the global count and this block's exclusive offset come
    from the cross-shard cumsum, the block that holds the rotated
    position picks, and the argmax merge hands its global column to
    every shard (the lowest global index wins the no-tie case, column
    0 as alone)."""
    pos = torch.cumsum(tied.to(torch.int32), dim=1, dtype=torch.int32)
    local = pos[:, -1]
    if sh is None:
        tcount, off = local, None
    else:
        tcount, off = yield coll.offsets(local)
    rot = torch.where(tcount > 0, arank % tcount.clamp_min(1), 0)
    if sh is None:
        choice = _first_true(tied & (pos == (rot + 1)[:, None]))
        return torch.where(tcount > 0, choice, 0), tcount
    at = rot - off
    owned = (tcount > 0) & (at >= 0) & (at < local)
    lc = torch.where(owned, _first_true(tied & (pos == (at + 1)[:, None])),
                     0)
    _, choice = yield coll.pick(owned.to(torch.int32), lc + sh.lo)
    return torch.where(tcount > 0, choice, 0), tcount


def _take_rows(table: torch.Tensor, choice: torch.Tensor, sh=None):
    """``table[choice]`` for a node-axis ``table`` and global node rows
    ``choice`` (clipped into the table), as a shard program: on a mesh
    the one block that owns each row supplies it."""
    if sh is None:
        return table[choice.clamp(0, table.shape[0] - 1)]
    g = choice.clamp(0, sh.n - 1)
    owner = torch.div(g, sh.rows, rounding_mode="floor")
    rows = table[(g - owner * sh.rows).clamp(0, sh.rows - 1)]
    return (yield coll.from_owner(rows, owner))


def _take_cols(x: torch.Tensor, choice: torch.Tensor, sh=None):
    """``x[p, choice[p]]`` of a (P, N) table, as a shard program."""
    if sh is None:
        return x.gather(1, choice[:, None])[:, 0]
    g = choice.clamp(0, sh.n - 1)
    owner = torch.div(g, sh.rows, rounding_mode="floor")
    local = (g - owner * sh.rows).clamp(0, sh.rows - 1)
    return (yield coll.from_owner(x.gather(1, local[:, None])[:, 0],
                                  owner))


def _admit_scored(choice, rank, req, free_at, n_nodes, per_node_cap,
                  capacity_on, sorted_gate=None):
    """Score-ordered per-node admission, one spelling shared by the general
    and lean rounds: group chosen pods by node (queue rank ascending
    within a node), admit the prefix that fits remaining capacity
    (``capacity_on`` is the PodFitsResources gate), cap admissions per
    node per round. ``free_at`` (P, R) is the free capacity of each pod's
    chosen node (any row where ``choice < 0``); ``n_nodes`` the node
    count. ``sorted_gate(order2, seg_starts) -> (P,) bool`` ANDs in the
    general path's port guard in the same sorted frame. Returns the (P,)
    accepted mask in original row order. Every input is per pod, so on a
    mesh each shard computes the same admission as the unsharded round."""
    P = choice.shape[0]
    ckey = torch.where(choice >= 0, choice, n_nodes + 1)
    order2 = _lexsort(rank, ckey)  # grouped by chosen node, rank asc
    c_s = choice[order2]
    ckey_s = ckey[order2].contiguous()  # sorted — safe for searchsorted
    req_s = req[order2]
    seg_starts = torch.searchsorted(ckey_s, ckey_s, side="left")
    prefix = _segment_prefix(req_s, seg_starts)  # usage by earlier pods
    free_s = free_at[order2]
    if capacity_on:
        fits = (prefix + req_s <= free_s + 1e-6).all(1)
    else:
        # a Policy bypassing PodFitsResources also bypasses the in-round
        # capacity guard (it only keeps co-admissions consistent with it)
        fits = torch.ones((P,), dtype=torch.bool, device=choice.device)
    within = torch.arange(P, device=choice.device) - seg_starts
    acc_s = (c_s >= 0) & fits & (within < per_node_cap)
    if sorted_gate is not None:
        acc_s = acc_s & sorted_gate(order2, seg_starts)
    return acc_s[_inverse_permutation(order2)]


def _admit_at(choice, rank, req, free, per_node_cap, capacity_on,
              sorted_gate=None, sh=None):
    """:func:`_admit_scored` reading each pod's chosen free row from the
    node-axis ``free`` table (the owning block's on a mesh)."""
    free_at = yield from _take_rows(free, choice, sh)
    n = free.shape[0] if sh is None else sh.n
    return _admit_scored(choice, rank, req, free_at, n, per_node_cap,
                         capacity_on, sorted_gate)


def _apply_local(u, pods, choice, accepted, sh=None):
    """Scatter the accepted pods into this block's usage: on a mesh only
    the pods whose chosen node the block owns, at its local rows."""
    if sh is None:
        return _apply_usage(u, pods, torch.where(accepted, choice, 0),
                            accepted)
    mine = accepted & (choice >= sh.lo) & (choice < sh.lo + sh.rows)
    return _apply_usage(u, pods, torch.where(mine, choice - sh.lo, 0), mine)


def _round_exit(assigned, pods, accepted) -> torch.Tensor:
    """The round loop's data-dependent exit test as a 0-d bool device
    tensor: continue while the round admitted somebody (no contention
    fixpoint) and somebody is left to place."""
    return accepted.any() & ((assigned == -1) & pods.valid).any()


def _lean_round(ctx, state, first, tag, *, per_node_cap, res_on,
                lean_plan, sh=None):
    """One fused lean round (the body :func:`_lean_rounds` loops), as a
    shard program over one block of the node axis (``sh`` None: the
    whole axis)."""
    pods, nodes, rank, static_ok = ctx
    assigned, u = state
    P = pods.req.shape[0]
    N = nodes.allocatable.shape[0] if sh is None else sh.n
    window = N * per_node_cap
    guard = NEG * 0.5  # real scores are finite and tiny next to NEG
    active = (assigned == -1) & pods.valid
    ms = _lean_masked_score(pods, nodes, u, active, static_ok, res_on,
                            lean_plan)
    rowmax = yield coll.all_max(ms.amax(1, keepdim=True))
    feasible_any = rowmax[:, 0] > guard
    wkey = torch.where(active & feasible_any, rank, P + 1)
    arank = _inverse_permutation(torch.argsort(wkey, stable=True))
    if P > window:
        # the bidder window binds only with more pods than window slots
        gate = active & feasible_any & (arank < window)
        ms = torch.where(gate[:, None], ms, NEG)
        rowmax = yield coll.all_max(ms.amax(1, keepdim=True))
    tied = (ms >= rowmax) & (rowmax > guard)
    choice, _tc = yield from _rotated_pick(tied, arank, sh)
    feasible = (yield from _take_cols(ms, choice, sh)) > guard
    choice = torch.where(feasible, choice, -1)
    accepted = yield from _admit_at(choice, rank, pods.req,
                                    nodes.allocatable - u.requested,
                                    per_node_cap, res_on, sh=sh)
    assigned = torch.where(accepted, choice.to(torch.int32), assigned)
    u = _apply_local(u, pods, choice, accepted, sh)
    return (assigned, u), _round_exit(assigned, pods, accepted), None


def _lean_static_ok(pods, nodes, sel, enabled_mask):
    static_reasons, _prog = static_predicate_reasons(pods, nodes, sel)
    if enabled_mask is not None:
        static_reasons = static_reasons & int(enabled_mask)
    return (static_reasons == 0) & nodes.valid[None, :] \
        & pods.valid[:, None]


def _lean_rounds(pods, nodes, sel, rank, lean_plan, max_rounds,
                 per_node_cap, enabled_mask):
    """The fused round loop for lean batches: same exits and admission
    rule as the general loop, one materialized (P, N) matrix per round."""
    P = pods.req.shape[0]
    static_ok = _lean_static_ok(pods, nodes, sel, enabled_mask)
    res_on = enabled_mask is None or bool(
        enabled_mask & (1 << BIT["PodFitsResources"]))
    body = functools.partial(_solo_round, _lean_round,
                             per_node_cap=per_node_cap, res_on=res_on,
                             lean_plan=lean_plan)
    state = (torch.full((P,), -1, dtype=torch.int32,
                        device=pods.req.device), usage_from_nodes(nodes))
    (assigned, u), rounds = device_loop.run(
        body, (pods, nodes, rank, static_ok), state, pods.valid, max_rounds,
        statics=("lean", per_node_cap, res_on, lean_plan),
        shape=static_ok.shape)
    return assigned, u, rounds


def _solo_round(program, ctx, state, first, tag, **kw):
    """A round body of the unsharded loop: the round's program alone."""
    return coll.solo(program(ctx, state, first, tag, **kw))


def _column_slots(pods, nodes, u, active):
    """Column capacity for the transport plan: how many ACTIVE pods could
    land on each node, bounded per resource by the smallest active
    request (the pod-count column alone almost never binds)."""
    from kubernetes_tpu_torch.snapshot import RES_PODS

    free = torch.clamp_min(nodes.allocatable - u.requested, 0.0)  # (N, R)
    min_req = torch.where(active[:, None] & (pods.req > 0), pods.req,
                          float("inf")).amin(0)  # (R,)
    per_res = torch.where(torch.isfinite(min_req),
                          torch.floor(free / torch.clamp_min(min_req, 1e-30)),
                          float("inf"))
    slots = per_res.amin(1)
    return torch.where(torch.isfinite(slots), slots, free[:, RES_PODS])


def _tie_cohort_detected(mask_full, score, slots):
    """The auto-router's round-0 test: does the batch hold a real
    tie-contention cohort — multi-way-tied best columns that are
    oversubscribed, among bidders whose runner-up gaps differ? Evaluated
    over the PRE-window mask (the whole batch's tie structure). A shard
    program: the row maximum, the tie count, the runner-up and the anys
    reduce across shards; the rest is per pod."""
    rm = yield coll.all_max(
        torch.where(mask_full, score, NEG).amax(1, keepdim=True))
    tied_f = mask_full & (score >= rm)
    tc0 = (yield coll.all_sum(tied_f.sum(1))).to(torch.float32)
    share = tied_f.to(torch.float32) / tc0.clamp_min(1.0)[:, None]
    demand = share.sum(0)  # (N,) intended tie mass
    over = demand > slots.clamp_min(1e-9)
    cohort = (tc0 >= 2.0) & (yield coll.all_or(
        (tied_f & over[None, :]).any(1)))
    alt = mask_full & ~tied_f
    r2 = yield coll.all_max(torch.where(alt, score, NEG).amax(1))
    gap = torch.where((yield coll.all_or(alt.any(1))), rm[:, 0] - r2, 1e3)
    gmin = torch.where(cohort, gap, float("inf")).amin()
    gmax = torch.where(cohort, gap, -float("inf")).amax()
    return ((cohort.sum() >= AUTO_TIE_MIN_COHORT)
            & (gmax - gmin >= AUTO_TIE_GAP_MARGIN))


def _first_per_group(ok, gate, key, rank):
    """Keep only the lowest-rank gated pod per ``key`` group; ungated pods
    pass through (``jnp.lexsort`` + ``searchsorted(side="left")`` group
    starts, as in the reference)."""
    P = ok.shape[0]
    big = 2**30
    gkey = torch.where(gate, key.long(), big)
    o = _lexsort(rank, gkey)
    gk_s = gkey[o].contiguous()
    starts = torch.searchsorted(gk_s, gk_s, side="left")
    within = torch.arange(P, device=ok.device) - starts
    keep = torch.empty_like(ok)
    keep[o] = (gk_s == big) | (within == 0)
    return ok & (keep | ~gate)


def _serialize_topology(accepted, choice, rank, sens, pods, cur, topo,
                        tpid, no_pod_affinity, sh=None):
    """The batched guard for anti-affinity / hard-spread interactions among
    same-round admissions (the serial loop never needs it; in-batch it
    replaces per-pod cache updates): one topology-sensitive pod per
    (key, pair) per round, then one self-match escapee per affinity
    program. A shard program: each pod's topology pairs come from the
    block that owns its chosen node."""
    ok = accepted
    pairs = yield from _take_rows(tpid, choice, sh)  # (P, K)
    for k in range(tpid.shape[1]):
        pair = pairs[:, k]
        gate = ok & (choice >= 0) & sens[:, k] & (pair >= 0)
        ok = _first_per_group(ok, gate, pair, rank)
    if not no_pod_affinity:
        # the second first-pod-of-a-group must wait and join the first
        esc = yield from self_escape_active_g(pods, cur, topo)
        gate_e = ok & (choice >= 0) & esc
        ok = _first_per_group(ok, gate_e, pods.affprog_id, rank)
    return ok


def _general_round(ctx, state, first, use_plan, *, weights, skip,
                   enabled_mask, no_ports, no_pod_affinity, no_spread,
                   per_node_cap, res_on, use_sinkhorn, auto_sinkhorn,
                   sk_warm, sk_tol, with_stats, fused, kernel_route,
                   route_plan=None, sh=None):
    """One general assignment round (the body :func:`_batch_impl` loops),
    as a shard program over one block of the node axis (``sh`` None: the
    whole axis). ``first`` marks round 0, where the auto-router decides
    ``use_plan`` for every later round with one counted sync. ``fused``
    scores the pair on its kernel, ``kernel_route`` runs the plan on the
    Sinkhorn kernels (both resolved by :func:`batch_assign`)."""
    (pods, nodes, sel, topo, vol, static_vol, extra_mask, extra_score, rank,
     hoisted, hoisted_prio, sens, has_port) = ctx
    assigned, u, sk_stats, sk_u, sk_v = state
    P = pods.req.shape[0]
    N = nodes.allocatable.shape[0] if sh is None else sh.n

    def port_gate(order2, seg_starts):
        # one port-bearing pod per node per round (conservative, exact)
        hp_s = has_port[order2].to(torch.int32)
        hp_prefix = _segment_prefix(hp_s[:, None], seg_starts)[:, 0]
        return (hp_s == 0) | (hp_prefix == 0)

    cur = nodes_with_usage(nodes, u)
    active = (assigned == -1) & pods.valid
    mask = (yield from run_predicates_g(
        pods, cur, sel, topo, vol, static_vol, enabled_mask,
        hoisted=hoisted, no_ports=no_ports,
        no_pod_affinity=no_pod_affinity,
        no_spread=no_spread)).mask & active[:, None]
    if extra_mask is not None:
        mask = mask & extra_mask
    score = yield from run_priorities_g(
        pods, cur, sel, mask, weights, topo, skip=skip,
        hoisted=hoisted_prio, fused=fused, sh=sh)
    if extra_score is not None:
        score = score + extra_score
    # bidder window: only the top K = N*per_node_cap active pods (by
    # queue rank) with a feasible node bid this round, so priority
    # order is structural (the serial loop is the K=1 case)
    feasible_any = yield coll.all_or(mask.any(1))
    wkey = torch.where(active & feasible_any, rank, P + 1)
    arank = _inverse_permutation(torch.argsort(wkey, stable=True))
    mask_full = mask  # pre-window, for the auto-router
    mask = mask & (active & feasible_any & (arank < N * per_node_cap))[
        :, None]
    rowmax = yield coll.all_max(
        torch.where(mask, score, NEG).amax(1, keepdim=True))
    tied = mask & (score >= rowmax)
    if use_sinkhorn or auto_sinkhorn:
        slots = _column_slots(pods, nodes, u, active)
        if auto_sinkhorn and first:
            # decide ONCE, from round 0: one counted sync (unless the
            # caller fixed the route)
            if route_plan is None:
                flag = yield from _tie_cohort_detected(mask_full, score,
                                                       slots)
                use_plan = bool((yield coll.host(flag)))
            else:
                use_plan = bool(route_plan)
        if use_sinkhorn or use_plan:
            tied, sk_stats, (sk_u, sk_v) = yield from _plan_tied(
                score, rowmax, mask, slots,
                init=(sk_u, sk_v) if sk_warm else None, tol=sk_tol,
                with_stats=with_stats, sh=sh, kernel_route=kernel_route)
    choice, _tc = yield from _rotated_pick(tied, arank, sh)
    feasible = yield from _take_cols(mask, choice, sh)
    choice = torch.where(feasible, choice, -1)
    # per-node acceptance: highest-priority prefix that fits. The cap
    # turns each round into an auction step: nodes admit their best
    # bidders, usage updates, the rest re-bid
    accepted = yield from _admit_at(choice, rank, pods.req,
                                    nodes.allocatable - u.requested,
                                    per_node_cap, res_on,
                                    sorted_gate=port_gate, sh=sh)
    if sens is not None:
        accepted = yield from _serialize_topology(
            accepted, choice, rank, sens, pods, cur, topo,
            nodes.topo_pair_id, no_pod_affinity, sh)
    assigned = torch.where(accepted, choice.to(torch.int32), assigned)
    u = _apply_local(u, pods, choice, accepted, sh)
    return ((assigned, u, sk_stats, sk_u, sk_v),
            _round_exit(assigned, pods, accepted), bool(use_plan))


def _batch_gates(topo, vol, static_vol, extra_mask, extra_score, no_ports,
                 use_sinkhorn, auto_sinkhorn, skip, weights, sk_init,
                 sk_tol):
    """The batch-wide routing of :func:`_batch_impl`, shared by the
    unsharded and the partitioned solve: ``(auto_sinkhorn, sk_warm,
    lean_plan)``."""
    # routing gate: no preference kernel live -> no possible asymmetric
    # tie cohort -> the router and the plan branch stay out
    auto_sinkhorn = (auto_sinkhorn and not use_sinkhorn
                     and not all(k in skip for k in _PREFERENCE_KERNELS))
    # warm-started Sinkhorn: the potentials carry across rounds (and, via
    # sk_init, across cycles) only when a warm start or a tolerance is
    # asked for; otherwise every round's plan solves from zeros
    sk_warm = (sk_init is not None) or (sk_tol is not None)
    # ---- lean round (constraint-light batches) --------------------------
    # no topology/volume/port coupling, no extender/plugin mask or score, argmax
    # tie-break and a provably exact lean scoring plan: one materialized
    # (P, N) matrix per round; placements identical to the general round
    lean_plan = None
    if (topo is None and vol is None and static_vol is None
            and extra_mask is None and extra_score is None and no_ports
            and not use_sinkhorn and not auto_sinkhorn):
        lean_plan = _lean_score_plan(weights, skip)
    return auto_sinkhorn, sk_warm, lean_plan


def _general_prologue(pods, nodes, sel, topo, vol, static_vol, weights,
                      skip, no_pod_affinity, no_spread, sh=None):
    """The once-per-batch slice of the general round, as a shard
    program: ``(static_vol, hoisted, hoisted_prio, sens, has_port)``."""
    # pods carrying host ports or attach-counted/conflict-checked volumes
    # are admitted at most one per node per round (conservative, exact)
    has_port = (pods.port_wild_pp.sum(1) + pods.port_spec_pp.sum(1)) > 0
    if vol is not None:
        has_port = has_port | ((pods.vol_any_mh.sum(1) + pods.pd_mh.sum(1)
                                + pods.csi_mh.sum(1)) > 0)
    # usage-invariant predicate bits + selector programs, and the
    # usage-invariant scoring slice, once per batch
    hoisted = static_predicate_reasons(pods, nodes, sel)
    if vol is not None and static_vol is None:
        static_vol = static_volume_reasons(pods, nodes, sel, vol,
                                           prog=hoisted[1])
    hoisted_prio = yield from hoist_priorities_g(pods, nodes, sel, weights,
                                                 skip, sh)
    # (P, K) topology keys along which same-round co-admission into one
    # topology group could violate required anti-affinity / hard spread;
    # skipped when BOTH batch gates hold (a universe matcher left by a
    # long-gone affinity pod would otherwise serialize clean pods)
    sens = None
    if topo is not None and not (no_pod_affinity and no_spread):
        sens = sensitive_keys(pods, topo, nodes.topo_pair_id.shape[1])
    return static_vol, hoisted, hoisted_prio, sens, has_port


def _batch_impl(pods, nodes, sel, topo, weights, max_rounds, per_node_cap,
                extra_mask=None, vol=None, static_vol=None,
                enabled_mask=None, extra_score=None, use_sinkhorn=False,
                skip=(), no_ports=False, no_pod_affinity=False,
                no_spread=False, auto_sinkhorn=True, with_stats=False,
                sk_init=None, sk_tol=None, route_plan=None, *, fused,
                kernel_route):
    """The round loop. Returns ``(assigned, usage, rounds, sk_stats,
    (sk_u, sk_v))``: ``rounds`` an int32 0-d tensor, the last round's
    Sinkhorn stats ([-1, -1] when the plan never ran or ``with_stats`` is
    off) and the potential carry. On a CUDA tensor nothing is read back
    except the auto-router's round-0 decision (:mod:`.device_loop`)."""
    auto_sinkhorn, sk_warm, lean_plan = _batch_gates(
        topo, vol, static_vol, extra_mask, extra_score, no_ports,
        use_sinkhorn, auto_sinkhorn, skip, weights, sk_init, sk_tol)
    P = pods.req.shape[0]
    N = nodes.allocatable.shape[0]
    dev = pods.req.device
    sk_stats = torch.full((2,), -1.0, dtype=torch.float32, device=dev)
    if sk_init is not None:
        sk_u, sk_v = (sk_init[0].to(torch.float32),
                      sk_init[1].to(torch.float32))
    else:
        sk_u = torch.zeros((P,), dtype=torch.float32, device=dev)
        sk_v = torch.zeros((N,), dtype=torch.float32, device=dev)
    perm = queue_order(pods)
    rank = _inverse_permutation(perm)
    if lean_plan is not None:
        # the lean route never runs the plan: [-1, -1] stats and zero
        # potentials keep the return uniform
        return _lean_rounds(pods, nodes, sel, rank, lean_plan, max_rounds,
                            per_node_cap, enabled_mask) + (
            sk_stats, (sk_u.new_zeros((P,)), sk_v.new_zeros((N,))))
    static_vol, hoisted, hoisted_prio, sens, has_port = coll.solo(
        _general_prologue(pods, nodes, sel, topo, vol, static_vol, weights,
                          skip, no_pod_affinity, no_spread))
    res_on = enabled_mask is None or bool(
        enabled_mask & (1 << BIT["PodFitsResources"]))
    flags = dict(weights=weights, skip=tuple(skip), enabled_mask=enabled_mask,
                 no_ports=no_ports, no_pod_affinity=no_pod_affinity,
                 no_spread=no_spread, per_node_cap=per_node_cap,
                 res_on=res_on, use_sinkhorn=use_sinkhorn,
                 auto_sinkhorn=auto_sinkhorn, sk_warm=sk_warm, sk_tol=sk_tol,
                 with_stats=with_stats, fused=fused,
                 kernel_route=kernel_route, route_plan=route_plan)
    ctx = (pods, nodes, sel, topo, vol, static_vol, extra_mask, extra_score,
           rank, hoisted, hoisted_prio, sens, has_port)
    state = (torch.full((P,), -1, dtype=torch.int32, device=dev),
             usage_from_nodes(nodes), sk_stats, sk_u, sk_v)
    (assigned, u, sk_stats, sk_u, sk_v), rounds = device_loop.run(
        functools.partial(_solo_round, _general_round, **flags), ctx, state,
        pods.valid, max_rounds, _general_statics(flags), shape=(P, N))
    return assigned, u, rounds, sk_stats, (sk_u, sk_v)


def _general_statics(flags):
    """What a captured general round bakes in besides its inputs' shapes,
    the resolved kernel route included (a flip of ``KTPU_PALLAS``
    captures a new graph, never replays one with the other route baked
    in). The tolerance-gated Sinkhorn reads its residual on the host
    every iteration, so its rounds cannot be captured: they keep the
    Python loop (None)."""
    if flags["sk_tol"] is not None:
        return None
    return ("general", _weights_key(flags["weights"]),
            *[(k, v) for k, v in flags.items()
              if k not in ("weights", "route_plan")])


def _batch_impl_sharded(pods, nodes, sel, topo, weights, max_rounds,
                        per_node_cap, extra_mask=None, vol=None,
                        static_vol=None, enabled_mask=None, extra_score=None,
                        use_sinkhorn=False, skip=(), no_ports=False,
                        no_pod_affinity=False, no_spread=False,
                        auto_sinkhorn=True, with_stats=False, sk_init=None,
                        sk_tol=None, route_plan=None, *, fused,
                        kernel_route):
    """The partitioned round loop over a :class:`~kubernetes_tpu_torch.
    parallel.mesh.ShardedNodes` of ``d`` blocks: one program per shard
    (the same round functions as :func:`_batch_impl`, each over its
    block, the cross-shard reductions in ``parallel/collectives.py``),
    driven in lockstep. Pods, selectors, topology and volume tables are
    replicated per device; (P, N) inputs split into column blocks.
    Returns :func:`_batch_impl`'s tuple with the placements as global
    node rows on ``mesh.devices[0]``, the usage as a ``UsageState`` of
    ``parallel.mesh.Blocks`` and v as the ``Blocks`` of the shards' own
    rows.

    On a logical mesh (the blocks share one card) the whole partitioned
    round is one device's work: round 0 runs eagerly and the later rounds
    are captured into one graph and looped by the WHILE node, as the
    unsharded loop is (the graph key carries the shard count through the
    block shapes and ``statics``). On distinct cards one graph cannot
    span devices: the rounds take the Python loop, whose exit test is
    one counted read per round, so a solve makes ``rounds + 1`` counted
    syncs (the batch's any-valid test and each round's exit) plus the
    auto-router's one and, with ``sk_tol``, one per Sinkhorn iteration;
    the result's readback is the caller's."""
    from kubernetes_tpu_torch.parallel.mesh import (
        Blocks,
        column_blocks,
        join,
        part,
        replicas,
    )

    mesh = nodes.mesh
    d = mesh.size
    devs = mesh.devices
    blocks = nodes.blocks
    pods_k, sel_k = replicas(pods, mesh), replicas(sel, mesh)
    topo_k, vol_k = replicas(topo, mesh), replicas(vol, mesh)
    pods0 = pods_k[0]
    auto_sinkhorn, sk_warm, lean_plan = _batch_gates(
        topo, vol, static_vol, extra_mask, extra_score, no_ports,
        use_sinkhorn, auto_sinkhorn, skip, weights, sk_init, sk_tol)
    shs = [coll.Shard(i, d, nodes.rows) for i in range(d)]
    P = pods0.req.shape[0]
    N = nodes.n
    ranks = [_inverse_permutation(queue_order(p)) for p in pods_k]
    usage0 = [usage_from_nodes(b) for b in blocks]
    assigned0 = [torch.full((P,), -1, dtype=torch.int32, device=dv)
                 for dv in devs]
    if lean_plan is not None:
        res_on = enabled_mask is None or bool(
            enabled_mask & (1 << BIT["PodFitsResources"]))
        ctx = tuple((pods_k[i], blocks[i], ranks[i], _lean_static_ok(
            pods_k[i], blocks[i], sel_k[i], enabled_mask)) for i in range(d))
        state = tuple(zip(assigned0, usage0))
        kw = dict(per_node_cap=per_node_cap, res_on=res_on,
                  lean_plan=lean_plan)
        statics = ("lean", per_node_cap, res_on, lean_plan)
        program = _lean_round
    else:
        static_vols = column_blocks(static_vol, mesh)
        pro = coll.lockstep([_general_prologue(
            pods_k[i], blocks[i], sel_k[i], topo_k[i], vol_k[i],
            part(static_vols, i), weights, skip, no_pod_affinity, no_spread,
            shs[i]) for i in range(d)], devs)
        res_on = enabled_mask is None or bool(
            enabled_mask & (1 << BIT["PodFitsResources"]))
        kw = dict(weights=weights, skip=tuple(skip),
                  enabled_mask=enabled_mask, no_ports=no_ports,
                  no_pod_affinity=no_pod_affinity, no_spread=no_spread,
                  per_node_cap=per_node_cap, res_on=res_on,
                  use_sinkhorn=use_sinkhorn, auto_sinkhorn=auto_sinkhorn,
                  sk_warm=sk_warm, sk_tol=sk_tol, with_stats=with_stats,
                  fused=fused, kernel_route=kernel_route,
                  route_plan=route_plan)
        statics = _general_statics(kw)
        program = _general_round
        ems, ess = column_blocks(extra_mask, mesh), \
            column_blocks(extra_score, mesh)
        ctx = tuple(
            (pods_k[i], blocks[i], sel_k[i], topo_k[i], vol_k[i], pro[i][0],
             part(ems, i), part(ess, i), ranks[i], pro[i][1], pro[i][2], pro[i][3],
             pro[i][4]) for i in range(d))
        if sk_init is not None:
            # graftlint: disable=R8 -- placement of the warm start: u
            # replicated onto every shard, v split into its row blocks
            us = [sk_init[0].to(dv, torch.float32) for dv in devs]
            # graftlint: disable=R8 -- placement of the warm start (v):
            # its row blocks, each onto its shard's device
            vs = [b.to(dv, torch.float32) for b, dv in zip(
                sk_init[1].parts if isinstance(sk_init[1], Blocks)
                else sk_init[1].chunk(d, 0), devs)]
        else:
            us = [torch.zeros((P,), dtype=torch.float32, device=dv)
                  for dv in devs]
            vs = [torch.zeros((nodes.rows,), dtype=torch.float32, device=dv)
                  for dv in devs]
        state = tuple(
            (assigned0[i], usage0[i],
             torch.full((2,), -1.0, dtype=torch.float32, device=devs[i]),
             us[i], vs[i]) for i in range(d))

    def body(ctx, state, first, tag):
        with coll.round_body():
            outs = coll.lockstep([program(ctx[i], state[i], first, tag,
                                          sh=shs[i], **kw)
                                  for i in range(d)], devs)
        return tuple(o[0] for o in outs), outs[0][1], outs[0][2]

    if statics is not None:
        statics = ("sharded", d) + tuple(statics) if mesh.logical else None
    states, rounds = device_loop.run(body, ctx, state, pods0.valid,
                                     max_rounds, statics, shape=(P, N))
    usage = join([st[1] for st in states], mesh)
    if lean_plan is not None:
        return (states[0][0], usage, rounds,
                torch.full((2,), -1.0, dtype=torch.float32, device=devs[0]),
                (torch.zeros((P,), dtype=torch.float32, device=devs[0]),
                 Blocks(mesh, tuple(
                     torch.zeros((nodes.rows,), dtype=torch.float32,
                                 device=dv) for dv in devs))))
    sk_v = Blocks(mesh, tuple(st[4] for st in states))
    return states[0][0], usage, rounds, states[0][2], (states[0][3], sk_v)


def _weights_key(weights) -> tuple:
    """What a captured round bakes in of the priority configuration: the
    weights in accumulation order and the kernel bound to each name."""
    from kubernetes_tpu_torch.ops.priorities import (
        DEFAULT_WEIGHTS,
        PRIORITY_REGISTRY,
    )

    weights = DEFAULT_WEIGHTS if weights is None else weights
    return tuple((k, float(w), id(PRIORITY_REGISTRY.get(k)))
                 for k, w in weights.items())


def _plan_tied(score, rowmax, mask, slots, init=None, tol=None,
               with_stats=False, sh=None, *, kernel_route):
    """Choose from the entropic-OT transport plan instead of the raw
    per-pod argmax: the plan balances the batch against node capacities,
    so contended pods pre-spread instead of colliding. Identical pods get
    identical plan rows, so the plan argmax keeps the rotation tie-break.
    ``init``/``tol`` warm-start the scaling and gate it on a tolerance.
    Returns ``(tied mask, stats, (u, v))``; stats are [-1, -1] unless
    ``with_stats``. A shard program: the plan's row pass and its row
    maximum reduce across shards. ``kernel_route`` is the plan's route
    (``sinkhorn_plan``'s ``pallas``)."""
    from kubernetes_tpu_torch.ops.sinkhorn import sinkhorn_plan_g

    masked = torch.where(mask, score - rowmax, NEG)
    out = yield from sinkhorn_plan_g(masked, mask, slots,
                                     with_stats=with_stats, init=init,
                                     tol=tol, return_potentials=True, sh=sh,
                                     pallas=kernel_route)
    if with_stats:
        plan, stats, pot = out
    else:
        (plan, pot), stats = out, torch.full(
            (2,), -1.0, dtype=torch.float32, device=score.device)
    pmasked = torch.where(mask, plan, -1.0)
    prowmax = yield coll.all_max(pmasked.amax(1, keepdim=True))
    return mask & (pmasked >= prowmax), stats, pot


def batch_assign(
    pods: DevicePods,
    nodes: DeviceNodes,
    sel: DeviceSelectors,
    weights: Optional[Dict[str, float]] = None,
    max_rounds: int = 256,
    per_node_cap: int = 1,
    topo=None,
    extra_mask: Optional[torch.Tensor] = None,
    vol=None,
    static_vol: Optional[torch.Tensor] = None,
    enabled_mask: Optional[int] = None,
    extra_score: Optional[torch.Tensor] = None,
    use_sinkhorn: bool = False,
    skip_priorities=(),
    no_ports: bool = False,
    no_pod_affinity: bool = False,
    no_spread: bool = False,
    auto_sinkhorn: bool = True,
    stats_out: bool = False,
    sk_init=None,
    sk_tol: Optional[float] = None,
    potentials_out: bool = False,
    fault_hook=None,
    fault_site: str = "solve:batch",
    route_plan: Optional[bool] = None,
    fused_score: bool = True,
):
    """Fast batched solver. Returns (assigned row per pod or -1, final
    usage, rounds executed) — ``rounds`` an int32 0-d tensor on the
    batch's device, read when the caller reads the result. ``per_node_cap``
    bounds admissions per node per round; expect about ceil(P / (N *
    cap)) rounds on uniform workloads. ``extra_mask`` as in
    :func:`greedy_assign` (None routes constraint-light batches to the
    lean round).

    ``fused_score`` (default on) lets the general round score the
    NodeAffinity + TaintToleration pair with the fused kernel (the CUDA
    kernel on the card) when the regrouped accumulation is provably exact
    — bit-identical to the two separate normalizes. It is resolved here,
    at call time, against the kernel-route policy (``KTPU_PALLAS``,
    :func:`~kubernetes_tpu_torch.ops.fused_score.use_kernels` of the
    tables' device), as the reference resolves it against ``use_pallas``;
    the same policy picks the transport plan's route, and both join the
    round-loop graph's key. On the plain route the pair takes the two
    separate normalizes and the plan the plain passes in the jnp rule; it
    is for CPU tensors only: asked for on CUDA tensors (``KTPU_PALLAS=0``
    or ``fused_score=False``), it raises
    :class:`~kubernetes_tpu_torch.ops.fused_score.PlainRouteRefused`.
    ``use_sinkhorn`` picks from the transport plan
    every round; ``auto_sinkhorn`` lets round 0 decide. ``topo`` (a
    :class:`~kubernetes_tpu_torch.ops.arrays.DeviceTopology`) adds inter-pod
    affinity and topology spread, with their admissions serialized per
    topology pair per round.

    ``stats_out`` appends a (2,) f32 device tensor [Sinkhorn iterations,
    final residual] of the last round that ran the plan ([-1, -1] when
    none did). Warm-started Sinkhorn (the incremental solve): ``sk_init``
    seeds the plan's potentials with a ``(u0, v0)`` pair, ``sk_tol``
    switches the scaling to the tolerance-gated loop, and either one
    carries the potentials from round to round; ``potentials_out``
    appends the final ``(u, v)`` pair (zeros on the lean route, which
    never runs the plan). Unset, the cold start of every round stays as
    it was.

    ``fault_hook``/``fault_site``: the fault-injection seam, as in
    :func:`greedy_assign`; the hook stands where an out-of-process
    solver's response would be decoded. ``route_plan`` replaces the
    auto-router's round-0 decision (no read): the warmup uses it to
    capture the round-loop graph of each route the router can take.

    ``nodes`` a :class:`~kubernetes_tpu_torch.parallel.mesh.ShardedNodes`
    (with pods and selectors replicated or not) runs the partitioned
    solve (:func:`_batch_impl_sharded`): the same placements and rounds,
    the usage and v left in the shards' blocks (``parallel.mesh.Blocks``,
    the usage field by field; ``sk_init`` takes v so too, or whole)."""
    from kubernetes_tpu_torch.parallel.mesh import ShardedNodes, unreplicated

    impl = _batch_impl
    if isinstance(nodes, ShardedNodes):
        impl = _batch_impl_sharded
        n_nodes = nodes.n
    else:
        pods, sel = unreplicated(pods), unreplicated(sel)
        topo, vol = unreplicated(topo), unreplicated(vol)
        n_nodes = nodes.allocatable.shape[0]
    # the route, resolved HERE so that it joins the graph key (the
    # reference resolves fused_score against use_pallas for its jit key);
    # fused_score=False asks for the pair's plain version, which only a
    # CPU tensor may take
    dev = unreplicated(pods).valid.device
    kernel_route = use_kernels(dev)
    fused = kernel_route if fused_score else use_kernels(dev, False)
    assigned, u, rounds, sk_stats, pot = impl(
        pods, nodes, sel, topo, weights, max_rounds, per_node_cap,
        extra_mask=extra_mask, vol=vol, static_vol=static_vol,
        enabled_mask=enabled_mask, extra_score=extra_score,
        use_sinkhorn=use_sinkhorn, skip=tuple(skip_priorities),
        no_ports=no_ports, no_pod_affinity=no_pod_affinity,
        no_spread=no_spread, auto_sinkhorn=auto_sinkhorn,
        with_stats=stats_out, sk_init=sk_init, sk_tol=sk_tol,
        route_plan=route_plan, fused=fused, kernel_route=kernel_route)
    if fault_hook is not None:
        assigned, u, rounds = fault_hook(fault_site, assigned, u, rounds,
                                         n_nodes)
    ret = (assigned, u, rounds)
    if stats_out:
        ret = ret + (sk_stats,)
    if potentials_out:
        ret = ret + (pot,)
    return ret


def solve_cost_analysis(pods: DevicePods, nodes: DeviceNodes,
                        sel: DeviceSelectors,
                        weights: Optional[Dict[str, float]] = None,
                        **solve_kwargs) -> Optional[dict]:
    """The work of one round of the dense batch solve at this signature
    (the perf ledger's model-side capture, obs/ledger.py): the bytes and
    operations the round's hand kernels move at the padded (P, N),
    counted from the shapes (:func:`~kubernetes_tpu_torch.obs.ledger.
    round_work`). Takes :func:`batch_assign`'s arguments and returns the
    reference's keys, ``{"flops", "bytes_accessed"}``, where the
    reference reads XLA's ``cost_analysis()`` of the compiled program.
    Host arithmetic only: no device work."""
    from kubernetes_tpu_torch.obs.ledger import round_work
    from kubernetes_tpu_torch.parallel.mesh import unreplicated

    return round_work(int(unreplicated(pods).valid.shape[0]), int(nodes.n),
                      use_sinkhorn=bool(solve_kwargs.get("use_sinkhorn")))


def solve_memory_analysis(pods: DevicePods, nodes: DeviceNodes,
                          sel: DeviceSelectors,
                          weights: Optional[Dict[str, float]] = None,
                          **solve_kwargs) -> Optional[dict]:
    """The device-memory footprint of the dense batch solve at this
    signature (the memory ledger's preflight capture, obs/memledger.py):
    runs :func:`batch_assign` with these arguments once and measures the
    allocator's peak over the run's start (the first solve at a warmed
    bucket captures its round-loop graph, so the graph's private pool is
    in it), plus the argument and output bytes. Returns the reference's
    keys (``argument_bytes``, ``output_bytes``, ``temp_bytes``,
    ``total_bytes``, ...), or None on CPU tensors, where no allocator
    counts. The run resolves the kernel route as the cycle's solve does
    (:func:`batch_assign`, ``KTPU_PALLAS``), so the preflight measures the
    program the cycle runs. A fault of the solve (a ``KernelError``
    included) propagates."""
    from kubernetes_tpu_torch.obs.jaxtel import tree_nbytes
    from kubernetes_tpu_torch.obs.memledger import capture_memory_analysis
    from kubernetes_tpu_torch.parallel.mesh import (
        ShardedNodes,
        unreplicated,
    )

    # a partitioned solve is measured on its first device, whose
    # allocator holds block 0
    blocks = nodes.blocks[0] if isinstance(nodes, ShardedNodes) else nodes
    args = tree_nbytes(unreplicated(pods), blocks, unreplicated(sel), *(
        solve_kwargs.get(k) for k in ("topo", "vol", "static_vol",
                                      "extra_mask", "extra_score")
        if solve_kwargs.get(k) is not None))
    return capture_memory_analysis(
        lambda: batch_assign(pods, nodes, sel, weights, **solve_kwargs),
        unreplicated(pods).valid.device, args)


# graftlint: disable-scope=R2,R7,R8 -- the deliberate host boundary: trust-
# but-verify reads the solver's claimed result back ONCE per cycle to check
# it before any pod binds; cheap O(P*R + N*R) numpy by design (see
# docstring). On a mesh the result is already on the first device
def validate_solution(assigned, usage: UsageState, pods: DevicePods,
                      nodes: DeviceNodes,
                      enabled_mask: Optional[int] = None) -> Tuple[bool, str]:
    """Host trust-but-verify for a solver result before any pod is
    assumed. Returns (ok, reason) with ``reason`` one of shape | dtype |
    range | invalid-node | finiteness | capacity. O(P·R + N·R) numpy:
    index-range sanity, claimed-usage finiteness, and a full per-node
    capacity recomputation from the assignment itself (never trusting the
    solver's usage). Capacity is enforced only when PodFitsResources is,
    and only blames nodes that were within allocatable before the batch."""

    from kubernetes_tpu_torch.parallel.mesh import (
        Blocks,
        ShardedNodes,
        join,
        unreplicated,
    )

    def host(t):
        if isinstance(t, Blocks):
            # a per-shard value: its parts read and joined on the host
            return np.concatenate([host(p) for p in t.parts], t.axis)
        return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
            else np.asarray(t)

    if isinstance(nodes, ShardedNodes):
        nodes = join(nodes.blocks, nodes.mesh)
    pods = unreplicated(pods)
    P = pods.req.shape[0]
    try:
        a = host(assigned)
    except (TypeError, ValueError, RuntimeError):
        return False, "dtype"
    if a.ndim != 1 or a.shape[0] < P:
        return False, "shape"
    a = a[:P]
    if not np.issubdtype(a.dtype, np.integer):
        if not np.all(np.isfinite(a)):
            return False, "finiteness"
        if np.any(a != np.floor(a)):
            return False, "dtype"
        a = a.astype(np.int64)
    valid = host(pods.valid)
    nvalid = host(nodes.valid)
    N = nvalid.shape[0]
    if np.any(valid & ((a < -1) | (a >= N))):
        return False, "range"
    sel = valid & (a >= 0)
    if np.any(sel & ~nvalid[np.clip(a, 0, N - 1)]):
        return False, "invalid-node"
    if not bool(np.all(np.isfinite(host(usage.requested)))):
        return False, "finiteness"
    res_on = enabled_mask is None or bool(
        enabled_mask & (1 << BIT["PodFitsResources"]))
    if res_on and np.any(sel):
        req = host(pods.req)
        base = host(nodes.requested)
        alloc = host(nodes.allocatable)
        add = np.zeros_like(base)
        np.add.at(add, a[sel], req[sel])
        # relative tolerance: f32 scatter-add drift scales with magnitude
        tol = 1e-5 * np.maximum(alloc, 1.0) + 1e-6
        pre_ok = base <= alloc + tol
        over = (base + add > alloc + tol) & nvalid[:, None] & (add > 0)
        if np.any(over & pre_ok):
            return False, "capacity"
    return True, ""


#: device_validate verdict codes, in the host checker's precedence order
#: (index 0 = ok). Host-side decode: ``VALIDATE_REASONS[int(code)]``.
VALIDATE_REASONS = ("", "shape", "dtype", "range", "invalid-node",
                    "finiteness", "capacity")


def device_validate(assigned, usage: UsageState, pods: DevicePods,
                    nodes: DeviceNodes, enabled_mask: Optional[int] = None):
    """On-device twin of :func:`validate_solution`: every check as one
    reduction over the assignment, returned as two int32 device scalars
    ``(code, valid_count)`` that ride the scheduler's single end-of-solve
    readback; decode with :data:`VALIDATE_REASONS`. A result that is not
    a 1-D tensor covering the batch never reaches the device (returns
    None; the host checker renders the verdict). Capacity is recomputed
    from the assignment, never from the claimed usage.

    ``nodes`` a ``parallel.mesh.ShardedNodes`` (``usage`` a
    ``UsageState`` of ``parallel.mesh.Blocks``) checks per shard: the
    assignment is broadcast, each shard checks the pods assigned into
    its own block (node validity, capacity) and its own usage
    (finiteness), the per-check flags merge with ``all_max``, and the
    code is taken from the merged flags in :data:`VALIDATE_REASONS`
    order, so several failing checks give the unsharded code, not a
    shard's own first. The verdict lands on the mesh's first device."""
    from kubernetes_tpu_torch.parallel.mesh import per_shard, unreplicated

    if isinstance(assigned, np.ndarray):
        assigned = torch.tensor(assigned)
    P = unreplicated(pods).req.shape[0]
    if (not isinstance(assigned, torch.Tensor) or assigned.ndim != 1
            or assigned.shape[0] < P):
        return None
    return per_shard(_validate_g, assigned, usage, pods, nodes,
                     enabled_mask, shard=True)


def _validate_g(assigned, usage, pods, nodes, enabled_mask, sh=None):
    """:func:`device_validate` as a shard program over one block of the
    node axis (``sh`` None: the whole table)."""
    P = pods.req.shape[0]
    valid = pods.valid
    nvalid = nodes.valid
    rows = nvalid.shape[0]
    lo, N = (0, rows) if sh is None else (sh.lo, sh.n)
    a = assigned[:P].to(pods.req.device)
    false = torch.zeros((), dtype=torch.bool, device=a.device)
    if a.is_floating_point():
        # a lying solver returning floats: finiteness first, then
        # integer-valuedness, then proceed on the floored values
        fin = torch.isfinite(a)
        fin_a_bad = ~fin.all()
        dtype_bad = (fin & (a != torch.floor(a))).any()
        a = torch.where(fin, a, -2.0).to(torch.int32)
    else:
        fin_a_bad = false
        dtype_bad = false
        a = a.to(torch.int32)
    range_bad = (valid & ((a < -1) | (a >= N))).any()
    sel = valid & (a >= 0)
    # the pods this block owns (a row past the table is range_bad, which
    # outranks every check below)
    mine = sel & (a >= lo) & (a < lo + rows)
    ac = (a - lo).clamp(0, rows - 1).long()
    invalid_node = (mine & ~nvalid[ac]).any()
    fin_bad = ~torch.isfinite(usage.requested).all()
    res_on = enabled_mask is None or bool(
        enabled_mask & (1 << BIT["PodFitsResources"]))
    if res_on:
        base = nodes.requested
        alloc = nodes.allocatable
        add = torch.zeros_like(base).index_add_(
            0, torch.where(mine, ac, 0),
            pods.req * mine.to(base.dtype)[:, None])
        tol = 1e-5 * torch.clamp_min(alloc, 1.0) + 1e-6
        pre_ok = base <= alloc + tol
        over = (base + add > alloc + tol) & nvalid[:, None] & (add > 0)
        cap_bad = (over & pre_ok).any()
    else:
        cap_bad = false
    # the block-local checks merge before the code is taken
    flags = yield coll.all_max(torch.stack(
        [invalid_node, fin_bad, cap_bad]).to(torch.int32))
    invalid_node, fin_bad, cap_bad = (flags > 0).unbind()
    code = torch.where(fin_a_bad, 5, torch.where(
        dtype_bad, 2, torch.where(
            range_bad, 3, torch.where(
                invalid_node, 4, torch.where(
                    fin_bad, 5, torch.where(cap_bad, 6, 0))))))
    return code.to(torch.int32), sel.sum(dtype=torch.int32)
