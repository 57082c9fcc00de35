"""Vectorized Score priorities — the reference's Map/Reduce priority
library (``pkg/scheduler/algorithm/priorities/``) as (pods x nodes) f32
kernels (the port of ``kubernetes_tpu/ops/priorities.py``).

Each priority emits the whole (P, N) matrix at once; reduces (normalizes)
are per-row ops; the weighted sum is one accumulate. Go's integer
arithmetic (scores are int64 0..10 with repeated integer division) is
emulated with ``floor(x + eps)`` in f32 — see ``_idiv``.

The kernels that reduce over the node axis (the NormalizeReduce maxima,
ImageLocality's node counts, SelectorSpread's node and zone maxima and
the topology scores) are also written as shard programs (``*_g``, see
``parallel/collectives.py``) that yield their per-shard partials for a
reduction across the mesh; :func:`run_priorities_g` is the whole Score
pass as one shard's program. The plain kernels run one program alone.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from kubernetes_tpu_torch.api.types import MAX_PRIORITY
from kubernetes_tpu_torch.ops.arrays import (
    DeviceNodes,
    DevicePods,
    DeviceSelectors,
)
from kubernetes_tpu_torch.ops.predicates import (
    preferred_program_score,
    selector_program_match,
)
from kubernetes_tpu_torch.ops.topology import (
    even_pods_spread_score_g,
    inter_pod_affinity_score_g,
)
from kubernetes_tpu_torch.parallel import collectives as coll

_EPS = 1e-5


def _idiv(num, den):
    """Go-style integer division num/den in f32: floor with a small epsilon
    to absorb f32 rounding below exact integer ratios."""
    if isinstance(den, torch.Tensor):
        den = torch.clamp_min(den, 1e-30)
    else:
        den = max(den, 1e-30)
    return torch.floor(num / den + _EPS)


def _normalize_reduce(raw, mask, reverse: bool):
    """priorities/reduce.go NormalizeReduce: per pod, scale scores so the
    max becomes MaxPriority; if max==0 -> all MaxPriority when reversed,
    else 0. The max is taken over the pod's feasible nodes only
    (PrioritizeNodes receives filteredNodes, generic_scheduler.go:684)."""
    return coll.solo(_normalize_reduce_g(raw, mask, reverse))


def _normalize_reduce_g(raw, mask, reverse: bool):
    """:func:`_normalize_reduce` as a shard program: the row max is an
    all-reduce MAX across shards."""
    mx = yield coll.all_max(
        torch.where(mask, raw, 0.0).amax(1, keepdim=True))  # (P, 1)
    scaled = _idiv(MAX_PRIORITY * raw, torch.where(mx > 0, mx, 1.0))
    scaled = torch.where(mx > 0, scaled, 0.0)
    if reverse:
        scaled = torch.where(mx > 0, MAX_PRIORITY - scaled,
                             float(MAX_PRIORITY))
    return scaled


def _requested_fractions(pods: DevicePods, nodes: DeviceNodes):
    """(cpu, mem) total nonzero requests after placing each pod on each
    node, and the capacities — the ResourceAllocationPriority scaffold
    (resource_allocation.go:39)."""
    cpu_req = pods.nonzero_req[:, 0:1] + nodes.nonzero_req[None, :, 0]
    mem_req = pods.nonzero_req[:, 1:2] + nodes.nonzero_req[None, :, 1]
    cpu_cap = nodes.allocatable[None, :, 0]
    mem_cap = nodes.allocatable[None, :, 1]
    return cpu_req, mem_req, cpu_cap, mem_cap


def _capped(req, cap, s):
    return torch.where((cap <= 0) | (req > cap), 0.0, s)


def least_requested(pods, nodes, sel, topo, mask):
    """least_requested.go: ((cap-req)*10/cap + (cap-req)*10/cap)/2, integer
    divisions preserved; req>cap or cap==0 scores 0."""
    cpu_req, mem_req, cpu_cap, mem_cap = _requested_fractions(pods, nodes)

    def score(req, cap):
        return _capped(req, cap, _idiv((cap - req) * MAX_PRIORITY, cap))

    return _idiv(score(cpu_req, cpu_cap) + score(mem_req, mem_cap), 2.0)


def most_requested(pods, nodes, sel, topo, mask):
    """most_requested.go: (req*10/cap) averaged — the bin-packing dual."""
    cpu_req, mem_req, cpu_cap, mem_cap = _requested_fractions(pods, nodes)

    def score(req, cap):
        return _capped(req, cap, _idiv(req * MAX_PRIORITY, cap))

    return _idiv(score(cpu_req, cpu_cap) + score(mem_req, mem_cap), 2.0)


def _balanced(cpu_req, mem_req, cpu_cap, mem_cap):
    cf = torch.where(cpu_cap > 0, cpu_req / torch.clamp_min(cpu_cap, 1e-30),
                     1.0)
    mf = torch.where(mem_cap > 0, mem_req / torch.clamp_min(mem_cap, 1e-30),
                     1.0)
    score = torch.floor((1.0 - (cf - mf).abs()) * MAX_PRIORITY + _EPS)
    return torch.where((cf >= 1.0) | (mf >= 1.0), 0.0, score)


def balanced_allocation(pods, nodes, sel, topo, mask):
    """balanced_resource_allocation.go (two-resource form): score =
    int((1 - |cpuFrac - memFrac|) * 10); any fraction >= 1 scores 0."""
    return _balanced(*_requested_fractions(pods, nodes))


def _node_affinity_raw(pods, nodes, sel):
    """Usage-invariant raw weight sums (the map phase) — hoistable out of
    the round loop; only the mask-dependent NormalizeReduce is per-round."""
    prog = preferred_program_score(sel, nodes)  # (Gp, N)
    idx = pods.prefprog_id.clamp(0, prog.shape[0] - 1).long()
    return torch.where((pods.prefprog_id >= 0)[:, None], prog[idx], 0.0)


def node_affinity(pods, nodes, sel, topo, mask):
    """node_affinity.go: weight-sum of matched PreferredDuringScheduling
    terms, NormalizeReduce(10, false)."""
    return _normalize_reduce(_node_affinity_raw(pods, nodes, sel), mask,
                             reverse=False)


def _taint_toleration_raw(pods, nodes, sel):
    """Usage-invariant intolerable-taint counts (taints never change
    within a batch) — the matmul half of the kernel, hoistable."""
    idx = pods.tolset_id.clamp(0, sel.tol_soft_mh.shape[0] - 1).long()
    tol_rows = torch.where((pods.tolset_id >= 0)[:, None],
                           sel.tol_soft_mh[idx], 0.0)
    soft_count = nodes.taint_soft_mh.sum(1)  # (N,)
    tolerated = tol_rows @ nodes.taint_soft_mh.T  # (P, N)
    return soft_count[None, :] - tolerated


def taint_toleration(pods, nodes, sel, topo, mask):
    """taint_toleration.go: count PreferNoSchedule taints not tolerated,
    NormalizeReduce(10, reverse=true)."""
    return _normalize_reduce(_taint_toleration_raw(pods, nodes, sel), mask,
                             reverse=True)


def image_locality(pods, nodes, sel, topo, mask):
    """image_locality.go: sum of (size * nodes-with-image/total-nodes) over
    the pod's images present on the node, clamped to [23MB, 1000MB] and
    scaled to 0..10."""
    return coll.solo(image_locality_g(pods, nodes, sel, topo, mask))


def image_locality_g(pods, nodes, sel, topo, mask):
    """:func:`image_locality` as a shard program: the node counts are
    all-reduce SUMs (exact integers)."""
    mb = 1024.0 * 1024.0
    lo, hi = 23.0 * mb, 1000.0 * mb
    total = torch.clamp_min(
        (yield coll.all_sum(nodes.valid.to(torch.float32).sum())), 1.0)
    num_nodes = yield coll.all_sum(torch.where(
        nodes.valid[:, None], nodes.image_mh, 0.0).sum(0))  # (Ui,)
    spread = num_nodes / total
    # truncation to int64 per image (scaledImageScore) then summed
    scaled = torch.floor(sel.image_sizes * spread + _EPS)  # (Ui,)
    sum_scores = pods.image_mh @ (nodes.image_mh * scaled[None, :]).T
    clamped = torch.clamp(sum_scores, lo, hi)
    return _idiv(MAX_PRIORITY * (clamped - lo), hi - lo)


def selector_spread(pods, nodes, sel, topo, mask):
    """selector_spreading.go: map = count of same-namespace pods on the node
    matching all owner selectors; reduce = 10*(max-count)/max blended 1/3
    with the zone-level equivalent at 2/3 (zoneWeighting, :34) when zones
    exist."""
    return coll.solo(selector_spread_g(pods, nodes, sel, topo, mask))


def selector_spread_g(pods, nodes, sel, topo, mask):
    """:func:`selector_spread` as a shard program: the node maximum is an
    all-reduce MAX, the zone panels all-reduce SUMs."""
    idx = pods.owner_id.clamp(0, nodes.owner_counts.shape[1] - 1).long()
    counts = torch.where((pods.owner_id >= 0)[:, None],
                         nodes.owner_counts.T[idx], 0.0)  # (P, N)
    counts = torch.where(mask, counts, 0.0)
    max_node = yield coll.all_max(counts.amax(1, keepdim=True))  # (P, 1)

    # zone aggregation as a one-hot matmul: zmat (N, Z)
    n_zones = nodes.zone_valid.shape[0]
    has_zone = nodes.zone_id >= 0
    zid = nodes.zone_id.clamp(0, n_zones - 1).long()
    zmat = ((zid[:, None] == torch.arange(n_zones, device=zid.device)[None, :])
            & has_zone[:, None]).to(torch.float32)  # (N, Z)
    zcounts = yield coll.all_sum(counts @ zmat)  # (P, Z)
    # zones present for this pod = zones containing a feasible node
    zone_present = (yield coll.all_sum(
        mask.to(torch.float32) @ zmat)) > 0  # (P, Z)
    max_zone = torch.where(zone_present, zcounts,
                           -float("inf")).amax(1, keepdim=True)
    have_zones = zone_present.any(1, keepdim=True)  # (P, 1)

    node_score = torch.where(
        max_node > 0,
        MAX_PRIORITY * (max_node - counts) / torch.clamp_min(max_node, 1e-30),
        float(MAX_PRIORITY))
    zcount_of_node = zcounts[:, zid]  # (P, N)
    zone_score = torch.where(
        max_zone > 0,
        MAX_PRIORITY * (max_zone - zcount_of_node)
        / torch.clamp_min(max_zone, 1e-30),
        float(MAX_PRIORITY))
    blend = torch.where(have_zones & has_zone[None, :],
                        node_score * (1.0 / 3.0) + zone_score * (2.0 / 3.0),
                        node_score)
    return torch.floor(blend + _EPS)  # reference truncates the final float


def node_prefer_avoid(pods, nodes, sel, topo, mask):
    """node_prefer_avoid_pods.go: 0 when the node's preferAvoidPods
    annotation lists the pod's controller owner, else 10."""
    idx = pods.owner_uid_id.clamp(0, nodes.avoid_mh.shape[1] - 1).long()
    avoided = torch.where((pods.owner_uid_id >= 0)[:, None],
                          nodes.avoid_mh.T[idx], 0.0)
    return torch.where(avoided > 0, 0.0, float(MAX_PRIORITY))


def equal_priority(pods, nodes, sel, topo, mask):
    """generic_scheduler.go:840 EqualPriority."""
    return torch.ones((pods.req.shape[0], nodes.allocatable.shape[0]),
                      dtype=torch.float32, device=pods.req.device)


def _zeros(pods, nodes):
    return torch.zeros((pods.req.shape[0], nodes.allocatable.shape[0]),
                       dtype=torch.float32, device=pods.req.device)


def inter_pod_affinity(pods, nodes, sel, topo, mask):
    """interpod_affinity.go CalculateInterPodAffinityPriority (symmetric
    weighted term counts, min/max-normalized). All zeros when no topology
    tables were packed."""
    return coll.solo(inter_pod_affinity_g(pods, nodes, sel, topo, mask))


def inter_pod_affinity_g(pods, nodes, sel, topo, mask):
    if topo is None:
        return _zeros(pods, nodes)
    return (yield from inter_pod_affinity_score_g(pods, nodes, topo, mask))


def even_pods_spread(pods, nodes, sel, topo, mask):
    """even_pods_spread.go CalculateEvenPodsSpreadPriority (enabled
    whenever soft constraints exist). All zeros when no topology tables
    were packed."""
    return coll.solo(even_pods_spread_g(pods, nodes, sel, topo, mask))


def even_pods_spread_g(pods, nodes, sel, topo, mask):
    if topo is None:
        return _zeros(pods, nodes)
    prog = selector_program_match(sel, nodes)
    return (yield from even_pods_spread_score_g(pods, nodes, topo, prog,
                                                mask))


#: RequestedToCapacityRatio default shape: least-utilized preferred
#: (requested_to_capacity_ratio.go:41 defaultFunctionShape).
DEFAULT_FUNCTION_SHAPE = ((0, 10), (100, 0))


def _broken_linear(p, shape):
    """buildBrokenLinearFunction (requested_to_capacity_ratio.go:110):
    piecewise-linear through integer (utilization, score) points with Go
    int64 division (truncation toward zero)."""
    xs = [float(x) for x, _ in shape]
    ys = [float(y) for _, y in shape]
    out = torch.full_like(p, ys[-1])
    for i in reversed(range(len(xs))):
        if i == 0:
            seg = torch.full_like(p, ys[0])
        else:
            seg = ys[i - 1] + torch.trunc(
                (ys[i] - ys[i - 1]) * (p - xs[i - 1]) / (xs[i] - xs[i - 1]))
        out = torch.where(p <= xs[i], seg, out)
    return out


def make_requested_to_capacity_ratio(shape=DEFAULT_FUNCTION_SHAPE):
    """RequestedToCapacityRatioResourceAllocationPriority
    (requested_to_capacity_ratio.go:87): per-resource utilization percent
    through the shape function, cpu/mem averaged with integer division.
    The percent floor adds a 1e-4 epsilon before flooring (Go computes in
    exact int64)."""

    def one(req, cap):
        bad = (cap <= 0) | (req > cap)
        pct = 100.0 - torch.floor(
            (cap - req) * 100.0 / torch.clamp_min(cap, 1.0) + 1e-4)
        return _broken_linear(torch.where(bad, 100.0, pct), shape)

    def kernel(pods, nodes, sel, topo, mask):
        cpu_req, mem_req, cpu_cap, mem_cap = _requested_fractions(pods, nodes)
        cpu = one(cpu_req, cpu_cap.expand_as(cpu_req))
        mem = one(mem_req, mem_cap.expand_as(mem_req))
        return torch.trunc((cpu + mem) / 2.0)

    return kernel


def make_node_label(key_id: int, presence: bool):
    """NodeLabelPriority (node_label.go:47): MaxPriority when the node's
    having label ``key_id`` agrees with ``presence``, else 0."""

    def kernel(pods, nodes, sel, topo, mask):
        has = nodes.key_mh[:, key_id] > 0  # (N,)
        hit = has if presence else ~has
        row = torch.where(hit, float(MAX_PRIORITY), 0.0)
        return row[None, :].expand(pods.req.shape[0], nodes.n)

    return kernel


def resource_limits(pods, nodes, sel, topo, mask):
    """ResourceLimitsPriority (resource_limits.go:44): 1 when the node's
    allocatable satisfies the pod's cpu OR memory limit, else 0."""
    cap = nodes.allocatable  # (N, R); cols 0/1 = cpu_milli/memory
    cpu_ok = (pods.limits[:, 0:1] > 0) & (pods.limits[:, 0:1]
                                          <= cap[:, 0][None, :])
    mem_ok = (pods.limits[:, 1:2] > 0) & (pods.limits[:, 1:2]
                                          <= cap[:, 1][None, :])
    return (cpu_ok | mem_ok).to(torch.float32)


PriorityFn = Callable[..., torch.Tensor]  # (pods, nodes, sel, topo, mask)

#: Registry name -> kernel; names mirror factory registrations
#: (algorithmprovider/defaults/register_priorities.go).
PRIORITY_REGISTRY: Dict[str, PriorityFn] = {
    "LeastRequestedPriority": least_requested,
    "MostRequestedPriority": most_requested,
    "BalancedResourceAllocation": balanced_allocation,
    "NodeAffinityPriority": node_affinity,
    "TaintTolerationPriority": taint_toleration,
    "ImageLocalityPriority": image_locality,
    "SelectorSpreadPriority": selector_spread,
    "NodePreferAvoidPodsPriority": node_prefer_avoid,
    "EqualPriority": equal_priority,
    "InterPodAffinityPriority": inter_pod_affinity,
    "EvenPodsSpreadPriority": even_pods_spread,
    "RequestedToCapacityRatioPriority": make_requested_to_capacity_ratio(),
    "ResourceLimitsPriority": resource_limits,
}


def register_priority(name: str, fn: PriorityFn) -> None:
    """Add a custom-configured priority (factory/plugins.go
    RegisterPriorityMapReduceFunction analog); weights dicts may then
    reference ``name``."""
    PRIORITY_REGISTRY[name] = fn


#: Default provider weights (defaults.go:119 defaultPriorities).
DEFAULT_WEIGHTS: Dict[str, float] = {
    "SelectorSpreadPriority": 1,
    "InterPodAffinityPriority": 1,
    "LeastRequestedPriority": 1,
    "BalancedResourceAllocation": 1,
    "NodePreferAvoidPodsPriority": 10000,
    "NodeAffinityPriority": 1,
    "TaintTolerationPriority": 1,
    "ImageLocalityPriority": 1,
}

#: the exact full-matrix constant each kernel produces when its inputs are
#: absent from the snapshot: reverse-normalized kernels and spread/avoid
#: fill MaxPriority everywhere, forward-normalized and sum-based kernels 0.
EMPTY_CONSTANTS: Dict[str, float] = {
    "NodeAffinityPriority": 0.0,
    "TaintTolerationPriority": float(MAX_PRIORITY),
    "ImageLocalityPriority": 0.0,
    "SelectorSpreadPriority": float(MAX_PRIORITY),
    "NodePreferAvoidPodsPriority": float(MAX_PRIORITY),
    "ResourceLimitsPriority": 0.0,
    "InterPodAffinityPriority": 0.0,
    "EvenPodsSpreadPriority": 0.0,
}

#: the stock kernels the constants were derived from: register_priority()
#: may rebind a registry name, and the gate must never constant-fold a
#: custom kernel
_STOCK_KERNELS: Dict[str, PriorityFn] = {
    name: PRIORITY_REGISTRY[name] for name in EMPTY_CONSTANTS
}


def empty_priorities(node_table, pod_table) -> tuple:
    """Host-side feature gate: names whose kernels provably produce their
    :data:`EMPTY_CONSTANTS` for THIS snapshot because the inputs they read
    are entirely absent (computed on the packed host tables, no device
    sync). The solvers then add a scalar instead of running the kernel."""
    import numpy as np

    out = []
    if pod_table.prefprog_id.size == 0 or (pod_table.prefprog_id < 0).all():
        out.append("NodeAffinityPriority")
    if (node_table.taint_soft_mh.size == 0
            or node_table.taint_soft_mh.sum() == 0):
        out.append("TaintTolerationPriority")
    if pod_table.image_mh.size == 0 or pod_table.image_mh.sum() == 0:
        out.append("ImageLocalityPriority")
    if pod_table.owner_id.size == 0 or (pod_table.owner_id < 0).all():
        out.append("SelectorSpreadPriority")
    if (node_table.avoid_mh.size == 0 or node_table.avoid_mh.sum() == 0
            or (pod_table.owner_uid_id < 0).all()):
        out.append("NodePreferAvoidPodsPriority")
    # graftlint: disable=R7,R8 -- host pack table, no device sync
    if pod_table.limits is None or np.asarray(pod_table.limits).max(
            initial=0) <= 0:
        out.append("ResourceLimitsPriority")
    # topology scores: gate only with full evidence — no (anti)affinity on
    # any batch pod AND zero node-side anti/sym term counts
    if (not pod_table.has_aff.any()
            and node_table.anti_counts.sum() == 0
            and node_table.sym_counts.sum() == 0):
        out.append("InterPodAffinityPriority")
    if ((pod_table.spread_hard_id < 0).all()
            and (pod_table.spread_soft_id < 0).all()):
        out.append("EvenPodsSpreadPriority")
    return tuple(out)


def solver_gates(node_table, pod_table):
    """``(skip_priorities, no_ports, no_pod_affinity, no_spread)`` for
    this snapshot + batch — the one evidence rule every solver caller
    needs. The two topology MASK gates share the score gates' evidence."""
    from kubernetes_tpu_torch.ops.predicates import pods_have_no_ports

    skip = empty_priorities(node_table, pod_table)
    return (skip, pods_have_no_ports(pod_table),
            "InterPodAffinityPriority" in skip,
            "EvenPodsSpreadPriority" in skip)


#: the whole stock registry at import time: the fused normalize path (and
#: its integer-sum exactness argument) applies only when every ACTIVE
#: kernel is stock
_ALL_STOCK_KERNELS: Dict[str, PriorityFn] = dict(PRIORITY_REGISTRY)


def _fusable(weights: Dict[str, float], skip) -> bool:
    """True when the NA+TT fused accumulate is provably bit-identical:
    every active kernel is stock (all stock kernels floor their scores to
    integer-valued f32) and every weight is an integer, so all partial
    sums are exact f32 integers (< 2^24) and regrouping cannot round."""
    for name, w in weights.items():
        if not w or name in skip:
            continue
        if PRIORITY_REGISTRY.get(name) is not _ALL_STOCK_KERNELS.get(name):
            return False
        if float(w) != int(w):
            return False
    return True


def _fused_pair_normalize(raw_fwd, raw_rev, mask, w_fwd, w_rev):
    """One-output fused form of the two hoisted-raw normalizes
    (NodeAffinity forward + TaintToleration reverse): the CUDA pair
    kernel on a CUDA tensor, its plain version on a CPU tensor — both
    identical per element to two :func:`_normalize_reduce` calls with the
    weighted pair landing as ONE (P, N) term."""
    from kubernetes_tpu_torch.ops.fused_score import fused_pair_normalize

    return fused_pair_normalize(raw_fwd.contiguous(), raw_rev.contiguous(),
                                mask.contiguous(), w_fwd, w_rev)


def _fused_pair_normalize_g(raw_fwd, raw_rev, mask, w_fwd, w_rev, sh):
    """The pair as a shard program: the fused kernel alone (``sh``
    None); on a mesh the split kernels, the max pass on this block, an
    all-reduce MAX of the (P,) maxima, the scale pass on this block."""
    if sh is None:
        return _fused_pair_normalize(raw_fwd, raw_rev, mask, w_fwd, w_rev)
    from kubernetes_tpu_torch.ops.fused_score import (
        fused_pair_max,
        fused_pair_scale,
    )

    raw_fwd, raw_rev = raw_fwd.contiguous(), raw_rev.contiguous()
    mx = yield coll.all_max(torch.stack(fused_pair_max(
        raw_fwd, raw_rev, mask.contiguous())))
    return fused_pair_scale(raw_fwd, raw_rev, mx[0], mx[1], w_fwd, w_rev)


#: stock kernels whose full (P, N) score reads NO usage field and NO mask
#: — computable once per batch and reused every round verbatim
STATIC_FULL = ("ImageLocalityPriority", "NodePreferAvoidPodsPriority",
               "ResourceLimitsPriority")
#: stock kernels whose RAW map phase is usage-invariant but whose
#: NormalizeReduce depends on the per-round feasibility mask:
#: name -> (raw_fn, reverse)
STATIC_RAW = {
    "NodeAffinityPriority": (_node_affinity_raw, False),
    "TaintTolerationPriority": (_taint_toleration_raw, True),
}

#: stock kernels that reduce over the node axis -> their shard programs;
#: every other stock kernel is node-local and runs on a block unchanged
_SHARD_PROGRAMS = {
    "NodeAffinityPriority": lambda p, n, s, t, m: _normalize_reduce_g(
        _node_affinity_raw(p, n, s), m, False),
    "TaintTolerationPriority": lambda p, n, s, t, m: _normalize_reduce_g(
        _taint_toleration_raw(p, n, s), m, True),
    "ImageLocalityPriority": image_locality_g,
    "SelectorSpreadPriority": selector_spread_g,
    "InterPodAffinityPriority": inter_pod_affinity_g,
    "EvenPodsSpreadPriority": even_pods_spread_g,
}


def _kernel_g(name, pods, nodes, sel, topo, mask, sh):
    """One registered kernel's (P, block) term in a shard program. A
    stock kernel runs as its shard program (or, node-local, as itself);
    on a mesh a custom kernel sees the whole table and the whole mask,
    gathered across shards, and keeps its block's columns."""
    fn = PRIORITY_REGISTRY[name]
    if fn is _ALL_STOCK_KERNELS.get(name):
        prog = _SHARD_PROGRAMS.get(name)
        if prog is None:
            return fn(pods, nodes, sel, topo, mask)
        return (yield from prog(pods, nodes, sel, topo, mask))
    if sh is None:
        return fn(pods, nodes, sel, topo, mask)
    full_nodes = yield from coll.gather_nodes(nodes)
    full_mask = yield coll.cat(mask, 1)
    lo = sh.index * sh.rows
    return fn(pods, full_nodes, sel, topo, full_mask)[:, lo:lo + sh.rows]


def hoist_priorities(pods, nodes, sel,
                     weights: Dict[str, float] | None = None,
                     skip=()) -> Dict[str, tuple]:
    """The usage-invariant slice of scoring, computed ONCE per batch.
    Returns ``{name: ("full", matrix) | ("raw", raw_matrix, reverse)}``
    for :func:`run_priorities`; gated and custom-registered kernels are
    not hoisted."""
    return coll.solo(hoist_priorities_g(pods, nodes, sel, weights, skip))


def hoist_priorities_g(pods, nodes, sel, weights=None, skip=(), sh=None):
    """:func:`hoist_priorities` as a shard program."""
    weights = DEFAULT_WEIGHTS if weights is None else weights
    parts: Dict[str, tuple] = {}
    for name, w in weights.items():
        if not w or name in skip:
            continue
        if PRIORITY_REGISTRY.get(name) is not _STOCK_KERNELS.get(name):
            continue
        if name in STATIC_FULL:
            parts[name] = ("full", (yield from _kernel_g(
                name, pods, nodes, sel, None, None, sh)))
        elif name in STATIC_RAW:
            raw_fn, reverse = STATIC_RAW[name]
            parts[name] = ("raw", raw_fn(pods, nodes, sel), reverse)
    return parts


def run_priorities(
    pods: DevicePods,
    nodes: DeviceNodes,
    sel: DeviceSelectors,
    mask: torch.Tensor,
    weights: Dict[str, float] | None = None,
    topo=None,
    skip=(),
    hoisted: Dict[str, tuple] | None = None,
    fused: bool = False,
) -> torch.Tensor:
    """PrioritizeNodes (generic_scheduler.go:684): weighted sum of all
    enabled priorities -> (P, N) f32 total score. ``skip`` names kernels
    replaced by their exact :data:`EMPTY_CONSTANTS` scalar; ``hoisted``
    takes :func:`hoist_priorities` output. Accumulation stays in
    weights-dict order with identical per-kernel arithmetic.

    ``fused=True`` collapses the two hoisted-raw normalizes (NodeAffinity
    + TaintToleration) into one kernel — only when :func:`_fusable` proves
    the regrouped accumulation exact, so the total is always
    bit-identical."""
    return coll.solo(run_priorities_g(pods, nodes, sel, mask, weights, topo,
                                      skip, hoisted, fused))


def run_priorities_g(pods, nodes, sel, mask, weights=None, topo=None,
                     skip=(), hoisted: Dict[str, tuple] | None = None,
                     fused: bool = False, sh=None):
    """:func:`run_priorities` as the shard program of one block (``sh``
    None: the whole table, alone): the same terms in the same order, the
    pair on the split kernels on a mesh."""
    weights = DEFAULT_WEIGHTS if weights is None else weights
    hoisted = hoisted or {}
    _NA, _TT = "NodeAffinityPriority", "TaintTolerationPriority"
    fuse_pair = ()
    if (fused and _fusable(weights, skip)
            and all(n in hoisted and hoisted[n][0] == "raw"
                    and weights.get(n) and n not in skip
                    for n in (_NA, _TT))):
        # dict order decides which name triggers the combined accumulate
        fuse_pair = tuple(n for n in weights if n in (_NA, _TT))
    total = torch.zeros((pods.req.shape[0], nodes.allocatable.shape[0]),
                        dtype=torch.float32, device=pods.req.device)
    for name, w in weights.items():
        if not w:
            continue
        if name in fuse_pair:
            if name == fuse_pair[0]:
                total = total + (yield from _fused_pair_normalize_g(
                    hoisted[_NA][1], hoisted[_TT][1], mask,
                    float(weights[_NA]), float(weights[_TT]), sh))
            continue  # second of the pair: already accumulated
        if (name in skip and name in EMPTY_CONSTANTS
                and PRIORITY_REGISTRY[name] is _STOCK_KERNELS[name]):
            total = total + w * EMPTY_CONSTANTS[name]
        elif name in hoisted:
            kind, val, *rest = hoisted[name]
            term = val if kind == "full" else (
                yield from _normalize_reduce_g(val, mask, rest[0]))
            total = total + w * term
        else:
            total = total + w * (yield from _kernel_g(
                name, pods, nodes, sel, topo, mask, sh))
    return total
