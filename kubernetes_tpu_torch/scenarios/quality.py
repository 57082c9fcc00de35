"""Host side of the scenario placement-quality surface (the port of
``kubernetes_tpu/scenarios/quality.py``, a numpy copy): the decode of the
device :func:`~kubernetes_tpu_torch.ops.scenario_cost.quality_reduce`
vector, the gang all-or-nothing bookkeeping over the already-read-back
assignment (zero extra readback bytes), and ``node_resources_score``, the
``mean_score`` / ``balanced`` solution score."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from kubernetes_tpu_torch.ops.scenario_cost import QUALITY_FIELDS


def decode_quality(vec) -> Dict[str, float]:
    """Read-back (len(QUALITY_FIELDS),) f32 vector -> named score dict.
    Counting fields decode as ints; fractions round to 4 places."""
    out: Dict[str, float] = {}
    arr = np.asarray(vec, np.float64).reshape(-1)
    for i, name in enumerate(QUALITY_FIELDS):
        v = float(arr[i])
        if name in ("nodes_used", "nodes_used_batch", "placed"):
            out[name] = int(round(v))
        else:
            out[name] = round(v, 4)
    return out


def slice_distance_host(za, zb, superpod: int = 4):
    """Numpy twin of :func:`kubernetes_tpu_torch.ops.scenario_cost.
    slice_distance` — the one host-side spelling of the hierarchical
    metric (0 = same slice, 1 = same superpod, 2 = fabric; -1 =
    unlabeled is always fabric), so the reported locality cannot drift
    from the solve objective. Broadcasts like the operands."""
    za = np.asarray(za)
    zb = np.asarray(zb)
    sp = max(int(superpod), 1)
    labeled = (za >= 0) & (zb >= 0)
    return np.where(labeled & (za == zb), 0,
                    np.where(labeled & ((za // sp) == (zb // sp)), 1, 2))


def gang_stats(batch, assigned, zone_of_node: Optional[Sequence[int]] = None,
               superpod: int = 4) -> Dict[str, float]:
    """Gang all-or-nothing bookkeeping over the cycle's FINAL host
    assignment (after the gang rollback): group success rate, partial
    binds (the atomicity invariant, which must be 0) and, when
    ``zone_of_node`` (host zone index per node row) is given, the mean
    intra-gang slice locality: each placed gang's mean pairwise hop
    saving against cross-fabric (2.0 = the whole gang on one slice)."""
    groups: Dict[str, List[int]] = {}
    for i, p in enumerate(batch):
        if p.pod_group:
            groups.setdefault(p.pod_group, []).append(i)
    total = len(groups)
    placed_groups = 0
    partial = 0
    locality: List[float] = []
    for idxs in groups.values():
        n_placed = sum(1 for i in idxs if int(assigned[i]) >= 0)
        if n_placed == len(idxs):
            placed_groups += 1
            if zone_of_node is not None and len(idxs) > 1:
                zs = np.asarray(
                    [int(zone_of_node[int(assigned[i])]) for i in idxs])
                d = slice_distance_host(zs[:, None], zs[None, :],
                                        superpod)
                iu = np.triu_indices(len(idxs), k=1)
                locality.append(float(np.mean(2.0 - d[iu])))
        elif n_placed:
            partial += 1
    return {
        "gang_groups": total,
        "gangs_placed": placed_groups,
        "gang_success_rate": (round(placed_groups / total, 4)
                              if total else 1.0),
        "gang_partial_binds": partial,
        **({"gang_locality": round(float(np.mean(locality)), 4)}
           if locality else {}),
    }


def node_resources_score(alloc, requested, assigned) -> Dict[str, float]:
    """Aggregate NodeResources score of a solution: the mean over PLACED
    pods of their node's LeastRequested + BalancedResourceAllocation
    score at the final usage (resource_allocation.go:39 arithmetic:
    LeastRequested = ((cap - req) * 10 / cap) averaged over cpu and mem;
    Balanced = 10 - |cpuFrac - memFrac| * 10)."""
    from kubernetes_tpu_torch.snapshot import RES_CPU, RES_MEM

    alloc = np.asarray(alloc, np.float64)
    req = np.asarray(requested, np.float64)
    assigned = np.asarray(assigned)
    placed = assigned[assigned >= 0]
    if placed.size == 0:
        return {"mean_score": 0.0, "least_requested": 0.0, "balanced": 0.0}
    cap_cpu = np.maximum(alloc[:, RES_CPU], 1e-9)
    cap_mem = np.maximum(alloc[:, RES_MEM], 1e-9)
    fr_cpu = np.clip(req[:, RES_CPU] / cap_cpu, 0.0, 1.0)
    fr_mem = np.clip(req[:, RES_MEM] / cap_mem, 0.0, 1.0)
    lr = ((1.0 - fr_cpu) * 10.0 + (1.0 - fr_mem) * 10.0) / 2.0
    ba = 10.0 - np.abs(fr_cpu - fr_mem) * 10.0
    per_node = lr + ba
    return {
        "mean_score": round(float(per_node[placed].mean()), 4),
        "least_requested": round(float(lr[placed].mean()), 4),
        "balanced": round(float(ba[placed].mean()), 4),
    }
