"""Scenario-pack cost terms and the placement-quality reduction — the
device half of :mod:`kubernetes_tpu_torch.scenarios` (the port of
``kubernetes_tpu/ops/scenario_cost.py``).

Two cost terms fold scenario objectives into the ``extra_score`` term
every solver tier already consumes (batch rounds, the Sinkhorn plan, the
greedy oracle, the exact Hungarian), so the objective rides the whole
degradation ladder unchanged:

- :func:`consolidation_bias` — a flat bonus on nodes that already host
  pods plus a sub-integer blocked fill order, so the rounds fill started
  nodes (and a demand-sized prefix of blocks) before opening empty ones;
- :func:`gang_topology_score` — each gang member scores nodes by the
  hierarchical slice distance (:func:`slice_distance`) between the
  node's zone and its gang's home slice (picked on the host,
  ``scenarios/packs.py``).

:func:`quality_reduce` turns the cycle's final usage and assignment into
a fixed-layout (7,) f32 vector (:data:`QUALITY_FIELDS`) that crosses to
the host as one small read.

The reference computes all of this in ``jnp`` outside any Pallas kernel,
so these are plain PyTorch operations on the tables' device. Each keeps
the reference's operation order where the result must be bit-identical
(the cost terms), and none reads the host: no ``.item()``, no boolean
indexing, no tensor built from host data, so a call can be replayed
inside a captured graph.
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.snapshot import RES_CPU, RES_MEM, RES_PODS

#: host-decode layout of the :func:`quality_reduce` vector (one f32 slot
#: per name, in order); ``scenarios/quality.decode_quality`` decodes it
QUALITY_FIELDS = (
    "nodes_used",            # valid nodes hosting >= 1 pod after the cycle
    "nodes_used_batch",      # valid nodes that received >= 1 pod this cycle
    "placed",                # pods this assignment placed (cross-check)
    "headroom",              # mean over valid nodes of min(cpu, mem) free frac
    "fragmentation",         # share of free CPU stranded on nodes too
    #                          empty-handed for the batch's mean request
    "priority_headroom",     # placed-pod mean of node free frac, weighted
    #                          by (priority - min_priority + 1)
    "free_cpu_frac",         # cluster-wide free CPU fraction
)


def slice_distance(za: torch.Tensor, zb: torch.Tensor,
                   superpod: int = 4) -> torch.Tensor:
    """Hierarchical distance between two slice (zone) indices: 0 = same
    slice, 1 = same superpod (``superpod`` consecutive slice indices per
    group), 2 = cross-fabric. Unlabeled (-1) indices are always
    cross-fabric. Broadcasts like the operands; int32 out. The superpod
    test is floor division, as ``jnp``'s ``//`` on int32."""
    sp = max(int(superpod), 1)
    labeled = (za >= 0) & (zb >= 0)
    same = labeled & (za == zb)
    near = labeled & (torch.div(za, sp, rounding_mode="floor")
                      == torch.div(zb, sp, rounding_mode="floor"))
    return torch.where(same, 0, torch.where(near, 1, 2)).to(torch.int32)


def consolidation_bias(pod_valid: torch.Tensor, nodes,
                       weight: torch.Tensor,
                       fill_block: int = 64) -> torch.Tensor:
    """(P, N) packing bias, two terms:

    - ``weight`` points on every valid node that already hosts a pod
      (occupancy at the snapshot; the in-cycle growth is the re-weighted
      MostRequested kernel's job);
    - a sub-integer blocked fill order: block ``k`` of ``fill_block``
      consecutive rows is biased ``-0.5 * k / nblocks``. The stock
      kernels are integer-valued, so the term breaks exact ties only,
      and it must be bit-identical to the reference's: it is evaluated in
      the reference's order, ``(-0.5 * blk) / nblocks`` in f32.

    ``weight`` is a 0-d f32 tensor on the tables' device (a new cost
    weight is new data, not a new graph); ``fill_block`` a Python int."""
    valid = nodes.valid
    occupied = valid & (nodes.requested[:, RES_PODS] > 0)
    N = valid.shape[0]
    fb = max(int(fill_block), 1)
    nblocks = max((N + int(fill_block) - 1) // int(fill_block), 1)
    blk = torch.div(torch.arange(N, dtype=torch.int32, device=valid.device),
                    fb, rounding_mode="floor")
    order = (-0.5 * blk.to(torch.float32)) / nblocks
    row = (torch.where(occupied, weight, 0.0) + order).to(torch.float32)
    return (row.unsqueeze(0).expand(pod_valid.shape[0], N)
            * pod_valid.unsqueeze(1))


def gang_topology_score(home_zone: torch.Tensor, nodes,
                        weight: torch.Tensor,
                        superpod: int = 4) -> torch.Tensor:
    """(P, N) slice-locality score for gang members: ``weight`` points
    per hop saved against cross-fabric (home-slice nodes ``2 * weight``,
    same superpod ``weight``, fabric 0). A pod without a gang home
    (``home_zone < 0``) gets an all-zero row. ``home_zone`` is (P,)
    int32 on the tables' device, ``weight`` a 0-d f32 tensor there."""
    d = slice_distance(home_zone.unsqueeze(1), nodes.zone_id.unsqueeze(0),
                       superpod=superpod)
    score = weight * (2 - d).to(torch.float32)
    gated = torch.where((home_zone >= 0).unsqueeze(1), score, 0.0)
    return gated * nodes.valid.unsqueeze(0)


def quality_reduce(assigned: torch.Tensor, usage_requested: torch.Tensor,
                   pods, nodes) -> torch.Tensor:
    """The cycle's placement-quality vector (layout
    :data:`QUALITY_FIELDS`) over the FINAL usage and assignment (gang
    rollbacks already applied by the caller). ``assigned`` is the (P,)
    int32 row vector (node row or -1), ``usage_requested`` the final
    (N, R) requested matrix. The three counts are exact (an int32
    ``index_add_`` and int32 sums); the fractions are f32 sums whose
    order may differ from XLA's in the last bits."""
    valid_n = nodes.valid
    alloc = nodes.allocatable
    dev = valid_n.device
    N = valid_n.shape[0]
    f32 = torch.float32
    placed_mask = pods.valid & (assigned >= 0)
    ac = assigned.clamp(0, N - 1).to(torch.long)

    pod_cnt = usage_requested[:, RES_PODS]
    nodes_used = (valid_n & (pod_cnt > 0)).sum(dtype=torch.int32)
    got_batch = torch.zeros((N,), dtype=torch.int32, device=dev)
    got_batch.index_add_(0, torch.where(placed_mask, ac, torch.zeros_like(ac)),
                         placed_mask.to(torch.int32))
    nodes_used_batch = ((got_batch > 0) & valid_n).sum(dtype=torch.int32)
    placed = placed_mask.sum(dtype=torch.int32)

    cap_cpu = alloc[:, RES_CPU].clamp_min(1e-9)
    cap_mem = alloc[:, RES_MEM].clamp_min(1e-9)
    free_cpu = (alloc[:, RES_CPU] - usage_requested[:, RES_CPU]).clamp_min(0.0)
    free_mem = (alloc[:, RES_MEM] - usage_requested[:, RES_MEM]).clamp_min(0.0)
    min_free_frac = torch.minimum(free_cpu / cap_cpu, free_mem / cap_mem)
    n_valid = valid_n.sum(dtype=torch.int32).clamp_min(1)
    headroom = torch.where(valid_n, min_free_frac, 0.0).sum() / n_valid

    # fragmentation: the share of free CPU on nodes whose free CPU cannot
    # fit even the batch's mean request
    n_pods = pods.valid.sum(dtype=torch.int32).clamp_min(1)
    mean_req = torch.where(pods.valid.unsqueeze(1), pods.req,
                           0.0)[:, RES_CPU].sum() / n_pods
    total_free = torch.where(valid_n, free_cpu, 0.0).sum()
    stranded = torch.where(valid_n & (free_cpu < mean_req.clamp_min(1e-9)),
                           free_cpu, 0.0).sum()
    fragmentation = stranded / total_free.clamp_min(1e-9)

    # priority-weighted headroom: placed pods' node free fraction,
    # weighted toward the high tiers
    pri = pods.priority.to(f32)
    pri_min = torch.where(placed_mask, pri, float("inf")).min()
    base = torch.where(torch.isfinite(pri_min), pri_min, 0.0)
    w = torch.where(placed_mask, pri - base + 1.0, 0.0)
    pod_free = min_free_frac.index_select(0, ac)
    pri_headroom = (w * pod_free).sum() / w.sum().clamp_min(1e-9)

    total_cap = torch.where(valid_n, alloc[:, RES_CPU], 0.0).sum()
    free_cpu_frac = total_free / total_cap.clamp_min(1e-9)

    return torch.stack([
        nodes_used.to(f32),
        nodes_used_batch.to(f32),
        placed.to(f32),
        headroom.to(f32),
        fragmentation.to(f32),
        pri_headroom.to(f32),
        free_cpu_frac.to(f32),
    ])
