"""The fused NodeAffinity + TaintToleration normalize pair — the masked
NormalizeReduce of both hoisted-raw priorities in one output (the two
Pallas kernels of ``kubernetes_tpu/ops/fused_score.py`` become one CUDA
kernel, ``csrc/fused_pair.cu``).

The two priorities (NodeAffinity forward, TaintToleration reverse —
priorities/reduce.go NormalizeReduce semantics over the filtered node
list, generic_scheduler.go:684) each need a masked row max and a scale
per round. A row of ``N <= STAGED_MAX_N`` with ``N % 16 == 0`` takes
the staged path: its block copies the row into shared memory once and
reads both maxima and the scaled, weighted sum from there. Other rows
take the wide path, which reads the row twice from global memory (the
second time mostly from L2). Per-element arithmetic
replicates ``priorities._idiv`` and ``_normalize_reduce`` exactly, and
f32 max is exact under any association, so the result is bit-identical
to :func:`fused_pair_normalize_plain`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from kubernetes_tpu_torch import kernels

MAX_PRIORITY = 10.0
_EPS = 1e-5

#: widest row the staged path holds in shared memory (9 bytes an element:
#: two at most of these 108 KB stages fit on an SM)
STAGED_MAX_N = 12288


def _idiv(num, den):
    """ops/priorities._idiv verbatim (Go integer division in f32)."""
    return torch.floor(num / torch.clamp_min(den, 1e-30) + _EPS)


def fused_pair_normalize_plain(raw_fwd, raw_rev, mask, w_fwd, w_rev):
    """The plain PyTorch version of the pair kernel:
    ``w_fwd * NormalizeReduce(raw_fwd) + w_rev * NormalizeReduce_rev(raw_rev)``
    over the feasible entries of each row (masked-out entries count 0)."""
    mxf = torch.where(mask, raw_fwd, 0.0).amax(1, keepdim=True)
    sf = _idiv(MAX_PRIORITY * raw_fwd, torch.where(mxf > 0, mxf, 1.0))
    sf = torch.where(mxf > 0, sf, 0.0)
    mxr = torch.where(mask, raw_rev, 0.0).amax(1, keepdim=True)
    sr = _idiv(MAX_PRIORITY * raw_rev, torch.where(mxr > 0, mxr, 1.0))
    sr = torch.where(mxr > 0, sr, 0.0)
    sr = torch.where(mxr > 0, MAX_PRIORITY - sr, MAX_PRIORITY)
    return w_fwd * sf + w_rev * sr


def staged_route(n, *ts) -> bool:
    """Whether a row of ``n`` goes down the staged path: it fits in shared
    memory, and each row of the mask (``n`` bytes) and of the f32
    operands is a whole number of 16-byte bulk copies at a 16-byte
    aligned address (``ts``: the tensors whose rows are copied or
    stored)."""
    return (n % 16 == 0 and n <= STAGED_MAX_N
            and all(t.data_ptr() % 16 == 0 for t in ts))


def fused_pair_normalize(raw_fwd, raw_rev, mask, w_fwd, w_rev):
    """(P, N) f32 fused pair. A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel (or raises): the staged path where
    :func:`staged_route` allows it, else the wide path. On the card N
    must be a multiple of four."""
    if raw_fwd.device.type == "cpu":
        return fused_pair_normalize_plain(raw_fwd, raw_rev, mask, w_fwd,
                                          w_rev)
    P, N = raw_fwd.shape
    kernels.require(raw_fwd, "fused_pair_normalize raw_fwd", torch.float32)
    kernels.require(raw_rev, "fused_pair_normalize raw_rev", torch.float32,
                    (P, N))
    kernels.require(mask, "fused_pair_normalize mask", torch.bool, (P, N))
    out = torch.empty((P, N), dtype=torch.float32, device=raw_fwd.device)
    kernels.require_vec4(N, "fused_pair_normalize", raw_fwd, raw_rev, mask,
                         out)
    staged = staged_route(N, raw_fwd, raw_rev, mask, out)
    launch(raw_fwd, raw_rev, mask, out, w_fwd, w_rev, staged)
    kernels.count_launch("fused_pair_normalize", (P, N))
    if not staged:
        kernels.count_launch("fused_pair_normalize_wide", (P, N))
    return out


def launch(raw_fwd, raw_rev, mask, out, w_fwd, w_rev, staged: bool):
    """Launch one path of the pair kernel into ``out`` (no checks and no
    count: :func:`fused_pair_normalize` makes both; the one place the C
    entry points are called)."""
    P, N = raw_fwd.shape
    lib = kernels.lib("fused_pair")
    fn = (lib.ktt_fused_pair_normalize if staged
          else lib.ktt_fused_pair_normalize_wide)
    code = fn(raw_fwd.data_ptr(), raw_rev.data_ptr(), mask.data_ptr(),
              out.data_ptr(), P, N, float(w_fwd), float(w_rev),
              kernels.stream_ptr(raw_fwd))
    kernels.check(code, "fused_pair_normalize")


# ---------------------------------------------------------------------------
# Incremental-solve score summary (reference ``fused_score.py:200-428``): a
# device-resident per-node summary of the score plane, kept coherent with
# the resident DeviceNodes by the same full-vs-delta discipline
# (SchedulerCache rebuilds it on full uploads and patches exactly the
# scattered rows on delta drains). The restricted solve picks its
# candidate node columns from it with one top-k over N, never a (P, N)
# plane.
# ---------------------------------------------------------------------------


class NodeSummary(NamedTuple):
    """The cached per-node slice of the score/feasibility plane.

    ``eligible``: node valid, schedulable and condition-clean (when the
    Policy enforces the condition predicates), with a free pod slot. The
    pod-conditioned predicates are re-evaluated by the restricted solve
    on the gathered columns; this only decides which columns to gather.
    ``rank``: the candidate ranking score (mean free cpu/memory fraction,
    flipped under a packing objective); ineligible columns hold
    :data:`_NEG`."""

    eligible: torch.Tensor  # (N,) bool
    rank: torch.Tensor  # (N,) f32, _NEG on ineligible columns


#: rank boost that guarantees dirty columns survive the top-k cut
DIRTY_BOOST = 1e6

#: rank boost for hinted columns: ahead of every plain rank, behind the
#: dirty boost
HINT_BOOST = 1e5

#: ineligible-column rank (finite, so the sentinel arithmetic stays
#: NaN-free)
_NEG = -3e38


def node_summary(nodes, honor_conditions: bool = True,
                 prefer_packed: bool = False) -> NodeSummary:
    """The per-node summary of a DeviceNodes table (a full rebuild) or of
    a delta sub-table (whose rows then go in through
    :func:`patch_node_summary`): one pass over the (N, R) usage and the
    (N,) condition bits. ``honor_conditions``: the Policy enforces the
    node condition predicates; ``prefer_packed``: rank fullest-first."""
    from kubernetes_tpu_torch.snapshot import RES_CPU, RES_MEM, RES_PODS

    free = nodes.allocatable - nodes.requested  # (N, R)
    eligible = nodes.valid
    if honor_conditions:
        eligible = (eligible & nodes.schedulable & nodes.ready
                    & ~nodes.network_unavailable & ~nodes.mem_pressure
                    & ~nodes.disk_pressure & ~nodes.pid_pressure)
    # a column with no free pod slot cannot admit anything this cycle
    eligible = eligible & (free[:, RES_PODS] >= 1.0)

    def frac(col):
        cap = nodes.allocatable[:, col]
        return torch.where(cap > 0, torch.clamp_min(free[:, col], 0.0)
                           / torch.clamp_min(cap, 1e-30), 0.0)

    rank = 0.5 * (frac(RES_CPU) + frac(RES_MEM))
    if prefer_packed:
        rank = 1.0 - rank
    return NodeSummary(eligible=eligible,
                       rank=torch.where(eligible, rank, _NEG))


def patch_node_summary(summary: NodeSummary, sub: NodeSummary,
                       idx) -> NodeSummary:
    """Copy ``sub``'s rows into the resident summary IN PLACE at the host
    row indices ``idx`` (aligned with ``sub``'s rows); entries at or past
    the resident row count are padding and drop, as in
    ``ops/arrays.scatter_node_rows``. Returns the patched summary (the
    same tensors)."""
    import numpy as np

    from kubernetes_tpu_torch.ops.arrays import upload

    idx = np.asarray(idx, np.int64)
    keep = np.nonzero(idx < summary.rank.shape[0])[0]
    if len(keep):
        dev = summary.rank.device
        rows = upload(idx[keep], dev)
        src = upload(keep, dev)
        summary.eligible.index_copy_(0, rows,
                                     sub.eligible.index_select(0, src))
        summary.rank.index_copy_(0, rows, sub.rank.index_select(0, src))
    return summary


def _candidate_score(summary: NodeSummary, dirty_mask,
                     hint_mask=None) -> torch.Tensor:
    """Plain rank + the dirty-frontier boost + (optionally) the hint
    boost, added in the reference's order in f32. A hint cannot
    resurrect an ineligible column."""
    score = summary.rank + torch.where(dirty_mask & summary.eligible,
                                       DIRTY_BOOST, 0.0)
    if hint_mask is not None:
        score = score + torch.where(hint_mask & summary.eligible,
                                    HINT_BOOST, 0.0)
    return score


def _topk(score, k: int):
    """``jax.lax.top_k`` of a (..., N) plane: the k largest of each row,
    ties broken toward the lower index (``torch.topk`` promises no tie
    order, a stable descending sort does). Returns (values, int32
    indices)."""
    order = torch.sort(score, dim=-1, descending=True, stable=True).indices
    order = order[..., :k]
    return score.gather(-1, order), order.to(torch.int32)


def _merge_local_topk(vals, idx, k: int):
    """Merge per-shard winners: sort the pool by (value desc, global index
    asc) and take the first k (two stable sorts: index, then value)."""
    vals, idx = vals.reshape(-1), idx.reshape(-1)
    o = torch.argsort(idx, stable=True)
    o = o[torch.sort(vals[o], descending=True, stable=True).indices]
    return vals[o[:k]], idx[o[:k]]


def _sharded_topk(score, k: int, num_shards: int):
    """Top-``k`` of a (N,) plane, optionally in two stages: with
    ``num_shards > 1`` each contiguous block of N/S columns picks its
    local top-k and the (S, k) winners merge by (value desc, index asc).
    Both stages break ties on the lower global index, so the result is
    bit-identical to the single pass on any shard count. Shapes that
    cannot shard evenly (or k past a block) take the single pass."""
    n = score.shape[0]
    if num_shards > 1 and n % num_shards == 0 and k <= n // num_shards:
        local = n // num_shards
        lvals, lidx = _topk(score.reshape(num_shards, local), k)
        offs = (torch.arange(num_shards, dtype=torch.int32,
                             device=score.device) * local)[:, None]
        return _merge_local_topk(lvals, lidx + offs, k)
    return _topk(score, k)


def candidate_columns(summary: NodeSummary, dirty_mask, k: int,
                      hint_mask: Optional[torch.Tensor] = None,
                      num_shards: int = 1, hint_quota: int = 0):
    """Top-``k`` candidate node columns for the restricted solve: the
    best-ranked eligible columns, every dirty eligible column guaranteed a
    slot by :data:`DIRTY_BOOST`, hinted ones right behind it. Returns (k,)
    int32 column indices; slots that fell on ineligible columns hold the
    padding sentinel ``N``.

    ``hint_quota > 0`` reserves a split: the first ``hint_quota`` slots
    hold the best hinted columns, the rest the best unhinted ones
    (disjoint; quota slots a small hint set cannot fill are sentinels)."""
    n = summary.rank.shape[0]
    if hint_mask is not None and 0 < hint_quota < k:
        base = _candidate_score(summary, dirty_mask, None)
        hv, hi = _sharded_topk(torch.where(hint_mask, base, _NEG),
                               hint_quota, num_shards)
        uv, ui = _sharded_topk(torch.where(hint_mask, _NEG, base),
                               k - hint_quota, num_shards)
        vals, idx = torch.cat([hv, uv]), torch.cat([hi, ui])
    else:
        vals, idx = _sharded_topk(
            _candidate_score(summary, dirty_mask, hint_mask), k, num_shards)
    return torch.where(vals > _NEG / 2, idx, n).to(torch.int32)


def partition_columns(summary: NodeSummary, dirty_mask, n_blocks: int,
                      block_width: int, num_shards: int = 1):
    """Capacity-balanced column blocks for the partitioned cold solve:
    the top ``n_blocks * block_width`` columns by rank, dealt round-robin
    (block b holds ranks b, b+B, b+2B, ...), so every block spans the
    rank spectrum and block 0 owns the best column. Ineligible slots hold
    the sentinel ``N``. Returns (n_blocks, block_width) int32."""
    n = summary.rank.shape[0]
    vals, order = _sharded_topk(_candidate_score(summary, dirty_mask),
                                n_blocks * block_width, num_shards)
    idx = torch.where(vals > _NEG / 2, order, n).to(torch.int32)
    return idx.reshape(block_width, n_blocks).T.contiguous()
