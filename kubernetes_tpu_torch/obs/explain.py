"""Batched schedulability explainer — cluster-wide "why pending" analytics
over the cycle's dense (P, N) predicate-failure bitmask (the port of
``kubernetes_tpu/obs/explain.py``).

:func:`explain_reduce` reduces the failure pass's per-(pod, node) reason
bits on the device into small int32 arrays:

- **per-pod per-reason node counts** — on how many valid nodes each
  predicate fired for each pod (the numbers behind the FitError text);
- **cluster-wide reason histogram** — (pod, node) failure pairs and
  blocked-pod counts per predicate;
- **one-bit-away relaxation** — for each pod, the single predicate whose
  relaxation opens the most nodes (nodes whose failure mask is exactly
  ``1 << b``).

The scheduler reads them back as one transfer; :func:`build_report`
decodes them into an :class:`UnschedulableReport` on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from kubernetes_tpu_torch.ops.predicates import (
    BIT,
    PREDICATE_BITS,
    REASON_MESSAGES,
)
from kubernetes_tpu_torch.ops.sync import to_host

#: number of predicate reason bits (the static axis of every reduction)
N_REASONS = len(PREDICATE_BITS)


class ExplainResult(NamedTuple):
    """Device outputs of :func:`explain_reduce` (everything int32)."""

    #: (P, B) — valid nodes on which predicate b fired for pod p
    per_pod: torch.Tensor
    #: (P, B) — valid nodes failing ONLY on predicate b (one bit away)
    one_bit: torch.Tensor
    #: (P,) — argmax_b one_bit: the best single relaxation per pod
    best_bit: torch.Tensor
    #: (P,) — nodes that best relaxation would open
    best_gain: torch.Tensor
    #: (P,) — valid nodes with NO failure bits (the pod lost a capacity
    #: race to the rest of the batch rather than failing predicates)
    feasible: torch.Tensor
    #: (B,) — total (pod, node) failure pairs per predicate
    pair_hist: torch.Tensor
    #: (B,) — pods with predicate b firing on >= 1 valid node
    pods_blocked: torch.Tensor
    #: (P,) — OR of every valid node's failure bits per pod
    pod_bits: torch.Tensor
    #: (P, R) — valid nodes where PodFitsResources fired AND the pod's
    #: request for resource r exceeds the node's free amount ((P, 0) when
    #: the fit inputs weren't supplied)
    insufficient: torch.Tensor
    #: (P,) — valid nodes where CheckNodeCondition fired and the node was
    #: not ready (zeros when fit inputs weren't supplied)
    not_ready: torch.Tensor
    #: (P,) — ...and where the node's network was unavailable
    net_unavail: torch.Tensor


def explain_reduce(reasons, node_valid, pod_mask, req=None, free=None,
                   ready=None, net_unavail=None) -> ExplainResult:
    """Reduce the cycle's failure bitmask into the explain analytics.

    ``reasons`` (P, N) int32 per-(pod, node) failed-predicate bits;
    ``node_valid`` (N,) bool; ``pod_mask`` (P,) bool selects the pods
    under analysis (rows outside it contribute nothing to any count or
    to the cluster rollup; ``pod_bits`` ignores it).

    ``req`` (P, R) / ``free`` (N, R) / ``ready`` / ``net_unavail`` (N,)
    are the FitError inputs: with them the result also carries the
    per-resource Insufficient counts and the node-condition splits.

    The reason axis unrolls as B passes over the (P, N) plane; no
    (P, N, B) intermediate is materialized. ``pod_bits`` is assembled
    from per-bit ``any`` reductions (each term owns its bit, so the sum
    is the bitwise OR), as in the reference."""
    vmask = pod_mask[:, None] & node_valid[None, :]  # (P, N)
    P = reasons.shape[0]
    i32 = torch.int32
    per_pod_cols = []
    one_bit_cols = []
    pod_bits = torch.zeros((P,), dtype=i32, device=reasons.device)
    for b in range(N_REASONS):
        fired = ((reasons >> b) & 1) > 0
        per_pod_cols.append((fired & vmask).sum(1, dtype=i32))
        only = (reasons == (1 << b)) & vmask
        one_bit_cols.append(only.sum(1, dtype=i32))
        pod_bits = pod_bits + (1 << b) * (
            fired & node_valid[None, :]).any(1).to(i32)
    per_pod = torch.stack(per_pod_cols, 1)  # (P, B)
    one_bit = torch.stack(one_bit_cols, 1)  # (P, B)
    # argmax takes the FIRST maximal index, as jnp.argmax does
    best_bit = one_bit.argmax(1).to(i32)
    best_gain = one_bit.max(1).values
    feasible = ((reasons == 0) & vmask).sum(1, dtype=i32)
    pair_hist = per_pod.sum(0, dtype=i32)
    pods_blocked = (per_pod > 0).sum(0, dtype=i32)
    if req is not None:
        res_fired = (((reasons >> BIT["PodFitsResources"]) & 1) > 0) \
            & node_valid[None, :]
        insufficient = torch.stack([
            (res_fired & (req[:, r:r + 1] > free[None, :, r] + 1e-6)).sum(
                1, dtype=i32)
            for r in range(req.shape[1])], 1)  # (P, R)
        cond_fired = (((reasons >> BIT["CheckNodeCondition"]) & 1) > 0) \
            & node_valid[None, :]
        not_ready = (cond_fired & ~ready[None, :]).sum(1, dtype=i32)
        netun = (cond_fired & net_unavail[None, :]).sum(1, dtype=i32)
    else:
        insufficient = torch.zeros((P, 0), dtype=i32, device=reasons.device)
        not_ready = torch.zeros((P,), dtype=i32, device=reasons.device)
        netun = torch.zeros((P,), dtype=i32, device=reasons.device)
    return ExplainResult(per_pod, one_bit, best_bit, best_gain, feasible,
                         pair_hist, pods_blocked, pod_bits, insufficient,
                         not_ready, netun)


#: the (P,) fields of ExplainResult, in the column order of read_back
_POD_FIELDS = ("best_bit", "best_gain", "feasible", "pod_bits", "not_ready",
               "net_unavail")


def read_back(ex: ExplainResult) -> dict:
    """Every field of ``ex`` on the host, read back as ONE counted
    transfer of a flat int32 concatenation: a dict of int64 numpy arrays
    keyed like :class:`ExplainResult`."""
    P, B = ex.per_pod.shape
    R = ex.insufficient.shape[1]
    rows = torch.cat([ex.per_pod, ex.one_bit, ex.insufficient,
                      torch.stack([getattr(ex, f) for f in _POD_FIELDS], 1)],
                     1)
    W = rows.shape[1]
    flat = np.asarray(to_host(torch.cat(
        [rows.flatten(), ex.pair_hist, ex.pods_blocked])), np.int64)
    host = flat[: P * W].reshape(P, W)
    out = {"per_pod": host[:, :B], "one_bit": host[:, B:2 * B],
           "insufficient": host[:, 2 * B:2 * B + R],
           "pair_hist": flat[P * W:P * W + B],
           "pods_blocked": flat[P * W + B:]}
    for k, name in enumerate(_POD_FIELDS):
        out[name] = host[:, 2 * B + R + k]
    return out


# ---------------------------------------------------------------------------
# host-side report (decoded once per cycle at the existing host boundary)
# ---------------------------------------------------------------------------


@dataclass
class PodExplanation:
    """Why ONE pod stayed pending this cycle."""

    key: str = ""
    #: predicate name -> number of valid nodes it excluded
    reason_node_counts: Dict[str, int] = field(default_factory=dict)
    #: (predicate name, nodes a solo relaxation would open), best first
    relaxations: List[Tuple[str, int]] = field(default_factory=list)
    #: valid nodes with no failure bits — the pod was feasible somewhere
    #: but lost the in-batch capacity race (or an extender/plugin said no)
    feasible_nodes: int = 0
    #: scheduling attempts so far (backoff-map count incl. this cycle)
    attempts: int = 0
    #: seconds since the pod first entered the queue
    queue_residency_s: float = 0.0
    #: the scheduler's failure-reason tuple (plugin/gang/extender failures
    #: carry their status here even without predicate bits)
    reasons: Tuple[str, ...] = ()
    #: FitError-shaped message when the failure came from the filter pass
    message: str = ""

    def to_json(self) -> dict:
        return {
            "pod": self.key,
            "reason_node_counts": dict(self.reason_node_counts),
            "relaxations": [
                {"reason": r, "nodes_opened": n} for r, n in self.relaxations
            ],
            "feasible_nodes": self.feasible_nodes,
            "attempts": self.attempts,
            "queue_residency_s": round(self.queue_residency_s, 3),
            "reasons": list(self.reasons),
            "message": self.message,
        }


@dataclass
class UnschedulableReport:
    """One cycle's cluster-wide unschedulability rollup."""

    cycle: int = 0
    n_nodes: int = 0
    pods: Dict[str, PodExplanation] = field(default_factory=dict)
    #: predicate name -> total (pod, node) failure pairs
    reason_node_counts: Dict[str, int] = field(default_factory=dict)
    #: predicate name -> pods blocked by it on >= 1 node
    reason_pods: Dict[str, int] = field(default_factory=dict)

    def top_reasons(self, k: int = 3) -> List[Tuple[str, int]]:
        """Top-K predicates by blocked-pod count."""
        return sorted(
            self.reason_pods.items(), key=lambda kv: (-kv[1], kv[0])
        )[:k]

    def to_json(self) -> dict:
        return {
            "cycle": self.cycle,
            "nodes": self.n_nodes,
            "unschedulable": len(self.pods),
            "reason_node_counts": dict(self.reason_node_counts),
            "reason_pods": dict(self.reason_pods),
            "pods": sorted(self.pods),
        }


def build_report(
    cycle: int,
    n_nodes: int,
    pod_keys: List[str],
    rows: Iterable[int],
    ex: Optional[dict] = None,
    top_k: int = 3,
) -> UnschedulableReport:
    """Decode read-back :func:`explain_reduce` arrays into the report.

    ``pod_keys`` is the cycle batch in row order; ``rows`` holds the
    batch indices of the unschedulable pods under analysis (the explain
    arrays are batch-indexed, so the same index addresses both); ``ex``
    holds the HOST arrays keyed like :class:`ExplainResult` (None when the
    explain pass did not run — the report then carries only scheduler-level
    reasons filled in by the caller)."""
    rep = UnschedulableReport(cycle=cycle, n_nodes=n_nodes)
    for i in rows:
        key = pod_keys[i]
        pe = PodExplanation(key=key)
        if ex is not None:
            counts = ex["per_pod"][i]
            pe.reason_node_counts = {
                PREDICATE_BITS[b]: int(counts[b])
                for b in range(N_REASONS) if counts[b]
            }
            one = ex["one_bit"][i]
            order = sorted(
                (b for b in range(N_REASONS) if one[b]),
                key=lambda b: (-int(one[b]), b),
            )
            pe.relaxations = [
                (PREDICATE_BITS[b], int(one[b])) for b in order[:top_k]
            ]
            pe.feasible_nodes = int(ex["feasible"][i])
        rep.pods[key] = pe
    if ex is not None:
        rep.reason_node_counts = {
            PREDICATE_BITS[b]: int(ex["pair_hist"][b])
            for b in range(N_REASONS) if ex["pair_hist"][b]
        }
        rep.reason_pods = {
            PREDICATE_BITS[b]: int(ex["pods_blocked"][b])
            for b in range(N_REASONS) if ex["pods_blocked"][b]
        }
    return rep


def reason_message(name: str) -> str:
    """Human text for a predicate name (FitError vocabulary where one
    exists; the registration name otherwise)."""
    return REASON_MESSAGES.get(name, name)


def summarize_breakdown(reason_pods: Dict[str, int], n_nodes: int) -> str:
    """The ``0/N nodes are available: ...`` line for a cluster rollup —
    counts here are BLOCKED PODS per reason (the cluster view), sorted
    like sortReasonsHistogram sorts the per-pod node counts."""
    parts = sorted(
        f"{v} x {reason_message(k)}" for k, v in reason_pods.items())
    return (f"0/{n_nodes} nodes available for the residual queue: "
            + ", ".join(parts)) if parts else "no unschedulable pods"
