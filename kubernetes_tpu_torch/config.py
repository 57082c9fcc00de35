"""Scheduler configuration blocks of the port (copies of the dataclasses of
``kubernetes_tpu/config.py`` that the port's scheduler reads; the
reference module imports its predicate table, so the port keeps its own
copy instead of importing it)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class IncrementalConfig:
    """Incremental solve: make the steady-state cycle cost proportional to
    CHURN instead of the full (P x N) plane. Three coupled pieces ride
    this block: the device-resident per-node score summary
    (``cache.py`` + ``ops/fused_score.py``: clean node columns reused
    across cycles, dirty columns patched in the same delta drain as the
    snapshot), the restricted solve (the micro-batch solves against a
    bounded candidate-column bucket gathered from the resident table
    instead of every node), and warm-started Sinkhorn potentials carried
    across rounds and cycles. The dense solve remains the correctness
    fallback: on pack-epoch growth, interner growth, a node-set change or
    a dirty-frac blowout the cache drops and the next cycle solves cold.
    (Fields and defaults of ``kubernetes_tpu/config.py:448``.)"""

    enabled: bool = False
    #: candidate node columns the restricted solve gathers (snapped UP to
    #: a power of two). Cycles where the padded cluster is not strictly
    #: larger than the bucket take the dense solve
    candidate_bucket: int = 256
    #: restricted solves admit at most candidate_bucket * this many pods
    #: per cycle (larger micro-batches could exhaust the candidate
    #: columns' capacity and under-place against the dense solve)
    max_batch_frac: float = 0.5
    #: dirty-column fraction above which the score summary is dropped and
    #: the cycle solves cold
    max_dirty_frac: float = 0.25
    #: carry the previous solve's Sinkhorn potentials across rounds and
    #: cycles when the sinkhorn tier runs the restricted route
    warm_potentials: bool = True
    #: early-exit tolerance of warm-started Sinkhorn scaling: a warm
    #: residual already under it exits after one verification iteration
    warm_tol: float = 1e-3
    #: documented bound on the warm-vs-cold placement-quality delta (mean
    #: lean score, fraction)
    quality_delta: float = 0.02
    #: sparsity-first routing: full-snapshot cycles solve PARTITIONED
    #: (capacity-balanced restricted blocks plus one remainder pass)
    #: before the dense plane is ever built; the dense solve stays the
    #: fallback for declined or under-placed attempts
    primary: bool = False
    #: block count of the partitioned cold solve; 0 = auto (the padded
    #: node bucket over the candidate bucket, capped at 8)
    cold_blocks: int = 0
    #: auto-tune the candidate bucket from observed micro-batch sizes and
    #: placement depth; without a warmed ladder of buckets it stays
    #: pinned to ``candidate_bucket``
    auto_tune: bool = False
    #: fraction of the candidate bucket that group hints may claim
    group_quota_frac: float = 0.5
