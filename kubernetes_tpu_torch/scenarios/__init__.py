"""Scenario packs: pluggable solve objectives and placement-quality
scores over the dense (P, N) formulation (the port of
``kubernetes_tpu/scenarios``).

The device cost terms and the quality reduction live in
:mod:`kubernetes_tpu_torch.ops.scenario_cost`; this package is the host
orchestration: the pack definitions (packs.py), the in-batch preemption
cascade (cascade.py), and the quality decode, gang bookkeeping and
solution scores (quality.py)."""

from kubernetes_tpu_torch.scenarios.cascade import (
    CascadeSelection,
    select_cascade,
)
from kubernetes_tpu_torch.scenarios.packs import (
    SCENARIO_REGISTRY,
    ConsolidationPack,
    GangTopologyPack,
    ScenarioPack,
    resolve_pack,
)
from kubernetes_tpu_torch.scenarios.quality import (
    decode_quality,
    gang_stats,
    node_resources_score,
)

__all__ = [
    "SCENARIO_REGISTRY",
    "CascadeSelection",
    "ConsolidationPack",
    "GangTopologyPack",
    "ScenarioPack",
    "decode_quality",
    "gang_stats",
    "node_resources_score",
    "resolve_pack",
    "select_cascade",
]
