"""Scenario packs — pluggable solve objectives over the dense (P, N)
formulation (the port of ``kubernetes_tpu/scenarios/packs.py``).

A :class:`ScenarioPack` owns three seams the scheduler threads through
its existing machinery (no solver forks):

- **weights** — a priority-weight override; the re-weighted kernels run
  on every tier of the degradation ladder, so the objective survives
  batch -> batch-cpu -> greedy unchanged;
- **cost** — an optional (P, N) term on the tables' device, folded into
  ``extra_score`` (the seam extenders and score plugins use), built by
  :mod:`kubernetes_tpu_torch.ops.scenario_cost`;
- **quality** — the cycle's placement-quality readback
  (``quality_reduce`` -> ``quality.decode_quality``) plus host-side gang
  bookkeeping, landing on the CycleResult, the flight record and
  ``scheduler_scenario_quality``.

Two packs ship:

- ``consolidation`` — bin packing: minimize the nodes used, maximize the
  priority-weighted headroom. MostRequested replaces the spreading
  objective, a flat occupied-node bias covers the open-a-new-node step,
  and preemption may run as an in-batch cascade (cascade.py).
- ``gang-topology`` — DL gangs score nodes by hierarchical slice
  distance to a per-gang home slice (biggest gang -> freest slice, a
  host greedy over the host mirror), with the scheduler's all-or-nothing
  groups keeping each gang atomic.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


class ScenarioPack:
    """Base pack: no cost term, no weight override, quality on."""

    name = ""
    #: route preemption through the in-batch cascade when the scenario
    #: config asks for it (consolidation turns this on)
    wants_cascade = False
    #: the cost term survives restriction to a candidate-column frame:
    #: ``cost`` depends on the node table's rows alone, so a gathered
    #: (P, C) sub-table sees the same per-column values. Packs that opt in
    #: ride the restricted and pipelined paths; unknown packs keep the
    #: dense oracle
    restricted_ok = False

    def __init__(self, config) -> None:
        self.config = config
        #: the cost weight as a 0-d f32 tensor, one per device, filled on
        #: the device (no host copy a sync-checked cycle would refuse)
        self._weights: Dict[tuple, torch.Tensor] = {}

    def weight_on(self, device) -> torch.Tensor:
        """``config.cost_weight`` as a 0-d f32 tensor on ``device``."""
        w = float(self.config.cost_weight)
        key = (str(device), w)
        t = self._weights.get(key)
        if t is None:
            t = torch.full((), w, dtype=torch.float32, device=device)
            self._weights = {key: t}
        return t

    def weights(self, base: Optional[Dict[str, float]]
                ) -> Optional[Dict[str, float]]:
        """Priority-weight override (None = keep the configured set)."""
        return base

    def cost(self, batch, nt, node_order, dp, dn):
        """Optional (P, N) score term for THIS cycle's solve, on ``dn``'s
        device (on a mesh, ``dn`` a ``parallel.mesh.ShardedNodes``: the
        ``parallel.mesh.Blocks`` of its shards' columns).
        ``batch``/``nt``/``node_order`` are host-side (a pack may derive
        small per-pod arrays from them: uploads only, never a readback);
        ``dp``/``dn`` are the cycle's device tables. None = no term."""
        return None

    def quality_host(self, batch, assigned, nt) -> Dict[str, float]:
        """Pack-specific host scores over the final assignment (already
        read back: zero extra readback bytes)."""
        return {}

    def candidate_hint(self, batch, nt, node_order) -> Optional[np.ndarray]:
        """(N,) bool host mask of the columns the restricted route must
        keep in its candidate frame for this batch, or None. It is only
        ever uploaded. Packs whose cost concentrates on specific columns
        (a gang's home slice) use it so the top-C cut cannot starve
        them."""
        return None


class ConsolidationPack(ScenarioPack):
    """Minimize-nodes-used / maximize-headroom under priority tiers."""

    name = "consolidation"
    # consolidation_bias is a per-column function of the node rows
    # (occupancy and row order), so restriction preserves it
    restricted_ok = True

    @property
    def wants_cascade(self) -> bool:
        return self.config.preempt_in_batch

    def weights(self, base):
        # the packing objective replaces the spreading one: fill the
        # fullest feasible node, keep cpu and memory balanced on it, drop
        # every spreading kernel; the bias below covers the step of
        # opening a new node
        return {
            "MostRequestedPriority": 3,
            "BalancedResourceAllocation": 1,
        }

    def cost(self, batch, nt, node_order, dp, dn):
        from kubernetes_tpu_torch.ops.scenario_cost import consolidation_bias

        return consolidation_bias(
            dp.valid, dn, self.weight_on(dp.valid.device),
            fill_block=self.config.fill_block)


class GangTopologyPack(ScenarioPack):
    """Topology-aware DL gangs: slice-distance cost to per-gang home
    slices, all-or-nothing groups (the scheduler's gang rollback)."""

    name = "gang-topology"
    # gang_topology_score is per-column (the distance of each node's zone
    # to the pod's home zone); candidate_hint keeps the home slices'
    # columns in the frame so restriction cannot strand a gang
    restricted_ok = True

    # graftlint: disable-scope=R7 -- nt is the HOST-mirror NodeTable
    # (numpy arrays the packer built on host); no device value ever
    # crosses here — the home-zone greedy is upload-only by design
    def _home_zones(self, batch, nt) -> np.ndarray:
        """(P,) int32 home slice per pod (-1 = gangless). A host greedy
        over the host mirror: gangs by total CPU demand descending (ties
        by name) each take the slice with the most free CPU left (the
        first on a tie, ``np.argmax``), and each pick debits the slice."""
        from kubernetes_tpu_torch.snapshot import RES_CPU

        zone = np.asarray(nt.zone_id)[: nt.n]
        free = np.maximum(
            np.asarray(nt.allocatable)[: nt.n, RES_CPU]
            - np.asarray(nt.requested)[: nt.n, RES_CPU], 0.0)
        n_zones = int(zone.max()) + 1 if zone.size and zone.max() >= 0 else 0
        zfree = np.zeros((max(n_zones, 1),), np.float64)
        for z in range(n_zones):
            zfree[z] = free[zone == z].sum()
        gangs: Dict[str, List[int]] = {}
        demand: Dict[str, float] = {}
        for i, p in enumerate(batch):
            if p.pod_group:
                gangs.setdefault(p.pod_group, []).append(i)
                demand[p.pod_group] = (demand.get(p.pod_group, 0.0)
                                       + p.requests.cpu_milli)
        home = np.full((len(batch),), -1, np.int32)
        if not gangs or n_zones == 0:
            return home
        for g in sorted(gangs, key=lambda g: (-demand[g], g)):
            z = int(np.argmax(zfree))
            zfree[z] -= demand[g]
            for i in gangs[g]:
                home[i] = z
        return home

    def cost(self, batch, nt, node_order, dp, dn):
        from kubernetes_tpu_torch.ops.arrays import upload
        from kubernetes_tpu_torch.ops.scenario_cost import gang_topology_score

        home = self._home_zones(batch, nt)
        P = dp.valid.shape[0]
        if P > home.shape[0]:  # padding rows are gangless
            home = np.concatenate(
                [home, np.full((P - home.shape[0],), -1, np.int32)])
        dev = dp.valid.device
        return gang_topology_score(
            upload(home, dev), dn, self.weight_on(dev),
            superpod=self.config.superpod)

    # graftlint: disable-scope=R7 -- nt is the HOST-mirror NodeTable
    # (numpy); the hint mask is derived host-side and uploaded only
    def candidate_hint(self, batch, nt, node_order) -> Optional[np.ndarray]:
        """Keep every column inside a gang's home slice: the top-C rank
        knows nothing of slice distance, so without the hint a hot but
        remote candidate set could leave a gang no home-slice column and
        force the dense fallback."""
        home = self._home_zones(batch, nt)
        zones = np.unique(home[home >= 0])
        if zones.size == 0:
            return None
        zone = np.asarray(nt.zone_id)[: nt.n]
        return np.isin(zone, zones)

    # graftlint: disable-scope=R7 -- nt is the HOST-mirror NodeTable
    # (numpy); gang bookkeeping reads host arrays only
    def quality_host(self, batch, assigned, nt) -> Dict[str, float]:
        from kubernetes_tpu_torch.scenarios.quality import gang_stats

        return gang_stats(batch, assigned,
                          zone_of_node=np.asarray(nt.zone_id)[: nt.n],
                          superpod=self.config.superpod)


#: pack name -> class; "" stays unregistered (scenario mode off)
SCENARIO_REGISTRY = {
    ConsolidationPack.name: ConsolidationPack,
    GangTopologyPack.name: GangTopologyPack,
}


def resolve_pack(config) -> Optional[ScenarioPack]:
    """ScenarioConfig -> pack instance (None when ``pack`` is empty).
    Unknown names fail loudly: ``cli.validate_config`` rejects them up
    front, and this guard covers direct constructor callers."""
    if config is None or not getattr(config, "pack", ""):
        return None
    cls = SCENARIO_REGISTRY.get(config.pack)
    if cls is None:
        raise ValueError(
            f"scenario.pack: unknown pack {config.pack!r} "
            f"(known: {sorted(SCENARIO_REGISTRY)})")
    return cls(config)
