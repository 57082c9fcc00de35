"""In-batch preemption cascade — the scenario packs' replacement for the
per-pod nominate-and-wait preemption loop (the port of
``kubernetes_tpu/scenarios/cascade.py``).

- **Victim selection stays exact and shared**: each preemptor runs the
  port's own :func:`kubernetes_tpu_torch.preemption.preempt` (candidate
  pruning by resolvable reason bits, the reprieve loop, PDB splits, the
  node pick), so a single-pod batch selects the stock path's victim set
  by construction. The cascade part: preemptors run in priority order
  against ONE shared hypothetical state, so an earlier preemptor's
  evictions are visible to later ones (no victim claimed twice, no
  phantom capacity).
- **Re-entry is the dense solve**: the scheduler evicts every selected
  victim (grace 0) and runs preemptors and displaced victims through one
  more dense solve in the same cycle (``Scheduler._cascade_solve``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import Pod
from kubernetes_tpu_torch.preemption import preempt


@dataclass
class CascadeSelection:
    """What the shared-state selection pass decided."""

    #: preemptor pod key -> node chosen for it (the evacuated node)
    chosen: Dict[str, str] = field(default_factory=dict)
    #: every victim selected across the cascade, in eviction order
    victims: List[Pod] = field(default_factory=list)
    #: victim key -> the preemptor key that claimed it
    victim_of: Dict[str, str] = field(default_factory=dict)
    #: pods whose lower-priority nominations must clear (stock semantics)
    clear_nominations: List[Pod] = field(default_factory=list)
    num_pdb_violations: int = 0


def select_cascade(
    preemptors: List[Tuple[Pod, Dict[str, int]]],
    nodes,
    node_pods_of: Dict[str, List[Pod]],
    pdbs=(),
    nominated_pods_of: Optional[Dict[str, List[Pod]]] = None,
    vol_state=None,
    extenders=(),
    enable_non_preempting: bool = False,
    max_preemptions: int = 16,
    on_attempt=None,
) -> CascadeSelection:
    """Run victim selection for every preemptor against one shared state.
    ``preemptors`` is [(pod, reason_bits_by_node)] already in
    priority-descending order (the caller sorts, as the stock loop does).
    Selected victims leave the shared ``node_pods_of`` view before the
    next preemptor runs, which IS the cascade. ``on_attempt`` fires once
    per pod processed (after the cap check), the stock loop's accounting
    of ``scheduler_preemption_attempts_total``."""
    sel = CascadeSelection()
    state = {k: list(v) for k, v in node_pods_of.items()}
    # the nominated view evolves like the stock loop's (which re-reads
    # queue.nominated every iteration): each successful preemptor joins
    # its chosen node as a phantom occupant and its cleared lower-priority
    # nominations leave, or a later preemptor would see the evacuated
    # capacity as free and evict more than the stock path
    nom = {k: list(v) for k, v in (nominated_pods_of or {}).items()}
    done = 0
    for pod, reason_bits in preemptors:
        if done >= max_preemptions:
            break
        if on_attempt is not None:
            on_attempt()
        result = preempt(
            pod, nodes, state, reason_bits, pdbs,
            nominated_pods_of=nom,
            vol_state=vol_state,
            extenders=extenders,
            enable_non_preempting=enable_non_preempting,
        )
        if result is None:
            continue
        sel.chosen[pod.key()] = result.node_name
        sel.num_pdb_violations += result.num_pdb_violations
        sel.clear_nominations.extend(result.clear_nominations)
        for v in result.victims:
            sel.victims.append(v)
            sel.victim_of[v.key()] = pod.key()
            state[result.node_name] = [
                p for p in state[result.node_name] if p.key() != v.key()
            ]
        cleared = {p.key() for p in result.clear_nominations}
        nom[result.node_name] = [
            p for p in nom.get(result.node_name, [])
            if p.key() not in cleared
        ] + [pod]
        done += 1
    return sel
