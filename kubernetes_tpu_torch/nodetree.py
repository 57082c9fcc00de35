"""NodeTree + adaptive node-search truncation (the port's copy of
``kubernetes_tpu/nodetree.py``).

- :class:`NodeTree` — zone-aware round-robin node enumeration
  (``pkg/scheduler/internal/cache/node_tree.go:31``; ``Next()`` :162):
  consecutive enumerations start where the last stopped and interleave
  zones, so a truncated search spreads load across zones between cycles.
- :func:`num_feasible_nodes_to_find` — the percentageOfNodesToScore
  subsampling rule (``generic_scheduler.go:437``; defaults
  ``api/types.go:40``): adaptive 50%→5%, minimum 100 nodes.

The dense batch solver does not need subsampling below ~5k nodes (one
fused pass scores everything), but the truncation remains available for
(a) reference-parity runs and (b) capping device work on very large
snapshots: the driver turns the subset into an extra column mask.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from kubernetes_tpu_torch.api.types import Node

#: generic_scheduler.go:53-62
MIN_FEASIBLE_NODES_TO_FIND = 100
MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND = 5
#: api/types.go:40
DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE = 50


def num_feasible_nodes_to_find(
    num_all_nodes: int, percentage: int = 0
) -> int:
    """numFeasibleNodesToFind (generic_scheduler.go:437). ``percentage``
    0 = adaptive default."""
    if (
        num_all_nodes < MIN_FEASIBLE_NODES_TO_FIND
        or percentage >= 100
    ):
        return num_all_nodes
    adaptive = percentage
    if adaptive <= 0:
        adaptive = DEFAULT_PERCENTAGE_OF_NODES_TO_SCORE - num_all_nodes // 125
        if adaptive < MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND:
            adaptive = MIN_FEASIBLE_NODES_PERCENTAGE_TO_FIND
    num = num_all_nodes * adaptive // 100
    if num < MIN_FEASIBLE_NODES_TO_FIND:
        return MIN_FEASIBLE_NODES_TO_FIND
    return num


class NodeTree:
    """Zone -> node-name lists with a resumable round-robin cursor."""

    def __init__(self) -> None:
        self._zones: List[str] = []  # insertion-ordered zone keys
        self._nodes: Dict[str, List[str]] = {}
        self._zone_idx = 0
        self._node_idx: Dict[str, int] = {}
        self.num_nodes = 0

    @staticmethod
    def _zone_of(node: Node) -> str:
        zk = node.zone_key()
        return f"{zk[0]}:{zk[1]}" if zk else ""

    def add_node(self, node: Node) -> None:
        z = self._zone_of(node)
        if z not in self._nodes:
            self._zones.append(z)
            self._nodes[z] = []
            self._node_idx[z] = 0
        if node.name not in self._nodes[z]:
            self._nodes[z].append(node.name)
            self.num_nodes += 1

    def remove_node(self, node: Node) -> None:
        z = self._zone_of(node)
        names = self._nodes.get(z)
        if names and node.name in names:
            names.remove(node.name)
            self.num_nodes -= 1
            if not names:
                del self._nodes[z]
                self._zones.remove(z)
                self._node_idx.pop(z, None)

    def next(self) -> Optional[str]:
        """node_tree.go:162 Next(): round-robin over zones, resuming."""
        if not self._zones:
            return None
        for _ in range(len(self._zones)):
            if self._zone_idx >= len(self._zones):
                self._zone_idx = 0
            z = self._zones[self._zone_idx]
            names = self._nodes[z]
            i = self._node_idx[z]
            if i >= len(names):
                # zone exhausted this sweep: reset and move on
                self._node_idx[z] = 0
                self._zone_idx += 1
                continue
            self._node_idx[z] = i + 1
            self._zone_idx += 1
            return names[i]
        # all zones exhausted simultaneously: start a fresh sweep
        for z in self._zones:
            self._node_idx[z] = 0
        self._zone_idx = 0
        return self.next() if self.num_nodes else None

    def take(self, n: int) -> List[str]:
        """The next ``n`` distinct nodes in rotation order (≤ num_nodes)."""
        n = min(n, self.num_nodes)
        out: List[str] = []
        seen = set()
        while len(out) < n:
            name = self.next()
            if name is None:
                break
            if name in seen:
                continue
            seen.add(name)
            out.append(name)
        return out
