"""String interning — the bridge between the reference's string-keyed maps
and dense integer tensor axes.

The reference scheduler compares strings everywhere (label keys/values, taint
keys, node names, image names). On TPU those comparisons become integer-id
set operations over multihot encodings, so every string universe gets a
stable int32 id space. Analogous in role to the label/topology-pair maps the
reference precomputes per cycle (``predicates/metadata.go:65``
topologyPairsMaps) — but interning is global and incremental, not per-cycle.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterable, List


class Interner:
    """Monotonic Hashable -> int32 id assignment. Ids are dense from 0 and
    never reused, so device-side multihot layouts stay valid as the universe
    grows (arrays are padded to bucketed sizes; see snapshot packing)."""

    def __init__(self) -> None:
        self._ids: Dict[Hashable, int] = {}
        self._items: List[Hashable] = []

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, item: Hashable) -> bool:
        return item in self._ids

    def intern(self, item: Hashable) -> int:
        i = self._ids.get(item)
        if i is None:
            i = len(self._items)
            self._ids[item] = i
            self._items.append(item)
        return i

    def intern_all(self, items: Iterable[Hashable]) -> List[int]:
        return [self.intern(it) for it in items]

    def lookup(self, item: Hashable) -> int:
        """-1 if unknown (unknown => cannot match anything interned)."""
        return self._ids.get(item, -1)

    def item(self, i: int) -> Hashable:
        return self._items[i]

    def items(self) -> List[Hashable]:
        return list(self._items)


def bucket_size(n: int, minimum: int = 8) -> int:
    """Round ``n`` up to the next power-of-two-ish bucket so tensor shapes
    change rarely (avoids XLA recompilation storms — SURVEY.md §7.3.6)."""
    size = max(minimum, 1)
    while size < n:
        size *= 2
    return size
