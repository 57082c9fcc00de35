"""The plain reference: the scheduler's predicates and priorities for the
benchmark's pods, written out in NumPy from the published semantics
(``pkg/scheduler/algorithm/{predicates,priorities}`` of the upstream
release the program follows), and the judge that holds a run's
placements to them.

It reads only the plain tables of ``core/workload.py`` and the answers
the program gave (which pod went to which node in which cycle). It
imports nothing of the program and takes nothing the program made: the
cluster's state at every cycle is worked out again here from the
existing pods and the binds judged so far.

Scores are Go's integer arithmetic (MaxPriority 10, integer division).
Priorities that are the same on every node for these pods
(SelectorSpread with no owner, NodePreferAvoidPods with no annotation,
ImageLocality with no image, InterPodAffinity with no term) add a
constant to a pod's row and leave every gap unchanged, so they are left
out. Weights are the default provider's: 1 each.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

MAX_PRIORITY = 10
DEFAULT_MILLI_CPU = 100          # non_zero.go DefaultMilliCPURequest
DEFAULT_MEMORY = 200 * 2**20     # non_zero.go DefaultMemoryRequest

@dataclass
class State:
    """What is bound on each node: requests as asked (the fit) and with
    the scoring defaults for zero requests (the resource priorities)."""

    cpu: np.ndarray
    mem: np.ndarray
    pods: np.ndarray
    nz_cpu: np.ndarray
    nz_mem: np.ndarray

    @classmethod
    def empty(cls, n: int) -> "State":
        z = lambda: np.zeros(n, dtype=np.int64)  # noqa: E731
        return cls(z(), z(), z(), z(), z())

    def apply(self, pods, ids: np.ndarray, nodes: np.ndarray) -> None:
        cpu, mem = pods.cpu[ids], pods.mem[ids]
        np.add.at(self.cpu, nodes, cpu)
        np.add.at(self.mem, nodes, mem)
        np.add.at(self.pods, nodes, 1)
        np.add.at(self.nz_cpu, nodes,
                  np.where(cpu > 0, cpu, DEFAULT_MILLI_CPU))
        np.add.at(self.nz_mem, nodes,
                  np.where(mem > 0, mem, DEFAULT_MEMORY))


def pod_class(pods, i: int) -> tuple:
    """The attributes the predicates and priorities read: pods of one
    class have the same row."""
    return (int(pods.cpu[i]), int(pods.mem[i]), int(pods.pref_zone[i]),
            int(pods.pref_weight[i]), bool(pods.tolerates[i]))


def feasible(nodes, st: State, cpu, mem, cols=slice(None)) -> np.ndarray:
    """PodFitsResources (cpu, memory, pod count) of a pod asking ``cpu``
    and ``mem`` on each node (arrays broadcast: one row a pod class).
    The nodes carry no NoSchedule taint and the pods no required
    affinity, so PodToleratesNodeTaints and MatchNodeSelector pass
    everywhere."""
    return ((st.pods[cols] + 1 <= nodes.pods[cols])
            & (st.cpu[cols] + cpu <= nodes.cpu[cols])
            & (st.mem[cols] + mem <= nodes.mem[cols]))


def resource_scores(nodes, st: State, cpu, mem, cols=slice(None),
                    drop=()) -> np.ndarray:
    """LeastRequested + BalancedResourceAllocation of placing a pod
    asking ``cpu`` and ``mem`` on each node (``least_requested.go``,
    ``balanced_resource_allocation.go``), on the non-zero requests."""
    pc = np.where(np.asarray(cpu) > 0, cpu, DEFAULT_MILLI_CPU)
    pm = np.where(np.asarray(mem) > 0, mem, DEFAULT_MEMORY)
    rc, rm = st.nz_cpu[cols] + pc, st.nz_mem[cols] + pm
    cc, cm = nodes.cpu[cols], nodes.mem[cols]
    out = np.zeros(np.broadcast(rc, rm).shape, dtype=np.int64)
    if "LeastRequestedPriority" not in drop:
        def least(r, c):
            ok = (c > 0) & (r <= c)
            return np.where(ok, (c - r) * MAX_PRIORITY // np.maximum(c, 1),
                            0)
        out += (least(rc, cc) + least(rm, cm)) // 2
    if "BalancedResourceAllocation" not in drop:
        cf = rc / np.maximum(cc, 1)
        mf = rm / np.maximum(cm, 1)
        bal = ((1.0 - np.abs(cf - mf)) * MAX_PRIORITY).astype(np.int64)
        out += np.where((cf >= 1.0) | (mf >= 1.0), 0, bal)
    return out


def soft_scores(nodes, cls: tuple, fit: np.ndarray, drop=()) -> np.ndarray:
    """NodeAffinity's preferred terms and TaintToleration's
    PreferNoSchedule count, each NormalizeReduce'd over the pod's
    feasible nodes (``node_affinity.go``, ``taint_toleration.go``,
    ``reduce.go``)."""
    out = np.zeros(len(nodes), dtype=np.int64)
    if "NodeAffinityPriority" not in drop:
        raw = np.where(nodes.zone == cls[2], cls[3], 0) if cls[2] >= 0 \
            else np.zeros(len(nodes), dtype=np.int64)
        mx = int(raw[fit].max()) if fit.any() else 0
        if mx > 0:
            out += MAX_PRIORITY * raw // mx
    if "TaintTolerationPriority" not in drop:
        raw = (nodes.soft_taint & (not cls[4])).astype(np.int64)
        mx = int(raw[fit].max()) if fit.any() else 0
        out += (MAX_PRIORITY - MAX_PRIORITY * raw // mx if mx > 0
                else MAX_PRIORITY)
    return out


def class_row(nodes, st: State, cls: tuple, drop=()):
    """(feasible, score) of the class on every node."""
    fit = feasible(nodes, st, cls[0], cls[1])
    score = resource_scores(nodes, st, cls[0], cls[1], drop=drop) \
        + soft_scores(nodes, cls, fit, drop)
    return fit, score


# ---------------------------------------------------------------------------
# the judge
# ---------------------------------------------------------------------------


@dataclass
class Cycle:
    """One cycle as the harness saw it: the program's answers and the
    pending pods the traffic added after it."""

    bound: np.ndarray            # pod ids bound
    nodes: np.ndarray            # their nodes
    failed: np.ndarray           # pod ids reported unschedulable
    attempted: int
    rounds: int
    added: np.ndarray            # pod ids the traffic added after it


#: numbers whose limit is 0: an exact comparison
EXACT = ("predicate_violations", "over_capacity", "node_cap_excess",
         "double_binds", "unplaced_with_room", "lost", "idle_cycles")


def _room_for(nodes, pods, st: State, pending: np.ndarray) -> bool:
    """Whether some ``pending`` pod fits some node."""
    asks = np.unique(np.stack([pods.cpu[pending], pods.mem[pending]], 1),
                     axis=0)
    return any(feasible(nodes, st, c, m).any() for c, m in asks.tolist())


def judge(nodes, pods, prefill_ids: np.ndarray, prefill_nodes: np.ndarray,
          pending0: np.ndarray, cycles: Sequence[Cycle], per_node_cap: int,
          ) -> Dict[str, int]:
    """Replays the run and measures, over every cycle:

    - ``score_gap``: the widest gap by which a bound pod's node scores
      below the best node the reference finds for it, on the cluster as
      it stood when the cycle began;
    - ``predicate_violations``: binds to a node the pod does not fit at
      the cycle's start;
    - ``over_capacity``: nodes past their allocatable after a cycle;
    - ``node_cap_excess``: nodes given more pods in one cycle than the
      per-node cap admits over its rounds;
    - ``double_binds``: binds of a pod that was not pending;
    - ``unplaced_with_room``: pods reported unschedulable that fit a
      node at the cycle's start;
    - ``lost``: pods the cycle attempted and neither bound nor reported;
    - ``idle_cycles``: cycles that attempted nothing while a pending pod
      fit a node (on a full cluster there is nothing to attempt).
    """
    st = State.empty(len(nodes))
    st.apply(pods, prefill_ids, prefill_nodes)
    where = np.full(len(pods), -2, dtype=np.int64)  # -2 absent, -1 pending
    where[prefill_ids] = prefill_nodes
    where[pending0] = -1
    n = {k: 0 for k in EXACT}
    gap = 0
    for c in cycles:
        if c.attempted == 0 and _room_for(nodes, pods, st, where == -1):
            n["idle_cycles"] += 1
        rows: Dict[tuple, tuple] = {}

        def row(i):
            k = pod_class(pods, i)
            if k not in rows:
                rows[k] = class_row(nodes, st, k)
            return rows[k]

        ok = where[c.bound] == -1
        n["double_binds"] += int((~ok).sum())
        n["double_binds"] += len(c.bound) - len(np.unique(c.bound))
        for i, nd in zip(c.bound.tolist(), c.nodes.tolist()):
            fit, score = row(i)
            if not fit[nd]:
                n["predicate_violations"] += 1
                continue
            gap = max(gap, int(score[fit].max() - score[nd]))
        for i in c.failed.tolist():
            fit, _ = row(i)
            n["unplaced_with_room"] += int(fit.any())
        n["lost"] += max(c.attempted - len(c.bound) - len(c.failed), 0)
        if len(c.bound):
            per = np.bincount(c.nodes, minlength=len(nodes))
            n["node_cap_excess"] += int(
                (per > per_node_cap * max(c.rounds, 1)).sum())
        st.apply(pods, c.bound, c.nodes)
        where[c.bound] = c.nodes
        n["over_capacity"] += int(((st.cpu > nodes.cpu) | (st.mem > nodes.mem)
                                   | (st.pods > nodes.pods)).sum())
        where[c.added] = -1
    return {"score_gap": gap, **n}


# ---------------------------------------------------------------------------
# the control: the reference put in the program's place
# ---------------------------------------------------------------------------


class Greedy:
    """Places each batch pod by pod in queue order on the node the
    reference scores best (lowest index on a tie), with the priorities
    in ``drop`` left out: the control, which breaks the configured
    scoring on purpose. Keeps one score row per pod class and, after a
    placement, updates only the column it changed."""

    def __init__(self, nodes, pods, drop: Sequence[str] = ()) -> None:
        self.nodes, self.pods, self.drop = nodes, pods, tuple(drop)
        self.st = State.empty(len(nodes))
        self.index: Dict[tuple, int] = {}
        self.classes: List[tuple] = []
        n = len(nodes)
        self.fit = np.zeros((0, n), dtype=bool)
        self.score = np.zeros((0, n), dtype=np.int64)
        self.soft = np.zeros((0, n), dtype=np.int64)

    def _redo(self, c: int) -> None:
        k = self.classes[c]
        self.fit[c] = feasible(self.nodes, self.st, k[0], k[1])
        self.soft[c] = soft_scores(self.nodes, k, self.fit[c], self.drop)
        self.score[c] = resource_scores(self.nodes, self.st, k[0], k[1],
                                        drop=self.drop) + self.soft[c]

    def _class(self, i: int) -> int:
        k = pod_class(self.pods, i)
        c = self.index.get(k)
        if c is None:
            c = self.index[k] = len(self.classes)
            self.classes.append(k)
            self.fit, self.score, self.soft = (
                np.vstack([a, np.zeros((1, a.shape[1]), a.dtype)])
                for a in (self.fit, self.score, self.soft))
            self._redo(c)
        return c

    def _touch(self, nd: int) -> None:
        if not self.classes:
            return
        cpu = np.array([k[0] for k in self.classes])[:, None]
        mem = np.array([k[1] for k in self.classes])[:, None]
        cols = slice(nd, nd + 1)
        fit = feasible(self.nodes, self.st, cpu, mem, cols)[:, 0]
        for c in np.flatnonzero(fit != self.fit[:, nd]).tolist():
            self._redo(c)  # the normalizers may move: redo the row
        res = resource_scores(self.nodes, self.st, cpu, mem, cols,
                              self.drop)[:, 0]
        self.score[:, nd] = res + self.soft[:, nd]

    def move(self, i: int, nd: int) -> None:
        self.st.apply(self.pods, np.array([i]), np.array([nd]))
        self._touch(nd)

    def place(self, ids: Sequence[int]) -> Tuple[List[int], List[int]]:
        bound, where = [], []
        low = np.iinfo(np.int64).min
        for i in ids:
            c = self._class(i)
            if not self.fit[c].any():
                continue
            nd = int(np.argmax(np.where(self.fit[c], self.score[c], low)))
            bound.append(i)
            where.append(nd)
            self.move(i, nd)
        return bound, where
