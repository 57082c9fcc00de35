"""The system under test: ``kubernetes_tpu_torch``'s ``Scheduler``, built
with ``Scheduler.from_config`` from the configuration's v1alpha1
document and fed the plain tables as an informer would: nodes and
bound pods at sync, pending pods through ``on_pod_add`` and each bind
confirmed through ``on_pod_update`` (the watch's MODIFIED event).

From the program the benchmark takes only this: the scheduler, its
cycle results, the spans of its cycle trace and its kernels' launch
counters and names.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import List

import numpy as np

ZONE_LABEL = "failure-domain.beta.kubernetes.io/zone"
HOST_LABEL = "kubernetes.io/hostname"
POD_PREFIX = "p"
_KEY_SKIP = len("default/" + POD_PREFIX)
_NODE_SKIP = len("node-")


@dataclass
class CycleOut:
    """One cycle's answers in pod and node ids, and what the program
    reported about it."""

    bound: np.ndarray
    nodes: np.ndarray
    failed: np.ndarray
    attempted: int
    rounds: int
    host_syncs: int
    graph_captures: int
    spans: list = field(default_factory=list)  # (name, start, end, ancestors)
    cycle_span: tuple = ()  # (start, end) of the whole cycle


def flatten(span, ancestors=()) -> list:
    """A cycle trace's spans as (name, start, end, ancestor names),
    on the scheduler's clock, the root left out."""
    out = []
    for c in span.children:
        end = c.end if c.end is not None else c.start
        out.append((c.name, c.start, end, ancestors))
        out.extend(flatten(c, ancestors + (c.name,)))
    return out


class Program:
    def __init__(self, cfg: dict, nodes, pods, device: str) -> None:
        from kubernetes_tpu_torch.cli import decode_config
        from kubernetes_tpu_torch.scheduler import Scheduler

        self.nodes, self.pods = nodes, pods
        doc = dict(cfg["scheduler"])
        self.sched = Scheduler.from_config(decode_config(doc), device=device)
        self.objs: List[object] = [None] * len(pods)
        self._affinity = {}
        self._tolerations = ()

    # -- objects ------------------------------------------------------------

    def _node(self, i: int):
        from kubernetes_tpu_torch.api.types import Node, Resources, Taint

        n = self.nodes
        name = n.name(i)
        taints = ((Taint(n.soft_taint_key, "true", "PreferNoSchedule"),)
                  if n.soft_taint[i] else ())
        return Node(name=name,
                    labels={HOST_LABEL: name,
                            ZONE_LABEL: f"zone-{int(n.zone[i])}"},
                    allocatable=Resources(cpu_milli=int(n.cpu[i]),
                                          memory=int(n.mem[i]),
                                          pods=int(n.pods[i])),
                    taints=taints)

    def _affinity_for(self, zone: int, weight: int):
        """One Affinity per preferred zone, shared by the pods that
        prefer it (the program interns terms by value)."""
        from kubernetes_tpu_torch.api.types import (
            Affinity,
            NodeSelectorTerm,
            PreferredSchedulingTerm,
            Requirement,
        )

        key = (zone, weight)
        a = self._affinity.get(key)
        if a is None:
            term = NodeSelectorTerm((Requirement(ZONE_LABEL, "In",
                                                 (f"zone-{zone}",)),))
            a = self._affinity[key] = Affinity(node_preferred=(
                PreferredSchedulingTerm(weight=weight, preference=term),))
        return a

    def make(self, ids) -> None:
        """Builds the program's objects of pods ``ids``."""
        from kubernetes_tpu_torch.api.types import Affinity, Pod, Resources
        from kubernetes_tpu_torch.api.types import Toleration

        p = self.pods
        if not self._tolerations and self.nodes.soft_taint_key:
            self._tolerations = (Toleration(
                key=self.nodes.soft_taint_key, operator="Exists",
                effect="PreferNoSchedule"),)
        none = Affinity()
        cpu, mem = p.cpu.tolist(), p.mem.tolist()
        zone, weight = p.pref_zone.tolist(), p.pref_weight.tolist()
        tol = p.tolerates.tolist()
        for i in ids:
            self.objs[i] = Pod(
                name=f"{POD_PREFIX}{i}",
                requests=Resources(cpu_milli=cpu[i], memory=mem[i]),
                affinity=(self._affinity_for(zone[i], weight[i])
                          if zone[i] >= 0 else none),
                tolerations=self._tolerations if tol[i] else ())

    # -- informer events ----------------------------------------------------

    def sync_nodes(self) -> None:
        for i in range(len(self.nodes)):
            self.sched.on_node_add(self._node(i))

    def add_bound(self, ids: np.ndarray, nodes: np.ndarray) -> None:
        self.make(ids.tolist())
        for i, nd in zip(ids.tolist(), nodes.tolist()):
            obj = self.objs[i]
            obj.node_name = self.nodes.name(nd)
            self.sched.on_pod_add(obj)

    def add_pending(self, ids) -> None:
        objs, add = self.objs, self.sched.on_pod_add
        for i in ids:
            add(objs[i])

    def warmup(self, sample_ids) -> int:
        return self.sched.warmup(sample_pods=[self.objs[i]
                                              for i in sample_ids])

    def cycle(self) -> CycleOut:
        r = self.sched.schedule_cycle()
        keys = list(r.assignments)
        bound = np.fromiter((int(k[_KEY_SKIP:]) for k in keys), np.int64,
                            len(keys))
        nodes = np.fromiter((int(r.assignments[k][_NODE_SKIP:])
                             for k in keys), np.int64, len(keys))
        failed = np.fromiter((int(k[_KEY_SKIP:]) for k in r.failure_reasons),
                             np.int64, len(r.failure_reasons))
        root = self.sched.obs.last_trace.root
        return CycleOut(bound, nodes, failed, r.attempted, r.rounds,
                        r.host_syncs, r.graph_captures, flatten(root),
                        (root.start, root.end if root.end is not None
                         else root.start))

    def confirm(self, out: CycleOut) -> None:
        """The watch's MODIFIED event of every bind."""
        objs, upd = self.objs, self.sched.on_pod_update
        for i, nd in zip(out.bound.tolist(), out.nodes.tolist()):
            old = objs[i]
            new = copy.copy(old)
            new.node_name = self.nodes.name(nd)
            upd(old, new)
            objs[i] = new

    def close(self) -> None:
        self.sched = None
