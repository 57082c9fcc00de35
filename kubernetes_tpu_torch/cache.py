"""Scheduler cache — in-memory truth about nodes and (assumed) pods, with
generation-tracked incremental snapshot packing and a device-resident
node table (the port of ``kubernetes_tpu/cache.py``).

Reference: ``pkg/scheduler/internal/cache/cache.go``.

1. **Assumed-pod state machine** (``cache/interface.go:36-47``): the scheduler
   assumes a pod onto its chosen node the moment the algorithm picks it,
   so the next cycle sees the capacity as used while the binding is in
   flight. FinishBinding starts a TTL; if the bound pod's add never
   arrives from the watch before the TTL, the assumption expires
   (``cache.go:674`` cleanupAssumedPods). ForgetPod undoes an assumption.

2. **Incremental snapshots** (``cache.go:211`` UpdateNodeInfoSnapshot):
   every mutation marks its node dirty; snapshotting repacks only dirty
   rows (a full repack happens only when the node set or the universe
   widths change). :meth:`SchedulerCache.device_snapshot` keeps the
   packed table on the device across cycles and patches dirty rows in
   place.

3. **Score summary** (the incremental solve's seam): when the scheduler
   turns it on (:meth:`SchedulerCache.enable_score_cache`), a per-node
   summary of the score plane (``ops/fused_score.NodeSummary``) lives
   beside the resident table under the same full-vs-delta discipline: a
   full upload drops it (rebuilt lazily by :meth:`score_summary`) and
   bumps ``summary_generation``; a delta drain patches exactly the rows
   it scatters, in the same drain; a clean cycle touches nothing.

4. **Device loss**: ``fault_injector`` (the scheduler attaches its own) is
   consulted at the head of :meth:`SchedulerCache.device_snapshot`, the
   ``snapshot:device`` chaos seam, so an injected ``device_lost`` /
   ``device_oom`` raises where a real CUDA error in the upload or the
   scatter would; :meth:`SchedulerCache.drop_device_snapshot` releases the
   resident tensors for the rebuild (the scheduler's
   ``_device_snapshot_recovering``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from kubernetes_tpu_torch.api.types import Node, Pod
from kubernetes_tpu_torch.sanitize import assert_held, make_lock
from kubernetes_tpu_torch.snapshot import NodeTable, SnapshotPacker

#: cache.go — factory.NewConfigFactory wires a 30 s assumed-pod TTL.
DEFAULT_ASSUME_TTL_S = 30.0

# assumed-pod states
_ASSUMED = "assumed"  # Assume() called, bind in flight
_EXPIRING = "expiring"  # FinishBinding() called, TTL armed
_ADDED = "added"  # confirmed via watch AddPod


class CacheError(Exception):
    pass


def tree_nbytes(tables) -> int:
    """Bytes held by the tensors of a NamedTuple table."""
    return sum(t.numel() * t.element_size() for t in tables)


class SchedulerCache:
    """Host-side cluster cache plus the device-resident node table. The
    scheduler is a single loop; the watch pump calls the mutators between
    cycles. ``device`` is where :meth:`device_snapshot` keeps the table."""

    def __init__(
        self,
        packer: Optional[SnapshotPacker] = None,
        ttl_s: float = DEFAULT_ASSUME_TTL_S,
        clock: Callable[[], float] = time.monotonic,
        max_dirty_frac: float = 0.25,
        device="cuda",
        lock_factory=None,
    ) -> None:
        import torch

        self.packer = packer or SnapshotPacker()
        self.ttl_s = ttl_s
        self.clock = clock
        self.device = torch.device(device)
        self._nodes: Dict[str, Node] = {}
        self._pods_by_node: Dict[str, Dict[str, Pod]] = {}
        self._pod_state: Dict[str, str] = {}  # key -> assumed state
        self._pod_node: Dict[str, str] = {}  # key -> node name
        self._pod_deadline: Dict[str, float] = {}  # key -> expiry (EXPIRING)
        self._dirty: Set[str] = set()  # node names needing row repack
        self._shape_dirty = True  # node set / widths changed => full repack
        self._table: Optional[NodeTable] = None
        self._row_of: Dict[str, int] = {}
        self._widths_key: Optional[Tuple] = None
        #: dirty-row fraction above which patching the resident device
        #: table costs more than re-uploading it
        self.max_dirty_frac = max_dirty_frac
        self._dev = None  # resident ops.arrays.DeviceNodes
        self._dev_pad: int = 0  # its padded row count
        #: host refreshes the device hasn't applied yet: [(idx, sub)]
        self._pending_dev: List[Tuple[List[int], NodeTable]] = []
        #: a full host repack happened since the device last uploaded
        self._dev_stale: bool = True
        #: serializes snapshot refreshes: the mutators and the refresh
        #: share the host table and the pending-delta queue
        self._snap_lock = make_lock(lock_factory, "cache.snap", "rlock")
        #: how the last device_snapshot() was produced: full | delta | clean
        self.last_snapshot_mode: str = ""
        #: host rows (re)packed + uploaded by the last call
        self.last_upload_rows: int = 0
        #: bytes the last call moved to the device
        self.last_upload_nbytes: int = 0
        # ---- the incremental solve's score summary ---------------------
        #: resident NodeSummary aligned row for row with the resident
        #: table (None until first asked for after a full upload)
        self._summary = None
        #: bumps whenever the summary's rows are rebuilt from scratch
        #: (full upload, drop, enable): the scheduler keys its warm
        #: Sinkhorn potentials on it
        self.summary_generation = 0
        #: node rows the last device_snapshot() patched (the cycle's dirty
        #: frontier; empty on clean and full snapshots)
        self.last_patched_idx: List[int] = []
        self._score_cache_on = False
        self._summary_flags = {"honor_conditions": True,
                               "prefer_packed": False}
        #: the last score_summary() call rebuilt the summary from scratch
        self.last_summary_rebuilt = False
        #: faults.FaultInjector (or None): the ``snapshot:device`` chaos
        #: seam, attached by the scheduler that owns this cache
        self.fault_injector = None

    # -- introspection -----------------------------------------------------

    def node(self, name: str) -> Optional[Node]:
        return self._nodes.get(name)

    def nodes(self) -> List[Node]:
        return list(self._nodes.values())

    def pods_on(self, node_name: str) -> List[Pod]:
        return list(self._pods_by_node.get(node_name, {}).values())

    def pod_count(self) -> int:
        return sum(len(m) for m in self._pods_by_node.values())

    def group_members(self, group: str) -> int:
        """Count of cached pods (assumed or bound) carrying ``pod_group ==
        group`` — the gang gate's credit for members placed in earlier
        cycles."""
        return sum(1 for m in self._pods_by_node.values()
                   for p in m.values() if p.pod_group == group)

    def node_count(self) -> int:
        return len(self._nodes)

    def is_assumed(self, pod_key: str) -> bool:
        return self._pod_state.get(pod_key) in (_ASSUMED, _EXPIRING)

    def assumed_keys(self) -> List[str]:
        """Keys of every pod still in an assumed state (ASSUMED or
        EXPIRING) — what a takeover reconciliation diffs against the
        relisted truth, and what a deposed leader drains."""
        return [k for k, st in self._pod_state.items()
                if st in (_ASSUMED, _EXPIRING)]

    def pod_states(self) -> Dict[str, str]:
        """key -> "assumed" | "bound" for every cached pod — the
        state-conservation auditor's view (obs/audit.py): assumed covers
        ASSUMED and EXPIRING (bind in flight / TTL armed), bound is the
        watch-confirmed ADDED state."""
        return {k: ("assumed" if s in (_ASSUMED, _EXPIRING) else "bound")
                for k, s in self._pod_state.items()}

    def pod(self, key: str) -> Optional[Pod]:
        node = self._pod_node.get(key)
        if node is None:
            return None
        return self._pods_by_node.get(node, {}).get(key)

    # -- assumed-pod state machine ----------------------------------------

    def assume_pod(self, pod: Pod, node_name: str) -> None:
        """cache.go:275 AssumePod — place the pod in the cache now, before
        the binding is durable."""
        key = pod.key()
        if key in self._pod_state:
            raise CacheError(
                f"pod {key} already in cache ({self._pod_state[key]})")
        self.packer.intern_pod(pod)
        p = dataclasses.replace(pod, node_name=node_name)
        self._pods_by_node.setdefault(node_name, {})[key] = p
        self._pod_state[key] = _ASSUMED
        self._pod_node[key] = node_name
        self._mark_dirty(node_name)

    def finish_binding(self, pod_key: str) -> None:
        """cache.go FinishBinding — arm the TTL."""
        if self._pod_state.get(pod_key) == _ASSUMED:
            self._pod_state[pod_key] = _EXPIRING
            self._pod_deadline[pod_key] = self.clock() + self.ttl_s

    def forget_pod(self, pod_key: str) -> None:
        """cache.go ForgetPod — undo an assumption (bind failed)."""
        if self._pod_state.get(pod_key) not in (_ASSUMED, _EXPIRING):
            raise CacheError(f"pod {pod_key} is not assumed")
        self._drop_pod(pod_key)

    def pop_expired(self) -> List[Pod]:
        """cache.go:674 cleanupAssumedPods — expire overdue assumptions,
        returning the expired pods (node_name still set) so the scheduler
        can requeue them."""
        now = self.clock()
        expired_keys = [
            k for k, d in self._pod_deadline.items()
            if d <= now and self._pod_state.get(k) == _EXPIRING
        ]
        out: List[Pod] = []
        for k in expired_keys:
            p = self.pod(k)
            self._drop_pod(k)
            if p is not None:
                out.append(p)
        return out

    def cleanup_expired(self) -> List[str]:
        """Key-returning wrapper over :meth:`pop_expired` (the reference's
        original surface)."""
        return [p.key() for p in self.pop_expired()]

    # -- watch-driven mutations -------------------------------------------

    def add_pod(self, pod: Pod) -> None:
        """Watch AddPod for an assigned pod: confirms an assumption or adds
        an unseen pod (cache.go AddPod)."""
        key = pod.key()
        state = self._pod_state.get(key)
        if state in (_ASSUMED, _EXPIRING):
            if self._pod_node.get(key) != pod.node_name:
                # assumed onto the wrong node — trust the API
                self._drop_pod(key)
                self._insert_pod(pod)
            else:
                self._pod_state[key] = _ADDED
                self._pod_deadline.pop(key, None)
                self._pods_by_node[pod.node_name][key] = pod
                self._mark_dirty(pod.node_name)
        elif state is None:
            self._insert_pod(pod)
        else:  # duplicate add — treat as update
            self.update_pod(pod)

    def update_pod(self, pod: Pod) -> None:
        key = pod.key()
        old_node = self._pod_node.get(key)
        if old_node is None or old_node != pod.node_name:
            if old_node is not None:
                self._drop_pod(key)
            self._insert_pod(pod)
            return
        self.packer.intern_pod(pod)
        self._pods_by_node[old_node][key] = pod
        self._mark_dirty(old_node)

    def remove_pod(self, pod_key: str) -> None:
        if pod_key in self._pod_node:
            self._drop_pod(pod_key)

    def add_node(self, node: Node) -> None:
        self.packer.intern_node(node)
        self._nodes[node.name] = node
        self._pods_by_node.setdefault(node.name, {})
        self._shape_dirty = True

    def update_node(self, node: Node) -> None:
        if node.name not in self._nodes:
            self.add_node(node)
            return
        self.packer.intern_node(node)
        self._nodes[node.name] = node
        self._mark_dirty(node.name)

    def remove_node(self, name: str) -> None:
        self._nodes.pop(name, None)
        # pods on the node stay until their own delete events arrive
        self._shape_dirty = True

    # -- internals ---------------------------------------------------------

    def _insert_pod(self, pod: Pod) -> None:
        if not pod.node_name:
            raise CacheError(f"pod {pod.key()} has no node assignment")
        self.packer.intern_pod(pod)
        self._pods_by_node.setdefault(pod.node_name, {})[pod.key()] = pod
        self._pod_state[pod.key()] = _ADDED
        self._pod_node[pod.key()] = pod.node_name
        self._mark_dirty(pod.node_name)

    def _drop_pod(self, key: str) -> None:
        node = self._pod_node.pop(key)
        self._pod_state.pop(key, None)
        self._pod_deadline.pop(key, None)
        pods = self._pods_by_node.get(node)
        if pods:
            pods.pop(key, None)
        self._mark_dirty(node)

    def _mark_dirty(self, node_name: str) -> None:
        if node_name in self._nodes:
            self._dirty.add(node_name)

    def invalidate_snapshot(self) -> None:
        """Force a full repack on the next snapshot (state outside the
        node/pod tables changed row contents, e.g. a PVC rebinding)."""
        self._shape_dirty = True

    # -- snapshot ----------------------------------------------------------

    def _refresh_host(self):
        with self._snap_lock:
            return self._refresh_host_locked()

    def _refresh_host_locked(self):
        """Bring the cached host NodeTable up to date. Returns ``(table,
        mode, idx, sub)`` where mode is ``full`` | ``clean`` | ``delta``;
        on ``delta``, ``idx`` is the patched row indices and ``sub`` the
        delta NodeTable whose row j landed at ``idx[j]``. Every delta is
        also queued for the device table (``_pending_dev``)."""
        assert_held(self._snap_lock, "cache._refresh_host_locked")
        # the EXACT universe signature, not the bucketed widths: interner
        # growth within a bucket still changes clean rows
        wkey = self.packer.universe_node_sig()
        if self._shape_dirty or self._table is None or wkey != self._widths_key:
            self._dev_stale = True
            self._pending_dev.clear()
            return self._full_repack(), "full", None, None
        if not self._dirty:
            return self._table, "clean", None, None
        # incremental: pack_nodes row computation is node-local, so a
        # subset pack yields rows identical to a full pack
        dirty = [n for n in self._dirty if n in self._nodes]
        sub_nodes = [self._nodes[n] for n in dirty]
        sub_pods = [p for n in dirty
                    for p in self._pods_by_node.get(n, {}).values()]
        sub = self.packer.pack_nodes_delta(sub_nodes, sub_pods)
        if self.packer.universe_node_sig() != wkey:
            # packing grew a universe mid-flight — fall back to full
            self._dev_stale = True
            self._pending_dev.clear()
            return self._full_repack(), "full", None, None
        t = self._table
        idx = []
        for j, name in enumerate(dirty):
            i = self._row_of[name]
            idx.append(i)
            for f in dataclasses.fields(NodeTable):
                if f.name in ("n", "zone_valid"):
                    continue
                getattr(t, f.name)[i] = getattr(sub, f.name)[j]
        self._table = dataclasses.replace(t, zone_valid=sub.zone_valid)
        self._dirty.clear()
        if self._dev is not None and not self._dev_stale:
            self._pending_dev.append((idx, sub))
        return self._table, "delta", idx, sub

    def device_snapshot(self):
        """The device-resident snapshot: returns ``(table, dev, mode)``
        where ``dev`` is a DeviceNodes that lives on ``self.device`` across
        cycles. A clean cache returns the resident tensors untouched; a
        small dirty set re-packs only those rows and copies them into the
        resident tensors in place; a full upload happens on node-set or
        universe-width changes, explicit invalidation, or when the dirty
        fraction exceeds ``max_dirty_frac``."""
        with self._snap_lock:
            return self._device_snapshot_locked()

    def _device_snapshot_locked(self):
        assert_held(self._snap_lock, "cache._device_snapshot_locked")
        from kubernetes_tpu_torch.ops.arrays import (
            nodes_to_device,
            scatter_node_rows,
        )
        from kubernetes_tpu_torch.utils.interner import bucket_size

        if self.fault_injector is not None:
            # chaos seam: an armed device_lost/device_oom rule raises
            # here, standing in for a CUDA error during the upload or the
            # scatter; the scheduler's recovery drops the resident table
            # and rebuilds it from the host mirror
            self.fault_injector.device_hook("snapshot:device")
        table, _mode, _idx, _sub = self._refresh_host()
        n_pad = bucket_size(max(table.n, 1))
        self.last_upload_rows = 0
        self.last_upload_nbytes = 0
        self.last_patched_idx = []
        pending_rows = sum(len(i) for i, _ in self._pending_dev)
        if (self._dev is None or self._dev_stale or n_pad != self._dev_pad
                or pending_rows > self.max_dirty_frac * max(table.n, 1)):
            self._pending_dev.clear()
            self._dev = nodes_to_device(table, pad_to=n_pad,
                                        device=self.device)
            self._dev_pad = n_pad
            self._dev_stale = False
            self.last_snapshot_mode = "full"
            self.last_upload_rows = table.n
            self.last_upload_nbytes = tree_nbytes(self._dev)
            if self._score_cache_on:
                # the whole plane changed: rebuild lazily, and the
                # generation bump kills warm state keyed on the old one
                self._summary = None
                self.summary_generation += 1
        elif not self._pending_dev:
            self.last_snapshot_mode = "clean"
        else:
            # delta: convert ONLY the queued dirty rows and copy them into
            # the resident tensors; pop-drain so a delta queued meanwhile
            # survives for the next drain
            while self._pending_dev:
                idx, sub = self._pending_dev.pop(0)
                d_pad = bucket_size(max(len(idx), 1), 4)
                sub_dev = nodes_to_device(sub, pad_to=d_pad,
                                          device=self.device)
                pidx = np.full((d_pad,), n_pad, np.int64)
                pidx[: len(idx)] = idx
                if self._score_cache_on and self._summary is not None:
                    # the summary's same rows, from the same delta pack:
                    # clean columns are reused, dirty ones recomputed
                    from kubernetes_tpu_torch.ops.fused_score import (
                        node_summary,
                        patch_node_summary,
                    )

                    self._summary = patch_node_summary(
                        self._summary,
                        node_summary(sub_dev, **self._summary_flags), pidx)
                self._dev = scatter_node_rows(self._dev, sub_dev, pidx)
                self.last_upload_rows += len(idx)
                self.last_upload_nbytes += tree_nbytes(sub_dev)
                self.last_patched_idx.extend(idx)
            self.last_snapshot_mode = "delta"
        return table, self._dev, self.last_snapshot_mode

    def snapshot(self) -> NodeTable:
        """The host NodeTable, recomputing only dirty rows (the
        reference's ``snapshot``; a delta it packs is queued for the
        resident device table)."""
        table, _mode, _idx, _sub = self._refresh_host()
        return table

    def drop_device_snapshot(self) -> None:
        """Release the resident device table; the next
        :meth:`device_snapshot` re-uploads in full on ``self.device``.
        The score summary drops with it and its generation bumps, so
        warm state keyed on the old plane dies too (takeover
        reconciliation and device-loss recovery land here). Only the
        references go: PyTorch's caching allocator keeps the blocks
        for the rebuild unless ``torch.cuda.empty_cache`` returns them."""
        with self._snap_lock:
            self._dev = None
            self._dev_pad = 0
            self._dev_stale = True
            self._pending_dev.clear()
            self._summary = None
            self.last_patched_idx = []
            self.summary_generation += 1

    def has_device_snapshot(self) -> bool:
        """Whether a resident device table exists now (no upload)."""
        return self._dev is not None

    # -- the incremental solve's score summary -----------------------------

    def enable_score_cache(self, honor_conditions: bool = True,
                           prefer_packed: bool = False) -> None:
        """Turn the resident score summary on, pinned to the scheduler's
        Policy (whether the node-condition predicates gate eligibility)
        and objective (fullest-first ranking under a packing one)."""
        self._score_cache_on = True
        self._summary_flags = {"honor_conditions": bool(honor_conditions),
                               "prefer_packed": bool(prefer_packed)}
        self._summary = None
        self.summary_generation += 1

    def drop_score_summary(self) -> None:
        """Drop only the summary (the resident table stays coherent): the
        next :meth:`score_summary` rebuilds it, and the generation bump
        kills warm state keyed on the old one."""
        with self._snap_lock:
            self._summary = None
            self.summary_generation += 1

    def has_score_summary(self) -> bool:
        """Whether a summary exists now (no lazy build)."""
        return self._summary is not None

    def score_summary(self):
        """The resident NodeSummary (None when the cache is off or no
        resident table exists), built from the resident table on first
        demand after a full upload and patched by delta drains after
        that; ``last_summary_rebuilt`` says which happened."""
        with self._snap_lock:
            self.last_summary_rebuilt = False
            if not self._score_cache_on or self._dev is None:
                return None
            if self._summary is None:
                from kubernetes_tpu_torch.ops.fused_score import node_summary

                self._summary = node_summary(self._dev,
                                             **self._summary_flags)
                self.last_summary_rebuilt = True
            return self._summary

    def _full_repack(self) -> NodeTable:
        nodes = list(self._nodes.values())
        pods = [p for name in self._nodes
                for p in self._pods_by_node.get(name, {}).values()]
        self._table = self.packer.pack_nodes(nodes, pods)
        self._row_of = {nd.name: i for i, nd in enumerate(nodes)}
        # the pack itself may intern — store the POST-pack signature
        self._widths_key = self.packer.universe_node_sig()
        self._dirty.clear()
        self._shape_dirty = False
        return self._table

    def node_order(self) -> List[str]:
        """Row order of the last snapshot (row index -> node name)."""
        out = [""] * len(self._row_of)
        for name, i in self._row_of.items():
            out[i] = name
        return out
