"""The messages of ``extender.proto`` (package ``ktpu``): the gRPC seam's
snapshot-delta stream and extender verbs (the message shapes of
pkg/scheduler/api/types.go:284-330). One class per message, on
:mod:`.wire`."""

from __future__ import annotations

from kubernetes_tpu_torch.proto.wire import Message


class NodeDelta(Message):
    #: enum Op
    ADD, UPDATE, REMOVE = 0, 1, 2
    FIELDS = (
        (1, "op", "enum"),
        (2, "name", "string"),
        (3, "node_json", "string"),  # v1.Node-shaped; empty on REMOVE
        (4, "node_pb", "bytes"),     # typed corev1.NodeMsg; preferred when set
    )


class PodDelta(Message):
    #: enum Op
    ADD, UPDATE, REMOVE = 0, 1, 2
    FIELDS = (
        (1, "op", "enum"),
        (2, "key", "string"),       # namespace/name
        (3, "pod_json", "string"),  # v1.Pod-shaped; empty on REMOVE
        (4, "pod_pb", "bytes"),     # typed corev1.PodMsg; preferred when set
    )


class SnapshotDelta(Message):
    """One watch-batch of state changes (the informer event pump
    serialized)."""

    FIELDS = (
        (1, "revision", "uint64"),
        (2, "nodes", ("repeated", NodeDelta)),
        (3, "pods", ("repeated", PodDelta)),
    )


class SyncAck(Message):
    FIELDS = ((1, "revision", "uint64"),  # last delta applied
              (2, "nodes_in_snapshot", "int32"))


class ExtenderArgs(Message):
    FIELDS = ((1, "pod_json", "string"),
              (2, "node_names", ("repeated", "string")))  # names only


class ExtenderFilterResult(Message):
    FIELDS = ((1, "node_names", ("repeated", "string")),
              (2, "failed_nodes", ("map", "string", "string")),
              (3, "error", "string"))


class HostPriority(Message):
    FIELDS = ((1, "host", "string"), (2, "score", "int64"))


class HostPriorityList(Message):
    FIELDS = ((1, "items", ("repeated", HostPriority)),
              (2, "error", "string"))


class Binding(Message):
    FIELDS = ((1, "pod_key", "string"),  # namespace/name
              (2, "node", "string"))


class BindResult(Message):
    FIELDS = ((1, "ok", "bool"), (2, "error", "string"))


class StateRequest(Message):
    FIELDS = ((1, "kind", "string"),)  # "" = everything; "nodes" | "pods"


class StateSnapshot(Message):
    """Read-only state dump for tooling: the service's resident snapshot."""

    FIELDS = (
        (1, "revision", "uint64"),  # last applied SyncState revision
        (2, "node_json", ("repeated", "string")),
        (3, "pod_json", ("repeated", "string")),      # bound or assumed
        (4, "pending_json", ("repeated", "string")),  # queued
    )
