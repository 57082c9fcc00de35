"""The messages of ``corev1.proto`` (package ``ktpucore``): the typed Pod
and Node codecs of the control-plane wire and the ``runtime.Unknown``
envelope. One class per message, on :mod:`.wire`."""

from __future__ import annotations

from kubernetes_tpu_torch.proto.wire import Message

_STR_MAP = ("map", "string", "string")


class TypeMeta(Message):
    FIELDS = ((1, "api_version", "string"), (2, "kind", "string"))


class Unknown(Message):
    """runtime.Unknown (runtime/types.go:108): typed envelope + raw bytes."""

    FIELDS = ((1, "type_meta", ("message", TypeMeta)), (2, "raw", "bytes"))


class OwnerReference(Message):
    FIELDS = ((1, "kind", "string"), (2, "name", "string"),
              (3, "uid", "string"))


class PodMsg(Message):
    FIELDS = (
        (1, "name", "string"),
        (2, "namespace", "string"),
        (3, "uid", "string"),
        (4, "labels", _STR_MAP),
        (5, "owner_refs", ("repeated", OwnerReference)),
        (6, "node_name", "string"),
        (7, "node_selector", _STR_MAP),
        (8, "priority", "int64"),
        (9, "scheduler_name", "string"),
        (10, "preemption_policy", "string"),
        (11, "cpu_milli", "double"),
        (12, "memory", "double"),
        (13, "scalars", ("map", "string", "double")),
        (14, "has_probe", "bool"),
        (15, "probe_initial_delay_s", "double"),
        (16, "ready", "bool"),
        (17, "nominated_node_name", "string"),
        (18, "phase", "string"),
        # metadata.deletionTimestamp (seconds epoch; 0 = live)
        (19, "deletion_timestamp", "double"),
    )


class TaintMsg(Message):
    FIELDS = ((1, "key", "string"), (2, "value", "string"),
              (3, "effect", "string"))


class NodeMsg(Message):
    FIELDS = (
        (1, "name", "string"),
        (2, "labels", _STR_MAP),
        (3, "annotations", _STR_MAP),
        (4, "prefer_avoid_owner_uids", ("repeated", "string")),
        (5, "cpu_milli", "double"),
        (6, "memory", "double"),
        (7, "pods", "double"),
        (8, "ephemeral_storage", "double"),
        (9, "scalars", ("map", "string", "double")),
        (10, "taints", ("repeated", TaintMsg)),
        (11, "unschedulable", "bool"),
        (12, "pod_cidr", "string"),
        (13, "ready", "bool"),
        (14, "memory_pressure", "bool"),
        (15, "disk_pressure", "bool"),
        (16, "pid_pressure", "bool"),
        (17, "network_unavailable", "bool"),
        (18, "images", ("map", "string", "int64")),
    )


class PodListMsg(Message):
    FIELDS = (
        (1, "resource_version", "uint64"),
        (2, "items", ("repeated", PodMsg)),
        (3, "continue_token", "string"),  # ListMeta.continue; "" = last page
        (4, "remaining", "int64"),        # remainingItemCount; -1 = omitted
    )


class NodeListMsg(Message):
    FIELDS = (
        (1, "resource_version", "uint64"),
        (2, "items", ("repeated", NodeMsg)),
        (3, "continue_token", "string"),
        (4, "remaining", "int64"),
    )
