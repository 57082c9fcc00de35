"""Typed protobuf codecs for Pod/Node — the protobuf serializer analog
(runtime/serializer/protobuf/protobuf.go:95).

The JSON converters (extender.pod_to_json / node_to_json and their
inverses) define the published wire SLICE; these codecs carry exactly
that slice in typed proto fields (proto/corev1.proto), so for any object
``from_pb(to_pb(x))`` equals ``from_json(to_json(x))`` — pinned by
tests/test_torch_protobuf_codec.py. Responses ride the reference's envelope:
the 4-byte magic ``k8s\\x00`` followed by a runtime.Unknown message
(protobuf.go:42 serializes exactly this shape).

It serves the REST facade's ``Accept: application/vnd.kubernetes.protobuf``
lists and objects and the gRPC SyncState delta feed. The messages are the
port's own proto3 codec (``proto/corev1.py``, plain Python), whose bytes
equal the protobuf runtime's deterministic serialization, so the port
needs no ``protobuf`` package. Its bytes and host seconds beside JSON's
are measured by ``chip_smoke.py``'s ``grpc`` phase (PERF.md).
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.types import (
    Node,
    NodeCondition,
    OwnerReference,
    Pod,
    ReadinessProbe,
    Resources,
    Taint,
)
from kubernetes_tpu_torch.proto import corev1 as pb

#: protobuf.go:42 — the recognizer prefix of the k8s proto wire format
MAGIC = b"k8s\x00"
PROTO_CONTENT_TYPE = "application/vnd.kubernetes.protobuf"


def pod_to_pb(pod: Pod) -> pb.PodMsg:
    m = pb.PodMsg(
        name=pod.name,
        namespace=pod.namespace,
        uid=pod.uid or pod.key(),
        node_name=pod.node_name,
        priority=int(pod.priority),
        scheduler_name=pod.scheduler_name,
        preemption_policy=pod.preemption_policy,
        cpu_milli=float(pod.requests.cpu_milli),
        memory=float(pod.requests.memory),
        has_probe=pod.readiness_probe is not None,
        probe_initial_delay_s=(
            float(pod.readiness_probe.initial_delay_s)
            if pod.readiness_probe is not None else 0.0),
        # the Ready condition exists only for probed pods in the JSON
        # slice (pod_to_json emits it conditionally) — mirror that here
        # or from_pb(to_pb(x)) and from_json(to_json(x)) diverge on a
        # probe-less ready=True pod
        ready=bool(pod.ready) if pod.readiness_probe is not None else False,
        nominated_node_name=pod.nominated_node_name,
        phase=pod.phase,
        deletion_timestamp=float(pod.deletion_timestamp),
    )
    m.labels.update(pod.labels)
    m.node_selector.update(pod.node_selector)
    m.scalars.update({k: float(v) for k, v in pod.requests.scalars.items()})
    for r in pod.owner_refs:
        m.owner_refs.add(kind=r.kind, name=r.name, uid=r.uid)
    return m


def pod_from_pb(m: pb.PodMsg) -> Pod:
    req = Resources(cpu_milli=m.cpu_milli, memory=m.memory)
    req.scalars.update(dict(m.scalars))
    return Pod(
        name=m.name,
        namespace=m.namespace or "default",
        uid=m.uid,
        labels=dict(m.labels),
        owner_refs=tuple(
            OwnerReference(kind=r.kind, name=r.name, uid=r.uid)
            for r in m.owner_refs),
        node_name=m.node_name,
        node_selector=dict(m.node_selector),
        priority=int(m.priority),
        scheduler_name=m.scheduler_name or "default-scheduler",
        preemption_policy=m.preemption_policy or "PreemptLowerPriority",
        requests=req,
        readiness_probe=(ReadinessProbe(
            initial_delay_s=m.probe_initial_delay_s)
            if m.has_probe else None),
        ready=m.ready,
        nominated_node_name=m.nominated_node_name,
        phase=m.phase or "Pending",
        deletion_timestamp=m.deletion_timestamp,
    )


def node_to_pb(node: Node) -> pb.NodeMsg:
    c = node.conditions
    m = pb.NodeMsg(
        name=node.name,
        cpu_milli=float(node.allocatable.cpu_milli),
        memory=float(node.allocatable.memory),
        pods=float(node.allocatable.pods),
        ephemeral_storage=float(node.allocatable.ephemeral_storage),
        unschedulable=node.unschedulable,
        pod_cidr=node.pod_cidr,
        ready=c.ready,
        memory_pressure=c.memory_pressure,
        disk_pressure=c.disk_pressure,
        pid_pressure=c.pid_pressure,
        network_unavailable=c.network_unavailable,
    )
    m.labels.update(node.labels)
    m.annotations.update(node.annotations)
    m.prefer_avoid_owner_uids.extend(node.prefer_avoid_owner_uids)
    m.scalars.update(
        {k: float(v) for k, v in node.allocatable.scalars.items()})
    for t in node.taints:
        m.taints.add(key=t.key, value=t.value, effect=t.effect)
    m.images.update({k: int(v) for k, v in node.images.items()})
    return m


def node_from_pb(m: pb.NodeMsg) -> Node:
    alloc = Resources(cpu_milli=m.cpu_milli, memory=m.memory, pods=m.pods,
                      ephemeral_storage=m.ephemeral_storage)
    alloc.scalars.update(dict(m.scalars))
    return Node(
        name=m.name,
        labels=dict(m.labels),
        annotations=dict(m.annotations),
        allocatable=alloc,
        taints=tuple(Taint(key=t.key, value=t.value, effect=t.effect)
                     for t in m.taints),
        unschedulable=m.unschedulable,
        pod_cidr=m.pod_cidr,
        conditions=NodeCondition(
            ready=m.ready, memory_pressure=m.memory_pressure,
            disk_pressure=m.disk_pressure, pid_pressure=m.pid_pressure,
            network_unavailable=m.network_unavailable),
        images=dict(m.images),
        prefer_avoid_owner_uids=tuple(m.prefer_avoid_owner_uids),
    )


def pod_list_to_pb(pods, resource_version: int) -> pb.PodListMsg:
    lst = pb.PodListMsg(resource_version=int(resource_version))
    for p in pods:
        lst.items.append(pod_to_pb(p))
    return lst


def node_list_to_pb(nodes, resource_version: int) -> pb.NodeListMsg:
    lst = pb.NodeListMsg(resource_version=int(resource_version))
    for n in nodes:
        lst.items.append(node_to_pb(n))
    return lst


def encode_envelope(kind: str, message) -> bytes:
    """runtime.Unknown behind the magic prefix — what the reference's
    proto serializer writes on the wire (protobuf.go:42,:95)."""
    unk = pb.Unknown(type_meta=pb.TypeMeta(api_version="v1", kind=kind),
                     raw=message.SerializeToString())
    return MAGIC + unk.SerializeToString()


def decode_envelope(data: bytes):
    """-> (kind, raw bytes); raises ValueError on a bad magic/envelope."""
    if not data.startswith(MAGIC):
        raise ValueError("not k8s protobuf wire data (bad magic)")
    unk = pb.Unknown()
    unk.ParseFromString(data[len(MAGIC):])
    return unk.type_meta.kind, unk.raw
