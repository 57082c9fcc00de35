"""The port's proto3 codec (``kubernetes_tpu_torch/proto``,
``kubernetes_tpu_torch/api/protobuf.py``) held against the protobuf
runtime and the JAX package's generated ``corev1_pb2`` / ``extender_pb2``:
for every message of both ``.proto`` files, seeded random instances (and
the edge cases by name) give the same bytes as the runtime's
``SerializeToString(deterministic=True)``, and each side parses the other's
bytes into equal objects. The tolerance is none: bytes and objects are
compared exactly (a double by its bits, so -0.0 is not 0.0). Then the
five tests of ``tests/test_protobuf_codec.py`` on the port."""

import dataclasses
import http.client
import math
import struct

import numpy as np
import pytest

import kubernetes_tpu.api.protobuf as jproto
from kubernetes_tpu.proto import corev1_pb2 as jcore
from kubernetes_tpu.proto import extender_pb2 as jext
from kubernetes_tpu_torch.api.protobuf import (
    MAGIC,
    PROTO_CONTENT_TYPE,
    decode_envelope,
    encode_envelope,
    node_from_pb,
    node_list_to_pb,
    node_to_pb,
    pod_from_pb,
    pod_list_to_pb,
    pod_to_pb,
)
from kubernetes_tpu_torch.api.types import OwnerReference, ReadinessProbe, Taint
from kubernetes_tpu_torch.extender import (
    node_from_json,
    node_to_json,
    pod_to_json,
)
from kubernetes_tpu_torch.proto import corev1 as tcore
from kubernetes_tpu_torch.proto import extender as text
from kubernetes_tpu_torch.proto.wire import DecodeError, Message
from kubernetes_tpu_torch.server import pod_from_json
from kubernetes_tpu_torch.testing import make_node, make_pod
from torch_parity import to_port

#: every message class of the port, beside the runtime's class
MESSAGES = {
    **{n: (getattr(tcore, n), getattr(jcore, n))
       for n in ("TypeMeta", "Unknown", "OwnerReference", "PodMsg",
                 "TaintMsg", "NodeMsg", "PodListMsg", "NodeListMsg")},
    **{n: (getattr(text, n), getattr(jext, n))
       for n in ("NodeDelta", "PodDelta", "SnapshotDelta", "SyncAck",
                 "ExtenderArgs", "ExtenderFilterResult", "HostPriority",
                 "HostPriorityList", "Binding", "BindResult",
                 "StateRequest", "StateSnapshot")},
}

STRINGS = ("", "a", "web-0", "kubernetes.io/hostname", "héllo ✓", "日本",
           "x" * 200)
INTS = {"int32": (0, 1, -1, 127, 128, 2**31 - 1, -2**31),
        "int64": (0, 1, -1, 300, 2**63 - 1, -2**63, -2**31 - 1),
        "uint64": (0, 1, 127, 128, 2**63, 2**64 - 1),
        "enum": (0, 1, 2)}
DOUBLES = (0.0, -0.0, 1.5, -3.25, 1e300, math.inf, -math.inf, 5e-324,
           1 / 3)


def _scalar(kind, rng):
    """A seeded value of a scalar kind: an edge value or a random one."""
    if kind == "string":
        if rng.random() < 0.7:
            return STRINGS[rng.integers(len(STRINGS))]
        return "".join(chr(c) for c in rng.integers(32, 0x3000,
                                                    rng.integers(0, 12)))
    if kind == "bytes":
        return bytes(rng.integers(0, 256, rng.choice([0, 1, 7, 300]),
                                  dtype=np.uint8))
    if kind == "bool":
        return bool(rng.integers(2))
    if kind == "double":
        if rng.random() < 0.6:
            return DOUBLES[rng.integers(len(DOUBLES))]
        return float(rng.normal() * 10.0 ** rng.integers(-5, 12))
    edges = INTS[kind]
    if rng.random() < 0.6 or kind == "enum":
        return int(edges[rng.integers(len(edges))])
    lo, hi = min(edges), max(edges)
    return int(rng.integers(max(lo, -2**62), min(hi, 2**62)))


def plan(cls, rng, depth=0):
    """A seeded instance of a port message class as plain data:
    ``{field: value}``, a submessage as ``(class, plan)``, every field
    left out about one time in three."""
    out = {}
    for number, name, kind in cls.FIELDS:
        if rng.random() < 0.3:
            continue
        if isinstance(kind, str):
            out[name] = _scalar(kind, rng)
        elif kind[0] == "message":
            out[name] = (kind[1], plan(kind[1], rng, depth + 1))
        elif kind[0] == "repeated" and isinstance(kind[1], type):
            n = rng.integers(0, 4 if depth < 2 else 1)
            out[name] = [(kind[1], plan(kind[1], rng, depth + 1))
                         for _ in range(n)]
        elif kind[0] == "repeated":
            out[name] = [_scalar(kind[1], rng)
                         for _ in range(rng.integers(0, 5))]
        else:
            out[name] = {_scalar(kind[1], rng): _scalar(kind[2], rng)
                         for _ in range(rng.integers(0, 5))}
    return out


def build(cls, p, side):
    """The message of plan ``p`` on one side (0 the port, 1 the runtime)."""
    target = MESSAGES[cls.__name__][side]

    def value(v):
        if isinstance(v, tuple):
            return build(v[0], v[1], side)
        if isinstance(v, list):
            return [value(x) for x in v]
        return v

    return target(**{k: value(v) for k, v in p.items()})


def bits(v):
    return struct.pack("<d", v) if isinstance(v, float) else v


def same(t, r) -> None:
    """The port's message ``t`` holds what the runtime's ``r`` holds,
    field by field, doubles by their bits and submessages by presence."""
    assert type(t).__name__ == type(r).__name__
    for fd in r.DESCRIPTOR.fields:
        tv, rv = getattr(t, fd.name), getattr(r, fd.name)
        if fd.message_type is not None and fd.message_type.GetOptions(
                ).map_entry:
            assert {k: bits(v) for k, v in tv.items()} == {
                k: bits(v) for k, v in rv.items()}, fd.name
            assert all(type(v) is type(rv[k]) for k, v in tv.items())
        elif fd.is_repeated and fd.message_type is not None:
            assert len(tv) == len(rv), fd.name
            for a, b in zip(tv, rv):
                same(a, b)
        elif fd.is_repeated:
            assert list(tv) == list(rv), fd.name
        elif fd.message_type is not None:
            assert (t.__dict__[fd.name] is not None) == r.HasField(fd.name)
            same(tv, rv)
        else:
            assert bits(tv) == bits(rv) and type(tv) is type(rv), (
                fd.name, tv, rv)


def round_trip(t, r) -> bytes:
    """The whole parity contract on one message pair; returns the bytes."""
    want = r.SerializeToString(deterministic=True)
    got = t.SerializeToString()
    assert got == want, (type(t).__name__, got, want)
    same(t, r)
    back_t = type(t).FromString(want)
    assert back_t == t
    same(back_t, r)
    back_r = type(r)()
    back_r.ParseFromString(got)
    assert back_r == r
    same(t, back_r)
    return got


# ---------------------------------------------------------------------------
# bytes and objects against the runtime, every message
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MESSAGES))
def test_every_message_matches_the_runtime_bytes(name):
    tcls, _ = MESSAGES[name]
    rng = np.random.default_rng(sorted(MESSAGES).index(name) + 100)
    seen = set()
    for _ in range(40):
        p = plan(tcls, rng)
        seen.add(round_trip(build(tcls, p, 0), build(tcls, p, 1)))
    assert len(seen) > 10  # the seeds reach varied instances
    assert round_trip(tcls(), MESSAGES[name][1]()) == b""


EDGES = {
    "negative_zero_double": (
        lambda m: m.PodMsg(cpu_milli=-0.0), b"Y" + b"\x00" * 7 + b"\x80"),
    "positive_zero_double": (lambda m: m.PodMsg(cpu_milli=0.0), b""),
    "negative_int64": (lambda m: m.PodMsg(priority=-1),
                       b"@" + b"\xff" * 9 + b"\x01"),
    "negative_int32": (lambda m: m.SyncAck(nodes_in_snapshot=-1),
                       b"\x10" + b"\xff" * 9 + b"\x01"),
    "empty_string_map_entry": (lambda m: m.NodeMsg(labels={"": ""}),
                               b"\x12\x04\n\x00\x12\x00"),
    "zero_double_map_value": (
        lambda m: m.NodeMsg(scalars={"x": 0.0}),
        b"J\x0c\n\x01x\x11" + b"\x00" * 8),
    "zero_int64_map_value": (lambda m: m.NodeMsg(images={"i": 0}),
                             b"\x92\x01\x05\n\x01i\x10\x00"),
    "empty_repeated_submessage": (
        lambda m: m.SnapshotDelta(nodes=[m.NodeDelta()]), b"\x12\x00"),
    "empty_repeated_string": (lambda m: m.ExtenderArgs(node_names=[""]),
                              b"\x12\x00"),
    "empty_singular_submessage": (
        lambda m: m.Unknown(type_meta=m.TypeMeta()), b"\n\x00"),
    "map_keys_sorted": (
        lambda m: m.ExtenderFilterResult(failed_nodes={"b": "2", "a": "1"}),
        b"\x12\x06\n\x01a\x12\x011\x12\x06\n\x01b\x12\x012"),
    # a key after every key it is a prefix of (the runtime's order)
    "map_prefix_keys": (
        lambda m: m.NodeMsg(labels={"": "", "a": "", "ab": ""}),
        b"\x12\x06\n\x02ab\x12\x00\x12\x05\n\x01a\x12\x00"
        b"\x12\x04\n\x00\x12\x00"),
    "utf8_string": (lambda m: m.Binding(pod_key="ns/é"),
                    b"\n\x05ns/\xc3\xa9"),
    "max_uint64": (lambda m: m.SnapshotDelta(revision=2**64 - 1),
                   b"\x08" + b"\xff" * 9 + b"\x01"),
    "omitted_remaining": (lambda m: m.NodeListMsg(remaining=-1),
                          b" " + b"\xff" * 9 + b"\x01"),
}


@pytest.mark.parametrize("case", sorted(EDGES))
def test_edge_cases_match_the_runtime(case):
    make, want = EDGES[case]
    port_mod = {**vars(tcore), **vars(text)}
    ref_mod = {**vars(jcore), **vars(jext)}

    class NS:
        def __init__(self, d):
            self.__dict__.update(d)

    t, r = make(NS(port_mod)), make(NS(ref_mod))
    assert round_trip(t, r) == want


@pytest.mark.parametrize("wire, payload", [
    (0, b"\xa8\x1f\x05"),                    # varint, field 501
    (1, b"\xa9\x1f" + b"\x01" * 8),          # fixed64
    (2, b"\xaa\x1f\x03abc"),                 # length-delimited
    (5, b"\xad\x1f\x01\x02\x03\x04"),        # fixed32
])
def test_unknown_fields_are_skipped(wire, payload):
    """A field neither side knows, of each wire type, before and after
    known fields and inside a submessage: skipped, the rest read."""
    r = jcore.PodMsg(name="p", priority=-7, labels={"a": "b"},
                     owner_refs=[jcore.OwnerReference(kind="RS")])
    body = r.SerializeToString(deterministic=True)
    owner = jcore.OwnerReference(kind="RS").SerializeToString()
    inner = b"\x2a" + bytes([len(owner) + len(payload)]) + owner + payload
    data = payload + body + payload + inner
    got = tcore.PodMsg.FromString(data)
    want = jcore.PodMsg()
    want.ParseFromString(data)
    same(got, want)
    assert len(got.owner_refs) == 2
    want.DiscardUnknownFields()  # the runtime keeps them; the port drops
    assert got.SerializeToString() == want.SerializeToString(
        deterministic=True)


def test_a_known_field_on_another_wire_type_is_skipped():
    """A field number the message knows, sent on the wrong wire type, is
    an unknown field to both sides."""
    data = b"\x0d\x01\x02\x03\x04" + b"\x12\x01n"  # name as fixed32, ns
    want = jcore.PodMsg()
    want.ParseFromString(data)
    got = tcore.PodMsg.FromString(data)
    same(got, want)
    assert got.name == "" and got.namespace == "n"


@pytest.mark.parametrize("data", [
    b"\x0a\x05ab",              # a string shorter than its length
    b"\x08",                    # a varint cut off
    b"\x59\x00\x00",            # a double cut off
    b"\x0a\x02\xff\xfe",        # a string that is not UTF-8
    b"\x2a\x03\x0a\x05abcde",   # a submessage overrunning its length
    b"\x0b",                    # a group (wire type 3)
])
def test_malformed_bytes_raise_on_both_sides(data):
    from google.protobuf.message import DecodeError as RefDecodeError

    with pytest.raises(RefDecodeError):
        jcore.PodMsg().ParseFromString(data)
    with pytest.raises(DecodeError):
        tcore.PodMsg.FromString(data)


def test_merge_of_a_repeated_singular_submessage():
    """A singular submessage sent twice merges, as the runtime does."""
    a = jcore.Unknown(type_meta=jcore.TypeMeta(api_version="v1"))
    b = jcore.Unknown(type_meta=jcore.TypeMeta(kind="Pod"), raw=b"x")
    data = a.SerializeToString() + b.SerializeToString()
    want = jcore.Unknown()
    want.ParseFromString(data)
    got = tcore.Unknown.FromString(data)
    same(got, want)
    assert (got.type_meta.api_version, got.type_meta.kind) == ("v1", "Pod")


@pytest.mark.parametrize("field, value", [
    ("name", 3), ("priority", 1.5), ("priority", 2**63), ("cpu_milli", "1"),
    ("labels", "not-a-map"), ("owner_refs", 5), ("labels", {"k": 1}),
    ("nope", 1),
])
def test_bad_values_are_refused_like_the_runtime(field, value):
    """What the runtime refuses at construction, the port refuses too
    (the gRPC service's corrupted results depend on it)."""
    with pytest.raises((TypeError, ValueError)):
        jcore.PodMsg(**{field: value})
    with pytest.raises((TypeError, ValueError)):
        tcore.PodMsg(**{field: value})


def test_message_api_the_seam_calls():
    d = text.SnapshotDelta(revision=3)
    nd = d.nodes.add(op=text.NodeDelta.REMOVE, name="n0")
    assert nd is d.nodes[0] and d.nodes[0].op == 2
    d.revision = 9
    with pytest.raises(AttributeError):
        d.nodes = []
    with pytest.raises(AttributeError):
        d.bogus = 1
    lst = tcore.PodListMsg()
    lst.items.append(tcore.PodMsg(name="a"))
    lst.continue_token = "tok"
    lst.remaining = -1
    m = tcore.NodeMsg()
    m.labels.update({"b": "2", "a": "1"})
    m.prefer_avoid_owner_uids.extend(["u"])
    m.taints.add(key="k")
    m.images.update({"i": 3})
    assert isinstance(m.labels, dict) and isinstance(m.taints, list)
    assert tcore.Unknown().type_meta == tcore.TypeMeta()
    assert tcore.Unknown().SerializeToString() == b""
    assert (text.NodeDelta.ADD, text.NodeDelta.UPDATE,
            text.PodDelta.REMOVE) == (jext.NodeDelta.ADD,
                                      jext.NodeDelta.UPDATE,
                                      jext.PodDelta.REMOVE)
    for msg in (d, lst, m):
        n = type(msg)()
        assert n.ParseFromString(msg.SerializeToString()) == len(
            msg.SerializeToString())
        assert n == msg
    assert issubclass(text.SyncAck, Message)


# ---------------------------------------------------------------------------
# the codecs and the envelope against the JAX package's
# ---------------------------------------------------------------------------


def seeded_objects(seed, n=8):
    """Seeded JAX-typed pods and nodes (2-16 of each) with every field the
    wire slice carries."""
    from kubernetes_tpu.api.types import (
        OwnerReference as JOwner,
        ReadinessProbe as JProbe,
        Taint as JTaint,
    )
    from kubernetes_tpu.testing import make_node as jnode
    from kubernetes_tpu.testing import make_pod as jpod

    rng = np.random.default_rng(seed)
    nodes, pods = [], []
    for i in range(n):
        nd = jnode(f"n{i}", cpu_milli=int(rng.integers(500, 64000)),
                   memory=int(rng.integers(1, 64)) * 2**30,
                   pods=int(rng.integers(10, 110)),
                   zone=f"z{rng.integers(3)}",
                   labels={f"k{j}": STRINGS[rng.integers(len(STRINGS))]
                           for j in range(rng.integers(0, 4))})
        if rng.random() < 0.5:
            nd.taints = (JTaint("dedicated", str(rng.integers(9)),
                                "NoSchedule"),)
        if rng.random() < 0.3:
            nd.allocatable.scalars["nvidia.com/gpu"] = int(rng.integers(1, 8))
        if rng.random() < 0.3:
            nd.images = {f"img{j}:v1": int(rng.integers(1, 2**30))
                         for j in range(rng.integers(1, 3))}
        if rng.random() < 0.3:
            nd.prefer_avoid_owner_uids = ("rc-1",)
        nd.unschedulable = bool(rng.random() < 0.2)
        nd.conditions.ready = bool(rng.random() < 0.8)
        nd.conditions.memory_pressure = bool(rng.random() < 0.2)
        nd.annotations = {"team": "a"} if rng.random() < 0.3 else {}
        nd.pod_cidr = f"10.0.{i}.0/24" if rng.random() < 0.5 else ""
        nodes.append(nd)
        p = jpod(f"p{i}", cpu_milli=int(rng.integers(0, 4000)),
                 memory=int(rng.integers(0, 4096)) * 2**20,
                 labels={"app": f"a{rng.integers(3)}"},
                 node_name=f"n{i}" if rng.random() < 0.5 else "",
                 priority=int(rng.integers(-10, 1000)))
        if rng.random() < 0.4:
            p.readiness_probe = JProbe(
                initial_delay_s=float(rng.integers(0, 30)))
        p.ready = bool(rng.random() < 0.5)
        if rng.random() < 0.3:
            p.owner_refs = (JOwner(kind="ReplicaSet", name="rs", uid="u1"),)
        if rng.random() < 0.3:
            p.node_selector = {"disk": "ssd"}
        if rng.random() < 0.2:
            p.deletion_timestamp = float(rng.integers(1, 1000)) / 4
        if rng.random() < 0.2:
            p.requests.scalars["nvidia.com/gpu"] = 1
        if rng.random() < 0.2:
            p.preemption_policy = "Never"
        p.nominated_node_name = "n0" if rng.random() < 0.2 else ""
        pods.append(p)
    return nodes, pods


@pytest.mark.parametrize("seed", range(4))
def test_object_codecs_give_the_jax_package_bytes(seed):
    """``pod_to_pb`` / ``node_to_pb`` on the same objects give the bytes of
    the JAX package's codecs, each side's decode of them gives the
    objects the other's does, and the list envelopes are byte-equal."""
    nodes, pods = seeded_objects(seed, n=2 + 2 * seed + seed * seed)
    for jobj, to_t, to_j, from_t in (
            *[(p, pod_to_pb, jproto.pod_to_pb, pod_from_pb) for p in pods],
            *[(n, node_to_pb, jproto.node_to_pb, node_from_pb)
              for n in nodes]):
        tmsg, jmsg = to_t(to_port(jobj)), to_j(jobj)
        data = round_trip(tmsg, jmsg)
        back = type(jmsg)()
        back.ParseFromString(data)
        jfrom = (jproto.pod_from_pb if to_t is pod_to_pb
                 else jproto.node_from_pb)
        assert from_t(type(tmsg).FromString(data)) == to_port(jfrom(back))
    for tlist, jlist, objs, kind in (
            (pod_list_to_pb, jproto.pod_list_to_pb, pods, "PodList"),
            (node_list_to_pb, jproto.node_list_to_pb, nodes, "NodeList")):
        tmsg = tlist([to_port(o) for o in objs], 41 + seed)
        jmsg = jlist(objs, 41 + seed)
        tmsg.continue_token, jmsg.continue_token = "c", "c"
        tmsg.remaining, jmsg.remaining = -1, -1
        round_trip(tmsg, jmsg)
        assert encode_envelope(kind, tmsg) == (
            jproto.MAGIC + jcore.Unknown(
                type_meta=jcore.TypeMeta(api_version="v1", kind=kind),
                raw=jmsg.SerializeToString(deterministic=True),
            ).SerializeToString(deterministic=True))
    one = pods[0]
    assert encode_envelope("Pod", pod_to_pb(to_port(one))) == \
        jproto.encode_envelope("Pod", jproto.pod_to_pb(one))
    assert decode_envelope(jproto.encode_envelope(
        "Pod", jproto.pod_to_pb(one))) == jproto.decode_envelope(
        encode_envelope("Pod", pod_to_pb(to_port(one))))


@pytest.mark.parametrize("seed", range(4))
def test_codec_parity_with_json_wire_slice_seeded(seed):
    """The module's invariant on seeded objects: ``from_pb(to_pb(x))``
    equals ``from_json(to_json(x))`` in the port wherever it does in the
    JAX package, and each path decodes to the JAX package's object. The
    JSON path alone rounds some CPU quantities in both packages (a node of
    20397 milli-CPU reads back as 20397.000000000004 from ``"20397m"``),
    so where the invariant fails it must fail alike on both sides."""
    from kubernetes_tpu.extender import node_to_json as jnode_json
    from kubernetes_tpu.extender import pod_to_json as jpod_json
    from kubernetes_tpu.grpc_shim import node_from_json as jnode_from
    from kubernetes_tpu.server import pod_from_json as jpod_from

    nodes, pods = seeded_objects(seed + 10)
    held = 0
    for objs, to_pb, from_pb, to_json, from_json, jto_json, jfrom_json in (
            (pods, (pod_to_pb, jproto.pod_to_pb),
             (pod_from_pb, jproto.pod_from_pb), pod_to_json, pod_from_json,
             jpod_json, jpod_from),
            (nodes, (node_to_pb, jproto.node_to_pb),
             (node_from_pb, jproto.node_from_pb), node_to_json,
             node_from_json, jnode_json, jnode_from)):
        for x in objs:
            t = to_port(x)
            t_pb, t_json = from_pb[0](to_pb[0](t)), from_json(to_json(t))
            j_pb = from_pb[1](to_pb[1](x))
            j_json = jfrom_json(jto_json(x))
            assert t_pb == to_port(j_pb) and t_json == to_port(j_json)
            assert (t_pb == t_json) == (j_pb == j_json)
            held += t_pb == t_json
    assert held >= (len(nodes) + len(pods)) // 2


# ---------------------------------------------------------------------------
# the five tests of tests/test_protobuf_codec.py, on the port
# ---------------------------------------------------------------------------


def rich_pod():
    return dataclasses.replace(
        make_pod("p1", cpu_milli=250, labels={"app": "x"},
                 node_name="n1", priority=5),
        readiness_probe=ReadinessProbe(initial_delay_s=3.0),
        owner_refs=(OwnerReference(kind="ReplicaSet", name="rs", uid="u1"),),
        nominated_node_name="n2", node_selector={"disk": "ssd"})


def rich_node():
    n = make_node("n1", cpu_milli=4000)
    n.allocatable.scalars["attachable-volumes-csi-x"] = 3
    return dataclasses.replace(
        n, taints=(Taint(key="k", value="v", effect="NoSchedule"),),
        annotations={"node.alpha.kubernetes.io/ttl": "15"},
        pod_cidr="10.0.1.0/24", prefer_avoid_owner_uids=("u9",),
        images={"img:a": 2 ** 26})


def test_codec_parity_with_json_wire_slice():
    p, n = rich_pod(), rich_node()
    assert pod_from_pb(pod_to_pb(p)) == pod_from_json(pod_to_json(p))
    assert node_from_pb(node_to_pb(n)) == node_from_json(node_to_json(n))


def test_codec_parity_terminating_and_probeless_ready():
    term = dataclasses.replace(rich_pod(), deletion_timestamp=17.5)
    assert pod_from_pb(pod_to_pb(term)).deletion_timestamp == 17.5
    assert pod_from_json(pod_to_json(term)).deletion_timestamp == 17.5
    assert pod_from_pb(pod_to_pb(term)) == pod_from_json(pod_to_json(term))

    probeless = dataclasses.replace(
        make_pod("p2", cpu_milli=100, node_name="n1"), ready=True)
    assert probeless.readiness_probe is None
    assert (pod_from_pb(pod_to_pb(probeless))
            == pod_from_json(pod_to_json(probeless)))
    assert pod_to_pb(probeless).ready is False


def test_envelope_magic_and_round_trip():
    p = rich_pod()
    data = encode_envelope("Pod", pod_to_pb(p))
    assert data.startswith(MAGIC)
    kind, raw = decode_envelope(data)
    assert kind == "Pod"
    msg = tcore.PodMsg()
    msg.ParseFromString(raw)
    assert pod_from_pb(msg) == pod_from_pb(pod_to_pb(p))
    with pytest.raises(ValueError):
        decode_envelope(b"{}" + data)


def _proto_get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request("GET", path, None, {"Accept": PROTO_CONTENT_TYPE})
    r = conn.getresponse()
    body = r.read()
    conn.close()
    return r.status, r.getheader("Content-Type"), body


def test_rest_lists_negotiate_protobuf():
    import json

    from kubernetes_tpu_torch.restapi import RestServer
    from kubernetes_tpu_torch.sim import HollowCluster

    hub = HollowCluster(seed=71, scheduler_kw={"enable_preemption": False,
                                               "device": "cpu"})
    srv = RestServer(hub)
    port = srv.serve()
    try:
        hub.add_node(make_node("n0", cpu_milli=8000, pods=60))
        for i in range(3):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
            conn.request("POST", "/api/v1/namespaces/default/pods",
                         json.dumps(pod_to_json(make_pod(f"p{i}"))))
            assert conn.getresponse().status == 201
            conn.close()

        status, ctype, body = _proto_get(port, "/api/v1/pods")
        assert status == 200 and ctype == PROTO_CONTENT_TYPE
        kind, raw = decode_envelope(body)
        assert kind == "PodList"
        lst = tcore.PodListMsg.FromString(raw)
        assert sorted(m.name for m in lst.items) == ["p0", "p1", "p2"]
        assert lst.resource_version > 0

        # selectors + pagination compose with the proto path
        _, _, body = _proto_get(port, "/api/v1/pods?limit=2")
        lst = tcore.PodListMsg.FromString(decode_envelope(body)[1])
        assert len(lst.items) == 2 and lst.continue_token
        assert lst.remaining == 1

        # item GET + node list
        _, _, body = _proto_get(port, "/api/v1/nodes/n0")
        kind, raw = decode_envelope(body)
        assert kind == "Node"
        assert node_from_pb(tcore.NodeMsg.FromString(raw)) == \
            hub.truth_nodes["n0"]

        # a JSON client is untouched
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request("GET", "/api/v1/pods")
        r = conn.getresponse()
        doc = json.loads(r.read())
        conn.close()
        assert r.status == 200 and doc["kind"] == "PodList"
    finally:
        srv.close()


def test_grpc_feed_rides_typed_deltas():
    pytest.importorskip("grpc")

    from kubernetes_tpu_torch.grpc_shim import (
        GrpcSchedulerClient,
        SnapshotDeltaBridge,
        TpuSchedulerService,
        serve_grpc,
    )
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.sim import HollowCluster

    hub = HollowCluster(seed=73, scheduler_kw={"enable_preemption": False,
                                               "device": "cpu"})
    hub.add_node(make_node("n0", cpu_milli=8000, pods=60))
    remote = Scheduler(device="cpu", clock=hub.clock,
                       enable_preemption=False)
    svc = TpuSchedulerService(remote)
    server, port = serve_grpc(remote, service=svc)
    try:
        client = GrpcSchedulerClient(f"127.0.0.1:{port}")
        bridge = SnapshotDeltaBridge(hub, client, lock=hub.lock)
        assert bridge.proto_feed  # typed deltas are the default
        hub.create_pod(make_pod("w0", cpu_milli=100))
        hub.step()
        bridge.pump()
        # the remote cache materialized objects from TYPED payloads
        assert remote.cache.node("n0") is not None
        assert (remote.cache.pod("default/w0") is not None
                or remote.queue.pod("default/w0") is not None)
        client.close()
    finally:
        server.stop(0)
