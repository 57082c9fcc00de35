"""The core/v1 object codec scheme — Pod and Node through the same
``runtime.Scheme`` pipeline the ComponentConfig uses.

The reference decodes EVERY API object through one registry
(apimachinery runtime/scheme.go:46; the core group's registration in
pkg/api/legacyscheme + k8s.io/api/core/v1): bytes -> versioned ->
convert -> internal. This module registers the v1 wire forms of the two
kinds this framework's clients exchange — Pod and Node — on a Scheme, so
codec access is uniform (``decode_any`` on any apiVersion/kind mapping)
while the conversion functions themselves are the ALREADY-TESTED wire
converters the REST seam uses (extender.pod_to_json/node_to_json/
node_from_json, server.pod_from_json): one converter set, two access
paths, zero drift. (The port's copy of ``kubernetes_tpu/api/core_v1.py``;
``node_from_json`` lives in ``extender.py`` beside ``node_to_json``, and
``grpc_shim`` re-exports it.)

The versioned "types" here are deliberately thin mapping holders (the
wire document), not field-by-field dataclasses: the wire shape is
already defined by the JSON converters, and duplicating it as a second
dataclass tree would create exactly the drift the Scheme exists to
prevent.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from kubernetes_tpu_torch.api.scheme import Scheme, SchemeError
from kubernetes_tpu_torch.api.types import Node, Pod


@dataclass
class PodV1:
    """v1.Pod wire document (held as the parsed mapping)."""

    doc: dict = field(default_factory=dict)


@dataclass
class NodeV1:
    """v1.Node wire document (held as the parsed mapping)."""

    doc: dict = field(default_factory=dict)


def _pod_to_internal(v: PodV1) -> Pod:
    from kubernetes_tpu_torch.server import pod_from_json

    return pod_from_json(v.doc)


def _pod_from_internal(p: Pod) -> PodV1:
    from kubernetes_tpu_torch.extender import pod_to_json

    return PodV1(doc=pod_to_json(p))


def _node_to_internal(v: NodeV1) -> Node:
    from kubernetes_tpu_torch.extender import node_from_json

    return node_from_json(v.doc)


def _node_from_internal(n: Node) -> NodeV1:
    from kubernetes_tpu_torch.extender import node_to_json

    return NodeV1(doc=node_to_json(n))


#: the ONE kind table: kind -> (versioned holder, internal type,
#: to_internal, from_internal). Registration, decode, and encode all
#: derive from it — adding a kind is one row here.
_KIND_TABLE = {
    "Pod": (PodV1, Pod, _pod_to_internal, _pod_from_internal),
    "Node": (NodeV1, Node, _node_to_internal, _node_from_internal),
}


def new_scheme() -> Scheme:
    s = Scheme()
    for kind, (versioned, internal, to_int, from_int) in _KIND_TABLE.items():
        s.register("v1", kind, versioned)
        s.add_conversion(versioned, internal, to_int)
        s.add_conversion(internal, versioned, from_int)
    return s


SCHEME = new_scheme()


def decode_any(doc: dict):
    """Mapping -> internal object by its own apiVersion/kind (the
    UniversalDeserializer shape, serializer/codec_factory.go). Unlike
    the config scheme's strict dataclass build, core objects keep the
    wire document intact (unknown fields are legal on API objects —
    strictness is a ComponentConfig posture)."""
    if not isinstance(doc, dict):
        raise SchemeError(["document: expected a mapping"])
    api_version = doc.get("apiVersion", "v1")
    kind = doc.get("kind", "")
    if api_version != "v1" or kind not in _KIND_TABLE:
        raise SchemeError([
            f'no kind "{kind}" is registered for version "{api_version}"'
        ])
    versioned_type, internal, _, _ = _KIND_TABLE[kind]
    return SCHEME.convert(versioned_type(doc=doc), internal)


def encode(obj) -> dict:
    """Internal Pod/Node -> v1 wire mapping with apiVersion/kind stamped."""
    kind = type(obj).__name__
    if kind not in _KIND_TABLE:
        raise SchemeError([f"no v1 encoding registered for {kind}"])
    versioned = SCHEME.convert(obj, _KIND_TABLE[kind][0])
    return {"apiVersion": "v1", "kind": kind, **versioned.doc}
