"""Label and field selectors — the server-side LIST filtering library.

Every reference client filters lists AT THE SERVER: ListOptions carries
``labelSelector``/``fieldSelector`` strings
(staging/src/k8s.io/apimachinery/pkg/apis/meta/v1/types.go:322), parsed
by the labels package's requirement grammar (labels/selector.go Parse)
and the fields package's =/==/!= pair grammar (fields/selector.go
ParseSelector), then evaluated against each object by the resource's
selection predicate (pkg/registry/core/pod/strategy.go:197 MatchPod —
including the ``spec.nodeName`` field selector kubelets live on;
node/strategy.go MatchNode). Client-side filtering of a full LIST is the
exact anti-pattern the watch cache exists to prevent.

This module is that library for the REST facade and the in-process
informer seam:

- :func:`parse_label_selector` — the full requirement grammar:
  ``k=v``, ``k==v``, ``k!=v``, ``k in (a,b)``, ``k notin (a,b)``,
  ``k`` (exists), ``!k`` (not-exists), ``k>n`` / ``k<n`` (numeric),
  comma-joined (AND).
- :func:`parse_field_selector` — comma-joined ``k=v``/``k==v``/``k!=v``.
- :func:`pod_fields` / :func:`node_fields` — the supported field-label
  surface of each kind; an UNSUPPORTED key is an error at match time
  ("field label not supported", the ToSelectableFields contract), never
  a silent everything-matches.

Matching is pure host-side Python over object attributes — this runs in
the API server's request path, not on device.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, Mapping, Sequence, Tuple

__all__ = [
    "SelectorError",
    "Requirement",
    "parse_label_selector",
    "match_labels",
    "parse_field_selector",
    "match_fields",
    "pod_fields",
    "node_fields",
    "event_fields",
]


class SelectorError(ValueError):
    """Unparseable selector or unsupported field label."""


#: operators in the labels.Requirement sense (selector.go Operator)
EXISTS, NOT_EXISTS = "exists", "!"
EQ, NEQ, IN, NOT_IN, GT, LT = "=", "!=", "in", "notin", ">", "<"


@dataclass(frozen=True)
class Requirement:
    key: str
    op: str
    values: Tuple[str, ...] = ()


_KEY = r"[A-Za-z0-9](?:[-A-Za-z0-9_./]*[A-Za-z0-9])?"
_VALUE = r"[A-Za-z0-9](?:[-A-Za-z0-9_.]*[A-Za-z0-9])?|"
_SET_RE = re.compile(
    rf"^({_KEY})\s+(in|notin)\s+\(\s*([^)]*)\)$"
)
_PAIR_RE = re.compile(rf"^({_KEY})\s*(==|=|!=|>|<)\s*({_VALUE})$")
_EXISTS_RE = re.compile(rf"^(!?)({_KEY})$")


def _split_requirements(s: str) -> list:
    """Comma-split outside parentheses (set values contain commas)."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(0, depth - 1)
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return [part.strip() for part in out if part.strip()]


def parse_label_selector(s: str) -> Tuple[Requirement, ...]:
    """labels.Parse: a comma-joined AND of requirements. Empty string =
    match everything (labels.Everything())."""
    reqs = []
    for part in _split_requirements(s or ""):
        m = _SET_RE.match(part)
        if m:
            vals = tuple(v.strip() for v in m.group(3).split(",")
                         if v.strip())
            if not vals:
                raise SelectorError(
                    f"empty value set in requirement {part!r}")
            reqs.append(Requirement(m.group(1),
                                    IN if m.group(2) == "in" else NOT_IN,
                                    vals))
            continue
        m = _PAIR_RE.match(part)
        if m:
            key, op, val = m.group(1), m.group(2), m.group(3)
            op = EQ if op in ("=", "==") else op
            if op in (GT, LT):
                try:
                    float(val)
                except ValueError:
                    raise SelectorError(
                        f"{part!r}: gt/lt require a numeric value")
            reqs.append(Requirement(key, NEQ if op == "!=" else op, (val,)))
            continue
        m = _EXISTS_RE.match(part)
        if m:
            reqs.append(Requirement(
                m.group(2), NOT_EXISTS if m.group(1) else EXISTS))
            continue
        raise SelectorError(f"unparseable selector requirement {part!r}")
    return tuple(reqs)


def match_labels(reqs: Sequence[Requirement],
                 labels: Mapping[str, str]) -> bool:
    """Requirement.Matches over a label map (selector.go:214)."""
    for r in reqs:
        has = r.key in labels
        val = labels.get(r.key, "")
        if r.op == EXISTS:
            if not has:
                return False
        elif r.op == NOT_EXISTS:
            if has:
                return False
        elif r.op == EQ:
            if not has or val != r.values[0]:
                return False
        elif r.op == NEQ:
            # the reference's != also matches ABSENT keys
            if has and val == r.values[0]:
                return False
        elif r.op == IN:
            if not has or val not in r.values:
                return False
        elif r.op == NOT_IN:
            if has and val in r.values:
                return False
        elif r.op in (GT, LT):
            if not has:
                return False
            try:
                num = float(val)
            except ValueError:
                return False  # non-numeric label value never matches
            bound = float(r.values[0])
            if r.op == GT and not num > bound:
                return False
            if r.op == LT and not num < bound:
                return False
    return True


def parse_field_selector(s: str) -> Tuple[Requirement, ...]:
    """fields.ParseSelector: comma-joined ``k=v``/``k==v``/``k!=v`` only
    (the fields grammar has no set/exists operators)."""
    reqs = []
    for part in _split_requirements(s or ""):
        if "!=" in part:
            key, _, val = part.partition("!=")
            op = NEQ
        elif "==" in part:
            key, _, val = part.partition("==")
            op = EQ
        elif "=" in part:
            key, _, val = part.partition("=")
            op = EQ
        else:
            raise SelectorError(
                f"unparseable field selector {part!r} (want k=v)")
        key = key.strip()
        if not key:
            raise SelectorError(f"empty key in field selector {part!r}")
        reqs.append(Requirement(key, op, (val.strip(),)))
    return tuple(reqs)


def match_fields(reqs: Sequence[Requirement],
                 fields: Mapping[str, str]) -> bool:
    """Field matching is exact string compare over the kind's selectable
    field set; an unknown key raises (generic/registry Store.List surfaces
    'field label not supported by the ... converter')."""
    for r in reqs:
        if r.key not in fields:
            raise SelectorError(
                f'field label not supported: "{r.key}"')
        val = fields[r.key]
        if r.op == EQ and val != r.values[0]:
            return False
        if r.op == NEQ and val == r.values[0]:
            return False
    return True


def pod_fields(pod) -> Dict[str, str]:
    """MatchPod's ToSelectableFields (pod/strategy.go:197): the pod field
    labels servers answer — spec.nodeName is the one kubelet/drain-scale
    list paths depend on."""
    return {
        "metadata.name": pod.name,
        "metadata.namespace": pod.namespace,
        "spec.nodeName": pod.node_name,
        "spec.schedulerName": pod.scheduler_name,
        "spec.restartPolicy": getattr(pod, "restart_policy", "Always"),
        "status.phase": getattr(pod, "phase", ""),
        "status.nominatedNodeName": pod.nominated_node_name,
    }


def node_fields(node) -> Dict[str, str]:
    """MatchNode's selectable fields (node/strategy.go)."""
    return {
        "metadata.name": node.name,
        "spec.unschedulable": "true" if node.unschedulable else "false",
    }


def event_fields(key: str, ev) -> Dict[str, str]:
    """The v1 Event selectable fields kubectl's --field-selector rides
    (registry/core/event/strategy.go GetAttrs ToSelectableFields):
    involvedObject identity + reason + type. ``key`` is the event's
    store key ("ns/name.series")."""
    ns, _, name = key.partition("/")
    obj_ns, _, obj_name = ev.object_key.partition("/")
    return {
        "metadata.name": name,
        "metadata.namespace": ns,
        "involvedObject.kind": getattr(ev, "involved_kind", "Pod"),
        "involvedObject.name": obj_name,
        "involvedObject.namespace": obj_ns,
        "reason": ev.reason,
        "type": ev.type,
    }


def validate_field_keys(reqs: Sequence[Requirement], kind: str) -> None:
    """Reject unsupported field labels at REQUEST/CONSTRUCTION time, not
    per object (ListOptions decoding semantics). ``kind``: "pods",
    "nodes", or "events". The one shared probe for every field-selector
    consumer (REST list/watch, Reflector) — the selectable surface
    lives only in pod_fields/node_fields/event_fields."""
    if not reqs:
        return
    from kubernetes_tpu_torch.api.types import Node, Pod

    if kind == "events":
        from kubernetes_tpu_torch.events import Event

        probe = event_fields("probe/probe.x", Event(
            type="Normal", reason="", object_key="probe/probe",
            message=""))
    elif kind == "pods":
        probe = pod_fields(Pod(name="probe"))
    else:
        probe = node_fields(Node(name="probe"))
    match_fields(reqs, probe)
