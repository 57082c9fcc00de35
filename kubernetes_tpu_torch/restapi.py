"""REST registry over the hub — the kube-apiserver's resource surface
(SURVEY §1 layer 2: pkg/master + pkg/registry + the generic apiserver),
serving the slice of the v1 API this framework's clients consume.

The storage semantics come from the hub itself (kubernetes_tpu_torch/sim.py is
the etcd3+registry analog: global revision, per-object resourceVersion,
CAS bindings, watch history with compaction); this module is the HTTP
facade the reference builds in staging/src/k8s.io/apiserver:

- GET    /api/v1/pods                         list (all namespaces)
- GET    /api/v1/namespaces/{ns}/pods         list (one namespace)
- POST   /api/v1/namespaces/{ns}/pods         create (admission → 403)
- GET    /api/v1/namespaces/{ns}/pods/{name}  read
- DELETE /api/v1/namespaces/{ns}/pods/{name}  delete
- POST   /api/v1/namespaces/{ns}/pods/{name}/binding
         the Binding subresource — the scheduler's one write
         (registry/core/pod/storage/storage.go:154 BindingREST.Create);
         409 Conflict on the CAS failures assignPod surfaces
- GET    /api/v1/nodes[/{name}], POST /api/v1/nodes, DELETE, PUT
         PUT enforces the resourceVersion precondition the way
         GuaranteedUpdate does (etcd3/store.go:236): stale rv → 409
- GET    /api/v1/[namespaces/{ns}/]{services|endpoints|events}
         read-only lists of the dataplane kinds and the Event registry
         (the events-recorder writes land here as API objects)
- GET    /api/v1/watch/{pods|nodes}?resourceVersion=N
         NDJSON event drain from the hub's watch history; a compacted
         rv → 410 Gone with reason=Expired (the client relists, exactly
         client-go Reflector's "too old resource version" path)

Status errors use the metav1.Status shape so a client-go-style consumer
can switch on reason/code.

The port's copy of ``kubernetes_tpu/restapi.py``. Node and pod lists and
single objects answer ``Accept: application/vnd.kubernetes.protobuf`` in
the port's proto3 codec (``api/protobuf.py``) behind the k8s magic
envelope, as the reference does; request bodies are read as JSON.
"""

from __future__ import annotations

import collections
import json
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from kubernetes_tpu_torch.admission import AdmissionError
from kubernetes_tpu_torch.api.selectors import (
    SelectorError,
    match_fields,
    match_labels,
    node_fields,
    parse_field_selector,
    parse_label_selector,
    pod_fields,
    validate_field_keys,
)
from kubernetes_tpu_torch.auth import (
    ALLOW,
    Attributes,
    Unauthenticated,
    forbidden_message,
)
from kubernetes_tpu_torch.extender import (
    node_from_json,
    node_to_json,
    pod_to_json,
)
from kubernetes_tpu_torch.server import pod_from_json
from kubernetes_tpu_torch.sim import Compacted, Conflict, HollowCluster


class AuditLog:
    """Request-level audit trail — the apiserver audit subsystem's shape
    (staging/src/k8s.io/apiserver/pkg/audit: policy level, one event per
    request at ResponseComplete) over this facade.

    Levels mirror audit.Level: ``"None"`` drops everything, ``"Metadata"``
    records verb/resource/code/latency, ``"Request"`` additionally keeps
    the request body. Entries land in a bounded ring (the in-memory
    backend) and optionally stream to ``sink`` (the log-backend seam —
    a callable per JSON-able entry dict)."""

    def __init__(self, level: str = "Metadata", capacity: int = 1024,
                 sink=None) -> None:
        if level not in ("None", "Metadata", "Request"):
            raise ValueError(f"unknown audit level {level!r}")
        self.level = level
        self.capacity = capacity
        self.sink = sink
        self.entries: "collections.deque" = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def record(self, verb: str, path: str, code: int, latency_s: float,
               body=None, user=None) -> None:
        if self.level == "None":
            return
        entry = {
            "stage": "ResponseComplete",
            "verb": verb,
            "requestURI": path,
            "code": code,
            "latency_s": round(latency_s, 6),
        }
        if user is not None:
            # audit events carry the authenticated identity
            # (apis/audit/types.go Event.User)
            entry["user"] = {"username": user.name,
                             "groups": list(user.groups)}
        if self.level == "Request" and body is not None:
            entry["requestObject"] = body
        with self._lock:
            self.entries.append(entry)
        if self.sink is not None:
            try:
                self.sink(entry)
            except Exception:
                # a failing log backend must never fail (or noise up) the
                # request it audits; the ring entry is already stored
                pass


#: the facade's resource surface, the single source for discovery AND the
#: OpenAPI document (name, kind, namespaced, verbs) — apiserver publishes
#: the same table through /api/v1 APIResourceList
#: (pkg/endpoints/discovery/resources) and /openapi/v2
#: (pkg/server/routes/openapi.go:30)
RESOURCES = (
    ("pods", "Pod", True,
     ("create", "delete", "get", "list", "patch", "watch")),
    ("pods/binding", "Binding", True, ("create",)),
    ("pods/eviction", "Eviction", True, ("create",)),
    ("nodes", "Node", False,
     ("create", "delete", "get", "list", "patch", "update", "watch")),
    ("namespaces", "Namespace", False, ("create", "delete", "get", "list")),
    ("services", "Service", True, ("list", "watch")),
    ("endpoints", "Endpoints", True, ("list", "watch")),
    ("events", "Event", True, ("list", "watch")),
    ("serviceaccounts", "ServiceAccount", True, ("list",)),
    ("configmaps", "ConfigMap", True, ("get", "list")),
)


#: non-core groups this facade serves READ-ONLY (writes go through the
#: hub seams that own them): coordination/v1 Leases make HA state
#: API-observable; apps/v1 Deployments+ReplicaSets make rollout state
#: observable (`kubectl get deploy` / `rollout status`). Controller
#: objects live hub-side without namespaces; they present in "default",
#: where their pods run.
LEASE_GROUP = "coordination.k8s.io"
APPS_GROUP = "apps"
CERT_GROUP = "certificates.k8s.io"
GROUPS = {
    LEASE_GROUP: (("leases", "Lease", True, ("get", "list")),),
    APPS_GROUP: (("deployments", "Deployment", True,
                  ("create", "delete", "get", "list", "patch", "update")),
                 ("deployments/scale", "Scale", True, ("get", "update")),
                 ("replicasets", "ReplicaSet", True, ("get", "list")),
                 ("daemonsets", "DaemonSet", True, ("get", "list")),
                 ("statefulsets", "StatefulSet", True, ("get", "list")),
                 ("controllerrevisions", "ControllerRevision", True,
                  ("list",))),
    CERT_GROUP: (("certificatesigningrequests",
                  "CertificateSigningRequest", False, ("get", "list")),),
}
#: group -> served version (the reference serves certificates at
#: v1beta1 in this cycle — csr.go's capi group)
GROUP_VERSIONS = {CERT_GROUP: "v1beta1"}
GROUP_RESOURCES = GROUPS[LEASE_GROUP]  # back-compat alias


def lease_to_json(ns: str, name: str, record, rv: int) -> dict:
    """coordination/v1 Lease wire shape from the stored election record
    (resourcelock.LeaderElectionRecord fields -> LeaseSpec names,
    leaselock.go:120 LeaderElectionRecordToLeaseSpec)."""
    return {
        "metadata": {"name": name, "namespace": ns,
                     "resourceVersion": str(rv)},
        "spec": {
            "holderIdentity": record.holder_identity,
            "leaseDurationSeconds": record.lease_duration_s,
            "acquireTime": record.acquire_time,
            "renewTime": record.renew_time,
            "leaseTransitions": record.leader_transitions,
        },
    }


def api_resource_list() -> dict:
    """GET /api/v1 — APIResourceList (discovery/resources analog)."""
    return {
        "kind": "APIResourceList",
        "apiVersion": "v1",
        "groupVersion": "v1",
        "resources": [
            {"name": name, "kind": kind, "namespaced": namespaced,
             "verbs": list(verbs)}
            for name, kind, namespaced, verbs in RESOURCES
        ],
    }


def openapi_doc() -> dict:
    """GET /openapi/v2 — a real (if minimal) swagger 2.0 document derived
    from the same RESOURCES table the routes implement, so the published
    surface can never drift from the served one. Operations carry the
    x-kubernetes-action the reference stamps (routes/openapi.go serves
    the aggregated spec; this facade's is hand-rolled but live)."""
    verb_http = {"create": "post", "delete": "delete", "get": "get",
                 "list": "get", "update": "put", "patch": "patch"}
    paths: dict = {}
    for name, kind, namespaced, verbs in RESOURCES:
        base, _, sub = name.partition("/")
        collection = (f"/api/v1/namespaces/{{namespace}}/{base}"
                      if namespaced else f"/api/v1/{base}")
        item = collection + "/{name}" + (f"/{sub}" if sub else "")
        for verb in verbs:
            if verb == "watch":
                route, method, action = f"/api/v1/watch/{base}", "get", "watch"
            elif verb == "create":
                # a SUBRESOURCE create posts to the item path
                # (/pods/{name}/binding); only base-resource creates post
                # to the collection
                route = item if sub else collection
                method, action = "post", "create"
            elif verb == "list":
                route, method, action = collection, "get", "list"
            else:
                route, method, action = item, verb_http[verb], verb
            op = {
                "x-kubernetes-action": action,
                "x-kubernetes-group-version-kind":
                    {"group": "", "version": "v1", "kind": kind},
                "responses": {"200": {"description": "OK"},
                              "401": {"description": "Unauthorized"}},
            }
            paths.setdefault(route, {})[method] = op
    # the non-core groups' routes (same verb->route mapping as the core
    # table; subresource names like "deployments/scale" route to the
    # item path)
    for group, resources in GROUPS.items():
        gv = GROUP_VERSIONS.get(group, "v1")
        for name, kind, namespaced, verbs in resources:
            gbase = f"/apis/{group}/{gv}"
            res, _, sub = name.partition("/")
            collection = (f"{gbase}/namespaces/{{namespace}}/{res}"
                          if namespaced else f"{gbase}/{res}")
            item = collection + "/{name}" + (f"/{sub}" if sub else "")
            gvk = {"group": group, "version": gv, "kind": kind}
            ok = {"200": {"description": "OK"},
                  "401": {"description": "Unauthorized"}}
            for verb in verbs:
                if verb == "list":
                    routes = ({f"{gbase}/{res}", collection}
                              if namespaced else {collection})
                    for route in sorted(routes):
                        paths.setdefault(route, {})["get"] = {
                            "x-kubernetes-action": "list",
                            "x-kubernetes-group-version-kind": gvk,
                            "responses": ok}
                    continue
                route = collection if verb == "create" and not sub else item
                paths.setdefault(route, {})[verb_http[verb]] = {
                    "x-kubernetes-action": verb,
                    "x-kubernetes-group-version-kind": gvk,
                    "responses": ok}
    return {
        "swagger": "2.0",
        "info": {"title": "kubernetes_tpu_torch", "version": "v1"},
        "paths": paths,
        "definitions": {
            "v1.Status": {"type": "object", "properties": {
                "kind": {"type": "string"},
                "apiVersion": {"type": "string"},
                "status": {"type": "string"},
                "reason": {"type": "string"},
                "message": {"type": "string"},
                "code": {"type": "integer"},
            }},
        },
    }


#: RFC-1123 DNS label — the apiserver's namespace/name validation
#: (apimachinery validation.IsDNS1123Label); anything else (slashes,
#: uppercase, 64+ chars) would mint objects no item route can address
_DNS_LABEL = re.compile(r"^[a-z0-9]([-a-z0-9]{0,61}[a-z0-9])?$")


def ns_to_json(hub, ns) -> dict:
    """The one v1.Namespace document shape (phase is live controller
    state), used by every namespace handler."""
    return _with_rv({
        "metadata": {"name": ns.name},
        "status": {"phase": ns.phase},
    }, hub, f"namespaces/{ns.name}")


def _rs_bound(hub, rs) -> int:
    """ONE bound-pod predicate for every apps/v1 doc shape (and the same
    rule the rolling reconcile's availability math uses)."""
    return sum(1 for k in rs.live
               if k in hub.truth_pods and hub.truth_pods[k].node_name)


def apps_rs_doc(hub, rs) -> dict:
    rv = {"resourceVersion": str(hub._revision)}
    return {
        "metadata": {"name": rs.name, "namespace": "default", **rv,
                     **({"ownerReferences": [
                         {"kind": "Deployment", "name": rs.owner}]}
                        if rs.owner else {})},
        "spec": {"replicas": rs.replicas},
        "status": {"replicas": len(rs.live),
                   "readyReplicas": _rs_bound(hub, rs),
                   "revision": rs.revision},
    }


def apps_deploy_doc(hub, d) -> dict:
    """v1.Deployment wire shape (deployment_controller syncStatus
    counts). The spec carries the WRITABLE slice round-trippably —
    template resources under spec.template so a merge patch of the
    template drives a rollout the way patching the pod template image
    does in the reference."""
    owned = [rs for rs in hub.replicasets.values() if rs.owner == d.name]
    new_rs = hub.replicasets.get(d.rs_name())
    return {
        "metadata": {"name": d.name, "namespace": "default",
                     "resourceVersion": str(hub._revision)},
        "spec": {
            "replicas": d.replicas,
            "strategy": d.strategy,
            "maxSurge": d.max_surge,
            "maxUnavailable": d.max_unavailable,
            "template": {"cpuMilli": d.cpu_milli, "memory": d.memory,
                         "priority": d.priority},
        },
        "status": {
            "observedRevision": d.template_rev,
            "replicas": sum(len(rs.live) for rs in owned),
            "updatedReplicas": (_rs_bound(hub, new_rs) if new_rs else 0),
            "readyReplicas": sum(_rs_bound(hub, rs) for rs in owned),
        },
    }


def apps_scale_doc(hub, d) -> dict:
    """autoscaling/v1 Scale — the /scale subresource document
    (pkg/registry/apps/deployment/storage/storage.go:230 ScaleREST):
    spec.replicas is the write surface HPA and kubectl scale drive."""
    owned = [rs for rs in hub.replicasets.values() if rs.owner == d.name]
    return {
        "kind": "Scale", "apiVersion": "autoscaling/v1",
        "metadata": {"name": d.name, "namespace": "default",
                     "resourceVersion": str(hub._revision)},
        "spec": {"replicas": d.replicas},
        "status": {"replicas": sum(len(rs.live) for rs in owned),
                   "selector": f"app={d.name}"},
    }


def svc_to_doc(hub, key: str, svc) -> dict:
    """v1.Service wire doc — one encoder for lists AND watch frames."""
    s_ns, name = key.split("/", 1)
    return _with_rv({
        "metadata": {"name": name, "namespace": s_ns},
        "spec": {
            "selector": dict(svc.selector),
            "clusterIP": svc.cluster_ip,
            "ports": [
                # v1 defaulting: targetPort falls back to port
                # (the apiserver's service defaulting)
                {"port": p.port,
                 "targetPort": p.target_port or p.port,
                 "protocol": p.protocol,
                 **({"nodePort": p.node_port} if p.node_port else {})}
                for p in svc.ports
            ],
            "sessionAffinity": svc.session_affinity,
            "type": getattr(svc, "type", "ClusterIP"),
        },
        **({"status": {"loadBalancer": {"ingress": [
            {"ip": svc.load_balancer_ingress}]}}}
           if getattr(svc, "load_balancer_ingress", "") else {}),
    }, hub, f"services/{key}")


def _ep_target_ref(a) -> dict:
    a_ns, a_name = a.pod_key.split("/", 1)
    return {"kind": "Pod", "name": a_name, "namespace": a_ns}


def ep_to_doc(hub, key: str, ep) -> dict:
    """v1.Endpoints wire doc — one encoder for lists AND watch frames.
    An Endpoints with no addresses at all serializes ``subsets: []``
    (the reference drops empty subsets, it never emits a subset whose
    address lists are both empty)."""
    e_ns, name = key.split("/", 1)
    subsets = []
    if ep.ready or ep.not_ready:
        subsets = [{
            "addresses": [
                {"nodeName": a.node_name, "targetRef": _ep_target_ref(a)}
                for a in ep.ready
            ],
            "notReadyAddresses": [
                {"targetRef": _ep_target_ref(a)} for a in ep.not_ready
            ],
        }]
    return _with_rv({
        "metadata": {"name": name, "namespace": e_ns},
        "subsets": subsets,
    }, hub, f"endpoints/{key}")


def event_to_doc(hub, key: str, ev) -> dict:
    """v1.Event wire doc — one encoder for lists AND watch frames."""
    ev_ns, name = key.split("/", 1)
    return _with_rv({
        "metadata": {"name": name, "namespace": ev_ns},
        "involvedObject": {
            "kind": getattr(ev, "involved_kind", "Pod"),
            "namespace": ev.object_key.split("/", 1)[0],
            "name": ev.object_key.split("/", 1)[1],
        },
        "type": ev.type,
        "reason": ev.reason,
        "message": ev.message,
        "count": ev.count,
        "firstTimestamp": ev.first_timestamp,
        "lastTimestamp": ev.last_timestamp,
    }, hub, f"events/{key}")


def status_doc(code: int, reason: str, message: str) -> dict:
    return {
        "kind": "Status",
        "apiVersion": "v1",
        "status": "Failure",
        "reason": reason,
        "message": message,
        "code": code,
    }


def _with_rv(doc: dict, hub: HollowCluster, obj_key: str) -> dict:
    doc.setdefault("metadata", {})["resourceVersion"] = str(
        hub.resource_version.get(obj_key, 0)
    )
    return doc


class ListOptions:
    """The server-evaluated slice of metav1.ListOptions (types.go:322):
    labelSelector, fieldSelector, limit, continue. Parsed once per list
    request; selector errors surface as 400 the way the apiserver's
    option-decoding does."""

    def __init__(self, query: dict) -> None:
        self.label = parse_label_selector(
            (query.get("labelSelector") or [""])[0])
        self.field = parse_field_selector(
            (query.get("fieldSelector") or [""])[0])
        try:
            self.limit = int((query.get("limit") or ["0"])[0])
        except ValueError:
            raise SelectorError("limit must be an integer")
        if self.limit < 0:
            raise SelectorError("limit must be non-negative")
        self.cont = (query.get("continue") or [""])[0]

    def matches(self, labels, fields) -> bool:
        return (match_labels(self.label, labels)
                and match_fields(self.field, fields))


def foreign_keys(doc, canon) -> list:
    """Key paths present in ``doc`` that its canonical re-serialization
    ``canon`` does not carry — i.e., fields OUTSIDE the wire projection.
    A patch introducing such a field must be rejected, never silently
    dropped (the projection would swallow it and the semantic-equality
    check would wave the patch through)."""
    out = []
    if isinstance(doc, dict) and isinstance(canon, dict):
        for k, v in doc.items():
            if k not in canon:
                out.append(k)
            else:
                out.extend(f"{k}.{p}" for p in foreign_keys(v, canon[k]))
    elif isinstance(doc, list) and isinstance(canon, list):
        for i, (a, b) in enumerate(zip(doc, canon)):
            out.extend(f"[{i}].{p}" for p in foreign_keys(a, b))
        if len(doc) > len(canon):
            out.append(f"[{len(canon)}:]")
    return out


def merge_patch(target, patch):
    """RFC 7386 JSON Merge Patch — the semantics behind
    Content-Type: application/merge-patch+json
    (apiserver/pkg/endpoints/handlers/patch.go:59 PatchResource,
    jsonmergepatch path): objects merge recursively, null DELETES the
    key, everything else replaces."""
    if not isinstance(patch, dict):
        return patch
    if not isinstance(target, dict):
        target = {}
    out = dict(target)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = merge_patch(out.get(k), v)
    return out


def encode_continue(rv: int, last_key: str) -> str:
    """Opaque continuation token (pager contract,
    apiserver/pkg/storage/etcd3/store.go encodeContinue): carries the
    list revision and the key to resume AFTER."""
    import base64

    raw = json.dumps({"rv": rv, "start": last_key}).encode()
    return base64.urlsafe_b64encode(raw).decode().rstrip("=")


def decode_continue(token: str):
    """-> (rv, start_after_key); raises SelectorError on garbage."""
    import base64

    try:
        pad = "=" * (-len(token) % 4)
        doc = json.loads(base64.urlsafe_b64decode(token + pad))
        return int(doc["rv"]), str(doc["start"])
    except Exception:
        raise SelectorError("invalid continue token")


class RestServer:
    """Serve the hub's registry over HTTP. ``serve()`` returns the bound
    port; ``close()`` shuts down."""

    #: how many revisions of history the server keeps alive for poll-
    #: watchers (the watch cache's bounded event window — cacher.go keeps
    #: a capacity-bounded cyclic buffer so watchers survive etcd
    #: compaction for a while; beyond it they get 410 and relist)
    WATCH_WINDOW = 2000

    #: per-watcher send-buffer bound: more events than this pending for
    #: one poll-watcher means it fell too far behind — it is answered
    #: 410 Gone (relist) instead of the hub serializing an unbounded
    #: drain under its lock (serving/fairness.py WatchHub semantics,
    #: adapted to the stateless poll-watch)
    WATCH_MAX_DRAIN = 4096

    def __init__(self, hub: HollowCluster, host: str = "127.0.0.1",
                 port: int = 0, audit: "AuditLog | None" = None,
                 authn=None, authz=None, fairness=None,
                 watch_max_drain: "int | None" = None,
                 metrics=None, fault_injector=None) -> None:
        """``authn``/``authz`` install the reference's request filter
        chain in its order — authentication, then authorization, then
        the handler (admission runs inside create paths), per
        DefaultBuildHandlerChain (apiserver pkg/server/config.go:639).
        ``authn=None`` (default) keeps the facade open — the reference's
        --anonymous-auth + AlwaysAllow development posture. ``authz``
        defaults to AlwaysAllow when only ``authn`` is given.

        ``fairness`` (a serving.fairness.FlowController) installs the
        APF-style admission filter AHEAD of the chain: requests are
        classified into flow schemas (exempt/watch/readonly/mutating),
        seats are bounded per flow with a bounded FIFO of waiters, and
        overload answers 429 TooManyRequests + Retry-After instead of
        piling up handler threads (the reference's priority-and-fairness
        filter position, config.go WithPriorityAndFairness)."""
        self.hub = hub
        self.audit = audit
        self.fairness = fairness
        #: faults.FaultInjector (or None): the NETWORK chaos seam —
        #: ``rest:{VERB}`` rules fire ahead of the filter chain.
        #: ``rpc_error`` answers 500 before the handler acts (definite
        #: failure); ``latency`` delays; ``rpc_timeout`` lets the
        #: handler run but kills the RESPONSE on the wire — the client
        #: sees a dead socket while the server-side state mutated, the
        #: exact ambiguity the scheduler's bind protocol must resolve.
        self.fault_injector = fault_injector
        self.watch_max_drain = (self.WATCH_MAX_DRAIN
                                if watch_max_drain is None
                                else int(watch_max_drain))
        #: watchers answered 410 for falling behind the drain bound
        self.watch_evictions = 0
        #: optional SchedulerMetrics — drives
        #: scheduler_watch_evictions_total (falls back to the fairness
        #: controller's attached metrics so one wiring covers both)
        self.metrics = metrics if metrics is not None else getattr(
            fairness, "metrics", None)
        if authz is not None and authn is None:
            # an authorizer without an authenticator would silently
            # enforce NOTHING (no identity to authorize) — refuse the
            # looks-configured-but-open posture outright
            raise ValueError(
                "authz requires authn (enable anonymous auth via "
                "TokenAuthenticator(tokens, anonymous=True) to authorize "
                "credential-less requests)"
            )
        self.authn = authn
        self.authz = authz
        # the anchor cursor pins the hub's auto-compaction floor so that
        # stateless HTTP watchers (transient cursors) can resume from an
        # rv they saw in an earlier poll; _trim (run on every request)
        # keeps the pin — and therefore retained history — bounded
        self._anchor = hub.watch(hub._revision)
        # serializes check-then-act mutations AND reads against the hub's
        # own mutators (step()/controllers run under hub.lock on the
        # sim loop's thread): the CAS semantics and dict iterations must hold
        # across ThreadingHTTPServer handler threads and the sim loop
        self._lock = getattr(hub, "lock", None) or threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _drain_body(self) -> None:
                """Discard any unread request body before responding.
                An early rejection (404 on an unknown path, 401, bad
                verb) that never touched rfile leaves the POSTed body in
                the socket's receive buffer; closing the connection with
                unread data makes the kernel send RST instead of FIN,
                and the client's in-flight response read then fails with
                ECONNRESET — a timing-dependent flake the REST fuzz test
                catches. Bounded (1 MiB) so a hostile Content-Length
                cannot wedge a handler thread."""
                if getattr(self, "_body_read", False):
                    return
                self._body_read = True
                try:
                    n = int(self.headers.get("Content-Length") or 0)
                except (TypeError, ValueError):
                    return
                if 0 < n <= 1 << 20:
                    try:
                        self.rfile.read(n)
                    except OSError:
                        pass

            def _send_raw(self, code: int, ctype: str, body: bytes,
                          headers=None) -> None:
                self._code = code  # for the audit trail
                self._drain_body()
                if getattr(self, "_buffer_mode", False):
                    # built under the hub lock, WRITTEN outside it — a
                    # slow client must never wedge the hub on socket I/O
                    self._buffered = (code, ctype, body, headers)
                    return
                self._write_response(code, ctype, body, headers)

            def _write_response(self, code, ctype, body, headers) -> None:
                if getattr(self, "_suppress_response", False):
                    # injected ambiguous timeout (rpc_timeout at the
                    # rest seam): the handler ran and the state
                    # mutated, but the answer dies on the wire — close
                    # without responding so the client observes exactly
                    # what a timed-out RPC observes
                    self.close_connection = True
                    return
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _flush_buffered(self) -> None:
                buffered, self._buffered = getattr(self, "_buffered", None), None
                self._buffer_mode = False
                if buffered is not None:
                    self._write_response(*buffered)

            def _respond(self, code: int, doc, headers=None) -> None:
                self._send_raw(code, "application/json",
                               json.dumps(doc).encode(), headers)

            def _fail(self, code: int, reason: str, message: str,
                      headers=None) -> None:
                self._respond(code, status_doc(code, reason, message),
                              headers)

            def do_GET(self):
                outer._begin(self)
                if outer._net_fault(self):
                    return
                t0 = time.perf_counter()
                seat = outer._admit(self, "GET")
                try:
                    if seat is None or not outer._auth(self, "GET"):
                        return
                    # reads hold the same lock as mutations (and as
                    # hub.step()): a list comprehension over a hub dict
                    # must never race a concurrent create/delete. The
                    # response is only BUFFERED under the lock; the socket
                    # write happens after release.
                    self._buffer_mode = True
                    with outer._lock:
                        outer._get(self)
                    self._flush_buffered()
                finally:
                    outer._release(seat)
                    outer._record_audit(self, "get", t0)

            def do_POST(self):
                outer._begin(self)
                if outer._net_fault(self):
                    return
                t0 = time.perf_counter()
                seat = outer._admit(self, "POST")
                try:
                    if seat is None or not outer._auth(self, "POST"):
                        return
                    with outer._lock:
                        outer._post(self)
                finally:
                    outer._release(seat)
                    outer._record_audit(self, "create", t0)

            def do_PUT(self):
                outer._begin(self)
                if outer._net_fault(self):
                    return
                t0 = time.perf_counter()
                seat = outer._admit(self, "PUT")
                try:
                    if seat is None or not outer._auth(self, "PUT"):
                        return
                    with outer._lock:
                        outer._put(self)
                finally:
                    outer._release(seat)
                    outer._record_audit(self, "update", t0)

            def do_DELETE(self):
                outer._begin(self)
                if outer._net_fault(self):
                    return
                t0 = time.perf_counter()
                seat = outer._admit(self, "DELETE")
                try:
                    if seat is None or not outer._auth(self, "DELETE"):
                        return
                    with outer._lock:
                        outer._delete(self)
                finally:
                    outer._release(seat)
                    outer._record_audit(self, "delete", t0)

            def do_PATCH(self):
                outer._begin(self)
                if outer._net_fault(self):
                    return
                t0 = time.perf_counter()
                seat = outer._admit(self, "PATCH")
                try:
                    if seat is None or not outer._auth(self, "PATCH"):
                        return
                    with outer._lock:
                        outer._patch(self)
                finally:
                    outer._release(seat)
                    outer._record_audit(self, "patch", t0)

        self._closed = False
        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_port
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )

    def _net_fault(self, handler) -> bool:
        """Injected network fault for one request (site
        ``rest:{METHOD}``). Returns True when the request was fully
        answered here (``rpc_error`` → 500 before any handler state
        changed); ``latency`` sleeps then proceeds; ``rpc_timeout``
        marks the handler's RESPONSE for suppression and proceeds —
        the ambiguous class at the HTTP layer."""
        inj = self.fault_injector
        if inj is None:
            return False
        out = inj.rpc_hook(f"rest:{handler.command}")
        if out is None:
            return False
        kind, rule, _committed = out
        if kind == "rpc_error":
            handler._fail(500, "InternalError",
                          "injected rpc error (nothing committed)")
            return True
        if kind == "latency":
            time.sleep(min(max(rule.latency_s, 0.0), 1.0))
        elif kind == "rpc_timeout":
            handler._suppress_response = True
        return False

    def serve(self) -> int:
        self._thread.start()

        def trim_loop():
            # request-driven trimming alone would pin the hub's
            # compaction floor forever on an idle server; this keeps the
            # retained history bounded regardless of traffic
            while not self._closed:
                self._trim()
                time.sleep(1.0)

        self._trimmer = threading.Thread(target=trim_loop, daemon=True,
                                         name="rest-watch-trim")
        self._trimmer.start()
        return self.port

    def _trim(self) -> None:
        """Advance the compaction pin AND enforce it, keeping at most
        ~WATCH_WINDOW revisions of history alive regardless of request
        mix. Moving only the anchor (the pre-serving behavior) merely
        ALLOWED a sim-driven ``hub.step()`` to compact; a REST-only hub
        never stepped, so sustained churn grew the watch history without
        bound — the compaction now happens here, batched (one sweep per
        WATCH_WINDOW/8 revisions) so a hot request path never pays an
        O(history) filter per request. Watchers that fall behind the
        floor get the clean 410 Gone + relist answer from ``_watch``,
        never a silently truncated drain. This deliberately overrides
        the hub's slowest-open-cursor auto-compaction (sim.step): an
        in-process cursor (Reflector) lagging more than WATCH_WINDOW
        revisions gets Compacted and relists — the reference's bounded
        watch cache makes exactly that trade, and relist-on-Compacted
        is the Reflector contract."""
        pin = self.hub._revision - self.WATCH_WINDOW
        self._anchor.rev = max(self._anchor.rev, pin)
        if pin - self.hub._compacted_rev >= max(self.WATCH_WINDOW // 8, 1):
            with self._lock:
                self.hub.compact(pin)

    def _admit(self, h, http_verb: str):
        """APF-style admission, ahead of authn (the filter-chain slot of
        WithPriorityAndFairness): classify into a flow schema, take a
        seat (bounded FIFO wait), or answer 429 + Retry-After. Returns
        the seat to pass to :meth:`_release` — "" when no fairness
        filter is installed, None when the request was shed."""
        if self.fairness is None:
            return ""
        from kubernetes_tpu_torch.serving.fairness import RequestRejected

        flow = self.fairness.classify(http_verb, h.path)
        try:
            return self.fairness.acquire(flow)
        except RequestRejected as e:
            h._fail(429, "TooManyRequests", str(e),
                    headers={"Retry-After":
                             str(max(int(round(e.retry_after_s)), 1))})
            return None

    def _release(self, seat) -> None:
        if seat and self.fairness is not None:
            self.fairness.release(seat)

    def _begin(self, h) -> None:
        """Per-request entry: trim history and clear per-request handler
        state — on a keep-alive connection the handler INSTANCE is reused,
        so stale _code/_audit_body from the previous request would be
        audited for the next one."""
        self._trim()
        h._code = 0
        h._audit_body = None
        h._user = None
        h._body_read = False  # this request's body not yet consumed

    def _auth(self, h, http_verb: str) -> bool:
        """The authentication -> authorization filter pair, ahead of all
        handler logic (WithAuthentication/WithAuthorization,
        endpoints/filters/authentication.go:41, authorization.go:42).
        Returns False after sending the Status-shaped 401/403."""
        if self.authn is None:
            return True
        try:
            user = self.authn.authenticate(h.headers)
        except Unauthenticated as e:
            h._fail(401, "Unauthorized", str(e))
            return False
        h._user = user
        verb, resource, ns, name = self.request_info(http_verb, h.path)
        attrs = Attributes(
            user=user, verb=verb, resource=resource, namespace=ns,
            name=name,
            # non-resource request (discovery/openapi/version): carry the
            # raw path for NonResourceURLs rules
            path="" if resource else h.path.split("?", 1)[0].rstrip("/"),
        )
        authz = self.authz
        if authz is not None and authz.authorize(attrs) != ALLOW:
            h._fail(403, "Forbidden", forbidden_message(attrs))
            return False
        return True

    @staticmethod
    def request_info(http_verb: str, path: str):
        """(verb, resource, namespace, name) for authorization — the
        RequestInfo resolver (endpoints/request/requestinfo.go:158):
        POSITIONAL segments only, GET on an exact collection route is
        "list", "watch" only as the segment after the version prefix,
        subresources join the resource as "pods/binding" (the rbac/v1
        resource spelling). Group-routed paths
        (/apis/coordination.k8s.io/v1/...) resolve the same way — the
        RBAC resource name carries no group prefix."""
        p = path.split("?", 1)[0]
        seg = RestServer._route(p)
        if seg is None:
            routed = RestServer._route_group(p)
            seg = routed[1] if routed is not None else None
        verb = {"GET": "get", "POST": "create", "PUT": "update",
                "DELETE": "delete", "PATCH": "patch"}.get(
                    http_verb, http_verb.lower())
        if not seg:
            return verb, "", "", ""
        if seg[0] == "watch":
            return "watch", seg[1] if len(seg) > 1 else "", "", ""
        ns = name = ""
        resource, rest = seg[0], seg[1:]
        if seg[0] == "namespaces" and len(seg) >= 3:
            ns, resource, rest = seg[1], seg[2], seg[3:]
        if rest:
            name = rest[0]
            if len(rest) >= 2:
                resource = f"{resource}/{rest[1]}"
        elif verb == "get":
            verb = "list"
        return verb, resource, ns, name

    def _record_audit(self, h, verb: str, t0: float) -> None:
        if self.audit is None:
            return
        path = h.path
        if verb == "get":
            # one resolver for audit AND authorization (request_info):
            # positional RequestInfo semantics — "watch" only right after
            # the version prefix, "list" only for nameless collections
            verb = self.request_info("GET", path)[0]
        self.audit.record(verb, path, getattr(h, "_code", 0),
                          time.perf_counter() - t0,
                          body=getattr(h, "_audit_body", None),
                          user=getattr(h, "_user", None))

    def close(self) -> None:
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()

    # -- routing helpers ----------------------------------------------------

    @staticmethod
    def _route(path: str):
        """Split '/api/v1/...' into segments after the version."""
        parts = [p for p in path.split("/") if p]
        if parts[:2] != ["api", "v1"]:
            return None
        return parts[2:]

    @staticmethod
    def _route_group(path: str):
        """Split '/apis/<group>/v1/...' into segments after the
        group-version (the apiserver's group routing layer) for any
        served group. Returns (group, segments) or None."""
        parts = [p for p in path.split("/") if p]
        if (len(parts) >= 3 and parts[0] == "apis" and parts[1] in GROUPS
                and parts[2] == GROUP_VERSIONS.get(parts[1], "v1")):
            return parts[1], parts[3:]
        return None

    @staticmethod
    def _read_body(h):
        """Parsed JSON body, or None (after a 400 response) on garbage."""
        n = int(h.headers.get("Content-Length", 0))
        raw = h.rfile.read(n) or b"{}"
        h._body_read = True  # _drain_body must not read the socket again
        try:
            doc = json.loads(raw)
        except ValueError:
            h._fail(400, "BadRequest", "request body is not valid JSON")
            return None
        if not isinstance(doc, dict):
            h._fail(400, "BadRequest", "request body must be a JSON object")
            return None
        h._audit_body = doc  # Request-level audit keeps the object
        return doc

    # -- GET ----------------------------------------------------------------

    def _get(self, h) -> None:
        url = urlparse(h.path)
        path = url.path.rstrip("/")
        # discovery + OpenAPI (nonResourceURLs in the reference's terms):
        # /api -> APIVersions, /api/v1 -> APIResourceList,
        # /openapi/v2 -> the live swagger doc, /version -> version info
        if path == "/api":
            return h._respond(200, {"kind": "APIVersions",
                                    "versions": ["v1"]})
        if path == "/api/v1":
            return h._respond(200, api_resource_list())
        if path == "/apis":
            return h._respond(200, {
                "kind": "APIGroupList",
                "groups": [{
                    "name": g,
                    "versions": [{
                        "groupVersion":
                            f"{g}/{GROUP_VERSIONS.get(g, 'v1')}",
                        "version": GROUP_VERSIONS.get(g, "v1")}],
                    "preferredVersion": {
                        "groupVersion":
                            f"{g}/{GROUP_VERSIONS.get(g, 'v1')}",
                        "version": GROUP_VERSIONS.get(g, "v1")},
                } for g in sorted(GROUPS)],
            })
        for g, resources in GROUPS.items():
            gv = GROUP_VERSIONS.get(g, "v1")
            if path == f"/apis/{g}/{gv}":
                return h._respond(200, {
                    "kind": "APIResourceList",
                    "groupVersion": f"{g}/{gv}",
                    "resources": [
                        {"name": name, "kind": kind,
                         "namespaced": namespaced, "verbs": list(verbs)}
                        for name, kind, namespaced, verbs in resources
                    ],
                })
        routed = self._route_group(url.path)
        if routed is not None:
            group, gseg = routed
            if group == LEASE_GROUP:
                return self._get_lease(h, gseg)
            if group == CERT_GROUP:
                return self._get_certs(h, gseg)
            return self._get_apps(h, gseg)
        if path == "/openapi/v2":
            return h._respond(200, openapi_doc())
        if path == "/version":
            from kubernetes_tpu_torch import version_info

            return h._respond(200, version_info())
        seg = self._route(url.path)
        hub = self.hub
        if not seg:
            return h._fail(404, "NotFound", h.path)
        if seg[0] == "watch":
            return self._watch(h, seg[1:], parse_qs(url.query))
        if seg == ["nodes"]:
            from kubernetes_tpu_torch.api.protobuf import node_list_to_pb

            return self._serve_list(
                h, parse_qs(url.query), "NodeList",
                list(hub.truth_nodes.values()),
                node_fields, lambda n: n.labels,
                lambda n: _with_rv(node_to_json(n), hub, f"nodes/{n.name}"),
                lambda n: n.name, to_pb_list=node_list_to_pb)
        if len(seg) == 2 and seg[0] == "nodes":
            n = hub.truth_nodes.get(seg[1])
            if n is None:
                return h._fail(404, "NotFound", f'nodes "{seg[1]}" not found')
            if self._wants_proto(h):
                from kubernetes_tpu_torch.api.protobuf import (
                    PROTO_CONTENT_TYPE,
                    encode_envelope,
                    node_to_pb,
                )

                return h._send_raw(200, PROTO_CONTENT_TYPE,
                                   encode_envelope("Node", node_to_pb(n)))
            return h._respond(200, _with_rv(node_to_json(n), hub,
                                            f"nodes/{n.name}"))
        if seg[0] == "namespaces" and len(seg) <= 2:
            # namespace discovery reads (registry/core/namespace): the
            # lifecycle phase is live state — Terminating is what the
            # namespace controller is mid-draining
            if len(seg) == 1:
                return h._respond(200, {
                    "kind": "NamespaceList", "apiVersion": "v1",
                    "metadata": {"resourceVersion": str(hub._revision)},
                    "items": [ns_to_json(hub, n)
                              for n in hub.namespaces.values()],
                })
            n = hub.namespaces.get(seg[1])
            if n is None:
                return h._fail(404, "NotFound",
                               f'namespaces "{seg[1]}" not found')
            return h._respond(200, ns_to_json(hub, n))
        ns = None
        if seg[0] == "namespaces" and len(seg) >= 3:
            ns, seg = seg[1], seg[2:]
        if seg in (["services"], ["endpoints"]):
            # selector semantics mirror the watch side exactly (the
            # informer list+watch pair must accept identical options):
            # these kinds carry no labels, so a non-empty labelSelector
            # selects nothing; fields are metadata-only
            try:
                q = parse_qs(url.query)
                lsel = parse_label_selector(
                    (q.get("labelSelector") or [""])[0])
                fsel = parse_field_selector(
                    (q.get("fieldSelector") or [""])[0])
                match_fields(fsel, {"metadata.name": "probe",
                                    "metadata.namespace": "probe"})
            except SelectorError as e:
                return h._fail(400, "BadRequest", str(e))
            registry = (hub.services if seg == ["services"]
                        else hub.endpoints)
            to_doc = svc_to_doc if seg == ["services"] else ep_to_doc
            items = []
            for key, obj in sorted(registry.items()):
                k_ns, _, k_name = key.partition("/")
                if ns is not None and k_ns != ns:
                    continue
                if lsel and not match_labels(lsel, {}):
                    continue
                if fsel and not match_fields(fsel, {
                        "metadata.name": k_name,
                        "metadata.namespace": k_ns}):
                    continue
                items.append(to_doc(hub, key, obj))
            return h._respond(200, {
                "kind": ("ServiceList" if seg == ["services"]
                         else "EndpointsList"),
                "apiVersion": "v1",
                "metadata": {"resourceVersion": str(hub._revision)},
                "items": items,
            })
        if seg == ["events"]:
            from kubernetes_tpu_torch.api.selectors import event_fields

            # field selectors (reason=..., involvedObject.name=... — the
            # kubectl --field-selector workflow); events carry no labels
            # so a labelSelector matches only when empty. Ordering stays
            # lastTimestamp (kubectl's newest-last), so the paginated
            # _serve_list pipeline (key-ordered) deliberately does not
            # serve this kind.
            try:
                fsel = parse_field_selector(
                    (parse_qs(url.query).get("fieldSelector") or [""])[0])
                validate_field_keys(fsel, "events")
                lsel = parse_label_selector(
                    (parse_qs(url.query).get("labelSelector") or [""])[0])
            except SelectorError as e:
                return h._fail(400, "BadRequest", str(e))
            items = []
            for key, ev in sorted(
                    getattr(hub, "events_v1", {}).items(),
                    key=lambda kv: kv[1].last_timestamp):
                ev_ns, name = key.split("/", 1)
                if ns is not None and ev_ns != ns:
                    continue
                if fsel and not match_fields(fsel, event_fields(key, ev)):
                    continue
                if lsel and not match_labels(lsel, {}):
                    continue
                items.append(event_to_doc(hub, key, ev))
            return h._respond(200, {
                "kind": "EventList", "apiVersion": "v1",
                "metadata": {"resourceVersion": str(hub._revision)},
                "items": items,
            })
        if seg == ["serviceaccounts"]:
            items = []
            for key in sorted(hub.service_accounts):
                sa_ns, name = key.split("/", 1)
                if ns is not None and sa_ns != ns:
                    continue
                items.append(_with_rv({
                    "metadata": {"name": name, "namespace": sa_ns},
                    # the tokens controller's credential, referenced the
                    # way v1 SAs reference their token secrets (names
                    # only — the secret VALUE never rides a list)
                    "secrets": [{"name": f"{name}-token"}],
                }, hub, f"serviceaccounts/{key}"))
            return h._respond(200, {
                "kind": "ServiceAccountList", "apiVersion": "v1",
                "metadata": {"resourceVersion": str(hub._revision)},
                "items": items,
            })
        if seg == ["configmaps"]:
            items = []
            for key in sorted(hub.configmaps):
                cm_ns, name = key.split("/", 1)
                if ns is not None and cm_ns != ns:
                    continue
                items.append(_with_rv({
                    "metadata": {"name": name, "namespace": cm_ns},
                    "data": dict(hub.configmaps[key].get("data", {})),
                }, hub, f"configmaps/{key}"))
            return h._respond(200, {
                "kind": "ConfigMapList", "apiVersion": "v1",
                "metadata": {"resourceVersion": str(hub._revision)},
                "items": items,
            })
        if (len(seg) == 2 and seg[0] == "configmaps" and ns is not None):
            key = f"{ns}/{seg[1]}"
            cm = hub.configmaps.get(key)
            if cm is None:
                return h._fail(404, "NotFound",
                               f'configmaps "{seg[1]}" not found')
            return h._respond(200, _with_rv({
                "metadata": {"name": seg[1], "namespace": ns},
                "data": dict(cm.get("data", {})),
            }, hub, f"configmaps/{key}"))
        if seg == ["pods"]:
            from kubernetes_tpu_torch.api.protobuf import pod_list_to_pb

            return self._serve_list(
                h, parse_qs(url.query), "PodList",
                [p for p in hub.truth_pods.values()
                 if ns is None or p.namespace == ns],
                pod_fields, lambda p: p.labels,
                lambda p: _with_rv(pod_to_json(p), hub,
                                   f"pods/{p.key()}"),
                lambda p: p.key(), to_pb_list=pod_list_to_pb)
        if len(seg) == 2 and seg[0] == "pods" and ns is not None:
            p = hub.truth_pods.get(f"{ns}/{seg[1]}")
            if p is None:
                return h._fail(404, "NotFound", f'pods "{seg[1]}" not found')
            if self._wants_proto(h):
                from kubernetes_tpu_torch.api.protobuf import (
                    PROTO_CONTENT_TYPE,
                    encode_envelope,
                    pod_to_pb,
                )

                return h._send_raw(200, PROTO_CONTENT_TYPE,
                                   encode_envelope("Pod", pod_to_pb(p)))
            return h._respond(200, _with_rv(pod_to_json(p), hub,
                                            f"pods/{p.key()}"))
        return h._fail(404, "NotFound", h.path)

    def _get_lease(self, h, seg) -> None:
        """Read-only Lease routes: list (all or one namespace) and get."""
        hub = self.hub

        def doc(key):
            ns, name = key.split("/", 1)
            return lease_to_json(
                ns, name, hub.leases[key],
                hub.resource_version.get(f"leases/{key}", 0))

        ns = None
        if seg[:1] == ["namespaces"] and len(seg) >= 3:
            ns, seg = seg[1], seg[2:]
        if seg == ["leases"]:
            items = [doc(key) for key in sorted(hub.leases)
                     if ns is None or key.split("/", 1)[0] == ns]
            return h._respond(200, {
                "kind": "LeaseList",
                "apiVersion": f"{LEASE_GROUP}/v1",
                "metadata": {"resourceVersion": str(hub._revision)},
                "items": items,
            })
        if len(seg) == 2 and seg[0] == "leases" and ns is not None:
            key = f"{ns}/{seg[1]}"
            if key not in hub.leases:
                return h._fail(404, "NotFound",
                               f'leases "{seg[1]}" not found')
            return h._respond(200, doc(key))
        return h._fail(404, "NotFound", h.path)

    def _get_certs(self, h, seg) -> None:
        """certificates.k8s.io/v1beta1 read routes: CSR list + get
        (cluster-scoped). The status carries the approval condition and
        whether a certificate was issued — the credential VALUE never
        rides a list (same rule as SA token secrets)."""
        hub = self.hub

        def doc(csr):
            conditions = []
            if csr.approved is True:
                conditions.append({"type": "Approved",
                                   "message": csr.approval_message})
            elif csr.approved is False:
                conditions.append({"type": "Denied",
                                   "message": csr.approval_message})
            return _with_rv({
                "metadata": {"name": csr.name},
                "spec": {
                    "username": csr.username,
                    "groups": list(csr.groups),
                    "usages": list(csr.usages),
                    "request": {"commonName": csr.request_cn,
                                "organizations": list(csr.request_orgs)},
                },
                "status": {
                    "conditions": conditions,
                    "certificateIssued": bool(csr.certificate),
                },
            }, hub, f"certificatesigningrequests/{csr.name}")

        if seg == ["certificatesigningrequests"]:
            return h._respond(200, {
                "kind": "CertificateSigningRequestList",
                "apiVersion": f"{CERT_GROUP}/v1beta1",
                "metadata": {"resourceVersion": str(hub._revision)},
                "items": [doc(hub.csrs[n]) for n in sorted(hub.csrs)],
            })
        if len(seg) == 2 and seg[0] == "certificatesigningrequests":
            csr = hub.csrs.get(seg[1])
            if csr is None:
                return h._fail(
                    404, "NotFound",
                    f'certificatesigningrequests "{seg[1]}" not found')
            return h._respond(200, doc(csr))
        return h._fail(404, "NotFound", h.path)

    def _get_apps(self, h, seg) -> None:
        """apps/v1 read routes: deployment + replicaset lists/gets (docs
        built by the module-level apps_*_doc helpers, shared with the
        write paths) plus the /scale subresource read. Controller objects
        are not individually versioned in the hub (hollow controllers
        mutate in place); item docs carry the GLOBAL revision so clients
        still get a usable change indicator."""
        hub = self.hub

        def rs_doc(rs):
            return apps_rs_doc(hub, rs)

        def deploy_doc(d):
            return apps_deploy_doc(hub, d)

        ns = None
        if seg[:1] == ["namespaces"] and len(seg) >= 3:
            ns, seg = seg[1], seg[2:]
        if ns not in (None, "default"):
            # controller objects live in "default" (module doc); other
            # namespaces legitimately have an EMPTY list of the KNOWN
            # kinds — but an unknown resource is 404, not a mislabeled
            # empty list
            empty_kinds = {"deployments": "DeploymentList",
                           "replicasets": "ReplicaSetList",
                           "daemonsets": "DaemonSetList",
                           "statefulsets": "StatefulSetList",
                           "controllerrevisions": "ControllerRevisionList"}
            if len(seg) == 1 and seg[0] in empty_kinds:
                return h._respond(200, {
                    "kind": empty_kinds[seg[0]],
                    "apiVersion": "apps/v1",
                    "metadata": {"resourceVersion": str(hub._revision)},
                    "items": []})
            return h._fail(404, "NotFound", h.path)
        def ds_doc(ds):
            live = [k for k in ds.live if k in hub.truth_pods]
            current = [k for k in live
                       if hub.truth_pods[k].labels.get("rev")
                       == str(ds.template_rev)]
            return _with_rv({
                "metadata": {"name": ds.name, "namespace": "default"},
                "spec": {
                    "updateStrategy": {"type": "RollingUpdate",
                                       "rollingUpdate": {"maxUnavailable":
                                                         ds.max_unavailable}},
                    "template": {"spec": {"nodeSelector":
                                          dict(ds.node_selector)}},
                },
                "status": {
                    "desiredNumberScheduled": len(ds.live),
                    "numberReady": sum(
                        1 for k in live if hub.truth_pods[k].node_name),
                    "updatedNumberScheduled": len(current),
                    "observedRevision": ds.template_rev,
                },
            }, hub, f"daemonsets/{ds.name}")

        def sts_doc(ss):
            pods = [p for p in hub.truth_pods.values()
                    if p.labels.get("ss") == ss.name]
            return _with_rv({
                "metadata": {"name": ss.name, "namespace": "default"},
                "spec": {
                    "replicas": ss.replicas,
                    "updateStrategy": {"type": "RollingUpdate",
                                       "rollingUpdate": {"partition":
                                                         ss.partition}},
                },
                "status": {
                    "replicas": len(pods),
                    "readyReplicas": sum(1 for p in pods if p.node_name),
                    "updatedReplicas": sum(
                        1 for p in pods
                        if p.labels.get("rev") == str(ss.template_rev)),
                    "observedRevision": ss.template_rev,
                },
            }, hub, f"statefulsets/{ss.name}")

        def cr_doc(cr):
            return _with_rv({
                "metadata": {"name": f"{cr.owner_name}-{cr.revision}",
                             "namespace": "default",
                             "ownerReferences": [{"kind": cr.owner_kind,
                                                  "name": cr.owner_name}]},
                "revision": cr.revision,
                "data": dict(cr.data),
            }, hub, f"controllerrevisions/{cr.key()}")

        if seg == ["controllerrevisions"]:
            items = [cr_doc(cr) for _, cr in
                     sorted(hub.controller_revisions.items())]
            return h._respond(200, {
                "kind": "ControllerRevisionList", "apiVersion": "apps/v1",
                "metadata": {"resourceVersion": str(hub._revision)},
                "items": items,
            })
        for kind, registry, doc, list_kind in (
                ("deployments", hub.deployments, deploy_doc,
                 "DeploymentList"),
                ("replicasets", hub.replicasets, rs_doc,
                 "ReplicaSetList"),
                ("daemonsets", hub.daemonsets, ds_doc, "DaemonSetList"),
                ("statefulsets", hub.statefulsets, sts_doc,
                 "StatefulSetList")):
            if seg == [kind]:
                return h._respond(200, {
                    "kind": list_kind,
                    "apiVersion": "apps/v1",
                    "metadata": {"resourceVersion": str(hub._revision)},
                    "items": [doc(o) for _, o in sorted(registry.items())],
                })
            if len(seg) == 2 and seg[0] == kind:
                obj = registry.get(seg[1])
                if obj is None:
                    return h._fail(404, "NotFound",
                                   f'{kind} "{seg[1]}" not found')
                return h._respond(200, doc(obj))
        if (len(seg) == 3 and seg[0] == "deployments"
                and seg[2] == "scale"):
            d = hub.deployments.get(seg[1])
            if d is None:
                return h._fail(404, "NotFound",
                               f'deployments "{seg[1]}" not found')
            return h._respond(200, apps_scale_doc(hub, d))
        return h._fail(404, "NotFound", h.path)

    @staticmethod
    def _wants_proto(h) -> bool:
        from kubernetes_tpu_torch.api.protobuf import PROTO_CONTENT_TYPE

        return PROTO_CONTENT_TYPE in (h.headers.get("Accept") or "")

    def _serve_list(self, h, query, kind, objs, obj_fields, obj_labels,
                    to_json, key_of, to_pb_list=None) -> None:
        """One list pipeline for the selectable kinds: ListOptions parse →
        hub-side selector evaluation BEFORE any serialization (the watch
        cache's reason to exist — pod/strategy.go:197 MatchPod) → key-
        ordered limit/continue pagination (pager contract).

        Continuation fidelity: the reference serves every page of one
        list at the token's revision straight from etcd. This hub keeps
        only live truth + bounded watch history, so follow-up pages read
        CURRENT state after the token's resume key; the token's revision
        is still honored against the compaction floor — a token older
        than retained history gets 410 Expired exactly like the
        reference's "continue parameter is too old" path, telling the
        client to restart the list."""
        hub = self.hub
        try:
            opts = ListOptions(query)
            if opts.label or opts.field:
                selected = [o for o in objs
                            if opts.matches(obj_labels(o), obj_fields(o))]
            else:
                selected = list(objs)  # hot path: no per-object field dicts
        except SelectorError as e:
            return h._fail(400, "BadRequest", str(e))
        selected.sort(key=key_of)
        # the revision every page of THIS list reports and re-encodes:
        # continuation pages carry the ORIGINAL list revision forward
        # (the reference's continue token does the same) — re-stamping
        # with the current revision would let a slow pager outrun
        # compaction without ever seeing the 410 restart signal
        list_rv = hub._revision
        if opts.cont:
            try:
                list_rv, start = decode_continue(opts.cont)
            except SelectorError as e:
                return h._fail(400, "BadRequest", str(e))
            if list_rv < hub._compacted_rev:
                return h._fail(
                    410, "Expired",
                    "the provided continue parameter is too old to display "
                    "a consistent list result; restart the list without it")
            selected = [o for o in selected if key_of(o) > start]
        meta = {"resourceVersion": str(list_rv)}
        if opts.limit and len(selected) > opts.limit:
            remaining = len(selected) - opts.limit
            selected = selected[:opts.limit]
            meta["continue"] = encode_continue(list_rv,
                                               key_of(selected[-1]))
            if not (opts.label or opts.field):
                # ListMeta contract: remainingItemCount is OMITTED on
                # selector'd lists (the apiserver can't compute it
                # exactly there and leaves the field unset)
                meta["remainingItemCount"] = remaining
        if to_pb_list is not None and self._wants_proto(h):
            # Accept: application/vnd.kubernetes.protobuf — the typed
            # codec behind the k8s magic envelope (protobuf.go:95); the
            # big-list wire-efficiency path
            from kubernetes_tpu_torch.api.protobuf import (
                PROTO_CONTENT_TYPE,
                encode_envelope,
            )

            msg = to_pb_list(selected, int(meta["resourceVersion"]))
            msg.continue_token = meta.get("continue", "")
            msg.remaining = meta.get("remainingItemCount", -1)
            return h._send_raw(200, PROTO_CONTENT_TYPE,
                               encode_envelope(kind, msg))
        return h._respond(200, {
            "kind": kind, "apiVersion": "v1", "metadata": meta,
            "items": [to_json(o) for o in selected],
        })

    # -- watch --------------------------------------------------------------

    def _watch(self, h, seg, query) -> None:
        """Drain currently-available events after ?resourceVersion as
        NDJSON and close — the chunked-frame watch with the client
        re-polling from its last seen rv (the cacher's delegation to
        etcd watch, compressed to a poll per request).

        ``labelSelector``/``fieldSelector`` scope the feed the way the
        cacher's watchFilterFunction does: matching ADDED/MODIFIED pass
        through, a MODIFIED whose new state no longer matches becomes a
        DELETED frame (the selector-scoped-feed contract informer caches
        rely on), non-matching ADDED are dropped.

        ``allowWatchBookmarks=true`` appends a final BOOKMARK frame
        carrying the revision this poll reached (cacher.go
        bookmarkAfterResourceVersion / watch_cache_interval): a watcher
        whose selector filters out all traffic still advances its
        anchor, so compaction of the quiet interval cannot 410 it into
        a full relist — exactly the reference's reason for bookmarks. One approximation vs
        the reference: the cacher tracks prevObject and suppresses
        DELETED frames for objects the watcher never matched; this
        stateless poll-watch cannot, so such frames may be sent — an
        informer cache ignores deletes of unknown keys, so the contract
        holds."""
        if seg not in (["pods"], ["nodes"], ["services"], ["endpoints"],
                       ["events"]):
            return h._fail(404, "NotFound", "/".join(seg))
        kind = seg[0]
        selectable = kind in ("pods", "nodes")
        try:
            rv = int((query.get("resourceVersion") or ["0"])[0])
        except ValueError:
            return h._fail(400, "BadRequest",
                           "resourceVersion must be an integer")
        try:
            lsel = parse_label_selector(
                (query.get("labelSelector") or [""])[0])
            fsel = parse_field_selector(
                (query.get("fieldSelector") or [""])[0])
            if selectable:
                validate_field_keys(fsel, kind)
            elif kind == "events":
                validate_field_keys(fsel, "events")
            else:
                # services/endpoints: metadata-only selectable fields
                # (strategy ToSelectableFields); unknown keys error at
                # request time like every other kind
                match_fields(fsel, {"metadata.name": "probe",
                                    "metadata.namespace": "probe"})
        except SelectorError as e:
            return h._fail(400, "BadRequest", str(e))

        from kubernetes_tpu_torch.api.selectors import event_fields

        def selects(store_key, obj) -> bool:
            # label-less kinds (events/services/endpoints in this model)
            # match a labelSelector against {} — a non-empty selector
            # selects nothing, same as the list side and the reference's
            # semantics for unlabeled objects (never a 400: the standard
            # informer list+watch pair must accept identical options)
            if kind == "events":
                return (match_labels(lsel, {})
                        and match_fields(fsel, event_fields(store_key, obj)))
            if kind in ("services", "endpoints"):
                s_ns, _, s_name = store_key.partition("/")
                return (match_labels(lsel, {})
                        and match_fields(fsel, {
                            "metadata.name": s_name,
                            "metadata.namespace": s_ns}))
            fields = pod_fields(obj) if kind == "pods" else node_fields(obj)
            return (match_labels(lsel, obj.labels)
                    and match_fields(fsel, fields))

        if rv > self.hub._revision:
            # a future rv (stale client state from another hub
            # incarnation / a restored checkpoint) can never be served:
            # silently answering an empty drain would let the client
            # believe it is caught up at a revision this server has
            # never reached. 410 forces the clean relist the reference
            # reaches via its "too large resource version" timeout.
            return h._fail(
                410, "Expired",
                f"resourceVersion {rv} is ahead of this server "
                f"(current {self.hub._revision}); relist and re-watch "
                "from the returned resourceVersion")
        try:
            events = self.hub.watch(rv).poll()
        except Compacted:
            # the reference's exact wire text ("too old resource
            # version: requested (floor)") — client-go Reflectors key
            # their relist on it; a bare internal message would still be
            # a 410 but loses the hint
            return h._fail(
                410, "Expired",
                f"too old resource version: {rv} "
                f"({self.hub._compacted_rev})")
        matched = [e for e in events if e[1].startswith(kind + "/")]
        if len(matched) > self.watch_max_drain:
            # bounded per-watcher send buffer (serving/fairness.py
            # WatchHub semantics on the stateless poll-watch): a watcher
            # this far behind would serialize an unbounded drain under
            # the hub lock, stalling every other client — disconnect it
            # with the relist signal instead
            self.watch_evictions += 1
            if self.metrics is not None:
                self.metrics.watch_evictions.inc()
            return h._fail(
                410, "Expired",
                f"watcher too far behind: {len(matched)} pending events "
                f"exceed the {self.watch_max_drain}-event send buffer; "
                "relist and re-watch")
        lines = []
        for rev, obj_key, etype, obj in matched:
            rest = obj_key.split("/", 1)[1]
            if (lsel or fsel) and obj is not None:
                if not selects(rest, obj):
                    if etype == "ADDED":
                        continue  # never matched this watcher's scope
                    etype, obj = "DELETED", None  # left the selector
            if obj is None:
                # namespaced keys are "<kind>/ns/name" — a DELETED frame
                # must carry namespace and name separately or informer
                # caches keyed on (ns, name) never evict the entry
                if kind != "nodes" and "/" in rest:
                    ns, name = rest.split("/", 1)
                    meta = {"name": name, "namespace": ns}
                else:
                    meta = {"name": rest}
                meta["resourceVersion"] = str(rev)
                doc = {"metadata": meta}
            else:
                builder = {
                    "pods": lambda: pod_to_json(obj),
                    "nodes": lambda: node_to_json(obj),
                    "services": lambda: svc_to_doc(self.hub, rest, obj),
                    "endpoints": lambda: ep_to_doc(self.hub, rest, obj),
                    "events": lambda: event_to_doc(self.hub, rest, obj),
                }[kind]
                doc = builder()
                doc.setdefault("metadata", {})["resourceVersion"] = str(rev)
            lines.append(json.dumps({"type": etype, "object": doc}))
        if (query.get("allowWatchBookmarks") or ["false"])[0] in (
                "true", "1"):
            mark = events[-1][0] if events else self.hub._revision
            kind_name = {"pods": "Pod", "nodes": "Node",
                         "services": "Service", "endpoints": "Endpoints",
                         "events": "Event"}[kind]
            lines.append(json.dumps({
                "type": "BOOKMARK",
                "object": {"kind": kind_name,
                           "apiVersion": "v1",
                           "metadata": {"resourceVersion": str(mark)}},
            }))
        body = ("\n".join(lines) + ("\n" if lines else "")).encode()
        h._send_raw(200, "application/json;stream=watch", body)

    # -- POST ---------------------------------------------------------------

    # -- apps/v1 writes ------------------------------------------------------

    @staticmethod
    def _apps_ns_route(seg):
        """('deployments', name_or_None, sub_or_None, ns) for a
        namespaces-prefixed apps segment list, else None. Writes REQUIRE
        the namespaced form — the cluster-scoped spelling
        (/apis/apps/v1/deployments/NAME) is not a published write route
        and must 404, not silently mutate the default namespace."""
        if seg[:1] != ["namespaces"] or len(seg) < 3:
            return None
        ns, seg = seg[1], seg[2:]
        if not seg or seg[0] != "deployments":
            return None
        return (seg[0], seg[1] if len(seg) > 1 else None,
                seg[2] if len(seg) > 2 else None, ns)

    def _deployment_from_spec(self, name: str, spec: dict):
        """Writable-spec doc -> Deployment, with apps/v1 validation
        surfaced as ValueError (callers answer 422 Invalid). Every field
        that would otherwise blow up LATER inside hub.step()'s rolling
        reconcile — a remotely-triggered async crash — is validated
        HERE: replicas non-negative, budgets int-or-percent."""
        from kubernetes_tpu_torch.sim import Deployment, _int_or_percent

        tmpl = spec.get("template") or {}
        replicas = int(spec.get("replicas", 1))
        if replicas < 0:
            raise ValueError("spec.replicas must be non-negative")
        for field in ("maxSurge", "maxUnavailable"):
            v = spec.get(field, 1)
            try:
                if _int_or_percent(v, max(replicas, 1),
                                   round_up=True) < 0:
                    raise ValueError
            except (ValueError, TypeError, AttributeError):
                raise ValueError(
                    f"spec.{field} must be a non-negative integer or "
                    f"percentage string, got {v!r}")
        return Deployment(
            name,
            replicas=replicas,
            cpu_milli=float(tmpl.get("cpuMilli", 100)),
            memory=float(tmpl.get("memory", 256 * 2**20)),
            priority=int(tmpl.get("priority", 0)),
            strategy=spec.get("strategy", "RollingUpdate"),
            max_surge=spec.get("maxSurge", 1),
            max_unavailable=spec.get("maxUnavailable", 1),
        )

    def _post_deployment(self, h, name, ns, body) -> None:
        hub = self.hub
        if ns != "default":
            return h._fail(
                422, "Invalid",
                "controller objects live in namespace \"default\" in this "
                "hub (module doc, restapi.py GROUPS)")
        if not name or not _DNS_LABEL.match(name):
            return h._fail(422, "Invalid",
                           "deployment metadata.name must be an RFC-1123 "
                           "DNS label")
        if name in hub.deployments:
            return h._fail(409, "AlreadyExists",
                           f'deployments "{name}" already exists')
        try:
            d = self._deployment_from_spec(name, body.get("spec") or {})
        except (ValueError, TypeError) as e:
            return h._fail(422, "Invalid", str(e))
        hub.add_deployment(d)
        return h._respond(201, apps_deploy_doc(hub, d))

    def _apply_deployment_spec(self, h, d, spec: dict) -> None:
        """Shared PUT/PATCH tail: validate the merged writable spec via a
        probe construction (the same __post_init__ rules a create runs),
        then apply — replicas through the scale seam, template changes
        through rollout() so the revision bumps exactly when the
        reference's getNewReplicaSet would."""
        hub = self.hub
        try:
            probe = self._deployment_from_spec(d.name, spec)
        except (ValueError, TypeError) as e:
            return h._fail(422, "Invalid", str(e))
        d.strategy = probe.strategy
        d.max_surge = probe.max_surge
        d.max_unavailable = probe.max_unavailable
        if probe.replicas != d.replicas:
            hub.scale_deployment(d.name, probe.replicas)
        if (probe.cpu_milli, probe.memory, probe.priority) != (
                d.cpu_milli, d.memory, d.priority):
            d.rollout(cpu_milli=probe.cpu_milli, memory=probe.memory,
                      priority=probe.priority)
        return h._respond(200, apps_deploy_doc(hub, d))

    def _post(self, h) -> None:
        url_path = urlparse(h.path).path
        routed = self._route_group(url_path)
        if routed is not None:
            group, gseg = routed
            body = self._read_body(h)
            if body is None:
                return
            r = self._apps_ns_route(gseg) if group == APPS_GROUP else None
            if r is not None and r[1] is None and r[2] is None:
                name = (body.get("metadata") or {}).get("name", "")
                return self._post_deployment(h, name, r[3], body)
            return h._fail(404, "NotFound", h.path)
        seg = self._route(url_path)
        hub = self.hub
        if not seg:
            return h._fail(404, "NotFound", h.path)
        body = self._read_body(h)
        if body is None:
            return  # 400 already sent
        if seg == ["nodes"]:
            node = node_from_json(body)
            if node.name in hub.truth_nodes:
                return h._fail(409, "AlreadyExists",
                               f'nodes "{node.name}" already exists')
            hub.add_node(node)
            return h._respond(201, _with_rv(node_to_json(node), hub,
                                            f"nodes/{node.name}"))
        if seg == ["namespaces"]:
            name = (body.get("metadata") or {}).get("name", "")
            if not name or not _DNS_LABEL.match(name):
                # a non-DNS-label name (slash, uppercase, 64+) would mint
                # an object no item route can ever address or delete
                return h._fail(
                    400, "BadRequest",
                    "namespace metadata.name must be an RFC-1123 DNS label")
            if name in hub.namespaces:
                return h._fail(409, "AlreadyExists",
                               f'namespaces "{name}" already exists')
            hub.add_namespace(name)
            return h._respond(201, ns_to_json(hub, hub.namespaces[name]))
        if seg[0] == "namespaces" and len(seg) >= 3:
            ns, seg = seg[1], seg[2:]
            if seg == ["pods"]:
                pod = pod_from_json(body)
                pod.namespace = ns
                if pod.key() in hub.truth_pods:
                    return h._fail(409, "AlreadyExists",
                                   f'pods "{pod.name}" already exists')
                try:
                    hub.create_pod(pod)
                except AdmissionError as e:
                    return h._fail(403, "Forbidden", str(e))
                # serialize the STORED object: admission may have rewritten
                # the pod (mutating plugins return a new copy) and the hub
                # assigned metadata.uid on that admitted copy, not ours
                stored = hub.truth_pods[pod.key()]
                return h._respond(201, _with_rv(pod_to_json(stored), hub,
                                                f"pods/{stored.key()}"))
            if len(seg) == 3 and seg[0] == "pods" and seg[2] == "eviction":
                # the Eviction subresource (eviction.go:147): PDB-guarded
                # graceful delete; an exhausted budget is 429
                # TooManyRequests, exactly the apiserver's answer
                key = f"{ns}/{seg[1]}"
                if key not in hub.truth_pods:
                    return h._fail(404, "NotFound",
                                   f'pods "{seg[1]}" not found')
                ok, msg = hub.evict_pod(key)
                if not ok:
                    return h._fail(429, "TooManyRequests", msg)
                return h._respond(201, status_doc(201, "", "")
                                  | {"status": "Success"})
            if len(seg) == 3 and seg[0] == "pods" and seg[2] == "binding":
                key = f"{ns}/{seg[1]}"
                pod = hub.truth_pods.get(key)
                if pod is None:
                    return h._fail(404, "NotFound",
                                   f'pods "{seg[1]}" not found')
                target = (body.get("target") or {}).get("name", "")
                if not target:
                    # the real apiserver validates the binding target
                    return h._fail(400, "BadRequest",
                                   "binding target.name is required")
                claimed_uid = (body.get("metadata") or {}).get("uid", pod.uid)
                import dataclasses
                try:
                    hub.confirm_binding(
                        dataclasses.replace(pod, uid=claimed_uid,
                                            node_name=""),
                        target,
                    )
                except Conflict as e:
                    return h._fail(409, "Conflict", str(e))
                return h._respond(201, status_doc(201, "", "")
                                  | {"status": "Success"})
        return h._fail(404, "NotFound", h.path)

    # -- PUT (GuaranteedUpdate CAS) -----------------------------------------

    def _put(self, h) -> None:
        url_path = urlparse(h.path).path
        routed = self._route_group(url_path)
        if routed is not None:
            group, gseg = routed
            r = self._apps_ns_route(gseg) if group == APPS_GROUP else None
            if r is None or r[1] is None:
                return h._fail(404, "NotFound", h.path)
            _, name, sub, ns = r
            d = self.hub.deployments.get(name) if ns == "default" else None
            if d is None:
                return h._fail(404, "NotFound",
                               f'deployments "{name}" not found')
            body = self._read_body(h)
            if body is None:
                return
            if sub == "scale":
                # the Scale subresource write — HPA's and kubectl
                # scale's contract (ScaleREST.Update, storage.go:230)
                try:
                    replicas = int((body.get("spec") or {})["replicas"])
                    if replicas < 0:
                        raise ValueError
                except (KeyError, TypeError, ValueError):
                    return h._fail(422, "Invalid",
                                   "scale spec.replicas must be a "
                                   "non-negative integer")
                self.hub.scale_deployment(name, replicas)
                return h._respond(200, apps_scale_doc(self.hub, d))
            if sub is not None:
                return h._fail(404, "NotFound", h.path)
            return self._apply_deployment_spec(h, d, body.get("spec") or {})
        seg = self._route(url_path)
        hub = self.hub
        if not seg or len(seg) != 2 or seg[0] != "nodes":
            return h._fail(404, "NotFound", h.path)
        cur = hub.truth_nodes.get(seg[1])
        if cur is None:
            return h._fail(404, "NotFound", f'nodes "{seg[1]}" not found')
        body = self._read_body(h)
        if body is None:
            return  # 400 already sent
        want_rv = str((body.get("metadata") or {}).get("resourceVersion", ""))
        cur_rv = str(hub.resource_version.get(f"nodes/{seg[1]}", 0))
        if want_rv and want_rv != cur_rv:
            return h._fail(
                409, "Conflict",
                f"Operation cannot be fulfilled on nodes \"{seg[1]}\": "
                f"object has been modified (rv {cur_rv}, submitted {want_rv})",
            )
        node = node_from_json(body)
        if node.name != seg[1]:
            return h._fail(400, "BadRequest", "name mismatch")
        hub._update_node(node)
        return h._respond(200, _with_rv(node_to_json(node), hub,
                                        f"nodes/{node.name}"))

    # -- PATCH (RFC 7386 JSON merge patch) -----------------------------------

    def _patch(self, h) -> None:
        """PatchResource (apiserver/pkg/endpoints/handlers/patch.go:59),
        merge-patch flavor only: the declarative update verb controllers
        and kubectl apply ride. Routes: pods (metadata/labels — identity
        and placement stay immutable, the Binding subresource owns
        nodeName), nodes, and apps/v1 deployments (whose spec patch can
        scale AND roll out — template changes bump the revision exactly
        like patching the pod template image in the reference).

        A patch body carrying metadata.resourceVersion is an optimistic
        concurrency precondition (409 on mismatch), same as PUT — for
        pods and nodes. Deployments are controller objects the hub does
        not individually version (their docs carry the GLOBAL revision
        as a change indicator only), so an rv precondition there cannot
        mean what the client intends; such a patch is rejected 400
        explicitly rather than silently dropping the precondition."""
        ctype = h.headers.get("Content-Type", "").split(";")[0].strip()
        if ctype != "application/merge-patch+json":
            return h._fail(
                415, "UnsupportedMediaType",
                "only application/merge-patch+json is supported "
                "(json-patch and strategic-merge-patch are not served)")
        hub = self.hub
        url_path = urlparse(h.path).path
        patch = self._read_body(h)
        if patch is None:
            return

        def rv_precondition_ok(obj_key: str) -> bool:
            want = (patch.get("metadata") or {}).get("resourceVersion")
            if want is None:
                return True
            cur_rv = str(hub.resource_version.get(obj_key, 0))
            if str(want) != cur_rv:
                h._fail(409, "Conflict",
                        f"Operation cannot be fulfilled on {obj_key}: "
                        f"object has been modified (rv {cur_rv}, "
                        f"submitted {want})")
                return False
            return True

        routed = self._route_group(url_path)
        if routed is not None:
            group, gseg = routed
            r = self._apps_ns_route(gseg) if group == APPS_GROUP else None
            if r is None or r[1] is None or r[2] is not None:
                return h._fail(404, "NotFound", h.path)
            _, name, _, ns = r
            d = hub.deployments.get(name) if ns == "default" else None
            if d is None:
                return h._fail(404, "NotFound",
                               f'deployments "{name}" not found')
            if (patch.get("metadata") or {}).get("resourceVersion") is not None:
                return h._fail(
                    400, "BadRequest",
                    "deployments are not individually versioned; "
                    "resourceVersion preconditions are not supported on "
                    "this resource")
            cur_spec = apps_deploy_doc(hub, d)["spec"]
            merged = merge_patch(cur_spec, patch.get("spec") or {})
            return self._apply_deployment_spec(h, d, merged)

        seg = self._route(url_path)
        if seg and len(seg) == 2 and seg[0] == "nodes":
            cur = hub.truth_nodes.get(seg[1])
            if cur is None:
                return h._fail(404, "NotFound",
                               f'nodes "{seg[1]}" not found')
            if not rv_precondition_ok(f"nodes/{seg[1]}"):
                return
            merged = merge_patch(node_to_json(cur), patch)
            try:
                node = node_from_json(merged)
            except Exception as e:  # type-invalid merged doc is a 422,
                return h._fail(422, "Invalid",  # never a dropped conn
                               f"patched node document is invalid: {e!r}")
            if node.name != seg[1]:
                return h._fail(422, "Invalid",
                               "metadata.name is immutable")
            hub._update_node(node)
            return h._respond(200, _with_rv(node_to_json(node), hub,
                                            f"nodes/{node.name}"))
        if (seg and len(seg) == 4 and seg[0] == "namespaces"
                and seg[2] == "pods"):
            ns, name = seg[1], seg[3]
            key = f"{ns}/{name}"
            cur = hub.truth_pods.get(key)
            if cur is None:
                return h._fail(404, "NotFound", f'pods "{name}" not found')
            if not rv_precondition_ok(f"pods/{key}"):
                return
            # Pod PATCH is scoped to METADATA on this facade. The wire
            # doc is a PARTIAL projection of the truth pod (tolerations,
            # affinity, volumes, limits... are not all serialized), so
            # rebuilding the pod from the merged doc would silently zero
            # every non-wire field on a pure label patch; and a spec
            # patch would bypass the quota/priority admission that
            # guards create. Spec/status mutations therefore answer 422
            # (the Binding subresource owns placement; delete+create is
            # the spec-change path), and the stored pod is built by
            # replacing ONLY metadata on the current truth object.
            cur_doc = pod_to_json(cur)
            merged = merge_patch(cur_doc, patch)
            if (merged.get("spec") != cur_doc.get("spec")
                    or merged.get("status") != cur_doc.get("status")):
                # a textual mismatch can still be semantically identical
                # (kubectl apply re-sends the manifest that CREATED the
                # pod; its "100m"-style quantities differ from the
                # server's canonical rendering): parse both through the
                # same wire projection and compare with metadata
                # normalized — BUT only when the merged doc carries no
                # fields OUTSIDE the projection. The projection ignores
                # unknown fields, so without the foreign-key check a
                # patch adding spec.tolerations or containers[0].image
                # would compare equal and be SILENTLY dropped with a 200.
                try:
                    import dataclasses

                    a = pod_from_json(merged)
                    b = pod_from_json(cur_doc)
                    canon = pod_to_json(a)
                    # Foreign fields split two ways:
                    # paths the TRUTH MODEL carries but the wire
                    # projection doesn't (tolerations, affinity,
                    # volumes, limits, ports...) are real data the
                    # facade cannot patch — comparing would silently
                    # drop a semantic change, so they 422. Paths modeled
                    # NOWHERE (containers[].image, env...) are dropped
                    # by the lenient decode exactly as POST drops them —
                    # otherwise re-applying the manifest that CREATED
                    # the pod (kubectl apply's 'unchanged' path) would
                    # fail on fields the create accepted.
                    # (containers[].image is deliberately NOT guarded:
                    # the decode drops it at POST too, so truth never
                    # holds a REST-created pod's image — lenient is the
                    # only symmetric choice; ImageLocality images exist
                    # for in-process pods only)
                    guarded = ("tolerations", "affinity", "volumes",
                               "limits", "ports", "restartPolicy",
                               "topologySpreadConstraints",
                               "priorityClassName")
                    # exact dotted-path SEGMENTS, not substring: an
                    # unmodeled field whose name merely contains a
                    # guarded token ("hostPorts", "volumesAttached")
                    # keeps the documented lenient drop-as-POST-dropped
                    # behavior instead of a spurious 422
                    fk = [
                        p
                        for part in ("spec", "status")
                        for p in foreign_keys(merged.get(part),
                                              canon.get(part))
                        if any(seg in guarded for seg in p.split("."))
                    ]
                    same = (
                        dataclasses.replace(a, labels=b.labels) == b
                        and not fk
                    )
                except Exception:
                    same = False
                if not same:
                    return h._fail(
                        422, "Invalid",
                        "pod PATCH is limited to metadata on this facade "
                        "(placement belongs to the Binding subresource; "
                        "spec changes go through delete+create so "
                        "admission re-runs)")
            meta = merged.get("metadata") or {}
            if meta.get("name") != name:
                return h._fail(422, "Invalid", "metadata.name is immutable")
            if meta.get("namespace", ns) != ns:
                return h._fail(422, "Invalid",
                               "metadata.namespace is immutable")
            if meta.get("uid", cur.uid) != cur.uid:
                return h._fail(422, "Invalid", "metadata.uid is immutable")
            # metadata keys the rebuild below actually carries: labels
            # (mutable) + the server-owned fields echoed back verbatim.
            # Anything else (annotations, finalizers, ownerReferences
            # edits...) would be SILENTLY dropped by the
            # labels-only rebuild — reject it instead (the spec/status
            # gate never fires on a metadata-only patch).
            # Same split as the spec side: metadata the projection
            # CARRIES (ownerReferences, deletionTimestamp) is
            # server-owned — a patch may only echo it unchanged, else
            # 422 (the labels-only rebuild cannot apply the edit).
            # Metadata modeled nowhere (annotations, finalizers,
            # managedFields — real kubectl apply always writes the
            # last-applied annotation) is dropped as leniently as POST
            # dropped it, keeping apply's 'unchanged' path working.
            cur_meta = cur_doc.get("metadata") or {}
            for k in ("ownerReferences", "deletionTimestamp"):
                if k in meta and meta.get(k) != cur_meta.get(k):
                    return h._fail(
                        422, "Invalid",
                        f"metadata.{k} is server-owned on this facade")
            import dataclasses

            new = dataclasses.replace(
                cur, labels=dict(meta.get("labels") or {}))
            hub.replace_pod(new)
            stored = hub.truth_pods[key]
            return h._respond(200, _with_rv(pod_to_json(stored), hub,
                                            f"pods/{key}"))
        return h._fail(404, "NotFound", h.path)

    # -- DELETE -------------------------------------------------------------

    def _delete(self, h) -> None:
        url_path = urlparse(h.path).path
        routed = self._route_group(url_path)
        if routed is not None:
            group, gseg = routed
            r = self._apps_ns_route(gseg) if group == APPS_GROUP else None
            if r is None or r[1] is None or r[2] is not None:
                return h._fail(404, "NotFound", h.path)
            _, name, _, ns = r
            if ns != "default" or name not in self.hub.deployments:
                return h._fail(404, "NotFound",
                               f'deployments "{name}" not found')
            # cascading: the ownerRef GC pass collects the orphaned RSes
            # and their pods (sim.delete_deployment docstring)
            self.hub.delete_deployment(name)
            return h._respond(200, status_doc(200, "", "")
                              | {"status": "Success"})
        seg = self._route(url_path)
        hub = self.hub
        if not seg:
            return h._fail(404, "NotFound", h.path)
        if len(seg) == 2 and seg[0] == "nodes":
            if seg[1] not in hub.truth_nodes:
                return h._fail(404, "NotFound", f'nodes "{seg[1]}" not found')
            hub.remove_node(seg[1])
            return h._respond(200, status_doc(200, "", "")
                              | {"status": "Success"})
        if len(seg) == 2 and seg[0] == "namespaces":
            # DELETE namespace = start termination; the namespace
            # controller drains and removes it (the reference answers
            # 200 with the Terminating-phase object, registry/core/
            # namespace/storage Delete). Protection lives in the HUB
            # guard so no seam can bypass it.
            ns = hub.namespaces.get(seg[1])
            if ns is None:
                return h._fail(404, "NotFound",
                               f'namespaces "{seg[1]}" not found')
            try:
                hub.terminate_namespace(seg[1])
            except ValueError as e:
                return h._fail(403, "Forbidden", str(e))
            return h._respond(200, ns_to_json(hub, ns))
        if seg[0] == "namespaces" and len(seg) == 4 and seg[2] == "pods":
            key = f"{seg[1]}/{seg[3]}"
            if key not in hub.truth_pods:
                return h._fail(404, "NotFound", f'pods "{seg[3]}" not found')
            hub.delete_pod(key)
            return h._respond(200, status_doc(200, "", "")
                              | {"status": "Success"})
        return h._fail(404, "NotFound", h.path)
