"""The port's REST registry (``kubernetes_tpu_torch/restapi.py``) held
against the JAX package's: two ``RestServer``s on 127.0.0.1, one over each
package's ``HollowCluster``, take the same request script, and every
status code and JSON body must be equal. Fields that name the package
rather than the state are left out of the comparison: the OpenAPI
document's ``info.title``. The audit entries are compared without
``latency_s``, the one field that carries wall time. Neither package's
bodies carry other wall time (timestamps come from the hub's simulated
clock). Protobuf negotiation has its own test, which decodes the bodies
with the codec and compares the messages."""

import http.client
import json
import time
import types

import kubernetes_tpu.auth as jauth
import kubernetes_tpu.restapi as jrest
import kubernetes_tpu.serving.fairness as jfair
import kubernetes_tpu.sim as jsim
import kubernetes_tpu_torch.auth as tauth
import kubernetes_tpu_torch.restapi as trest
import kubernetes_tpu_torch.serving.fairness as tfair
import kubernetes_tpu_torch.sim as tsim

REF = types.SimpleNamespace(sim=jsim, rest=jrest, auth=jauth, fair=jfair,
                            kw={"enable_preemption": False})
PORT = types.SimpleNamespace(sim=tsim, rest=trest, auth=tauth, fair=tfair,
                             kw={"enable_preemption": False,
                                 "device": "cpu"})

NODE = {
    "metadata": {"name": "n0", "labels": {"kubernetes.io/hostname": "n0"}},
    "status": {"allocatable": {"cpu": "4000m", "memory": "8589934592",
                               "pods": "110"}},
}


def pod_doc(name, cpu="100m", labels=None):
    return {"metadata": {"name": name, "labels": labels or {}},
            "spec": {"containers": [
                {"name": "main", "resources": {"requests": {"cpu": cpu}}}]}}


class Client:
    """Records (method, path, status, body) of every request."""

    def __init__(self, port: int) -> None:
        self.port = port
        self.log = []

    def __call__(self, method, path, body=None, headers=None, raw=False):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=10)
        conn.request(method, path,
                     json.dumps(body) if body is not None else None,
                     headers or {})
        r = conn.getresponse()
        data = r.read()
        hdr = {k: v for k, v in r.getheaders() if k == "Retry-After"}
        conn.close()
        if raw or (r.status == 200 and "/watch/" in path):
            doc = [json.loads(x) for x in data.splitlines() if x.strip()]
        else:
            doc = json.loads(data) if data else None
        if path == "/openapi/v2" and r.status == 200:
            doc["info"].pop("title")  # names the package
        self.log.append((method, path, r.status, hdr, doc))
        return r.status, doc


def settled_trail(audit, n):
    """The audit entries once all ``n`` requests have landed (an entry is
    recorded after its response is written), without ``latency_s``."""
    deadline = time.monotonic() + 10
    while len(audit.entries) < n and time.monotonic() < deadline:
        time.sleep(0.01)
    return sorted(json.dumps({k: v for k, v in e.items()
                              if k != "latency_s"}, sort_keys=True)
                  for e in audit.entries)


def core_script(pkg):
    """CRUD, lists with continue tokens and selectors, the Binding CAS,
    the PUT rv precondition, merge patch, watch with 410 and bookmarks,
    admission 403, discovery and OpenAPI, events, leases, apps, the
    namespace drain and the audit trail."""
    hub = pkg.sim.HollowCluster(seed=3, admission=True,
                                scheduler_kw=dict(pkg.kw))
    audit = pkg.rest.AuditLog(level="Request")
    srv = pkg.rest.RestServer(hub, audit=audit)
    c = Client(srv.serve())
    try:
        for path in ("/api", "/api/v1", "/apis", "/openapi/v2", "/version",
                     "/apis/apps/v1", "/api/v1/nope"):
            c("GET", path)
        _, doc = c("GET", "/api/v1/nodes")
        rv0 = int(doc["metadata"]["resourceVersion"])
        c("POST", "/api/v1/nodes", NODE)
        c("POST", "/api/v1/nodes", {**NODE, "metadata": {"name": "n1"}})
        for i in range(4):
            c("POST", "/api/v1/namespaces/default/pods",
              pod_doc(f"web-{i}", labels={"app": "web" if i % 2 else "db"}))
        c("GET", "/api/v1/pods?limit=2")
        cont = c.log[-1][4]["metadata"]["continue"]
        c("GET", f"/api/v1/pods?limit=2&continue={cont}")
        c("GET", "/api/v1/namespaces/default/pods?labelSelector=app%3Dweb")
        c("GET", "/api/v1/pods?fieldSelector=spec.nodeName%3D")
        c("GET", "/api/v1/pods?labelSelector=app%3D%3D%3D")
        # the Binding subresource: bind, the already-assigned CAS, a
        # recreated pod with a stale uid
        c("POST", "/api/v1/namespaces/default/pods/web-0/binding",
          {"target": {"name": "n0"}})
        c("POST", "/api/v1/namespaces/default/pods/web-0/binding",
          {"target": {"name": "n0"}})
        c("DELETE", "/api/v1/namespaces/default/pods/web-0")
        c("POST", "/api/v1/namespaces/default/pods", pod_doc("web-0"))
        c("POST", "/api/v1/namespaces/default/pods/web-0/binding",
          {"target": {"name": "n0"}, "metadata": {"uid": "stale-uid"}})
        c("GET", "/api/v1/namespaces/default/pods/web-0")
        # PUT with the resourceVersion precondition, then a stale one
        _, node = c("GET", "/api/v1/nodes/n0")
        upd = {**NODE, "metadata": {"name": "n0", "labels": {"tier": "gold"},
                                    "resourceVersion":
                                    node["metadata"]["resourceVersion"]}}
        c("PUT", "/api/v1/nodes/n0", upd)
        c("PUT", "/api/v1/nodes/n0", upd)
        c("PATCH", "/api/v1/namespaces/default/pods/web-1",
          {"metadata": {"labels": {"patched": "yes"}}},
          headers={"Content-Type": "application/merge-patch+json"})
        c("PATCH", "/api/v1/namespaces/default/pods/web-1", {"x": 1},
          headers={"Content-Type": "application/json-patch+json"})
        hub.step()
        hub.settle()
        c("GET", "/api/v1/pods")
        c("GET", f"/api/v1/watch/pods?resourceVersion={rv0}")
        c("GET", f"/api/v1/watch/nodes?resourceVersion={rv0}")
        c("GET", f"/api/v1/watch/pods?resourceVersion={rv0}"
                 "&labelSelector=app%3Dnone&allowWatchBookmarks=true")
        mark = int(c.log[-1][4][-1]["object"]["metadata"]["resourceVersion"])
        hub.compact(mark)
        c("GET", f"/api/v1/watch/pods?resourceVersion={mark}"
                 "&labelSelector=app%3Dnone&allowWatchBookmarks=true")
        c("GET", f"/api/v1/watch/pods?resourceVersion={rv0}")
        c("GET", f"/api/v1/watch/pods?resourceVersion={hub._revision + 9}")
        # admission: a create into a terminating namespace is 403
        hub.add_namespace("doomed")
        hub.terminate_namespace("doomed")
        c("POST", "/api/v1/namespaces/doomed/pods", pod_doc("late"))
        # events, services, endpoints, leases, apps
        c("GET", "/api/v1/events")
        c("GET", "/api/v1/namespaces/default/events"
                 "?fieldSelector=reason%3DScheduled")
        c("GET", "/api/v1/services")
        c("GET", "/api/v1/endpoints")
        c("GET", "/apis/coordination.k8s.io/v1/leases")
        c("POST", "/apis/apps/v1/namespaces/default/deployments",
          {"metadata": {"name": "api"},
           "spec": {"replicas": 3, "template": {"spec": {"containers": [
               {"name": "main",
                "resources": {"requests": {"cpu": "200m"}}}]}}}})
        hub.step()
        c("GET", "/apis/apps/v1/namespaces/default/deployments/api")
        c("GET", "/apis/apps/v1/namespaces/default/deployments/api/scale")
        c("GET", "/apis/apps/v1/replicasets")
        # namespace create, a pod bound in it, delete -> Terminating ->
        # drained by the controller -> 404; system namespaces protected
        c("POST", "/api/v1/namespaces", {"metadata": {"name": "team-a"}})
        c("POST", "/api/v1/namespaces", {"metadata": {"name": "team-a"}})
        c("POST", "/api/v1/namespaces/team-a/pods", pod_doc("w0"))
        hub.step()
        c("DELETE", "/api/v1/namespaces/team-a")
        c("GET", "/api/v1/namespaces/team-a")
        for _ in range(3):
            hub.step()
        c("GET", "/api/v1/namespaces/team-a")
        c("GET", "/api/v1/namespaces")
        c("DELETE", "/api/v1/namespaces/kube-system")
        c("DELETE", "/api/v1/nodes/n1")
        c("GET", "/api/v1/nodes")
        c("POST", "/api/v1/nodes", "not an object")
        hub.check_consistency()
        trail = settled_trail(audit, len(c.log))
    finally:
        srv.close()
    return c.log, trail


SCHED_RULES = [
    ("system:kube-scheduler", ("get", "list", "watch", "create", "update"),
     ("pods", "pods/binding", "nodes")),
    ("readers", ("get", "list", "watch"),
     ("pods", "nodes", "services", "endpoints", "events")),
]


def auth_script(pkg):
    """The authentication -> authorization filter pair: 401 without or
    with a bogus token, 403 for a verb outside the user's rules, 200 and
    201 inside them; the audit entries carry the user."""
    a = pkg.auth
    users = {"sched-token": a.UserInfo("system:kube-scheduler",
                                       groups=("system:authenticated",)),
             "viewer-token": a.UserInfo("viewer", groups=(
                 "system:authenticated", "readers"))}
    rules = [a.Rule(subjects=(s,), verbs=v, resources=r)
             for s, v, r in SCHED_RULES]
    hub = pkg.sim.HollowCluster(seed=1, scheduler_kw=dict(pkg.kw))
    audit = pkg.rest.AuditLog()
    srv = pkg.rest.RestServer(hub, audit=audit,
                              authn=a.TokenAuthenticator(users),
                              authz=a.RuleAuthorizer(rules))
    c = Client(srv.serve())
    sched = {"Authorization": "Bearer sched-token"}
    viewer = {"Authorization": "Bearer viewer-token"}
    try:
        c("GET", "/api/v1/pods")
        c("GET", "/api/v1/pods", headers={"Authorization": "Bearer bogus"})
        c("POST", "/api/v1/nodes", NODE, headers=sched)
        c("POST", "/api/v1/namespaces/default/pods", pod_doc("p0"),
          headers=sched)
        c("GET", "/api/v1/pods", headers=viewer)
        c("POST", "/api/v1/namespaces/default/pods", pod_doc("p1"),
          headers=viewer)
        c("DELETE", "/api/v1/nodes/n0", headers=sched)
        c("GET", "/api/v1/events", headers=sched)
        c("GET", "/version", headers=viewer)
        trail = settled_trail(audit, len(c.log))
    finally:
        srv.close()
    return c.log, trail


def fairness_script(pkg):
    """APF ahead of the chain: no readonly seat sheds a list 429 with
    Retry-After and the Status shape; the exempt and mutating flows
    still pass."""
    f = pkg.fair
    ctrl = f.FlowController(flows=[
        f.FlowSchema("exempt", exempt=True),
        f.FlowSchema("watch", concurrency=1, queue_length=0,
                     queue_timeout_s=0.0),
        f.FlowSchema("readonly", concurrency=0, queue_length=0,
                     queue_timeout_s=0.0),
        f.FlowSchema("mutating", concurrency=4, queue_length=2,
                     queue_timeout_s=0.0)], retry_after_s=2.0)
    hub = pkg.sim.HollowCluster(seed=11, scheduler_kw=dict(pkg.kw))
    srv = pkg.rest.RestServer(hub, fairness=ctrl)
    c = Client(srv.serve())
    try:
        c("GET", "/api/v1/pods")
        c("GET", "/openapi/v2")
        c("POST", "/api/v1/namespaces/default/pods", pod_doc("w"))
        c("GET", "/api/v1/watch/pods?resourceVersion=0")
    finally:
        srv.close()
    return c.log, dict(ctrl.stats()["rejected"])


def _same(script):
    want, got = script(REF), script(PORT)
    for w, g in zip(want[0], got[0]):
        assert g == w, (w[:3], g[:3])
    assert len(got[0]) == len(want[0])
    assert got[1:] == want[1:]
    return got


def test_rest_core_surface_matches_reference():
    log, trail = _same(core_script)
    codes = [(m, p.split("?")[0], s) for m, p, s, _, _ in log]
    assert ("POST", "/api/v1/namespaces/default/pods/web-0/binding",
            409) in codes
    assert ("PUT", "/api/v1/nodes/n0", 409) in codes
    assert ("GET", "/api/v1/watch/pods", 410) in codes
    assert ("POST", "/api/v1/namespaces/doomed/pods", 403) in codes
    assert ("GET", "/api/v1/namespaces/team-a", 404) in codes
    assert len(trail) == len(log)


def test_rest_authn_authz_match_reference():
    log, trail = _same(auth_script)
    assert [e[2] for e in log][:2] == [401, 401]
    assert 403 in [e[2] for e in log]
    assert any('"username": "viewer"' in e for e in trail)


def test_rest_fairness_sheds_like_reference():
    log, rejected = _same(fairness_script)
    assert log[0][2] == 429 and log[0][3] == {"Retry-After": "2"}
    assert rejected == {"readonly/queue-full": 1}


def proto_script(pkg):
    """Protobuf negotiation: node and pod lists (whole, paged with
    continue tokens, selected), single objects, a missing object, and
    request bodies sent as protobuf. Returns (status, Content-Type,
    body) of every request, a protobuf body decoded to (kind, message)
    with the port's codec."""
    from kubernetes_tpu_torch.api.protobuf import decode_envelope
    from kubernetes_tpu_torch.proto import corev1

    hub = pkg.sim.HollowCluster(seed=2, scheduler_kw=dict(pkg.kw))
    srv = pkg.rest.RestServer(hub)
    port = srv.serve()
    proto = "application/vnd.kubernetes.protobuf"
    out = []

    def call(method, path, body=None, headers=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
        conn.request(method, path, body, headers or {})
        r = conn.getresponse()
        data = r.read()
        ctype = r.getheader("Content-Type")
        conn.close()
        if ctype == proto:
            kind, raw = decode_envelope(data)
            cls = getattr(corev1, {"PodList": "PodListMsg",
                                   "NodeList": "NodeListMsg"}.get(
                kind, kind + "Msg"))
            doc = (kind, cls.FromString(raw))
        else:
            doc = json.loads(data) if data else None
        out.append((method, path, r.status, ctype, doc))
        return doc

    try:
        for i in range(3):
            call("POST", "/api/v1/nodes", json.dumps(
                {**NODE, "metadata": {"name": f"n{i}", "labels": {
                    "kubernetes.io/hostname": f"n{i}",
                    "tier": "a" if i % 2 else "b"}}}))
        for i in range(5):
            call("POST", "/api/v1/namespaces/default/pods",
                 json.dumps(pod_doc(f"p{i}", labels={"app": f"a{i % 2}"})))
        call("POST", "/api/v1/namespaces/default/pods/p0/binding",
             json.dumps({"target": {"name": "n0"}}))
        accept = {"Accept": proto}
        for path in ("/api/v1/pods", "/api/v1/nodes",
                     "/api/v1/namespaces/default/pods",
                     "/api/v1/pods?labelSelector=app%3Da1",
                     "/api/v1/nodes?labelSelector=tier%3Da",
                     "/api/v1/nodes/n0", "/api/v1/nodes/nope",
                     "/api/v1/namespaces/default/pods/p0",
                     "/api/v1/namespaces/default/pods/nope"):
            call("GET", path, headers=accept)
        for path in ("/api/v1/pods?limit=2", "/api/v1/nodes?limit=2"):
            doc = call("GET", path, headers=accept)
            tok = doc[1].continue_token
            call("GET", f"{path}&continue={tok}", headers=accept)
        # the same lists in JSON, for the objects they must hold
        call("GET", "/api/v1/pods")
        call("GET", "/api/v1/nodes")
        # request bodies are read as JSON whatever they are labelled
        from kubernetes_tpu_torch.api.protobuf import (
            encode_envelope,
            pod_to_pb,
        )
        from kubernetes_tpu_torch.testing import make_pod

        call("POST", "/api/v1/namespaces/default/pods",
             encode_envelope("Pod", pod_to_pb(make_pod("pb-body"))),
             {"Content-Type": proto})
        call("POST", "/api/v1/namespaces/default/pods",
             json.dumps(pod_doc("json-body")), {"Content-Type": proto})
        call("PUT", "/api/v1/nodes/n1", b"\x0a\x02n1",
             {"Content-Type": proto})
    finally:
        srv.close()
    return out


def test_protobuf_negotiation_matches_reference():
    """``Accept: application/vnd.kubernetes.protobuf`` answers lists
    (whole, paged, selected) and single objects in the codec behind the
    magic envelope, as the reference does: equal statuses, content types
    and decoded messages; a protobuf body is read as JSON by both."""
    from kubernetes_tpu_torch.api.protobuf import node_from_pb, pod_from_pb
    from kubernetes_tpu_torch.extender import node_from_json
    from kubernetes_tpu_torch.server import pod_from_json

    want, got = proto_script(REF), proto_script(PORT)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g == w, w[:3]
    proto = "application/vnd.kubernetes.protobuf"
    pb = {p: (st, doc) for m, p, st, ct, doc in got
          if m == "GET" and ct == proto}
    js = {p: doc for m, p, st, ct, doc in got
          if m == "GET" and ct != proto}
    st, (kind, lst) = pb["/api/v1/pods"]
    assert (st, kind) == (200, "PodList") and len(lst.items) == 5
    assert lst.remaining == -1 and not lst.continue_token
    assert [pod_from_pb(m) for m in lst.items] == [
        pod_from_json(d) for d in js["/api/v1/pods"]["items"]]
    _, (_, nodes) = pb["/api/v1/nodes"]
    assert [node_from_pb(m) for m in nodes.items] == [
        node_from_json(d) for d in js["/api/v1/nodes"]["items"]]
    _, (_, page) = pb["/api/v1/pods?limit=2"]
    assert len(page.items) == 2 and page.remaining == 3
    assert page.continue_token
    _, (_, sel) = pb["/api/v1/pods?labelSelector=app%3Da1"]
    assert len(sel.items) == 2 and sel.remaining == -1
    assert pb["/api/v1/nodes/n0"][1][0] == "Node"
    assert pb["/api/v1/namespaces/default/pods/p0"][1][1].node_name == "n0"
    assert js["/api/v1/nodes/nope"]["code"] == 404
    posts = [(st, (doc or {}).get("reason")) for m, p, st, ct, doc in got
             if m in ("POST", "PUT") and "binding" not in p][-3:]
    assert posts[0] == (400, "BadRequest") and posts[1][0] == 201
    assert posts[2] == (400, "BadRequest")


def test_node_from_json_round_trips_like_the_reference():
    """The port keeps ``node_from_json`` beside ``node_to_json`` (the
    reference's lives in the gRPC shim): the wire form decodes to the
    same node in both packages, and a round trip keeps what the reference
    keeps."""
    from kubernetes_tpu.extender import node_to_json as jto
    from kubernetes_tpu.grpc_shim import node_from_json as jfrom
    from kubernetes_tpu.testing import make_node
    from kubernetes_tpu_torch.extender import node_from_json as tfrom
    from kubernetes_tpu_torch.extender import node_to_json as tto
    from torch_parity import to_port

    nd = make_node("n0", cpu_milli=4000, labels={"disk": "ssd"},
                   images={"registry/app:v1": 500 * 2**20}, zone="z1")
    nd.allocatable.scalars["nvidia.com/gpu"] = 2
    nd.prefer_avoid_owner_uids = ("rc-1", "rc-2")
    nd.unschedulable = True
    nd.allocatable.ephemeral_storage = 5 * 2**30
    nd.annotations = {"team": "a"}
    nd.pod_cidr = "10.0.3.0/24"
    doc = jto(nd)
    assert tto(to_port(nd)) == doc
    assert tfrom(doc) == to_port(jfrom(doc))
    assert tto(tfrom(doc)) == jto(jfrom(doc))
    back = tfrom(doc)
    assert back.images == nd.images and back.labels == nd.labels
    assert back.prefer_avoid_owner_uids == ("rc-1", "rc-2")
    assert back.allocatable.ephemeral_storage == 5 * 2**30
    for bad in ('{"preferAvoidPods": [42]}', "[]", "not json"):
        d = json.loads(json.dumps(doc))
        d["metadata"]["annotations"] = {
            "scheduler.alpha.kubernetes.io/preferAvoidPods": bad}
        assert tfrom(d) == to_port(jfrom(d))
        assert tfrom(d).prefer_avoid_owner_uids == ()
