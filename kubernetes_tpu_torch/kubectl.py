"""``ktpu`` — the kubectl-shaped operator CLI for this framework's scope
(the `pkg/kubectl` analog restricted to what the scheduler service owns):
inspect the service's resident snapshot over the gRPC seam, EXPLAIN
scheduling decisions with the real device kernels, and mutate cluster
state through the REST registry.

Read verbs (gRPC seam, --server HOST:PORT — grpc_shim.py; needs grpcio):

    python -m kubernetes_tpu_torch.kubectl --server 127.0.0.1:PORT get nodes
    python -m kubernetes_tpu_torch.kubectl --server ... get pods
    python -m kubernetes_tpu_torch.kubectl --server ... describe pod web-0
    python -m kubernetes_tpu_torch.kubectl --server ... describe node n3
    python -m kubernetes_tpu_torch.kubectl --server ... top nodes

Verbs (REST registry, --api-server HOST:PORT — restapi.py):

    python -m kubernetes_tpu_torch.kubectl --api-server ... create -f pod.json
    python -m kubernetes_tpu_torch.kubectl --api-server ... apply -f d.json
    python -m kubernetes_tpu_torch.kubectl --api-server ... delete pod web-0
    python -m kubernetes_tpu_torch.kubectl --api-server ... cordon n3
    python -m kubernetes_tpu_torch.kubectl --api-server ... drain n3
    python -m kubernetes_tpu_torch.kubectl --api-server ... get events
    python -m kubernetes_tpu_torch.kubectl --api-server ... scale deployment/web --replicas 3
    python -m kubernetes_tpu_torch.kubectl --api-server ... rollout status deployment/web

``describe pod`` on a pending pod runs the Filter/Prioritize verbs against
every node in the snapshot and prints the per-node failure reasons /
scores — `kubectl describe pod` events plus `kubectl get events` rolled
into the scheduler's own explanation (FitError text shapes). ``cordon``
is the kubectl drain primitive: a resourceVersion-preconditioned PUT
retried on 409, the client side of GuaranteedUpdate. The read verbs take
any client with ``get_state_snapshot``, ``filter`` and ``prioritize``
(:class:`_Client` over gRPC, or another transport of the same messages).
Without grpcio, ``--server`` exits 1 with one line naming it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List, Optional


def _fmt_table(headers: List[str], rows: List[List[str]]) -> str:
    widths = [len(h) for h in headers]
    for r in rows:
        for i, c in enumerate(r):
            widths[i] = max(widths[i], len(str(c)))
    line = lambda cells: "   ".join(
        str(c).ljust(w) for c, w in zip(cells, widths)
    ).rstrip()
    return "\n".join([line(headers)] + [line(r) for r in rows])


def _parse_mem(n: float) -> str:
    for unit, div in (("Gi", 2**30), ("Mi", 2**20), ("Ki", 2**10)):
        if n >= div:
            return f"{n / div:.1f}{unit}"
    return str(int(n))


class State:
    """Decoded GetState snapshot."""

    def __init__(self, snap) -> None:
        self.revision = snap.revision
        self.nodes = [json.loads(j) for j in snap.node_json]
        self.bound = [json.loads(j) for j in snap.pod_json]
        #: list of (queue name, pod doc) — provenance from the service
        self.pending_q = []
        for j in snap.pending_json:
            doc = json.loads(j)
            self.pending_q.append((doc["queue"], doc["pod"]))
        self.pending = [p for _, p in self.pending_q]

    def node_names(self) -> List[str]:
        return [n["metadata"]["name"] for n in self.nodes]

    def find_pod(self, name: str) -> Optional[dict]:
        ns, _, bare = name.rpartition("/")
        ns = ns or None
        for p in self.pending + self.bound:
            m = p["metadata"]
            if m["name"] == bare and (ns is None or m["namespace"] == ns):
                return p
        return None

    def usage_by_node(self) -> Dict[str, Dict[str, float]]:
        out: Dict[str, Dict[str, float]] = {}
        for p in self.bound:
            nd = p["spec"].get("nodeName")
            if not nd:
                continue
            u = out.setdefault(nd, {"cpu": 0.0, "memory": 0.0, "pods": 0})
            for c in p["spec"].get("containers", []):
                req = (c.get("resources") or {}).get("requests") or {}
                from kubernetes_tpu_torch.server import parse_quantity

                u["cpu"] += parse_quantity(req.get("cpu", "0"), is_cpu=True)
                u["memory"] += parse_quantity(req.get("memory", "0"))
            u["pods"] += 1
        return out


def _node_status(nd: dict) -> str:
    conds = {c["type"]: c["status"] == "True"
             for c in nd.get("status", {}).get("conditions", [])}
    parts = ["Ready" if conds.get("Ready", True) else "NotReady"]
    if nd.get("spec", {}).get("unschedulable"):
        parts.append("SchedulingDisabled")
    for k in ("MemoryPressure", "DiskPressure", "PIDPressure"):
        if conds.get(k):
            parts.append(k)
    return ",".join(parts)


def cmd_get(client, args) -> int:
    st = State(client.get_state_snapshot())
    if args.kind in ("nodes", "node", "no"):
        rows = []
        for nd in st.nodes:
            alloc = nd["status"]["allocatable"]
            taints = nd.get("spec", {}).get("taints", [])
            rows.append([
                nd["metadata"]["name"], _node_status(nd),
                str(len(taints)), alloc.get("cpu", "?"),
                _parse_mem(float(alloc.get("memory", 0))),
                alloc.get("pods", "?"),
            ])
        print(_fmt_table(
            ["NAME", "STATUS", "TAINTS", "CPU", "MEMORY", "PODS"], rows))
    elif args.kind in ("pods", "pod", "po"):
        # kubectl-parity scoping: -n selects a namespace (defaulting to
        # "default", like kubectl), -A lists every namespace
        want_ns = None if getattr(args, "all_namespaces", False) \
            else getattr(args, "namespace", None)
        rows = []
        for p in st.bound:
            m = p["metadata"]
            if want_ns and m["namespace"] != want_ns:
                continue
            rows.append([m["namespace"], m["name"], "Bound",
                         p["spec"].get("nodeName", ""),
                         str(p["spec"].get("priority", 0))])
        for q, p in st.pending_q:
            m = p["metadata"]
            if want_ns and m["namespace"] != want_ns:
                continue
            status = "Pending" if q == "active" else f"Pending({q})"
            rows.append([m["namespace"], m["name"], status, "",
                         str(p["spec"].get("priority", 0))])
        print(_fmt_table(
            ["NAMESPACE", "NAME", "STATUS", "NODE", "PRIORITY"], rows))
    else:
        print(f"error: unknown kind {args.kind!r}", file=sys.stderr)
        return 1
    return 0


def cmd_top(client, args) -> int:
    st = State(client.get_state_snapshot())
    usage = st.usage_by_node()
    from kubernetes_tpu_torch.server import parse_quantity

    rows = []
    for nd in st.nodes:
        name = nd["metadata"]["name"]
        alloc = nd["status"]["allocatable"]
        cap_cpu = parse_quantity(alloc.get("cpu", "0"), is_cpu=True)
        cap_mem = parse_quantity(alloc.get("memory", "0"))
        u = usage.get(name, {"cpu": 0.0, "memory": 0.0, "pods": 0})
        rows.append([
            name,
            f"{u['cpu']:.0f}m",
            f"{100 * u['cpu'] / cap_cpu:.0f}%" if cap_cpu else "-",
            _parse_mem(u["memory"]),
            f"{100 * u['memory'] / cap_mem:.0f}%" if cap_mem else "-",
            str(u["pods"]),
        ])
    print(_fmt_table(
        ["NAME", "CPU(req)", "CPU%", "MEMORY(req)", "MEMORY%", "PODS"], rows))
    return 0


def _pending_breakdown(failed_nodes: Dict[str, str], n_total: int,
                       feasible: int) -> List[str]:
    """kubectl-describe enrichment for a pending pod: aggregate the
    filter verb's per-node failure reasons into the reference's
    "0/N nodes are available: <count> <reason>, ..." line (FitError
    shape, per-reason NODE counts) plus the top one-bit-away
    relaxations — a node whose failure set is a single predicate is
    opened by relaxing exactly that predicate (obs/explain.py
    semantics, recomputed client-side from the wire reasons)."""
    from kubernetes_tpu_torch.obs.explain import reason_message
    from kubernetes_tpu_torch.ops.predicates import PREDICATE_BITS

    predicates = set(PREDICATE_BITS)
    per_reason: Dict[str, int] = {}
    one_bit: Dict[str, int] = {}
    for _node, why in failed_nodes.items():
        names = [w for w in why.split(",") if w]
        for nm in names:
            per_reason[nm] = per_reason.get(nm, 0) + 1
        # wire sentinels ("infeasible", "node not in snapshot") stay in
        # the 0/N line but are not predicates — "relax infeasible" is
        # not actionable advice
        if len(names) == 1 and names[0] in predicates:
            one_bit[names[0]] = one_bit.get(names[0], 0) + 1
    lines: List[str] = []
    if not feasible and per_reason:
        parts = sorted(
            f"{c} {reason_message(n)}" for n, c in per_reason.items())
        lines.append(
            f"Status: 0/{n_total} nodes are available: "
            f"{', '.join(parts)}.")
    if not feasible and one_bit:
        lines.append("One-bit-away (single relaxation -> nodes opened):")
        for nm, c in sorted(one_bit.items(),
                            key=lambda kv: (-kv[1], kv[0]))[:3]:
            lines.append(f"  relax {nm}: +{c} node(s)")
    return lines


def cmd_describe(client, args) -> int:
    from kubernetes_tpu_torch.proto import extender as pb

    st = State(client.get_state_snapshot())
    if args.kind in ("pod", "pods", "po"):
        p = st.find_pod(args.name)
        if p is None:
            print(f'error: pod "{args.name}" not found', file=sys.stderr)
            return 1
        m = p["metadata"]
        print(f"Name:       {m['name']}")
        print(f"Namespace:  {m['namespace']}")
        print(f"Priority:   {p['spec'].get('priority', 0)}")
        print(f"Labels:     {m.get('labels') or {}}")
        node = p["spec"].get("nodeName", "")
        print(f"Node:       {node or '<none>'}")
        if not node:
            # explain: run the real Filter/Prioritize verbs over the
            # snapshot (the scheduler's own kernels answer)
            fr = client.filter(pb.ExtenderArgs(
                pod_json=json.dumps(p), node_names=st.node_names()))
            print("\nScheduling explanation (Filter):")
            if fr.error:
                print(f"  error: {fr.error}")
            for line in _pending_breakdown(
                    dict(fr.failed_nodes),
                    len(fr.node_names) + len(fr.failed_nodes),
                    len(fr.node_names)):
                print(line)
            for n in fr.node_names:
                print(f"  {n}: feasible")
            for n, why in sorted(fr.failed_nodes.items()):
                print(f"  {n}: {why}")
            if fr.node_names:
                pr = client.prioritize(pb.ExtenderArgs(
                    pod_json=json.dumps(p),
                    node_names=list(fr.node_names)))
                print("Scores (0-10):")
                for item in sorted(pr.items, key=lambda i: -i.score):
                    print(f"  {item.host}: {item.score}")
        return 0
    if args.kind in ("node", "nodes", "no"):
        nd = next((n for n in st.nodes
                   if n["metadata"]["name"] == args.name), None)
        if nd is None:
            print(f'error: node "{args.name}" not found', file=sys.stderr)
            return 1
        print(f"Name:    {nd['metadata']['name']}")
        print(f"Status:  {_node_status(nd)}")
        print(f"Labels:  {nd['metadata'].get('labels') or {}}")
        taints = nd.get("spec", {}).get("taints", [])
        print(f"Taints:  {taints or '<none>'}")
        print(f"Allocatable: {nd['status']['allocatable']}")
        u = st.usage_by_node().get(args.name)
        if u:
            print(f"Requested:   cpu {u['cpu']:.0f}m, "
                  f"memory {_parse_mem(u['memory'])}, pods {u['pods']}")
        pods = [p["metadata"]["name"] for p in st.bound
                if p["spec"].get("nodeName") == args.name]
        print(f"Pods ({len(pods)}): {', '.join(sorted(pods)) or '<none>'}")
        return 0
    print(f"error: unknown kind {args.kind!r}", file=sys.stderr)
    return 1


class RestClient:
    """HTTP client for the REST registry (restapi.py). ``token`` sends
    `Authorization: Bearer <token>` on every request — the client half
    of the facade's authentication filter."""

    def __init__(self, target: str, token=None):
        host, _, port = target.rpartition(":")
        self.host, self.port = host or "127.0.0.1", int(port)
        self._headers = ({"Authorization": f"Bearer {token}"}
                         if token else {})

    def call(self, method: str, path: str, body=None, headers=None):
        import http.client

        conn = http.client.HTTPConnection(self.host, self.port, timeout=30)
        conn.request(method, path,
                     json.dumps(body) if body is not None else None,
                     {**self._headers, **(headers or {})})
        r = conn.getresponse()
        data = r.read()
        conn.close()
        return r.status, json.loads(data) if data else None


def _rest_fail(doc) -> int:
    msg = (doc or {}).get("message") or (doc or {}).get("reason") or "error"
    print(f"Error: {msg}", file=sys.stderr)
    return 1


def cmd_create(rest: RestClient, args) -> int:
    with open(args.filename) as f:
        doc = json.load(f)
    kind = doc.get("kind")
    if not kind:
        # kubectl refuses kind-less docs; guessing here could create a
        # bogus Pod out of a hand-written Node manifest
        print(f"Error: {args.filename} is missing 'kind'", file=sys.stderr)
        return 1
    if kind not in ("Pod", "Node"):
        print(f"Error: unsupported kind {kind!r}", file=sys.stderr)
        return 1
    if kind == "Node":
        code, out = rest.call("POST", "/api/v1/nodes", doc)
        what = f"node/{(doc.get('metadata') or {}).get('name', '?')}"
    else:
        ns = (doc.get("metadata") or {}).get("namespace") or args.namespace
        code, out = rest.call("POST", f"/api/v1/namespaces/{ns}/pods", doc)
        what = f"pod/{(doc.get('metadata') or {}).get('name', '?')}"
    if code != 201:
        return _rest_fail(out)
    print(f"{what} created")
    return 0


def cmd_apply(rest: RestClient, args) -> int:
    """kubectl apply -f: declarative create-or-update. Absent -> POST;
    present -> PATCH with the manifest as a JSON merge patch (the
    facade's supported patch type). One deliberate simplification vs
    kubectl: no last-applied three-way merge — fields you DROP from the
    manifest are left as-is on the server, not deleted (delete a field
    explicitly with null, RFC 7386)."""
    with open(args.filename) as f:
        doc = json.load(f)
    kind = doc.get("kind")
    name = (doc.get("metadata") or {}).get("name", "")
    if not kind or not name:
        print(f"Error: {args.filename} needs kind and metadata.name",
              file=sys.stderr)
        return 1
    ns = (doc.get("metadata") or {}).get("namespace") or args.namespace
    routes = {
        "Pod": (f"/api/v1/namespaces/{ns}/pods", f"pod/{name}"),
        "Node": ("/api/v1/nodes", f"node/{name}"),
        "Deployment": (f"/apis/apps/v1/namespaces/{ns}/deployments",
                       f"deployment.apps/{name}"),
        "Namespace": ("/api/v1/namespaces", f"namespace/{name}"),
    }
    if kind not in routes:
        print(f"Error: unsupported kind {kind!r}", file=sys.stderr)
        return 1
    collection, what = routes[kind]
    code, cur = rest.call("GET", f"{collection}/{name}")
    if code == 404:
        code, out = rest.call("POST", collection, doc)
        if code != 201:
            return _rest_fail(out)
        print(f"{what} created")
        return 0
    if code != 200:
        return _rest_fail(cur)
    if kind == "Namespace":
        print(f"{what} unchanged")  # namespaces have no mutable spec here
        return 0
    # the FULL manifest goes as the patch: a pod whose spec genuinely
    # changed gets the facade's 422 (spec changes need delete+create so
    # admission re-runs) surfaced as a real failure — never a silent
    # 'configured' that dropped the user's change
    code, out = rest.call(
        "PATCH", f"{collection}/{name}", doc,
        headers={"Content-Type": "application/merge-patch+json"})
    if code != 200:
        return _rest_fail(out)
    print(f"{what} configured")
    return 0


def cmd_get_events(rest: RestClient, args) -> int:
    """kubectl get events: the hub's Event registry over REST, newest
    last, kubectl's column shape; -A/--all-namespaces widens the scope."""
    path = ("/api/v1/events" if args.all_namespaces
            else f"/api/v1/namespaces/{args.namespace}/events")
    if getattr(args, "field_selector", ""):
        from urllib.parse import quote

        path += f"?fieldSelector={quote(args.field_selector)}"
    code, doc = rest.call("GET", path)
    if code != 200:
        return _rest_fail(doc)
    rows = [
        [
            str(it.get("count", 1)),
            it.get("type", ""),
            it.get("reason", ""),
            f"pod/{it['involvedObject']['name']}",
            it.get("message", "")[:80],
        ]
        for it in doc["items"]
    ]
    print(_fmt_table(["COUNT", "TYPE", "REASON", "OBJECT", "MESSAGE"], rows))
    return 0


def cmd_get_csr(rest: RestClient, args) -> int:
    """kubectl get csr (certificates.k8s.io/v1beta1): the CSR flow's
    observable state — requestor, subject, condition."""
    code, doc = rest.call(
        "GET", "/apis/certificates.k8s.io/v1beta1/"
               "certificatesigningrequests")
    if code != 200:
        return _rest_fail(doc)
    rows = []
    for it in doc["items"]:
        conds = [c["type"] for c in it["status"].get("conditions", [])]
        cond = ",".join(conds) or "Pending"
        if it["status"].get("certificateIssued"):
            cond += ",Issued"
        rows.append([
            it["metadata"]["name"],
            it["spec"].get("username", ""),
            it["spec"].get("request", {}).get("commonName", ""),
            cond,
        ])
    print(_fmt_table(["NAME", "REQUESTOR", "SUBJECT", "CONDITION"], rows))
    return 0


def cmd_get_configmaps(rest: RestClient, args) -> int:
    """kubectl get configmaps: name + data-key count per namespace."""
    path = ("/api/v1/configmaps" if args.all_namespaces
            else f"/api/v1/namespaces/{args.namespace}/configmaps")
    code, doc = rest.call("GET", path)
    if code != 200:
        return _rest_fail(doc)
    rows = [[it["metadata"]["namespace"], it["metadata"]["name"],
             str(len(it.get("data", {})))]
            for it in doc["items"]]
    print(_fmt_table(["NAMESPACE", "NAME", "DATA"], rows))
    return 0


def cmd_get_serviceaccounts(rest: RestClient, args) -> int:
    """kubectl get serviceaccounts: the identities the tokens
    controller maintains, with their token-secret references."""
    path = ("/api/v1/serviceaccounts" if args.all_namespaces
            else f"/api/v1/namespaces/{args.namespace}/serviceaccounts")
    code, doc = rest.call("GET", path)
    if code != 200:
        return _rest_fail(doc)
    rows = [[it["metadata"]["namespace"], it["metadata"]["name"],
             str(len(it.get("secrets", [])))]
            for it in doc["items"]]
    print(_fmt_table(["NAMESPACE", "NAME", "SECRETS"], rows))
    return 0


def cmd_get_daemonsets(rest: RestClient, args) -> int:
    """kubectl get daemonsets: desired/ready/updated per DS."""
    code, doc = rest.call("GET", "/apis/apps/v1/namespaces/default/"
                                 "daemonsets")
    if code != 200:
        return _rest_fail(doc)
    rows = [[it["metadata"]["name"],
             str(it["status"]["desiredNumberScheduled"]),
             str(it["status"]["numberReady"]),
             str(it["status"]["updatedNumberScheduled"]),
             str(it["status"]["observedRevision"])]
            for it in doc["items"]]
    print(_fmt_table(["NAME", "DESIRED", "READY", "UPDATED", "REV"], rows))
    return 0


def cmd_get_statefulsets(rest: RestClient, args) -> int:
    """kubectl get statefulsets: replicas/ready/updated per STS."""
    code, doc = rest.call("GET", "/apis/apps/v1/namespaces/default/"
                                 "statefulsets")
    if code != 200:
        return _rest_fail(doc)
    rows = [[it["metadata"]["name"],
             f'{it["status"]["readyReplicas"]}/{it["spec"]["replicas"]}',
             str(it["status"]["updatedReplicas"]),
             str(it["status"]["observedRevision"])]
            for it in doc["items"]]
    print(_fmt_table(["NAME", "READY", "UPDATED", "REV"], rows))
    return 0


def cmd_rollout_history(rest: RestClient, args) -> int:
    """kubectl rollout history: the ControllerRevision trail for one
    DS/STS (kind/name target, like rollout status)."""
    kind, _, name = args.target.partition("/")
    kind_map = {"daemonset": "DaemonSet", "ds": "DaemonSet",
                "statefulset": "StatefulSet", "sts": "StatefulSet"}
    owner_kind = kind_map.get(kind.lower())
    if owner_kind is None or not name:
        print(f"Error: rollout history target must be "
              f"daemonset/NAME or statefulset/NAME, got {args.target!r}",
              file=sys.stderr)
        return 2
    code, doc = rest.call("GET", "/apis/apps/v1/namespaces/default/"
                                 "controllerrevisions")
    if code != 200:
        return _rest_fail(doc)
    rows = [[str(it["revision"]),
             ", ".join(f"{k}={v}" for k, v in sorted(it["data"].items()))]
            for it in sorted(doc["items"], key=lambda i: i["revision"])
            if it["metadata"]["ownerReferences"][0]["kind"] == owner_kind
            and it["metadata"]["ownerReferences"][0]["name"] == name]
    if not rows:
        print(f"Error: no revisions found for {args.target}",
              file=sys.stderr)
        return 1
    print(_fmt_table(["REVISION", "TEMPLATE"], rows))
    return 0


def cmd_get_leases(rest: RestClient, args) -> int:
    """kubectl get leases (coordination.k8s.io/v1): HA state over REST —
    who holds each lock and how fresh the renewal is."""
    path = ("/apis/coordination.k8s.io/v1/leases" if args.all_namespaces
            else "/apis/coordination.k8s.io/v1/namespaces/"
                 f"{args.namespace}/leases")
    code, doc = rest.call("GET", path)
    if code != 200:
        return _rest_fail(doc)
    rows = [
        [
            it["metadata"]["namespace"],
            it["metadata"]["name"],
            it["spec"].get("holderIdentity", ""),
            str(it["spec"].get("leaseTransitions", 0)),
            f"{it['spec'].get('renewTime', 0):.1f}",
        ]
        for it in doc["items"]
    ]
    print(_fmt_table(["NAMESPACE", "NAME", "HOLDER", "TRANSITIONS",
                      "RENEWTIME"], rows))
    if not rows and not args.all_namespaces:
        # the well-known scheduler lease lives in kube-system; an empty
        # default-namespace table almost always means the wrong scope
        print(f'No leases found in namespace "{args.namespace}" '
              "(try -n kube-system or -A)", file=sys.stderr)
    return 0


def cmd_drain(rest: RestClient, args) -> int:
    """kubectl drain: cordon the node, then EVICT every pod on it
    through the Eviction subresource (PDB-guarded; a 429 is reported and
    leaves the pod — kubectl's retry loop compressed to one pass with an
    honest exit code). DaemonSet-owned pods are skipped, kubectl's
    --ignore-daemonsets posture (their controller would just repin
    them)."""
    rc = cmd_cordon(rest, args, unschedulable=True)
    if rc != 0:
        return rc
    # server-side field selector: list ONLY this node's pods (the
    # spec.nodeName selector kubelets live on, pod/strategy.go:197) —
    # listing the world and filtering client-side is the anti-pattern
    # the watch cache exists to prevent
    from urllib.parse import quote

    code, doc = rest.call(
        "GET",
        f"/api/v1/pods?fieldSelector={quote(f'spec.nodeName={args.name}')}",
    )
    if code != 200:
        return _rest_fail(doc)
    blocked = []
    for p in doc["items"]:
        m = p["metadata"]
        refs = p["metadata"].get("ownerReferences") or []
        if any(r.get("kind") == "DaemonSet" for r in refs):
            print(f"ignoring DaemonSet-managed pod {m['name']}")
            continue
        code, out = rest.call(
            "POST",
            f"/api/v1/namespaces/{m['namespace']}/pods/{m['name']}/eviction",
            {"kind": "Eviction",
             "metadata": {"name": m["name"], "namespace": m["namespace"]}},
        )
        if code == 201:
            print(f"pod/{m['name']} evicted")
        elif code == 404:
            # vanished between list and evict — exactly what drain
            # wanted; kubectl treats this as success too
            print(f"pod/{m['name']} already gone")
        elif code == 429:
            blocked.append(m["name"])
            print(f"error when evicting pod/{m['name']}: "
                  f"{out.get('message', '')}", file=sys.stderr)
        else:
            return _rest_fail(out)
    if blocked:
        print(f"drain incomplete: {len(blocked)} pod(s) blocked by "
              "disruption budgets", file=sys.stderr)
        return 1
    print(f"node/{args.name} drained")
    return 0


def cmd_get_deployments(rest: RestClient, args) -> int:
    """kubectl get deployments: rollout state over the apps/v1 routes."""
    code, doc = rest.call("GET", "/apis/apps/v1/deployments")
    if code != 200:
        return _rest_fail(doc)
    rows = []
    for it in doc["items"]:
        st = it["status"]
        rows.append([
            it["metadata"]["name"],
            f"{st.get('readyReplicas', 0)}/{it['spec'].get('replicas', 0)}",
            str(st.get("updatedReplicas", 0)),
            str(st.get("observedRevision", 0)),
            it["spec"].get("strategy", ""),
        ])
    print(_fmt_table(["NAME", "READY", "UP-TO-DATE", "REVISION",
                      "STRATEGY"], rows))
    return 0


def cmd_scale(rest: RestClient, args) -> int:
    """kubectl scale deployment/NAME --replicas=N through the /scale
    subresource (ScaleREST.Update, storage.go:230) — the same write the
    HPA performs."""
    kind, _, name = args.target.partition("/")
    if kind not in ("deployment", "deploy", "deployments") or not name:
        print(f"error: scale expects deployment/NAME, got "
              f"{args.target!r}", file=sys.stderr)
        return 2
    code, doc = rest.call(
        "PUT",
        f"/apis/apps/v1/namespaces/{args.namespace}/deployments/"
        f"{name}/scale",
        {"kind": "Scale", "spec": {"replicas": args.replicas}},
    )
    if code != 200:
        return _rest_fail(doc)
    print(f"deployment.apps/{name} scaled")
    return 0


def cmd_rollout_status(rest: RestClient, args) -> int:
    """kubectl rollout status deployment/NAME, one-shot: prints the
    current rollout state; exit 0 when complete (all replicas updated
    and ready), 1 while in progress — scriptable polling instead of
    kubectl's watch loop."""
    kind, _, name = args.target.partition("/")
    if kind not in ("deployment", "deploy", "deployments") or not name:
        print(f"error: rollout status expects deployment/NAME, got "
              f"{args.target!r}", file=sys.stderr)
        return 2
    code, doc = rest.call("GET", "/apis/apps/v1/namespaces/default/"
                                 f"deployments/{name}")
    if code != 200:
        _rest_fail(doc)
        return 2  # error, NOT "in progress": pollable scripts must stop
    want = doc["spec"].get("replicas", 0)
    st = doc["status"]
    updated, ready = st.get("updatedReplicas", 0), st.get("readyReplicas", 0)
    if updated >= want and ready >= want and st.get("replicas", 0) == want:
        print(f'deployment "{name}" successfully rolled out '
              f'({updated}/{want} updated)')
        return 0
    print(f'Waiting for deployment "{name}" rollout to finish: '
          f'{updated} of {want} updated replicas are available...')
    return 1


def cmd_describe_apps(rest: RestClient, args) -> int:
    """kubectl describe deployment/daemonset/statefulset over REST:
    spec + rollout status, the owned-ReplicaSet breakdown (deployments),
    and the object's recent events — the operator's one-stop rollout
    view."""
    kind_map = {"deployment": "deployments", "deploy": "deployments",
                "daemonset": "daemonsets", "ds": "daemonsets",
                "statefulset": "statefulsets", "sts": "statefulsets"}
    resource = kind_map[args.kind]
    code, doc = rest.call(
        "GET", f"/apis/apps/v1/namespaces/default/{resource}/{args.name}")
    if code != 200:
        return _rest_fail(doc)
    print(f"Name:       {args.name}")
    st = doc.get("status", {})
    if resource == "deployments":
        spec = doc["spec"]
        print(f"Replicas:   {spec.get('replicas', 0)} desired | "
              f"{st.get('updatedReplicas', 0)} updated | "
              f"{st.get('readyReplicas', 0)} ready")
        strategy = spec.get("strategy", "")
        if isinstance(strategy, dict):  # tolerate both doc shapes
            strategy = strategy.get("type", "RollingUpdate")
        if strategy:
            print(f"Strategy:   {strategy}")
        code, rss = rest.call(
            "GET", "/apis/apps/v1/namespaces/default/replicasets")
        if code == 200:
            owned = [it for it in rss["items"]
                     if it["metadata"].get("ownerReferences",
                                           [{}])[0].get("name")
                     == args.name]
            if owned:
                print("ReplicaSets:")
                for it in owned:
                    m, s = it["metadata"], it.get("status", {})
                    print(f"  {m['name']}: {s.get('replicas', 0)} replicas,"
                          f" revision {it.get('revision', '?')}")
    elif resource == "daemonsets":
        print(f"Desired:    {st.get('desiredNumberScheduled', 0)} | "
              f"ready {st.get('numberReady', 0)} | "
              f"updated {st.get('updatedNumberScheduled', 0)} "
              f"(rev {st.get('observedRevision', '?')})")
    else:
        print(f"Replicas:   {st.get('readyReplicas', 0)}/"
              f"{doc['spec'].get('replicas', 0)} ready | "
              f"updated {st.get('updatedReplicas', 0)} "
              f"(rev {st.get('observedRevision', '?')})")
    code, evs = rest.call(
        "GET", "/api/v1/events?fieldSelector="
               f"involvedObject.name%3D{args.name}")
    if code == 200 and evs["items"]:
        print("Events:")
        for it in evs["items"]:
            print(f"  {it['type']}\t{it['reason']}\t{it['message'][:70]}")
    return 0


def cmd_get_namespaces(rest: RestClient, args) -> int:
    """kubectl get namespaces: lifecycle phases over REST."""
    code, doc = rest.call("GET", "/api/v1/namespaces")
    if code != 200:
        return _rest_fail(doc)
    rows = [[it["metadata"]["name"], it["status"].get("phase", "")]
            for it in doc["items"]]
    print(_fmt_table(["NAME", "STATUS"], rows))
    return 0


def cmd_delete(rest: RestClient, args) -> int:
    if args.kind in ("node", "nodes"):
        code, out = rest.call("DELETE", f"/api/v1/nodes/{args.name}")
        what = f"node/{args.name}"
    else:
        code, out = rest.call(
            "DELETE", f"/api/v1/namespaces/{args.namespace}/pods/{args.name}"
        )
        what = f"pod/{args.name}"
    if code != 200:
        return _rest_fail(out)
    print(f"{what} deleted")
    return 0


def cmd_cordon(rest: RestClient, args, unschedulable: bool) -> int:
    # kubectl cordon: read-modify-write with the resourceVersion
    # precondition, retried on 409 — the client half of GuaranteedUpdate
    # (etcd3/store.go:236); bounded attempts like RetryOnConflict
    for _ in range(5):
        code, node = rest.call("GET", f"/api/v1/nodes/{args.name}")
        if code != 200:
            return _rest_fail(node)
        node.setdefault("spec", {})["unschedulable"] = unschedulable
        code, out = rest.call("PUT", f"/api/v1/nodes/{args.name}", node)
        if code == 200:
            print(f"node/{args.name} "
                  f"{'cordoned' if unschedulable else 'uncordoned'}")
            return 0
        if code != 409:
            return _rest_fail(out)
    print(f"Error: conflict updating node/{args.name} after 5 retries",
          file=sys.stderr)
    return 1


class _Client:
    """Thin wrapper adding get_state_snapshot() sugar."""

    def __init__(self, target: str, token=None):
        from kubernetes_tpu_torch.grpc_shim import GrpcSchedulerClient
        from kubernetes_tpu_torch.proto import extender as pb

        self._c = GrpcSchedulerClient(target, token=token)
        self._pb = pb

    def get_state_snapshot(self):
        return self._c.get_state(self._pb.StateRequest())

    def __getattr__(self, name):
        return getattr(self._c, name)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="ktpu", description="kubectl-shaped CLI for the TPU scheduler"
    )
    p.add_argument("--server", help="gRPC service HOST:PORT (read verbs)")
    p.add_argument("--api-server",
                   help="REST registry HOST:PORT (mutation verbs)")
    p.add_argument("--token", default=os.environ.get("KTPU_TOKEN"),
                   help="bearer token for a token-gated gRPC service "
                        "(or KTPU_TOKEN env var)")
    sub = p.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("get")
    g.add_argument("kind")
    g.add_argument("-n", "--namespace", default="default")
    g.add_argument("-A", "--all-namespaces", action="store_true")
    g.add_argument("--field-selector", default="",
                   help="server-side field filter (events: reason=..., "
                        "involvedObject.name=..., type=...)")
    t = sub.add_parser("top")
    t.add_argument("kind", choices=["nodes"])
    d = sub.add_parser("describe")
    d.add_argument("kind")
    d.add_argument("name")
    c = sub.add_parser("create")
    c.add_argument("-f", "--filename", required=True)
    c.add_argument("-n", "--namespace", default="default")
    ap_ = sub.add_parser("apply")
    ap_.add_argument("-f", "--filename", required=True)
    ap_.add_argument("-n", "--namespace", default="default")
    de = sub.add_parser("delete")
    de.add_argument("kind", choices=["pod", "pods", "node", "nodes"])
    de.add_argument("name")
    de.add_argument("-n", "--namespace", default="default")
    for verb in ("cordon", "uncordon", "drain"):
        cv = sub.add_parser(verb)
        cv.add_argument("name")
    ro = sub.add_parser("rollout")
    ro.add_argument("verb", choices=["status", "history"])
    ro.add_argument("target")  # deployment/NAME
    sc = sub.add_parser("scale")
    sc.add_argument("target")  # deployment/NAME
    sc.add_argument("--replicas", type=int, required=True)
    sc.add_argument("-n", "--namespace", default="default")
    args = p.parse_args(argv)

    if args.cmd == "rollout":
        if not args.api_server:
            p.error("rollout requires --api-server")
        try:
            rest = RestClient(args.api_server, token=args.token)
        except ValueError:
            p.error(f"--api-server must be HOST:PORT, got {args.api_server!r}")
        try:
            if args.verb == "history":
                return cmd_rollout_history(rest, args)
            return cmd_rollout_status(rest, args)
        except OSError as e:
            print(f"Error: cannot reach API server {args.api_server}: {e}",
                  file=sys.stderr)
            return 2

    if (args.cmd == "get" and getattr(args, "field_selector", "")
            and args.kind != "events"):
        p.error("--field-selector is only supported for 'get events' "
                "(other kinds read the gRPC snapshot, which is "
                "unfiltered by design)")
    if args.cmd == "get" and args.kind in ("events", "leases",
                                           "namespaces", "ns",
                                           "deployments", "deploy",
                                           "csr", "configmaps", "cm",
                                           "serviceaccounts", "sa",
                                           "daemonsets", "ds",
                                           "statefulsets", "sts"):
        if not args.api_server:
            p.error(f"get {args.kind} requires --api-server")
        try:
            rest = RestClient(args.api_server, token=args.token)
        except ValueError:
            p.error(f"--api-server must be HOST:PORT, got {args.api_server!r}")
        try:
            if args.kind == "leases":
                return cmd_get_leases(rest, args)
            if args.kind in ("namespaces", "ns"):
                return cmd_get_namespaces(rest, args)
            if args.kind in ("deployments", "deploy"):
                return cmd_get_deployments(rest, args)
            if args.kind == "csr":
                return cmd_get_csr(rest, args)
            if args.kind in ("configmaps", "cm"):
                return cmd_get_configmaps(rest, args)
            if args.kind in ("serviceaccounts", "sa"):
                return cmd_get_serviceaccounts(rest, args)
            if args.kind in ("daemonsets", "ds"):
                return cmd_get_daemonsets(rest, args)
            if args.kind in ("statefulsets", "sts"):
                return cmd_get_statefulsets(rest, args)
            return cmd_get_events(rest, args)
        except OSError as e:
            print(f"Error: cannot reach API server {args.api_server}: {e}",
                  file=sys.stderr)
            return 1

    if args.cmd in ("create", "delete", "cordon", "uncordon", "drain",
                    "scale", "apply"):
        if not args.api_server:
            p.error(f"{args.cmd} requires --api-server")
        try:
            rest = RestClient(args.api_server, token=args.token)
        except ValueError:
            p.error(f"--api-server must be HOST:PORT, got {args.api_server!r}")
        try:
            if args.cmd == "create":
                return cmd_create(rest, args)
            if args.cmd == "apply":
                return cmd_apply(rest, args)
            if args.cmd == "delete":
                return cmd_delete(rest, args)
            if args.cmd == "drain":
                return cmd_drain(rest, args)
            if args.cmd == "scale":
                return cmd_scale(rest, args)
            return cmd_cordon(rest, args,
                              unschedulable=(args.cmd == "cordon"))
        except OSError as e:
            print(f"Error: cannot reach API server {args.api_server}: {e}",
                  file=sys.stderr)
            return 1

    if (args.cmd == "describe" and args.kind in (
            "deployment", "deploy", "daemonset", "ds",
            "statefulset", "sts")):
        if not args.api_server:
            p.error(f"describe {args.kind} requires --api-server")
        try:
            rest = RestClient(args.api_server, token=args.token)
        except ValueError:
            p.error(f"--api-server must be HOST:PORT, got "
                    f"{args.api_server!r}")
        try:
            return cmd_describe_apps(rest, args)
        except OSError as e:
            print(f"Error: cannot reach API server {args.api_server}: {e}",
                  file=sys.stderr)
            return 2

    if not args.server:
        p.error(f"{args.cmd} requires --server")
    try:
        client = _Client(args.server, token=args.token)
    except ImportError as e:
        # the read verbs' transport is grpcio: without it, one line
        # naming it, never a fall back to another transport
        print(f"Error: {e}", file=sys.stderr)
        return 1
    import grpc

    try:
        if args.cmd == "get":
            return cmd_get(client, args)
        if args.cmd == "top":
            return cmd_top(client, args)
        return cmd_describe(client, args)
    except grpc.RpcError as e:
        # kubectl-style one-line failures, not tracebacks: an
        # UNAUTHENTICATED here means the service is token-gated —
        # say how to supply one
        hint = (" (pass --token or set KTPU_TOKEN)"
                if e.code() == grpc.StatusCode.UNAUTHENTICATED else "")
        print(f"Error from server: {e.code().name}: {e.details()}{hint}",
              file=sys.stderr)
        return 1
    finally:
        client.close()


if __name__ == "__main__":
    sys.exit(main())
