"""The control-plane modules the hollow cluster runs, held against the JAX
package's: admission, auth, certificates, cloud, proxy, bootstrap and
``api/selectors``. Each case runs one seeded script through each
package's copy of the module (and its ``HollowCluster`` where the module
lives in the hub) and the outcomes must be equal. The reference's
scheduler runs on JAX's CPU backend, the port's on CPU tensors."""

import dataclasses
import random
import types

import pytest

import kubernetes_tpu.admission as jadmission
import kubernetes_tpu.api.selectors as jselectors
import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu.auth as jauth
import kubernetes_tpu.bootstrap as jbootstrap
import kubernetes_tpu.certificates as jcertificates
import kubernetes_tpu.cloud as jcloud
import kubernetes_tpu.proxy as jproxy
import kubernetes_tpu.sim as jsim
import kubernetes_tpu.testing as jtesting
import kubernetes_tpu_torch.admission as tadmission
import kubernetes_tpu_torch.api.selectors as tselectors
import kubernetes_tpu_torch.api.types as ttypes
import kubernetes_tpu_torch.auth as tauth
import kubernetes_tpu_torch.bootstrap as tbootstrap
import kubernetes_tpu_torch.certificates as tcertificates
import kubernetes_tpu_torch.cloud as tcloud
import kubernetes_tpu_torch.proxy as tproxy
import kubernetes_tpu_torch.sim as tsim
import kubernetes_tpu_torch.testing as ttesting

REF = types.SimpleNamespace(
    admission=jadmission, selectors=jselectors, types=jtypes, auth=jauth,
    bootstrap=jbootstrap, certificates=jcertificates, cloud=jcloud,
    proxy=jproxy, sim=jsim, testing=jtesting, kw={})
PORT = types.SimpleNamespace(
    admission=tadmission, selectors=tselectors, types=ttypes, auth=tauth,
    bootstrap=tbootstrap, certificates=tcertificates, cloud=tcloud,
    proxy=tproxy, sim=tsim, testing=ttesting, kw={"device": "cpu"})


def hub_of(pkg, n_nodes=3, **kw):
    hub = pkg.sim.HollowCluster(seed=3, scheduler_kw=dict(pkg.kw), **kw)
    for i in range(n_nodes):
        hub.add_node(pkg.testing.make_node(f"n{i}", cpu_milli=4000))
    return hub


def admission(pkg):
    """Priority classes (named, global default, never-preempting, the
    system-critical builtins), default tolerations, LimitRanger defaults
    and bounds, quota on pods and cpu released by the controller, and a
    terminating namespace — every create's stored pod or its 403."""
    a, t = pkg.admission, pkg.types
    hub = hub_of(pkg, admission=True)
    hub.add_priority_class(a.PriorityClass("high", 1000))
    hub.add_priority_class(a.PriorityClass("std", 7, global_default=True))
    hub.add_priority_class(a.PriorityClass(
        "gentle", 500, preemption_policy="Never"))
    hub.add_namespace("team")
    hub.add_quota(a.ResourceQuota("q", namespace="team", hard_pods=3,
                                  hard_cpu_milli=700))
    hub.add_limit_range(a.LimitRange(namespace="team",
                                     default_cpu_milli=150,
                                     max_cpu_milli=400))
    hub.add_namespace("doomed")
    hub.terminate_namespace("doomed")
    specs = [("a", "default", "high", 100, ()),
             ("b", "default", "", 100, ()),
             ("c", "default", "gentle", 100, ()),
             ("d", "default", "nope", 100, ()),
             ("e", "kube-system", "system-cluster-critical", 100, ()),
             ("f", "default", "", 100, (t.Toleration(
                 key=a.TAINT_UNREACHABLE, operator="Exists",
                 effect=t.EFFECT_NO_EXECUTE, toleration_seconds=5),)),
             ("g", "team", "", 0, ()), ("h", "team", "", 300, ()),
             ("i", "team", "", 300, ()), ("j", "team", "", 900, ()),
             ("k", "team", "", 100, ()), ("l", "doomed", "", 100, ())]
    out = []
    for name, ns, cls, cpu, tols in specs:
        p = pkg.testing.make_pod(name, namespace=ns, cpu_milli=cpu)
        p.priority_class_name = cls
        p.tolerations = tols
        try:
            hub.create_pod(p)
        except a.AdmissionError as e:
            out.append((name, "rejected", str(e)))
            continue
        got = hub.truth_pods[p.key()]
        out.append((name, got.priority, got.priority_class_name,
                    got.preemption_policy, got.requests.cpu_milli,
                    repr(got.tolerations)))
    hub.delete_pod("team/g")
    hub.step()
    try:
        hub.create_pod(pkg.testing.make_pod("m", namespace="team",
                                            cpu_milli=100))
        out.append(("m", "admitted"))
    except a.AdmissionError as e:
        out.append(("m", "rejected", str(e)))
    q = hub.quotas[0]
    out.append((q.used_pods, q.used_cpu_milli, hub.admission.rejected))
    return out


def auth(pkg):
    """Token authn (bearer parsing, unknown and anonymous), service
    accounts, the flat rule authorizer, the union chain, RBAC with role
    aggregation, and the 403 text, over a grid of requests."""
    a = pkg.auth
    sched = a.UserInfo("system:kube-scheduler", groups=("system:authenticated",))
    view = a.UserInfo("viewer", groups=("system:authenticated", "readers"))
    authn = a.TokenAuthenticator({"t1": sched, "t2": view})
    anon = a.TokenAuthenticator({"t1": sched}, anonymous=True)
    out = []
    for hdr in ({}, {"Authorization": "Bearer t1"},
                {"Authorization": "Bearer t2"},
                {"Authorization": "Bearer nope"},
                {"Authorization": "Basic abc"},
                {"Authorization": "Bearer"}):
        for who in (authn, anon):
            try:
                out.append(repr(who.authenticate(hdr)))
            except a.Unauthenticated as e:
                out.append(f"401 {e}")
    sa = a.service_account_user("team", "ci-bot")
    out.append(repr(sa))
    rules = a.RuleAuthorizer([
        a.Rule(subjects=("system:kube-scheduler",),
               verbs=("get", "list", "create"),
               resources=("pods", "pods/binding")),
        a.Rule(subjects=("readers",), verbs=("get", "list"),
               resources=("*",), namespaces=("default",))])
    roles = {
        "view": a.ClusterRole("view", aggregation_selectors=(
            {"agg": "view"},)),
        "pods-read": a.ClusterRole("pods-read", labels={"agg": "view"},
                                   rules=(a.PolicyRule(
                                       verbs=("get", "list"),
                                       resources=("pods",)),)),
        "health": a.ClusterRole("health", labels={"agg": "view"},
                                rules=(a.PolicyRule(
                                    verbs=("get",),
                                    non_resource_urls=("/healthz*",)),)),
    }
    out.append(a.aggregate_cluster_roles(roles))
    rbac = a.RBACAuthorizer(roles, [a.ClusterRoleBinding("view",
                                                         ("readers",))])
    union = a.chain(rules, rbac, a.AlwaysDeny())
    for user in (sched, view, sa):
        for verb, res, ns, path in (
                ("get", "pods", "default", ""),
                ("create", "pods/binding", "default", ""),
                ("list", "nodes", "", ""), ("list", "pods", "team", ""),
                ("delete", "pods", "default", ""),
                ("get", "", "", "/healthz/ready")):
            attrs = a.Attributes(user=user, verb=verb, resource=res,
                                 namespace=ns, path=path)
            out.append((user.name, verb, res, ns, path,
                         rules.authorize(attrs), rbac.authorize(attrs),
                         union.authorize(attrs), a.forbidden_message(attrs)))
    return out


def certificates(pkg):
    """The kubelet TLS bootstrap (approve, sign, authenticate), a
    requestor without the bootstrap group left pending, self-renewal,
    expiry at lookup, and the root-CA publisher's ConfigMaps."""
    c = pkg.certificates
    hub = hub_of(pkg)
    hub.add_namespace("team")
    hub.create_csr(c.node_bootstrap_csr("n0"))
    hub.create_csr(c.node_bootstrap_csr("nX", username="mallory",
                                        groups=("devs",)))
    hub.step()
    cert = hub.csrs["csr-n0"].certificate
    renew = c.node_bootstrap_csr("n0", username="system:node:n0",
                                 groups=(c.NODES_GROUP,))
    renew = dataclasses.replace(renew, name="csr-n0-renew")
    hub.create_csr(renew)
    hub.step()
    out = [(k, v.approved, bool(v.certificate), c.is_node_client_csr(v),
            c.is_self_node_client_csr(v)) for k, v in sorted(hub.csrs.items())]
    out.append(repr(hub.cert_user(cert)))
    hub.clock.advance(400 * 24 * 3600.0)
    hub.step()
    out.append(repr(hub.cert_user(cert)))
    out.append(sorted(hub.configmaps))
    out.append(hub.configmaps["team/" + c.ROOT_CA_CONFIGMAP])
    return out


def cloud(pkg):
    """The cloud node controller (initialize, zone labels, terminate),
    the service load-balancer and the route controllers."""
    cl, px = pkg.cloud, pkg.proxy
    hub = pkg.sim.HollowCluster(seed=5, scheduler_kw=dict(pkg.kw))
    fake = cl.FakeCloud()
    hub.attach_cloud(fake)
    alloc = pkg.testing.make_node("x").allocatable
    for i, z in enumerate(("a", "a", "b")):
        fake.add_instance(cl.Instance(f"n{i}", zone=z, region="r1",
                                      instance_type="v5e-8"))
        hub.add_node(cl.uninitialized_node(f"n{i}", allocatable=alloc))
    hub.add_node(cl.uninitialized_node("ghost", allocatable=alloc))
    hub.create_pod(pkg.testing.make_pod("a"))
    hub.add_service(px.Service("web", selector={"app": "web"},
                               type="LoadBalancer",
                               ports=(px.ServicePort(port=80,
                                                     target_port=8080),)))
    steps = []
    for tick in range(5):
        if tick == 3:
            fake.terminate("n1")
        hub.step()
        steps.append((sorted((n, sorted(nd.labels.items()),
                              [x.key for x in nd.taints])
                             for n, nd in hub.truth_nodes.items()),
                      hub.truth_pods["default/a"].node_name,
                      sorted(fake.list_routes("kubernetes").items()),
                      fake.list_load_balancers("kubernetes")))
    steps.append((hub.cloud_controller.deleted,
                  repr(hub.services["default/web"])))
    return steps


def proxy(pkg):
    """ClusterIP and NodePort allocators, the endpoints controller over
    the hub, and the service proxy's resolution with session affinity on
    a hand clock."""
    px = pkg.proxy
    out = []
    ips = px.ClusterIPAllocator()
    got = [ips.allocate() for _ in range(5)]
    ips.release(got[2])
    ips.reserve("10.96.7.7")
    got += [ips.allocate() for _ in range(2)]
    ports = px.NodePortAllocator()
    got += [ports.allocate() for _ in range(3)]
    out.append(got)
    hub = hub_of(pkg, n_nodes=3)
    hub.add_service(px.Service("web", selector={"app": "web"},
                               ports=(px.ServicePort("http", 80, 8080,
                                                     node_port=30080),)))
    for i in range(4):
        hub.create_pod(pkg.testing.make_pod(f"web-{i}",
                                            labels={"app": "web"}))
    for _ in range(3):
        hub.step()
    hub.delete_pod("default/web-1")
    hub.step()
    ep = hub.endpoints["default/web"]
    out.append(repr(ep))
    svc = hub.services["default/web"]
    out.append(repr(svc))

    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

    clock = Clock()
    proxy = px.ServiceProxy("n0", clock)
    sticky = dataclasses.replace(svc, session_affinity=px.AFFINITY_CLIENT_IP,
                                 affinity_seconds=60)
    proxy.sync({sticky.key(): sticky}, {ep.key(): ep})
    rng = random.Random(4)
    for _ in range(40):
        clock.t += rng.choice((1.0, 30.0, 90.0))
        client = f"10.1.0.{rng.randrange(6)}"
        hit = proxy.resolve(svc.cluster_ip, 80, client=client)
        out.append((client, hit.pod_key if hit else None))
    nodeport = proxy.resolve_node_port(30080)
    out.append(nodeport.pod_key if nodeport else None)
    out.append(proxy.resolve("10.96.9.9", 80))
    return out


def bootstrap(pkg):
    """kubeadm init and join: preflight errors, the control-plane taint,
    joins with a good, a malformed and an expired token, a duplicate,
    cluster-info signatures, the token cleaner. Tokens are random in
    both packages, so their shape is compared, not their value."""
    b = pkg.bootstrap
    out = []
    for bad in ({"cluster_name": ""}, {"control_plane_cpu_milli": 0},
                {"token_ttl_s": -1}):
        try:
            b.preflight(b.InitConfig(**bad))
        except b.BootstrapError as e:
            out.append(str(e))
    hub, token = b.init_cluster(b.InitConfig(
        token_ttl_s=60.0, hub_kw={"scheduler_kw": dict(pkg.kw)}))
    tid, _, secret = token.partition(".")
    out.append((len(tid), len(secret)))
    b.join_node(hub, token, pkg.testing.make_node("w0", cpu_milli=4000))
    for tok, node in (("zzzzzz.0000000000000000", "w1"), (token, "w0")):
        try:
            b.join_node(hub, tok, pkg.testing.make_node(node))
        except b.BootstrapError as e:
            out.append(str(e).replace(tok, "<token>"))
    hub.create_pod(pkg.testing.make_pod("app"))
    for _ in range(3):
        hub.step()
    out.append(bool(b.verify_cluster_info(hub, token)))
    out.append(hub.truth_pods["default/app"].node_name)
    hub.clock.advance(61.0)
    try:
        b.join_node(hub, token, pkg.testing.make_node("w2"))
    except b.BootstrapError as e:
        out.append(str(e).replace(token, "<token>"))
    out.append(b.token_cleaner(hub))
    hub.step()
    out.append((len(hub.bootstrap_tokens), sorted(hub.truth_nodes)))
    return out


def selectors(pkg):
    """Label and field selector grammar (every operator, whitespace,
    errors), matching over seeded label sets, the pod/node/event field
    tables and their key validation."""
    s = pkg.selectors
    texts = ["", "app=web", "app==web,tier!=db", "app in (web, api)",
             "tier notin (db)", "gpu", "!gpu", "x>3", "x<10",
             "app in (web),!canary,zone", "app=", "a b", "in (x)",
             "app=web,", "=web", "app in web", "x>z", "k8s.io/name=a.b-c"]
    rng = random.Random(9)
    label_sets = [{k: rng.choice(("web", "db", "api", "3", "11"))
                   for k in rng.sample(["app", "tier", "gpu", "x", "zone",
                                        "canary"], rng.randrange(4))}
                  for _ in range(30)]
    out = []
    for text in texts:
        try:
            reqs = s.parse_label_selector(text)
        except s.SelectorError as e:
            out.append((text, "error", str(e)))
            continue
        out.append((text, repr(reqs),
                    [s.match_labels(reqs, ls) for ls in label_sets]))
    pod = pkg.testing.make_pod("p", node_name="n0")
    node = pkg.testing.make_node("n0")
    fields = {"pods": s.pod_fields(pod), "nodes": s.node_fields(node)}
    for text in ("spec.nodeName=n0", "spec.nodeName!=n0,metadata.name=p",
                 "status.phase=Pending", "metadata.name==p", "bogus=1",
                 "spec.unschedulable=false", "a in (b)"):
        for kind, f in fields.items():
            try:
                reqs = s.parse_field_selector(text)
                s.validate_field_keys(reqs, kind)
                out.append((text, kind, s.match_fields(reqs, f)))
            except s.SelectorError as e:
                out.append((text, kind, "error", str(e)))
    return out


CASES = [admission, auth, certificates, cloud, proxy, bootstrap, selectors]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_control_plane_module_matches_reference(case):
    want = case(REF)
    assert case(PORT) == want
    assert len(want) > 3
