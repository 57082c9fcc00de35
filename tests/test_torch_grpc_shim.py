"""The port's gRPC seam (``kubernetes_tpu_torch/grpc_shim.py``) held against
the JAX package's (``kubernetes_tpu/grpc_shim.py``): the 15 tests of
``tests/test_grpc_shim.py`` run one script through each package — a real
grpc server and client on 127.0.0.1 over ``scheduler_pair(device="cpu")``
— and every ack, verb result, binding and placement must be equal. Then
the two packages talk to each other over real sockets (a port client
against the JAX package's ``serve_grpc`` and the other way round), the
token and service-account gates, and the seam's fault tests of
``tests/test_fault_injection.py``."""

import json
import types
from contextlib import nullcontext

import numpy as np
import pytest

grpc = pytest.importorskip("grpc")

import kubernetes_tpu.extender as jext
import kubernetes_tpu.faults as jfaults
import kubernetes_tpu.grpc_shim as jshim
import kubernetes_tpu.kubectl as jkubectl
import kubernetes_tpu.testing as jtesting
import kubernetes_tpu_torch.extender as text
import kubernetes_tpu_torch.faults as tfaults
import kubernetes_tpu_torch.grpc_shim as tshim
import kubernetes_tpu_torch.kubectl as tkubectl
import kubernetes_tpu_torch.testing as ttesting
from kubernetes_tpu.api import protobuf as jproto
from kubernetes_tpu.api import types as jtypes
from kubernetes_tpu.proto import extender_pb2 as jpb
from kubernetes_tpu_torch.api import protobuf as tproto
from kubernetes_tpu_torch.api import types as ttypes
from kubernetes_tpu_torch.proto import extender as tpb
from torch_parity import scheduler_pair, to_port

REF = types.SimpleNamespace(name="ref", shim=jshim, pb=jpb, ext=jext,
                            testing=jtesting, kubectl=jkubectl,
                            types=jtypes, faults=jfaults, proto=jproto)
PORT = types.SimpleNamespace(name="port", shim=tshim, pb=tpb, ext=text,
                             testing=ttesting, kubectl=tkubectl,
                             types=ttypes, faults=tfaults, proto=tproto)


class Served:
    """One package's scheduler behind its own ``serve_grpc`` and client."""

    def __init__(self, pkg, sched, token=None, client_pkg=None,
                 client_token=None, fault_injector=None) -> None:
        self.pkg, self.sched = pkg, sched
        self.svc = pkg.shim.TpuSchedulerService(
            sched, fault_injector=fault_injector)
        self.server, self.port = pkg.shim.serve_grpc(sched, service=self.svc,
                                                     token=token)
        self.cpkg = client_pkg or pkg
        self.client = self.cpkg.shim.GrpcSchedulerClient(
            f"127.0.0.1:{self.port}", token=client_token)

    def close(self) -> None:
        self.client.close()
        self.server.stop(grace=None)


@pytest.fixture()
def shims():
    js, ts = scheduler_pair(enable_preemption=False)
    served = [Served(REF, js), Served(PORT, ts)]
    yield served
    for s in served:
        s.close()


def _delta(pkg, revision, nodes=(), pods=(), removes=()):
    pb = pkg.pb
    d = pb.SnapshotDelta(revision=revision)
    for nd in nodes:
        d.nodes.add(op=pb.NodeDelta.ADD, name=nd.name,
                    node_json=json.dumps(pkg.ext.node_to_json(nd)))
    for p in pods:
        d.pods.add(op=pb.PodDelta.ADD, key=p.key(),
                   pod_json=json.dumps(pkg.ext.pod_to_json(p)))
    for name in removes:
        d.nodes.add(op=pb.NodeDelta.REMOVE, name=name)
    return d


def both(shims, script):
    """``script(served)`` on each package; the two returns must be equal.
    Returns the port's."""
    want, got = (script(s) for s in shims)
    assert got == want
    return got


def _acks(acks):
    return [(a.revision, a.nodes_in_snapshot) for a in acks]


def _filter(fr):
    return list(fr.node_names), dict(fr.failed_nodes), fr.error


def _prio(pr):
    return [(i.host, i.score) for i in pr.items], pr.error


# ---------------------------------------------------------------------------
# the 15 tests of tests/test_grpc_shim.py, through both packages
# ---------------------------------------------------------------------------


def test_node_from_json_roundtrip():
    assert tshim.node_from_json is text.node_from_json  # one copy
    nd = jtesting.make_node("n0", cpu_milli=4000, memory=8 * 2**30,
                            labels={"disk": "ssd"})
    want = jshim.node_from_json(jext.node_to_json(nd))
    back = tshim.node_from_json(text.node_to_json(to_port(nd)))
    assert back == to_port(want)
    assert back.name == "n0"
    assert back.allocatable.cpu_milli == 4000
    assert back.labels["disk"] == "ssd"


def test_delta_stream_applies_and_acks(shims):
    def script(s):
        mk = s.pkg.testing.make_node

        def gen():
            yield _delta(s.pkg, 1, nodes=[mk("n0", cpu_milli=4000),
                                          mk("n1", cpu_milli=4000)])
            yield _delta(s.pkg, 2, removes=["n1"])

        acks = _acks(s.client.sync_state(gen()))
        return acks, [s.sched.cache.node(n) is not None
                      for n in ("n0", "n1")]

    acks, present = both(shims, script)
    assert acks == [(1, 2), (2, 1)] and present == [True, False]


def test_filter_prioritize_name_only_payloads(shims):
    def script(s):
        t = s.pkg.testing
        list(s.client.sync_state(iter([
            _delta(s.pkg, 1, nodes=[t.make_node("small", cpu_milli=500),
                                    t.make_node("big", cpu_milli=64000)]),
        ])))
        pod = t.make_pod("p", cpu_milli=1000)
        args = s.pkg.pb.ExtenderArgs(
            pod_json=json.dumps(s.pkg.ext.pod_to_json(pod)),
            node_names=["small", "big", "ghost"])
        return _filter(s.client.filter(args)), _prio(
            s.client.prioritize(args))

    (names, failed, err), (items, _) = both(shims, script)
    assert names == ["big"] and not err
    assert "small" in failed and "ghost" in failed
    assert "PodFitsResources" in failed["small"]
    scores = dict(items)
    assert scores["big"] == 10
    assert scores.get("small", 0) == 0


def test_bind_moves_pod_from_queue_to_cache(shims):
    def script(s):
        t, pb = s.pkg.testing, s.pkg.pb
        list(s.client.sync_state(iter([
            _delta(s.pkg, 1, nodes=[t.make_node("n0", cpu_milli=4000)],
                   pods=[t.make_pod("w", cpu_milli=100)]),
        ])))
        r = s.client.bind(pb.Binding(pod_key="default/w", node="n0"))
        out = [(r.ok, r.error), s.sched.cache.pod("default/w") is not None,
               s.sched.cache.is_assumed("default/w"),
               ("default/w", "n0") in s.sched.binder.bindings]
        bound = t.make_pod("w", cpu_milli=100, node_name="n0")
        list(s.client.sync_state(iter([_delta(s.pkg, 2, pods=[bound])])))
        out.append(s.sched.cache.is_assumed("default/w"))
        r2 = s.client.bind(pb.Binding(pod_key="default/w", node="n0"))
        r3 = s.client.bind(pb.Binding(pod_key="default/ghost", node="n0"))
        return out + [(r2.ok, r2.error), (r3.ok, r3.error)]

    got = both(shims, script)
    assert got[:5] == [(True, ""), True, True, True, False]
    assert not got[5][0] and "already bound" in got[5][1]
    assert not got[6][0]


def test_delta_fed_pod_schedulable_by_service_side_cycle(shims):
    def script(s):
        t = s.pkg.testing
        list(s.client.sync_state(iter([
            _delta(s.pkg, 1, nodes=[t.make_node("n0", cpu_milli=4000)],
                   pods=[t.make_pod("q", cpu_milli=100)]),
        ])))
        return s.sched.schedule_cycle().assignments

    assert both(shims, script) == {"default/q": "n0"}


def test_node_json_carries_taints_and_conditions():
    def script(pkg):
        nd = pkg.testing.make_node(
            "t0", cpu_milli=4000,
            taints=(pkg.types.Taint("dedicated", "gpu", "NoSchedule"),))
        nd.conditions = pkg.types.NodeCondition(ready=False,
                                                memory_pressure=True)
        back = pkg.shim.node_from_json(pkg.ext.node_to_json(nd))
        assert back.taints == nd.taints
        return back

    want, got = script(REF), script(PORT)
    assert got == to_port(want)
    assert not got.conditions.ready and got.conditions.memory_pressure


def test_synced_tainted_node_rejects_pods(shims):
    def script(s):
        t = s.pkg.testing
        tainted = t.make_node(
            "t", cpu_milli=64000,
            taints=(s.pkg.types.Taint("dedicated", "db", "NoSchedule"),))
        list(s.client.sync_state(iter([_delta(s.pkg, 1, nodes=[tainted])])))
        pod = t.make_pod("p", cpu_milli=100)
        return _filter(s.client.filter(s.pkg.pb.ExtenderArgs(
            pod_json=json.dumps(s.pkg.ext.pod_to_json(pod)),
            node_names=["t"])))

    names, failed, _ = both(shims, script)
    assert names == [] and "PodToleratesNodeTaints" in failed["t"]


def test_update_delta_routes_through_on_pod_update(shims):
    def script(s):
        t, pb = s.pkg.testing, s.pkg.pb
        list(s.client.sync_state(iter([
            _delta(s.pkg, 1, nodes=[t.make_node("n0", cpu_milli=1000)],
                   pods=[t.make_pod("w", cpu_milli=800)]),
        ])))
        bound = t.make_pod("w", cpu_milli=800, node_name="n0")
        d = pb.SnapshotDelta(revision=2)
        d.pods.add(op=pb.PodDelta.UPDATE, key="default/w",
                   pod_json=json.dumps(s.pkg.ext.pod_to_json(bound)))
        list(s.client.sync_state(iter([d])))
        res = s.sched.schedule_cycle()
        return res.attempted, s.sched.cache.pod("default/w") is not None

    assert both(shims, script) == (0, True)


def test_bind_failure_requeues_pod(shims):
    class Boom:
        bindings = []

        def bind(self, pod, node):
            raise RuntimeError("apiserver down")

    def script(s):
        t = s.pkg.testing
        s.sched.binder = Boom()
        list(s.client.sync_state(iter([
            _delta(s.pkg, 1, nodes=[t.make_node("n0", cpu_milli=4000)],
                   pods=[t.make_pod("w", cpu_milli=100)]),
        ])))
        r = s.client.bind(s.pkg.pb.Binding(pod_key="default/w", node="n0"))
        return ((r.ok, r.error), s.sched.queue.pod("default/w") is not None,
                s.sched.cache.pod("default/w") is None)

    (ok, err), queued, uncached = both(shims, script)
    assert not ok and "apiserver down" in err and queued and uncached


def test_pod_json_carries_preemption_policy():
    for pkg in (REF, PORT):
        p = pkg.testing.make_pod("np", cpu_milli=100)
        p.preemption_policy = "Never"
        back = pkg.shim.pod_from_json(pkg.ext.pod_to_json(p))
        assert back.preemption_policy == "Never"


def test_kubectl_get_describe_top(shims, capsys):
    """The ktpu CLI over GetState in both packages: get/top/describe print
    the same, including the per-node explanation of a pending pod."""

    def script(s):
        t, pb = s.pkg.testing, s.pkg.pb
        list(s.client.sync_state(iter([
            _delta(s.pkg, 1,
                   nodes=[t.make_node("big", cpu_milli=64000),
                          t.make_node("small", cpu_milli=500)],
                   pods=[t.make_pod("w", cpu_milli=100),
                         t.make_pod("stuck", cpu_milli=1000)]),
        ])))
        s.sched.schedule_cycle()
        server = s.client.target
        runs = []
        for argv in (["get", "nodes"], ["get", "pods"], ["top", "nodes"],
                     ["describe", "node", "big"]):
            rc = s.pkg.kubectl.main(["--server", server, *argv])
            out = capsys.readouterr()
            runs.append((rc, out.out, out.err))
        big_pod = t.make_pod("toobig", cpu_milli=100000)
        d = pb.SnapshotDelta(revision=2)
        d.pods.add(op=pb.PodDelta.ADD, key="default/toobig",
                   pod_json=json.dumps(s.pkg.ext.pod_to_json(big_pod)))
        list(s.client.sync_state(iter([d])))
        rc = s.pkg.kubectl.main(
            ["--server", server, "describe", "pod", "toobig"])
        out = capsys.readouterr()
        return runs + [(rc, out.out, out.err)]

    runs = both(shims, script)
    assert [r[0] for r in runs] == [0] * 5
    assert "big" in runs[0][1] and "Ready" in runs[0][1]
    assert "Bound" in runs[1][1] and "w" in runs[1][1]
    assert "CPU%" in runs[2][1]
    assert "Allocatable" in runs[3][1] and "Requested" in runs[3][1]
    assert "Scheduling explanation" in runs[4][1]
    assert "PodFitsResources" in runs[4][1]


def test_stream_reconnect_resumes_from_acked_revision(shims):
    def script(s):
        t = s.pkg.testing
        n0 = t.make_node("n0", cpu_milli=4000)
        n1 = t.make_node("n1", cpu_milli=4000)
        p = t.make_pod("w0", cpu_milli=100)
        acks1 = _acks(s.client.sync_state(iter([
            _delta(s.pkg, 1, nodes=[n0]),
            _delta(s.pkg, 2, nodes=[n1], pods=[p])])))
        count1 = s.sched.cache.node_count()
        p2 = t.make_pod("w1", cpu_milli=100)
        acks2 = _acks(s.client.sync_state(iter([
            _delta(s.pkg, 2, nodes=[n1], pods=[p]),   # duplicate replay
            _delta(s.pkg, 3, pods=[p2]),
        ])))
        count2 = s.sched.cache.node_count()
        res = s.sched.schedule_cycle()
        return acks1, count1, acks2, count2, res.scheduled, sorted(
            res.assignments)

    acks1, c1, acks2, c2, scheduled, keys = both(shims, script)
    assert [a for a, _ in acks1] == [1, 2] and c1 == 2
    assert [a for a, _ in acks2] == [2, 3] and c2 == 2
    assert scheduled == 2 and keys == ["default/w0", "default/w1"]


def test_grpc_bearer_token_gates_every_rpc():
    """Without (or with a wrong) bearer token a client gets
    UNAUTHENTICATED on unary AND streaming RPCs, in both packages and
    across them; the right token opens every verb; a token-less server
    stays open."""
    js, ts = scheduler_pair(enable_preemption=False)
    js.on_node_add(jtesting.make_node("n0", cpu_milli=1000))
    ts.on_node_add(ttesting.make_node("n0", cpu_milli=1000))
    out = {}
    for spkg, sched in ((REF, js), (PORT, ts)):
        server, port = spkg.shim.serve_grpc(sched, token="s3cret")
        try:
            for cpkg in (REF, PORT):
                codes = []
                for client_token in (None, "wrong"):
                    c = cpkg.shim.GrpcSchedulerClient(f"127.0.0.1:{port}",
                                                      token=client_token)
                    with pytest.raises(grpc.RpcError) as ei:
                        c.get_state(cpkg.pb.StateRequest())
                    codes.append(ei.value.code())
                    with pytest.raises(grpc.RpcError) as ei:
                        list(c.sync_state(iter(
                            [cpkg.pb.SnapshotDelta(revision=1)])))
                    codes.append(ei.value.code())
                    c.close()
                ok = cpkg.shim.GrpcSchedulerClient(f"127.0.0.1:{port}",
                                                   token="s3cret")
                st = ok.get_state(cpkg.pb.StateRequest())
                acks = _acks(ok.sync_state(iter(
                    [cpkg.pb.SnapshotDelta(revision=7)])))
                ok.close()
                out[(spkg.name, cpkg.name)] = (codes, len(st.node_json),
                                               acks[-1])
        finally:
            server.stop(grace=None)
        open_server, oport = spkg.shim.serve_grpc(sched)
        try:
            c = spkg.shim.GrpcSchedulerClient(f"127.0.0.1:{oport}")
            assert len(c.get_state(spkg.pb.StateRequest()).node_json) == 1
            c.close()
        finally:
            open_server.stop(grace=None)
    assert len(set(map(repr, out.values()))) == 1, out
    codes, n_nodes, ack = out[("port", "port")]
    assert codes == [grpc.StatusCode.UNAUTHENTICATED] * 4
    assert n_nodes == 1 and ack == (7, 1)


def _probe_bind(pkg, sched, probe):
    service = pkg.shim.TpuSchedulerService(sched)

    class ProbeBinder:
        bindings = []

        def bind(self, pod, node):
            probe(service)
            self.bindings.append((pod.key(), node))

    sched.binder = ProbeBinder()
    sched.on_node_add(pkg.testing.make_node("n0", cpu_milli=4000))
    sched.queue.add(pkg.testing.make_pod("w", cpu_milli=100))
    r = service.bind(pkg.pb.Binding(pod_key="default/w", node="n0"), None)
    return (r.ok, r.error), sched.cache.pod("default/w") is not None


def test_bind_releases_service_lock_across_the_binder_hop():
    js, ts = scheduler_pair(enable_preemption=False)
    out = []
    for pkg, sched in ((REF, js), (PORT, ts)):
        free = []

        def probe(service):
            got = service.lock.acquire(blocking=False)
            if got:
                service.lock.release()
            free.append(got)

        out.append((_probe_bind(pkg, sched, probe), free))
    assert out[1] == out[0] == (((True, ""), True), [True])


def test_bind_assumes_before_releasing_the_lock():
    js, ts = scheduler_pair(enable_preemption=False)
    out = []
    for pkg, sched in ((REF, js), (PORT, ts)):
        seen = {}

        def probe(service, sched=sched):
            seen["assumed"] = sched.cache.is_assumed("default/w")
            seen["queued"] = sched.queue.pod("default/w") is not None

        out.append((_probe_bind(pkg, sched, probe), seen))
    assert out[1] == out[0]
    assert out[1][1] == {"assumed": True, "queued": False}


# ---------------------------------------------------------------------------
# the packages across the wire: a seeded cluster through every pairing
# ---------------------------------------------------------------------------


def seeded_cluster(seed):
    """JAX-typed nodes and pending pods (2-16 each), seeded with numpy."""
    rng = np.random.default_rng(seed)
    n_nodes, n_pods = int(rng.integers(2, 17)), int(rng.integers(4, 17))
    nodes = []
    for i in range(n_nodes):
        taints = ((jtypes.Taint("dedicated", "db", "NoSchedule"),)
                  if rng.random() < 0.25 else ())
        nodes.append(jtesting.make_node(
            f"n{i}", cpu_milli=int(rng.choice([500, 2000, 4000, 16000])),
            memory=int(rng.integers(1, 32)) * 2**30, pods=20,
            zone=f"z{rng.integers(3)}", taints=taints,
            labels={"disk": "ssd"} if rng.random() < 0.5 else {}))
    pods = [jtesting.make_pod(
        f"p{i}", cpu_milli=int(rng.choice([100, 300, 1000, 3000])),
        memory=int(rng.integers(0, 2048)) * 2**20,
        labels={"app": f"a{rng.integers(3)}"},
        priority=int(rng.integers(0, 3)))
        for i in range(n_pods)]
    return nodes, pods


def wire_script(s, seed, typed=True):
    """A client of package ``s.cpkg`` drives a server of package ``s.pkg``
    through every verb on a seeded cluster; returns what came back and
    what the server holds, as plain data."""
    cpkg, pb = s.cpkg, s.cpkg.pb
    nodes, pods = seeded_cluster(seed)
    if cpkg is PORT:
        nodes, pods = to_port(nodes), to_port(pods)

    def payload(obj, kind):
        if typed:
            to_pb = (cpkg.proto.node_to_pb if kind == "node"
                     else cpkg.proto.pod_to_pb)
            return {f"{kind}_pb": to_pb(obj).SerializeToString()}
        to_json = (cpkg.ext.node_to_json if kind == "node"
                   else cpkg.ext.pod_to_json)
        return {f"{kind}_json": json.dumps(to_json(obj))}

    d1 = pb.SnapshotDelta(revision=5)
    for nd in nodes:
        d1.nodes.add(op=pb.NodeDelta.ADD, name=nd.name, **payload(nd, "node"))
    d2 = pb.SnapshotDelta(revision=6)
    for p in pods:
        d2.pods.add(op=pb.PodDelta.ADD, key=p.key(), **payload(p, "pod"))
    d3 = pb.SnapshotDelta(revision=7)
    d3.nodes.add(op=pb.NodeDelta.REMOVE, name=nodes[-1].name)
    d3.pods.add(op=pb.PodDelta.REMOVE, key=pods[-1].key())
    acks = _acks(s.client.sync_state(iter([d1, d2, d3])))
    names = [nd.name for nd in nodes] + ["ghost"]
    verbs = []
    for p in pods[:4]:
        args = pb.ExtenderArgs(pod_json=json.dumps(cpkg.ext.pod_to_json(p)),
                               node_names=names)
        verbs.append((_filter(s.client.filter(args)),
                      _prio(s.client.prioritize(args))))
    binds = []
    for p, nd in zip(pods[:2], nodes):
        r = s.client.bind(pb.Binding(pod_key=p.key(), node=nd.name))
        binds.append((r.ok, r.error))
    with s.svc.lock:
        res = s.sched.schedule_cycle()
    st = s.client.get_state(pb.StateRequest())
    state = (st.revision, [json.loads(j) for j in st.node_json],
             [json.loads(j) for j in st.pod_json],
             [json.loads(j) for j in st.pending_json])
    pods_only = s.client.get_state(pb.StateRequest(kind="pods"))
    return {"acks": acks, "verbs": verbs, "binds": binds,
            "assignments": res.assignments, "state": state,
            "pods_only": (len(pods_only.node_json),
                          len(pods_only.pod_json))}


PAIRINGS = [("ref", "port"), ("port", "ref"), ("port", "port")]


@pytest.mark.parametrize("server, client", PAIRINGS)
@pytest.mark.parametrize("seed", [3, 8])
def test_packages_talk_across_the_wire(server, client, seed):
    """Every verb, a port client against the JAX package's server and the
    other way round (and the port on both ends), gives what the JAX
    package on both ends gives on the same seeded cluster: the typed
    deltas the client's codec wrote are read by the server's."""
    pkgs = {"ref": REF, "port": PORT}
    js, ts = scheduler_pair(enable_preemption=False)
    base = Served(REF, js)
    try:
        want = wire_script(base, seed)
    finally:
        base.close()
    js, ts = scheduler_pair(enable_preemption=False)
    s = Served(pkgs[server], js if server == "ref" else ts,
               client_pkg=pkgs[client])
    try:
        got = wire_script(s, seed)
    finally:
        s.close()
    assert got == want
    assert got["acks"][-1][0] == 7
    assert got["assignments"] and any(ok for ok, _ in got["binds"])


def test_json_payload_feed_matches_typed_feed():
    """The JSON-string payloads (``KTPU_PROTO_FEED=0``) and the typed ones
    leave the port's service in the same state."""
    _, ts1 = scheduler_pair(enable_preemption=False)
    _, ts2 = scheduler_pair(enable_preemption=False)
    a, b = Served(PORT, ts1), Served(PORT, ts2)
    try:
        assert wire_script(a, 11, typed=True) == wire_script(b, 11,
                                                             typed=False)
    finally:
        a.close()
        b.close()


def test_port_service_account_gate_consumes_live_tokens():
    """``serve_grpc``'s callable token: the hub's live service-account
    registry opens the seam, a forged token does not, and revocation
    reaches the seam live — for a port client and a JAX-package client."""
    from kubernetes_tpu_torch.sim import HollowCluster

    hub = HollowCluster(seed=47, scheduler_kw={"enable_preemption": False,
                                               "device": "cpu"})
    hub.add_namespace("team-a")
    hub.step()
    tok = hub.service_account_token("team-a")
    _, ts = scheduler_pair(enable_preemption=False)
    server, port = tshim.serve_grpc(
        ts, token=lambda t: hub.sa_token_user(t) is not None)
    try:
        for cpkg in (PORT, REF):
            ok = cpkg.shim.GrpcSchedulerClient(f"127.0.0.1:{port}", token=tok)
            assert ok.get_state(cpkg.pb.StateRequest()).revision == 0
            bad = cpkg.shim.GrpcSchedulerClient(f"127.0.0.1:{port}",
                                                token="forged")
            with pytest.raises(grpc.RpcError) as ei:
                bad.get_state(cpkg.pb.StateRequest())
            assert ei.value.code() == grpc.StatusCode.UNAUTHENTICATED
            bad.close()
            ok.close()
        hub.terminate_namespace("team-a")
        for _ in range(10):
            hub.step()
        late = tshim.GrpcSchedulerClient(f"127.0.0.1:{port}", token=tok)
        with pytest.raises(grpc.RpcError) as ei:
            late.get_state(tpb.StateRequest())
        assert ei.value.code() == grpc.StatusCode.UNAUTHENTICATED
        late.close()
    finally:
        server.stop(0)


def test_messages_past_grpcs_default_limit_cross_the_port_seam():
    """A GetState answer and a SyncState delta larger than grpc's default
    4 MiB receive limit (one GetState of a 5000-node cluster is about 4.9
    MB): the port's seam carries them; the JAX package's, at grpc's
    defaults, answers RESOURCE_EXHAUSTED."""
    out = {}
    for pkg, sched in zip((REF, PORT), scheduler_pair(
            enable_preemption=False)):
        s = Served(pkg, sched)
        try:
            nd = pkg.testing.make_node("n0", cpu_milli=4000)
            nd.annotations = {"big": "x" * (5 * 2**20)}
            d = _delta(pkg, 1, nodes=[nd])
            try:
                acks = _acks(s.client.sync_state(iter([d])))
                st = s.client.get_state(pkg.pb.StateRequest(kind="nodes"))
                out[pkg.name] = (acks, len(st.node_json[0]) > 5 * 2**20)
            except grpc.RpcError as e:
                out[pkg.name] = e.code()
        finally:
            s.close()
    assert out == {"ref": grpc.StatusCode.RESOURCE_EXHAUSTED,
                   "port": ([(1, 1)], True)}
    assert tshim.MAX_MESSAGE_BYTES > 5 * 2**20


def test_serve_grpc_refuses_a_service_of_another_scheduler():
    js, ts = scheduler_pair(enable_preemption=False)
    _, other = scheduler_pair(enable_preemption=False)
    for pkg, a, b in ((REF, js, ts), (PORT, ts, other)):
        with pytest.raises(ValueError, match="different Scheduler"):
            pkg.shim.serve_grpc(a, service=pkg.shim.TpuSchedulerService(b))


# ---------------------------------------------------------------------------
# the seam's fault tests (tests/test_fault_injection.py), both packages
# ---------------------------------------------------------------------------


def _service(pkg, sched, inj):
    sched.on_node_add(pkg.testing.make_node("n0", cpu_milli=8000))
    svc = pkg.shim.TpuSchedulerService(sched, fault_injector=inj)
    args = pkg.pb.ExtenderArgs(
        pod_json=json.dumps(pkg.ext.pod_to_json(
            pkg.testing.make_pod("p", cpu_milli=100))),
        node_names=["n0"])
    return svc, args


def test_grpc_service_verb_fault_rides_error_result():
    js, ts = scheduler_pair(enable_preemption=False)
    out = []
    for pkg, sched in ((REF, js), (PORT, ts)):
        inj = pkg.faults.FaultInjector(seed=31).arm(
            "grpc-service:filter", "timeout", count=1)
        svc, args = _service(pkg, sched, inj)
        out.append((_filter(svc.filter(args, None)),
                    _filter(svc.filter(args, None))))
    assert out[1] == out[0]
    (_, _, err1), (names2, _, err2) = out[1]
    assert "injected timeout" in err1 and err2 == "" and names2 == ["n0"]


def test_grpc_service_hooks_apply_armed_corruption():
    js, ts = scheduler_pair(enable_preemption=False)
    out = []
    for pkg, sched in ((REF, js), (PORT, ts)):
        inj = pkg.faults.FaultInjector(seed=7)
        inj.arm("grpc-service:filter", "corrupt", count=1)
        inj.arm("grpc-service:prioritize", "error-field", count=1)
        svc, args = _service(pkg, sched, inj)
        fr, pr = svc.filter(args, None), svc.prioritize(args, None)
        out.append((bool(fr.error), list(fr.node_names), bool(pr.error),
                    inj.fired[("grpc-service:filter", "corrupt")],
                    inj.fired[("grpc-service:prioritize", "error-field")],
                    _filter(svc.filter(args, None)),
                    _prio(svc.prioritize(args, None))))
    assert out[1] == out[0]
    assert out[1][:5] == (True, [], True, 1, 1)
    assert out[1][5][0] == ["n0"] and not out[1][5][2]
    assert len(out[1][6][0]) == 1 and not out[1][6][1]


@pytest.mark.parametrize("verb", ["Filter", "Prioritize", "GetState"])
def test_grpc_client_unary_retry_wraps_transient_faults(verb):
    """An injected transient fault on a unary verb is absorbed by the
    client's retry policy over a real socket, with one ``grpc:{verb}``
    span a call on ``obs``, in both packages alike."""
    js, ts = scheduler_pair(enable_preemption=False)
    out = []
    for pkg, sched in ((REF, js), (PORT, ts)):
        sched.on_node_add(pkg.testing.make_node("n0", cpu_milli=4000))
        server, port = pkg.shim.serve_grpc(sched)
        inj = pkg.faults.FaultInjector(seed=41).arm(f"grpc:{verb}",
                                                    "connection", count=1)
        rp = pkg.faults.RetryPolicy(max_retries=1, sleep=lambda _s: None)
        spans = []
        obs = types.SimpleNamespace(
            span=lambda name: spans.append(name) or nullcontext())
        client = pkg.shim.GrpcSchedulerClient(
            f"127.0.0.1:{port}", retry=rp, fault_injector=inj, obs=obs)
        try:
            pb = pkg.pb
            args = pb.ExtenderArgs(
                pod_json=json.dumps(pkg.ext.pod_to_json(
                    pkg.testing.make_pod("p", cpu_milli=100))),
                node_names=["n0"])
            call = {"Filter": lambda: _filter(client.filter(args)),
                    "Prioritize": lambda: _prio(client.prioritize(args)),
                    "GetState": lambda: len(client.get_state(
                        pb.StateRequest()).node_json)}[verb]
            got = call()
            again = call()
        finally:
            client.close()
            server.stop(grace=None)
        out.append((got, again, rp.retries,
                    inj.fired[(f"grpc:{verb}", "connection")], spans))
    assert out[1] == out[0]
    assert out[1][2:] == (1, 1, [f"grpc:{verb}"] * 2)


def test_grpc_client_stream_is_not_retried():
    """A fault on SyncState reaches the caller: the stream is the bridge's
    to resume, never the retry policy's."""
    _, ts = scheduler_pair(enable_preemption=False)
    server, port = tshim.serve_grpc(ts)
    inj = tfaults.FaultInjector(seed=5).arm("grpc:SyncState", "connection",
                                            count=1)
    rp = tfaults.RetryPolicy(max_retries=3, sleep=lambda _s: None)
    client = tshim.GrpcSchedulerClient(f"127.0.0.1:{port}", retry=rp,
                                       fault_injector=inj)
    try:
        with pytest.raises(Exception, match="injected"):
            list(client.sync_state(iter([tpb.SnapshotDelta(revision=1)])))
        assert rp.retries == 0
        acks = _acks(client.sync_state(iter([tpb.SnapshotDelta(revision=2)])))
        assert acks == [(2, 0)]
    finally:
        client.close()
        server.stop(grace=None)
