"""The port's kubectl (``kubernetes_tpu_torch/kubectl.py``, the REST half:
``RestClient`` and every verb that takes ``--api-server``) held against
the JAX package's: the same verbs, in the same order, against a
``RestServer`` over each package's ``HollowCluster``; every exit code,
stdout and stderr must be equal. The read verbs over the gRPC seam
(``--server``) are held the same way against each package's own
``serve_grpc``."""

import json
import types

import pytest

import kubernetes_tpu.kubectl as jkubectl
import kubernetes_tpu.restapi as jrest
import kubernetes_tpu.sim as jsim
import kubernetes_tpu.testing as jtesting
import kubernetes_tpu_torch.kubectl as tkubectl
import kubernetes_tpu_torch.restapi as trest
import kubernetes_tpu_torch.sim as tsim
import kubernetes_tpu_torch.testing as ttesting

REF = types.SimpleNamespace(sim=jsim, rest=jrest, kubectl=jkubectl,
                            testing=jtesting, kw={})
PORT = types.SimpleNamespace(sim=tsim, rest=trest, kubectl=tkubectl,
                             testing=ttesting, kw={"device": "cpu"})

NODE = {"kind": "Node",
        "metadata": {"name": "n9", "labels": {"kubernetes.io/hostname": "n9"}},
        "status": {"allocatable": {"cpu": "4000m", "memory": "8589934592",
                                   "pods": "110"}}}
POD = {"kind": "Pod", "metadata": {"name": "web"},
       "spec": {"containers": [
           {"name": "main", "resources": {"requests": {"cpu": "100m"}}}]}}
DEPLOY = {"kind": "Deployment", "metadata": {"name": "api"},
          "spec": {"replicas": 3, "template": {"spec": {"containers": [
              {"name": "main", "resources": {"requests": {"cpu": "200m"}}}]}}}}


def manifests(tmp):
    out = {}
    for name, doc in (("node", NODE), ("pod", POD), ("deploy", DEPLOY),
                      ("kindless", {"metadata": {"name": "x"}}),
                      ("ns", {"kind": "Namespace",
                              "metadata": {"name": "team-a"}})):
        path = tmp / f"{name}.json"
        path.write_text(json.dumps(doc))
        out[name] = str(path)
    scaled = json.loads(json.dumps(DEPLOY))
    scaled["spec"]["replicas"] = 5
    (tmp / "deploy5.json").write_text(json.dumps(scaled))
    out["deploy5"] = str(tmp / "deploy5.json")
    return out


def session(pkg, tmp, capsys):
    """One operator session; returns [(argv, rc, stdout, stderr)]."""
    hub = pkg.sim.HollowCluster(seed=41, admission=True,
                                scheduler_kw=dict(pkg.kw))
    for i in range(3):
        hub.add_node(pkg.testing.make_node(f"n{i}", cpu_milli=4000))
    hub.add_daemonset(pkg.sim.DaemonSet("agent"))
    hub.add_statefulset(pkg.sim.StatefulSet("db", replicas=2))
    for _ in range(3):
        hub.step()
    srv = pkg.rest.RestServer(hub)
    api = f"127.0.0.1:{srv.serve()}"
    f = manifests(tmp)
    runs = []

    def k(*argv, step=False):
        rc = pkg.kubectl.main(["--api-server", api, *argv])
        out = capsys.readouterr()
        runs.append((argv, rc, out.out, out.err))
        if step:
            hub.step()
            hub.settle()

    try:
        k("create", "-f", f["node"])
        k("create", "-f", f["pod"], step=True)
        k("create", "-f", f["pod"])
        k("create", "-f", f["kindless"])
        k("apply", "-f", f["deploy"], step=True)
        k("apply", "-f", f["deploy5"], step=True)
        k("apply", "-f", f["ns"])
        k("apply", "-f", f["ns"])
        k("get", "deployments")
        k("describe", "deployment", "api")
        k("scale", "deployment/api", "--replicas", "2", step=True)
        k("rollout", "status", "deployment/api")
        k("rollout", "history", "deployment/api")
        k("get", "daemonsets")
        k("get", "statefulsets")
        k("describe", "statefulset", "db")
        k("get", "namespaces")
        k("get", "serviceaccounts", "-A")
        k("get", "configmaps", "-A")
        k("get", "leases")
        k("get", "csr")
        k("get", "events", "-A")
        k("get", "events", "--field-selector", "reason=Scheduled")
        k("cordon", "n1")
        k("uncordon", "n1")
        k("drain", "n0", step=True)
        k("delete", "pod", "web")
        k("delete", "node", "n9")
        k("delete", "node", "n9")
        hub.check_consistency()
    finally:
        srv.close()
    return runs


def test_rest_verbs_match_reference(tmp_path, capsys):
    want = session(REF, tmp_path, capsys)
    got = session(PORT, tmp_path, capsys)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g == w, w[0]
    rcs = [rc for _, rc, _, _ in got]
    assert rcs[:4] == [0, 0, 1, 1]  # created, created, exists, no kind
    assert "drained" in "".join(out for _, _, out, _ in got)


def test_unreachable_server_is_a_clean_error(capsys):
    for pkg in (REF, PORT):
        rc = pkg.kubectl.main(["--api-server", "127.0.0.1:9", "cordon", "n0"])
        out = capsys.readouterr()
        assert rc == 1 and "cannot reach" in out.err and not out.out


def grpc_session(pkg, argv, capsys):
    """One read verb over the gRPC seam: a scheduler on CPU tensors (the
    port's) or the JAX package's behind its ``serve_grpc``, fed a small
    cluster through its client (a bound pod, a pod placed by a cycle, a
    pod no node fits), then ``kubectl --server``. Returns (rc, stdout,
    stderr)."""
    import importlib
    import json as _json

    from torch_parity import scheduler_pair

    root = pkg.kubectl.__name__.rsplit(".", 1)[0]
    shim = importlib.import_module(f"{root}.grpc_shim")
    ext = importlib.import_module(f"{root}.extender")
    msgs = importlib.import_module(
        "kubernetes_tpu.proto.extender_pb2" if pkg is REF
        else "kubernetes_tpu_torch.proto.extender")
    js, ts = scheduler_pair(enable_preemption=False)
    sched = js if pkg is REF else ts
    server, port = shim.serve_grpc(sched)
    client = shim.GrpcSchedulerClient(f"127.0.0.1:{port}")
    try:
        t = pkg.testing
        d = msgs.SnapshotDelta(revision=3)
        for nd in (t.make_node("n0", cpu_milli=4000, labels={"disk": "ssd"}),
                   t.make_node("n1", cpu_milli=1000),
                   t.make_node("n2", cpu_milli=500)):
            d.nodes.add(op=msgs.NodeDelta.ADD, name=nd.name,
                        node_json=_json.dumps(ext.node_to_json(nd)))
        for p in (t.make_pod("db", cpu_milli=300, node_name="n1"),
                  t.make_pod("api", cpu_milli=700, namespace="team-a"),
                  t.make_pod("web", cpu_milli=9000)):
            d.pods.add(op=msgs.PodDelta.ADD, key=p.key(),
                       pod_json=_json.dumps(ext.pod_to_json(p)))
        list(client.sync_state(iter([d])))
        sched.schedule_cycle()
        rc = pkg.kubectl.main(["--server", f"127.0.0.1:{port}", *argv])
        out = capsys.readouterr()
        return rc, out.out, out.err
    finally:
        client.close()
        server.stop(grace=None)


@pytest.mark.parametrize("argv", [
    ["get", "nodes"], ["get", "pods", "-A"], ["top", "nodes"],
    ["describe", "pod", "web"], ["describe", "node", "n0"],
])
def test_grpc_read_verbs_match_reference(argv, capsys):
    """The read verbs over the gRPC seam (``--server``) print what the
    JAX package's print over its own seam: the same exit code, stdout and
    stderr."""
    pytest.importorskip("grpc")
    want = grpc_session(REF, argv, capsys)
    got = grpc_session(PORT, argv, capsys)
    assert got == want
    assert got[0] == 0 and got[1] and not got[2]
    with pytest.raises(SystemExit) as e:
        tkubectl.main(argv)  # no --server: the reference's usage error
    assert e.value.code == 2


def test_grpc_read_verbs_without_grpcio_name_it(monkeypatch, capsys):
    """Where grpcio is not installed (the card's machine), ``--server``
    exits 1 with one line on stderr naming it, never a traceback or
    another transport."""
    import sys

    monkeypatch.setitem(sys.modules, "grpc", None)
    rc = tkubectl.main(["--server", "127.0.0.1:9", "get", "nodes"])
    out = capsys.readouterr()
    assert rc == 1 and not out.out
    assert "grpcio is not installed" in out.err
    assert out.err.count("\n") == 1
