"""The port's HTTP shim (``kubernetes_tpu_torch/server.py``) against the
JAX package's (``kubernetes_tpu/server.py``): the wire decode
(``parse_quantity``, ``pod_from_json``), the extender's ``filter`` and
``prioritize`` answers, ``/debug/why``, ``/debug/journeys``,
``/debug/soak``, ``/debug/flightrecorder``, ``/debug/ledger``,
``/debug/memory``, ``/debug/incidents`` and ``/debug/profile`` must be
JSON-equal on the same seeded cluster (the port on CPU tensors), but for
what each package measures on its own: the readback bytes of its own
payloads, the memory ledger's measured census (the reference counts the
process's live JAX arrays, the port its live CPU tensors) and the phase
seconds the ledger folds from real clocks; the routes, the APF 429 with
``Retry-After``, and the extender's one counted readback per call."""

import dataclasses
import http.client
import json

import pytest

import kubernetes_tpu.server as jserver
import kubernetes_tpu_torch.server as tserver
from kubernetes_tpu.extender import pod_to_json
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.testing import make_pod
from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler
from torch_parity import pref_affinity_cluster, to_port


@pytest.fixture(scope="module")
def pair():
    """Both packages' schedulers over one seeded cluster (16 nodes, 8
    bound pods) after one cycle of 48 pending pods, some oversized (so
    /debug/why has explanations)."""
    nodes, bound, pending = pref_affinity_cluster(5, n_nodes=16, n_bound=8,
                                                  n_pending=48,
                                                  oversized_every=7)
    js = JScheduler(clock=lambda: 0.0, enable_preemption=False)
    ts = TScheduler(device="cpu", clock=lambda: 0.0, enable_preemption=False)
    for nd in nodes:
        js.on_node_add(nd)
        ts.on_node_add(to_port(nd))
    for p in bound + pending:
        js.on_pod_add(p)
        ts.on_pod_add(to_port(p))
    rj, rt = js.schedule_cycle(), ts.schedule_cycle()
    assert rt.assignments == rj.assignments and rt.unschedulable > 0
    return js, ts


def _wire(doc):
    return json.loads(json.dumps(doc))


QUANTITIES = [("250m", True), ("2", True), ("1.5", True), ("1Gi", False),
              ("500Mi", False), ("128974848", False), ("129e6", False),
              ("1k", False), ("0.5Ki", False), ("3", False)]


@pytest.mark.parametrize("q,is_cpu", QUANTITIES)
def test_parse_quantity_matches_reference(q, is_cpu):
    assert tserver.parse_quantity(q, is_cpu) == jserver.parse_quantity(
        q, is_cpu)


POD_DOCS = [
    {"metadata": {"name": "a"}, "spec": {"containers": []}},
    {"metadata": {"name": "b", "namespace": "ns", "uid": "u-b",
                  "labels": {"app": "x"},
                  "ownerReferences": [{"kind": "ReplicaSet", "name": "rs",
                                       "uid": "r1"}],
                  "deletionTimestamp": "2026-01-02T03:04:05Z"},
     "spec": {"nodeName": "", "nodeSelector": {"disk": "ssd"},
              "priority": 7, "schedulerName": "other",
              "preemptionPolicy": "Never",
              "containers": [
                  {"resources": {"requests": {
                      "cpu": "250m", "memory": "1Gi",
                      "ephemeral-storage": "2Gi", "nvidia.com/gpu": "1"}},
                   "readinessProbe": {"initialDelaySeconds": 5}},
                  {"resources": {"requests": {"cpu": "1", "memory": "10Mi",
                                              "nvidia.com/gpu": "1"}}}]},
     "status": {"phase": "Running", "nominatedNodeName": "n3",
                "conditions": [{"type": "Ready", "status": "True"}]}},
]


@pytest.mark.parametrize("doc", POD_DOCS, ids=["minimal", "full"])
def test_pod_from_json_matches_reference(doc):
    want = dataclasses.asdict(jserver.pod_from_json(doc))
    got = dataclasses.asdict(tserver.pod_from_json(doc))
    assert got == want


def _payloads(js):
    names = js.cache.node_order()
    out = []
    for i, (cpu, mem, sel) in enumerate((
            (100, 500 * 2**20, {}), (3900, 2**30, {}),
            (100, 500 * 2**20,
             {"failure-domain.beta.kubernetes.io/zone": "zone-3"}),
            (9000, 2**30, {}), (50, 64 * 2**20, {"missing": "label"}))):
        pod = make_pod(f"ext-{i}", cpu_milli=cpu, memory=mem,
                       node_selector=sel)
        body = {"pod": pod_to_json(pod)}
        if i % 2:
            # a subset, in a scrambled order, with a name not in the cache
            body["nodenames"] = names[::-3] + ["ghost-node"]
        out.append(body)
    return out


@pytest.mark.parametrize("verb", ["filter", "prioritize", "bogus"])
def test_extender_answers_equal_the_reference(pair, verb):
    js, ts = pair
    jext, text = jserver.ExtenderServer(js), tserver.ExtenderServer(ts)
    for body in _payloads(js):
        want = _wire(jext.handle(verb, json.loads(json.dumps(body))))
        got = _wire(text.handle(verb, json.loads(json.dumps(body))))
        assert got == want, body["pod"]["metadata"]["name"]


def test_extender_reads_back_once_per_call(pair):
    from kubernetes_tpu_torch import kernels
    from kubernetes_tpu_torch.ops.sync import SYNCS

    _, ts = pair
    ext = tserver.ExtenderServer(ts)
    body = {"pod": pod_to_json(make_pod("once", cpu_milli=100))}
    kernels.reset_launches()
    for verb in ("filter", "prioritize"):
        n0 = SYNCS.count
        ext.handle(verb, body)
        assert SYNCS.count - n0 == 1
    # the unfused, unhoisted passes launch no hand kernel
    assert sum(kernels.LAUNCHES.values()) == 0


@pytest.mark.parametrize("query", ["", "?pod=pod-0", "?pod=default/pod-7",
                                   "?pod=pod-14", "?pod=nope",
                                   "?pod=default/nope"])
def test_debug_why_equals_the_reference(pair, query):
    js, ts = pair
    want = jserver.why_payload(js, f"/debug/why{query}")
    got = tserver.why_payload(ts, f"/debug/why{query}")
    assert (got[0], _wire(got[1])) == (want[0], _wire(want[1]))


def _get(port, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request(method, path, json.dumps(body) if body is not None else None,
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    raw = r.read()
    conn.close()
    return r.status, dict(r.getheaders()), raw


def test_routes_over_http(pair):
    js, ts = pair
    srv = tserver.serve_scheduler(ts, port=0,
                                  extender=tserver.ExtenderServer(ts))
    jsrv = jserver.serve_scheduler(js, port=0,
                                   extender=jserver.ExtenderServer(js))
    port, jport = srv.server_address[1], jsrv.server_address[1]
    try:
        assert _get(port, "GET", "/healthz")[::2] == (200, b"ok")
        st, _, body = _get(port, "GET", "/metrics")
        assert st == 200 and b"scheduler_schedule_attempts_total" in body
        st, _, body = _get(port, "GET", "/version")
        assert st == 200 and json.loads(body)["gitVersion"].startswith("v")
        st, _, body = _get(port, "GET", "/debug/traces")
        assert st == 200 and json.loads(body)["traceEvents"]
        for path in ("/debug/why", "/debug/why?pod=pod-0"):
            st, _, body = _get(port, "GET", path)
            jst, _, jbody = _get(jport, "GET", path)
            assert (st, json.loads(body)) == (jst, json.loads(jbody))
        for path in ("/debug/ledger", "/debug/memory", "/debug/incidents",
                     "/debug/profile"):
            st, _, body = _get(port, "GET", path)
            jst, _, jbody = _get(jport, "GET", path)
            assert st == jst and st in (200, 409), path
            assert json.loads(body).keys() == json.loads(jbody).keys(), path
        assert _get(port, "GET", "/nope")[0] == 404
        for verb in ("filter", "prioritize"):
            payload = _payloads(js)[1]
            st, _, body = _get(port, "POST", f"/scheduler/{verb}", payload)
            jst, _, jbody = _get(jport, "POST", f"/scheduler/{verb}",
                                 payload)
            assert st == jst == 200 and json.loads(body) == json.loads(jbody)
    finally:
        srv.shutdown()
        srv.server_close()
        jsrv.shutdown()
        jsrv.server_close()
    plain = tserver.serve_scheduler(ts, port=0)
    try:
        assert _get(plain.server_address[1], "POST", "/scheduler/filter",
                    {})[0] == 404
    finally:
        plain.shutdown()
        plain.server_close()


#: the readback bytes each package counts over its own payloads
NOT_COMPARED = ("readback_bytes",)
#: the memory ledger's measured fields of a record's ``mem`` block
MEASURED_MEM = ("measured_bytes", "efficiency")


def _compared(r: dict) -> dict:
    r = {k: v for k, v in r.items() if k not in NOT_COMPARED}
    if "mem" in r:
        r["mem"] = {k: v for k, v in r["mem"].items()
                    if k not in MEASURED_MEM}
    return r


def _both_get(pair, path):
    """GET ``path`` from both packages' servers: ((status, body) port,
    (status, body) reference); a non-JSON body comes back as bytes."""
    out = []
    for sched, mod in zip(pair[::-1], (tserver, jserver)):
        srv = mod.serve_scheduler(sched, port=0)
        try:
            st, _, body = _get(srv.server_address[1], "GET", path)
        finally:
            srv.shutdown()
            srv.server_close()
        try:
            body = json.loads(body)
        except ValueError:
            pass
        out.append((st, body))
    return out


def test_flightrecorder_route_serves_the_references_records(pair):
    (st, got), (jst, want) = _both_get(pair, "/debug/flightrecorder")
    assert st == jst == 200
    rec, jrec = got["flight_recorder"], want["flight_recorder"]
    assert len(rec["records"]) == 1
    assert ({k: v for k, v in rec.items() if k != "records"}
            == {k: v for k, v in jrec.items() if k != "records"})
    assert ([_compared(r) for r in rec["records"]]
            == [_compared(r) for r in jrec["records"]])
    assert got["jax"]["sites"] == want["jax"]["sites"]
    assert set(got["jax"]["transfers"]) >= {"solve-result:d2h",
                                            "explain:d2h", "snapshot:h2d"}


@pytest.mark.parametrize("query", ["", "?pod=pod-1", "?pod=default/pod-2",
                                   "?pod=nope"])
def test_journeys_route_matches_the_reference(pair, query):
    (st, got), (jst, want) = _both_get(pair, f"/debug/journeys{query}")
    assert (st, got) == (jst, want)
    assert st == (404 if query == "?pod=nope" else 200)


def test_soak_route_serves_an_attached_engine(pair):
    js, ts = pair
    assert [b[0] for b in _both_get(pair, "/debug/soak")] == [404, 404]
    import kubernetes_tpu.soak as jsoak
    import kubernetes_tpu_torch.soak as tsoak

    try:
        for sched, mod in ((js, jsoak), (ts, tsoak)):
            sent = mod.SoakSentinels(sched=sched, rss_reader=lambda: 0)
            mod.SoakEngine([mod.SoakPhase("idle", 0.0, "clean")], sent,
                           clock=lambda: 0.0, sleep=lambda _s: None).attach(
                               sched).run()
        (st, got), (jst, want) = _both_get(pair, "/debug/soak")
        assert st == jst == 200
        assert got["phases_done"] == want["phases_done"] == [
            {"name": "idle", "kind": "clean", "ok": True}]
        assert got["current_phase"] is want["current_phase"] is None
        # the sentinels of this facade (the scheduler's own sizes move
        # with whatever the module's other cases fed the pair)
        keep = ("obs.", "jax.", "journey.", "sched.journey_")
        assert ({k: v for k, v in got["sentinels"]["last"]["values"].items()
                 if k.startswith(keep)}
                == {k: v for k, v in want["sentinels"]["last"]["values"]
                    .items() if k.startswith(keep)})
    finally:
        del js.soak, ts.soak


def test_extender_posts_shed_with_429_and_retry_after(pair):
    """Extender POSTs ride the mutating flow: with no seat free they are
    shed with 429 + Retry-After, while the exempt probes keep answering."""
    from kubernetes_tpu_torch.serving import FlowController, FlowSchema

    _, ts = pair
    ctrl = FlowController(flows=[
        FlowSchema("exempt", exempt=True),
        FlowSchema("mutating", concurrency=0, queue_length=0,
                   queue_timeout_s=0.0)], retry_after_s=2.0)
    srv = tserver.serve_scheduler(ts, port=0, fairness=ctrl,
                                  extender=tserver.ExtenderServer(ts))
    port = srv.server_address[1]
    try:
        st, hdr, body = _get(port, "POST", "/scheduler/filter",
                             {"pod": pod_to_json(make_pod("x"))})
        assert st == 429 and hdr.get("Retry-After") == "2"
        assert "too many requests" in json.loads(body)["error"]
        assert _get(port, "GET", "/healthz")[0] == 200
        assert _get(port, "GET", "/metrics")[0] == 200
        assert ctrl.stats()["rejected"] == {"mutating/queue-full": 1}
    finally:
        srv.shutdown()
        srv.server_close()


def _memory_unmeasured(doc: dict) -> dict:
    """``/debug/memory`` without what the memory ledger measured (its
    census, peak, per-device rows and the efficiency made from them)."""
    doc = {k: v for k, v in doc.items()
           if k not in ("measured_bytes", "peak_bytes", "census", "devices",
                        "model_efficiency")}
    doc["watermarks"] = [{k: v for k, v in w.items() if k != "measured"}
                         for w in doc["watermarks"]]
    doc["entries"] = [{k: v for k, v in e.items()
                       if k not in ("measured_bytes", "efficiency")}
                      for e in doc["entries"]]
    return doc


@pytest.mark.parametrize("path", ["/debug/ledger", "/debug/memory",
                                  "/debug/incidents",
                                  "/debug/profile?cycles=2"])
def test_device_backend_routes_match_the_reference(pair, path):
    """The perf ledger, the memory ledger (but its measured side), the
    incident ring and the profiler's arming answer as the reference's do
    (no profile directory is configured: both refuse to arm, 409)."""
    (st, got), (jst, want) = _both_get(pair, path)
    assert st == jst == (409 if "profile" in path else 200)
    if path == "/debug/memory":
        got, want = _memory_unmeasured(got), _memory_unmeasured(want)
        assert got["residents"] and got["modeled_bytes"] > 0
    assert got == want
