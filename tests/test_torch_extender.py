"""Scheduler extenders and node-search truncation in the PyTorch port,
held against the JAX package: ``HTTPExtender`` over an in-process stub
transport (filter + prioritize), ignorable and failing extenders, the
transport retry on the per-replica jitter seed, the breaker's shed path
and the call budget; and ``percentage_of_nodes_to_score``, whose
``NodeTree`` rotation must pick the same node subset every cycle."""

import pytest

from kubernetes_tpu.config import ExtenderConfig as JExtenderConfig
from kubernetes_tpu.extender import build_extenders as jbuild
from kubernetes_tpu.testing import make_node, make_pod
from kubernetes_tpu_torch import faults as tfaults
from kubernetes_tpu_torch.config import ExtenderConfig as TExtenderConfig
from kubernetes_tpu_torch.extender import (
    ExtenderError,
    HTTPExtender,
    build_extenders as tbuild,
)
from kubernetes_tpu_torch.nodetree import NodeTree
from kubernetes_tpu_torch.ops.sync import SYNCS
from torch_parity import FakeClock, Pair, to_port


def _cfg(cls, **kw):
    kw.setdefault("url_prefix", "http://extender.test")
    kw.setdefault("filter_verb", "filter")
    kw.setdefault("node_cache_capable", True)
    return cls(**kw)


class StubExtender:
    """An in-process extender endpoint: filter keeps the nodes whose index
    is not a multiple of ``drop_every``, prioritize scores a node by its
    index modulo 5. Records every call (verb, pod name, node names)."""

    def __init__(self, drop_every=3, fail=False):
        self.drop_every = drop_every
        self.fail = fail
        self.calls = []

    def __call__(self, url, payload, timeout):
        verb = url.rsplit("/", 1)[-1]
        names = list(payload.get("nodenames") or [])
        self.calls.append((verb, payload["pod"]["metadata"]["name"],
                           tuple(names)))
        if self.fail:
            raise ConnectionError("refused")
        idx = {n: int(n.lstrip("n")) for n in names}
        if verb == "filter":
            return {"nodenames": [n for n in names
                                  if idx[n] % self.drop_every]}
        return [{"host": n, "score": idx[n] % 5} for n in names]


def _pair_with(stub_j, stub_t, rc=None, **cfg):
    """A scheduler pair whose extenders (one per package) call the two
    stubs."""
    exts = (jbuild([_cfg(JExtenderConfig, **cfg)], stub_j),
            tbuild([_cfg(TExtenderConfig, **cfg)], stub_t))
    pair = Pair(rc=rc, per_pkg=({"extenders": exts[0]},
                                {"extenders": exts[1]}))
    return pair, exts


def test_filter_and_prioritize_place_like_the_reference():
    stubs = StubExtender(), StubExtender()
    pair, _ = _pair_with(*stubs, prioritize_verb="prioritize", weight=2)
    pair.feed([make_node(f"n{i}", cpu_milli=2000) for i in range(9)],
              [make_pod(f"p{i}", cpu_milli=300) for i in range(12)])
    rt = pair.cycle()
    assert rt.scheduled == 12
    # every bound node passed the extender's filter
    assert all(int(n.lstrip("n")) % 3 for n in rt.assignments.values())
    # the wire calls are the same, in the same order
    assert stubs[1].calls == stubs[0].calls


def test_the_extender_mask_read_is_counted():
    stubs = StubExtender(), StubExtender()
    pair, _ = _pair_with(*stubs)
    pair.feed([make_node(f"n{i}", cpu_milli=2000) for i in range(4)],
              [make_pod("p0", cpu_milli=100)])
    s0 = SYNCS.count
    rt = pair.cycle()
    # the extender mask and the solve's validated readback
    assert rt.host_syncs >= 2 and SYNCS.count - s0 == rt.host_syncs


@pytest.mark.parametrize("ignorable", [False, True])
def test_a_failing_extender_fails_its_pod_unless_ignorable(ignorable):
    stubs = StubExtender(fail=True), StubExtender(fail=True)
    pair, _ = _pair_with(*stubs, rc={"solver_retries": 0,
                                     "transport_retries": 0},
                         ignorable=ignorable)
    pair.feed([make_node("n1", cpu_milli=4000)],
              [make_pod("p0", cpu_milli=100)])
    rt = pair.cycle()
    if ignorable:
        assert rt.scheduled == 1
    else:
        assert rt.scheduled == 0
        assert rt.failure_reasons["default/p0"][0].startswith("Extender:")


def test_extender_outage_opens_breaker_then_degrades_to_ignorable():
    stubs = StubExtender(fail=True), StubExtender(fail=True)
    rc = {"solver_retries": 0, "transport_retries": 0,
          "breaker_failure_threshold": 2, "breaker_open_duration_s": 1e9}
    pair, exts = _pair_with(*stubs, rc=rc)
    pair.feed([make_node("n1", cpu_milli=8000)],
              [make_pod("p0", cpu_milli=100)])
    for _ in range(2):
        rt = pair.cycle()
        assert rt.scheduled == 0
        pair.advance(10.0)
        for s in pair.s:
            s.queue.move_all_to_active()
    ename = exts[1][0].name()
    assert pair.s[1]._breakers[f"extender:{ename}"].state == tfaults.OPEN
    pair.feed(pods=[make_pod("p1", cpu_milli=100)])
    rt = pair.cycle()
    assert rt.scheduled == 2
    assert pair.s[1].metrics.extender_degraded.value(extender=ename) >= 2


def test_shed_path_honors_config_ignorable_extender():
    stubs = StubExtender(fail=True), StubExtender(fail=True)
    rc = {"solver_retries": 0, "transport_retries": 0,
          "breaker_failure_threshold": 1, "breaker_open_duration_s": 1e9,
          "extender_degrade_to_ignorable": False}
    pair, _ = _pair_with(*stubs, rc=rc, ignorable=True)
    pair.feed([make_node("n1", cpu_milli=8000)],
              [make_pod("p0", cpu_milli=100)])
    assert pair.cycle().scheduled == 1
    pair.feed(pods=[make_pod("p1", cpu_milli=100)])
    rt = pair.cycle()
    assert rt.scheduled == 1 and "default/p1" not in rt.failure_reasons


def test_transport_retries_then_errors():
    calls = {"n": 0}

    def transport(url, payload, timeout):
        calls["n"] += 1
        raise ConnectionError("refused")

    ext = HTTPExtender(_cfg(TExtenderConfig), transport,
                       retry=tfaults.RetryPolicy(max_retries=2,
                                                 sleep=lambda _s: None))
    with pytest.raises(ExtenderError):
        ext.filter(to_port(make_pod("p")), ["n0"], {})
    assert calls["n"] == 3


@pytest.mark.parametrize("kind", ["corrupt", "error-field"])
def test_corrupt_responses_become_extender_errors(kind):
    inj = tfaults.FaultInjector(seed=21).arm("extender:filter", kind)
    ext = HTTPExtender(_cfg(TExtenderConfig),
                       lambda u, p, t: {"nodenames": ["n0"]},
                       fault_injector=inj)
    with pytest.raises(ExtenderError):
        ext.filter(to_port(make_pod("p")), ["n0"], {})


def test_retries_bounded_by_call_budget_deadline():
    clk = FakeClock()
    seen = []

    def transport(url, payload, timeout):
        seen.append(timeout)
        clk.advance(0.4)
        raise ConnectionError("refused")

    rp = tfaults.RetryPolicy(max_retries=5, base_s=0.3, jitter=0.0,
                             sleep=clk.advance)
    ext = HTTPExtender(_cfg(TExtenderConfig, http_timeout_s=30.0), transport,
                       retry=rp, clock=clk)
    ext.set_call_budget(1.0)
    with pytest.raises(ExtenderError):
        ext.filter(to_port(make_pod("p")), ["n0"], {})
    assert seen == [pytest.approx(1.0), pytest.approx(0.3)]


def test_call_budget_rearmed_per_verb_and_clearable():
    clk = FakeClock()
    seen = []

    def transport(url, payload, timeout):
        seen.append((url.rsplit("/", 1)[-1], timeout))
        return {"nodenames": ["n0"]}

    ext = HTTPExtender(_cfg(TExtenderConfig, bind_verb="bind",
                            http_timeout_s=30.0), transport, clock=clk)
    ext.set_call_budget(0.25)
    ext.filter(to_port(make_pod("p")), ["n0"], {})
    assert seen[-1] == ("filter", pytest.approx(0.25))
    ext.set_call_budget(None)
    ext.bind(to_port(make_pod("p")), "n0")
    assert seen[-1] == ("bind", pytest.approx(30.0))


def test_transport_retry_rides_the_per_replica_jitter_seed():
    """Two replicas sharing one configuration draw different jitter
    streams; a pinned seed gives the reference's stream exactly."""
    from kubernetes_tpu.scheduler import Scheduler as JScheduler
    from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler

    def delays(s):
        return [s._transport_retry.backoff_s(i) for i in range(4)]

    a = TScheduler(device="cpu", enable_preemption=False)
    b = TScheduler(device="cpu", enable_preemption=False)
    assert delays(a) != delays(b)
    j = JScheduler(enable_preemption=False, jitter_seed=1234)
    t = TScheduler(device="cpu", enable_preemption=False, jitter_seed=1234)
    assert delays(t) == delays(j)


def test_a_binder_extender_takes_the_binding():
    bound = []

    def transport(url, payload, timeout):
        verb = url.rsplit("/", 1)[-1]
        if verb == "bind":
            bound.append((payload["podName"], payload["node"]))
            return {}
        return {"nodenames": list(payload.get("nodenames") or [])}

    exts = tbuild([_cfg(TExtenderConfig, bind_verb="bind")], transport)
    from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler

    s = TScheduler(device="cpu", enable_preemption=False, extenders=exts,
                   clock=FakeClock())
    s.on_node_add(to_port(make_node("n1", cpu_milli=4000)))
    s.on_pod_add(to_port(make_pod("p0", cpu_milli=100)))
    r = s.schedule_cycle()
    assert r.scheduled == 1 and bound == [("p0", "n1")]
    assert s.binder.bindings == []


# -- percentageOfNodesToScore -------------------------------------------------


def test_node_tree_rotation_is_the_references():
    from kubernetes_tpu.nodetree import NodeTree as JNodeTree

    nodes = [make_node(f"n{i}", zone=f"z{i % 3}") for i in range(11)]
    jt, tt = JNodeTree(), NodeTree()
    for nd in nodes:
        jt.add_node(nd)
        tt.add_node(to_port(nd))
    jt.remove_node(nodes[4])
    tt.remove_node(to_port(nodes[4]))
    for n in (3, 5, 7, 10, 4):
        assert tt.take(n) == jt.take(n)


@pytest.mark.parametrize("percentage", [0, 50])
def test_truncated_cycles_solve_on_the_references_subset(percentage):
    nodes = [make_node(f"n{i}", cpu_milli=2000, zone=f"z{i % 4}")
             for i in range(160)]
    pair = Pair(percentage_of_nodes_to_score=percentage)
    pair.feed(nodes)
    placed = {}
    for cyc in range(3):
        pair.feed(pods=[make_pod(f"c{cyc}-p{i}", cpu_milli=500)
                        for i in range(40)])
        before = list(pair.s[1].node_tree._zones)
        rt = pair.cycle()
        assert rt.solver_tier == "batch" and rt.scheduled == 40
        assert before == pair.s[0].node_tree._zones
        placed.update(rt.assignments)
    # the rotation resumed where it stopped: later cycles used new nodes
    assert len(set(placed.values())) > 40


def test_truncation_keeps_the_monolithic_cycle_and_dense_route():
    from kubernetes_tpu_torch.config import IncrementalConfig
    from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler

    s = TScheduler(device="cpu", enable_preemption=False,
                   percentage_of_nodes_to_score=50, pipeline_chunk=4,
                   incremental=IncrementalConfig(enabled=True, primary=True,
                                                 candidate_bucket=16))
    for i in range(120):
        s.on_node_add(to_port(make_node(f"n{i}", cpu_milli=4000)))
    for i in range(8):
        s.on_pod_add(to_port(make_pod(f"p{i}", cpu_milli=100)))
    r = s.schedule_cycle()
    assert r.pipeline_chunks == 0 and r.solve_scope == "full"
    assert r.scheduled == 8
