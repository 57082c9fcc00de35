"""The slice as a whole: one event sequence fed to the JAX package's
``Scheduler(pipeline_depth=1)`` and to the port's
``Scheduler(device="cpu")`` binds the same pods to the same nodes, cycle
by cycle, with the same ``CycleResult`` failure reasons, FitError texts
and round counts — on the chip smoke cells shrunk to 64 nodes (the
preferred-zone cell through node and pod churn, on every ladder tier the
port runs; the mixed affinity/anti-affinity/spread cell over three
cycles), on topology failures, on snapshot modes as new topology
groups arrive, and on the preemption scenarios (victims, nominations,
pass A and the explain report)."""

import dataclasses

import pytest

from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu_torch import scheduler as tsched
from kubernetes_tpu_torch.kernels import KernelError
from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler
from kubernetes_tpu.api.types import (
    Affinity,
    LabelSelector,
    PodAffinityTerm,
    PodDisruptionBudget,
    TopologySpreadConstraint,
)
from kubernetes_tpu.testing import make_node, make_pod
from torch_parity import (
    preempt_burst_cluster,
    pref_affinity_cluster,
    to_port,
    topo_mixed_cluster,
)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _pair(**kw):
    jc, tc = FakeClock(), FakeClock()
    js = JScheduler(pipeline_depth=1, clock=jc, **kw)
    ts = TScheduler(device="cpu", clock=tc, **kw)
    return js, ts, (jc, tc)


def _feed(scheds, nodes=(), pods=()):
    js, ts = scheds
    for nd in nodes:
        js.on_node_add(nd)
        ts.on_node_add(to_port(nd))
    for p in pods:
        js.on_pod_add(p)
        ts.on_pod_add(to_port(p))


def _cycle_matches(js, ts):
    rj, rt = js.schedule_cycle(), ts.schedule_cycle()
    assert rt.attempted == rj.attempted
    assert rt.assignments == rj.assignments
    assert rt.failure_reasons == rj.failure_reasons
    assert rt.fit_errors == rj.fit_errors
    assert (rt.scheduled, rt.unschedulable, rt.rounds) == (
        rj.scheduled, rj.unschedulable, rj.rounds)
    assert rt.solver_tier == rj.solver_tier
    assert (rt.preempted, rt.nominations) == (rj.preempted, rj.nominations)
    assert (rt.explain is None) == (rj.explain is None)
    if rt.explain is not None:
        assert rt.explain.to_json() == rj.explain.to_json()
        assert ({k: pe.to_json() for k, pe in rt.explain.pods.items()}
                == {k: pe.to_json() for k, pe in rj.explain.pods.items()})
    return rj, rt


def test_scheduler_binds_like_the_reference_through_churn():
    nodes, bound, pending = pref_affinity_cluster(1, n_nodes=64, n_bound=64,
                                                  n_pending=512)
    js, ts, clocks = _pair()
    _feed((js, ts), nodes, bound + pending[:384])
    rj, rt = _cycle_matches(js, ts)
    assert rt.scheduled > 300 and rt.unschedulable > 0
    assert rt.snapshot_mode == "full"
    # churn: a node's labels change, a bound pod leaves, more pods arrive
    node = dataclasses.replace(nodes[3], labels=dict(
        nodes[3].labels, **{"failure-domain.beta.kubernetes.io/zone":
                            "zone-7"}))
    js.on_node_update(node)
    ts.on_node_update(to_port(node))
    js.on_pod_delete(bound[5])
    ts.on_pod_delete(to_port(bound[5]))
    _feed((js, ts), pods=pending[384:])
    for c in clocks:
        c.t += 61.0  # past the unschedulable resweep: failures retry
    _rj, rt = _cycle_matches(js, ts)
    assert rt.attempted > 128
    assert rt.snapshot_mode in ("delta", "full")


@pytest.mark.parametrize("solver", ["sinkhorn", "greedy"])
def test_other_tiers_bind_like_the_reference(monkeypatch, solver):
    # the JAX package's Pallas kernels in interpret mode: the transport
    # plan the port's kernels are held to
    monkeypatch.setenv("KTPU_PALLAS", "1")
    nodes, bound, pending = pref_affinity_cluster(
        2, n_nodes=16, n_bound=8, n_pending=64 if solver == "sinkhorn"
        else 24)
    js, ts, _clocks = _pair(solver=solver)
    _feed((js, ts), nodes, bound + pending)
    _rj, rt = _cycle_matches(js, ts)
    assert rt.solver_tier == solver and rt.scheduled > 0


def test_gang_rollback_matches():
    nodes = [make_node(f"n{i}", cpu_milli=2000) for i in range(4)]
    pods = [make_pod(f"g{i}", cpu_milli=1500, pod_group="big",
                     pod_group_min_available=6) for i in range(6)]
    pods += [make_pod(f"s{i}", cpu_milli=100, pod_group="small",
                      pod_group_min_available=2) for i in range(2)]
    js, ts, _clocks = _pair()
    _feed((js, ts), nodes, pods)
    _rj, rt = _cycle_matches(js, ts)
    assert rt.failure_reasons["default/g0"] == ("GangIncomplete:big",)
    assert rt.scheduled == 2


@pytest.mark.parametrize("fault, falls_back", [(RuntimeError, True),
                                               (KernelError, False)])
def test_kernel_faults_escape_the_solver_ladder(monkeypatch, fault,
                                                falls_back):
    """A solver fault falls through to greedy; a kernel that fails to
    build or launch stops the cycle instead of hiding behind greedy's
    plain PyTorch scores."""
    def broken(*_a, **_k):
        raise fault("injected")

    monkeypatch.setattr(tsched, "batch_assign", broken)
    nodes, bound, pending = pref_affinity_cluster(3, n_nodes=8, n_bound=4,
                                                  n_pending=16)
    ts = TScheduler(device="cpu", clock=FakeClock())
    for nd in nodes:
        ts.on_node_add(to_port(nd))
    for p in bound + pending:
        ts.on_pod_add(to_port(p))
    if falls_back:
        rt = ts.schedule_cycle()
        assert (rt.solver_tier, rt.solver_fallbacks) == ("greedy", 1)
        assert rt.scheduled > 0
    else:
        with pytest.raises(KernelError, match="injected"):
            ts.schedule_cycle()


def _topo_pod(name, labels=None, anti=None, aff=None, spread_key=None):
    """100m / 256 Mi pod with required hostname anti-affinity to ``anti``,
    required zone affinity to ``aff`` and/or a hard spread (maxSkew 1)
    over ``spread_key`` — each against its own labels when given."""
    labels = dict(labels or {})

    def term(key, sel):
        return PodAffinityTerm(label_selector=LabelSelector(match_labels=sel),
                               topology_key=key)

    affinity = Affinity(
        pod_anti_affinity_required=(
            (term("kubernetes.io/hostname", anti),) if anti else ()),
        pod_affinity_required=(
            (term("failure-domain.beta.kubernetes.io/zone", aff),)
            if aff else ()))
    spread = ((TopologySpreadConstraint(
        max_skew=1, topology_key=spread_key,
        when_unsatisfiable="DoNotSchedule",
        label_selector=LabelSelector(match_labels=labels)),)
        if spread_key else ())
    return make_pod(name, cpu_milli=100, memory=2**28, labels=labels,
                    affinity=affinity, topology_spread=spread)


def test_topology_cell_binds_like_the_reference():
    """The chip cell topo-5k-mixed shrunk to 64 nodes over 4 zones and 320
    pending pods, in three cycles of at most 128."""
    nodes, bound, pending = topo_mixed_cluster(1, n_nodes=64, n_bound=16,
                                               n_pending=320)
    js, ts, _clocks = _pair(max_batch=128)
    _feed((js, ts), nodes, bound + pending)
    results = [_cycle_matches(js, ts)[1] for _ in range(3)]
    assert [r.attempted for r in results] == [128, 128, 64]
    assert sum(r.scheduled for r in results) == 320
    assert all(r.solver_tier == "batch" and not r.solver_fallbacks
               for r in results)
    placed = {}
    for r in results:
        placed.update(r.assignments)
    zone_of = {nd.name: nd.labels["failure-domain.beta.kubernetes.io/zone"]
               for nd in nodes}
    by_key = {p.key(): p for p in pending}
    for label in ("anti-group", "spread-app"):
        seen = set()
        for key, node in placed.items():
            v = by_key[key].labels.get(label)
            if v and (label == "anti-group" or v == "hard"):
                assert (v, node) not in seen, (label, v, node)
                seen.add((v, node))
    groups = {}
    for key, node in placed.items():
        g = by_key[key].labels.get("aff-group")
        if g:
            groups.setdefault(g, set()).add(zone_of[node])
    assert groups and all(len(z) == 1 for z in groups.values())


def test_topology_failures_match():
    """Pods that topology keeps out: an anti-affinity group larger than the
    node count, affinity to a group that exists nowhere (and no
    self-match), and a hard spread over a key no node carries. Reasons and
    FitError texts equal the reference's."""
    nodes = [make_node(f"n{i}", cpu_milli=4000, memory=32 * 2**30,
                       zone=f"z{i % 2}") for i in range(6)]
    pods = [_topo_pod(f"anti-{i}", {"grp": "a"}, anti={"grp": "a"})
            for i in range(9)]
    pods += [_topo_pod(f"lost-{i}", {"grp": "b"}, aff={"grp": "nowhere"})
             for i in range(2)]
    pods += [_topo_pod(f"rack-{i}", {"grp": "c"}, spread_key="rack")
             for i in range(2)]
    pods += [_topo_pod(f"host-{i}", {"grp": "d"}, spread_key=(
        "kubernetes.io/hostname")) for i in range(8)]
    js, ts, _clocks = _pair()
    _feed((js, ts), nodes, pods)
    _rj, rt = _cycle_matches(js, ts)
    assert rt.failure_reasons["default/anti-8"] == ("MatchInterPodAffinity",)
    assert rt.failure_reasons["default/lost-0"] == ("MatchInterPodAffinity",)
    assert rt.failure_reasons["default/rack-0"] == ("EvenPodsSpread",)
    assert "didn't match pod affinity/anti-affinity" in rt.fit_errors[
        "default/anti-8"]
    assert rt.scheduled == 6 + 8


def test_new_topology_groups_repack_like_the_reference():
    """Cycles that bring new anti-affinity groups widen the node-side
    count matrices: the port's snapshot mode is ``full`` exactly where the
    reference's is, and ``delta`` where it is."""
    nodes = [make_node(f"n{i}", cpu_milli=4000, memory=32 * 2**30,
                       zone=f"z{i % 4}") for i in range(16)]

    def plain(prefix, n):
        return [make_pod(f"{prefix}{i}", cpu_milli=100, memory=2**28)
                for i in range(n)]

    def anti(prefix, n, g):
        return [_topo_pod(f"{prefix}{i}", {"anti-group": g},
                          anti={"anti-group": g}) for i in range(n)]

    js, ts, _clocks = _pair()
    _feed((js, ts), nodes, anti("z", 3, "g0") + plain("p", 10))
    arrivals = (plain("q", 10), anti("a", 6, "g0"), anti("b", 4, "g1"),
                plain("r", 5), anti("c", 4, "g2") + [_topo_pod(
                    "s0", {"aff-group": "x"}, aff={"aff-group": "x"},
                    spread_key="kubernetes.io/hostname")], ())
    modes = []
    for batch in arrivals:
        rj, rt = _cycle_matches(js, ts)
        assert rt.snapshot_mode == rj.snapshot_mode
        modes.append(rt.snapshot_mode)
        _feed((js, ts), pods=batch)
    assert modes[3] == "full"  # the cycle that brought group g1
    assert "delta" in modes


# -- preemption, nominated pods and the explain report ----------------------
# The scheduler scenarios of tests/test_preemption.py (plus one where a
# higher-priority preemptor clears a lower-priority nomination), fed to
# both schedulers with fake clocks advanced together; every cycle's
# bindings, victims, nominations, reasons, FitError text and explain
# report must be equal (_cycle_matches).


def _advance(clocks, dt):
    for c in clocks:
        c.t += dt


def _scn_preempts_then_binds(js, ts, clocks, ev):
    _feed((js, ts), [make_node("n0", cpu_milli=1000, pods=10)],
          [make_pod("low", cpu_milli=900, priority=1)])
    assert _cycle_matches(js, ts)[1].scheduled == 1
    _feed((js, ts), pods=[make_pod("high", cpu_milli=900, priority=50)])
    r = _cycle_matches(js, ts)[1]
    assert (r.preempted, r.nominations) == (1, {"default/high": "n0"})
    assert ("Preempted", "low") in ev[1]
    assert ts.cache.pod_count() == js.cache.pod_count() == 0
    assert set(ts.why_pending) == {"default/high"}
    _advance(clocks, 2.0)
    assert _cycle_matches(js, ts)[1].assignments == {"default/high": "n0"}
    assert not ts.why_pending and not ts.queue.nominated.items()
    # an idle cycle retires the drained report
    _cycle_matches(js, ts)
    assert ts.last_explain.to_json() == js.last_explain.to_json()
    assert not ts.last_explain.pods


def _scn_poacher_held_off(js, ts, clocks, ev):
    _feed((js, ts), [make_node("n0", cpu_milli=1000, pods=10)],
          [make_pod("low", cpu_milli=900, priority=1)])
    _cycle_matches(js, ts)
    _feed((js, ts), pods=[make_pod("high", cpu_milli=900, priority=50)])
    assert _cycle_matches(js, ts)[1].nominations == {"default/high": "n0"}
    _feed((js, ts), pods=[make_pod("poacher", cpu_milli=900, priority=5)])
    r = _cycle_matches(js, ts)[1]
    assert r.scheduled == 0 and "default/poacher" in r.failure_reasons
    # the failure pass runs without the phantoms: n0 reads feasible
    assert r.explain.pods["default/poacher"].feasible_nodes == 1
    _advance(clocks, 2.0)
    assert _cycle_matches(js, ts)[1].assignments.get("default/high") == "n0"


def _scn_pdb_across_nodes(js, ts, clocks, ev):
    _feed((js, ts), [make_node(f"n{i}", cpu_milli=1000, pods=10)
                     for i in range(2)],
          [make_pod("guarded", cpu_milli=900, priority=1,
                    labels={"app": "guarded"}),
           make_pod("plain", cpu_milli=900, priority=1)])
    r = _cycle_matches(js, ts)[1]
    plain_node = r.assignments["default/plain"]
    _feed((js, ts), pods=[make_pod("big", cpu_milli=900, priority=50)])
    assert _cycle_matches(js, ts)[1].nominations["default/big"] == plain_node


def _scn_two_preemptors(js, ts, clocks, ev):
    _feed((js, ts), [make_node(f"n{i}", cpu_milli=1000, pods=10)
                     for i in range(2)],
          [make_pod(f"low{i}", cpu_milli=900, priority=1) for i in range(2)])
    _cycle_matches(js, ts)
    _feed((js, ts), pods=[make_pod("hi0", cpu_milli=900, priority=50),
                          make_pod("hi1", cpu_milli=900, priority=40)])
    r = _cycle_matches(js, ts)[1]
    assert r.preempted == 2 and sorted(r.nominations.values()) == ["n0", "n1"]
    _advance(clocks, 2.0)
    assert sorted(_cycle_matches(js, ts)[1].assignments) == [
        "default/hi0", "default/hi1"]


def _scn_hub_deleter(js, ts, clocks, ev):
    _feed((js, ts), [make_node("n0", cpu_milli=1000, pods=10)],
          [make_pod("low", cpu_milli=900, priority=1)])
    _cycle_matches(js, ts)
    _feed((js, ts), pods=[make_pod("h1", cpu_milli=900, priority=50),
                          make_pod("h2", cpu_milli=900, priority=40)])
    r = _cycle_matches(js, ts)[1]
    assert r.preempted == 1
    assert ts.cache.pod_count() == js.cache.pod_count() == 1


def _scn_disabled(js, ts, clocks, ev):
    _feed((js, ts), [make_node("n0", cpu_milli=1000, pods=10)],
          [make_pod("low", cpu_milli=900, priority=1)])
    _cycle_matches(js, ts)
    _feed((js, ts), pods=[make_pod("high", cpu_milli=900, priority=50)])
    r = _cycle_matches(js, ts)[1]
    assert (r.preempted, r.nominations) == (0, {})
    assert ts.cache.pod_count() == 1


def _scn_clears_lower_nomination(js, ts, clocks, ev):
    _feed((js, ts), [make_node("n0", cpu_milli=2000, pods=10)],
          [make_pod("lowA", cpu_milli=900, priority=1),
           make_pod("lowB", cpu_milli=900, priority=1)])
    _cycle_matches(js, ts)
    _feed((js, ts), pods=[make_pod("mid", cpu_milli=1000, priority=20)])
    r = _cycle_matches(js, ts)[1]
    assert (r.preempted, r.nominations) == (1, {"default/mid": "n0"})
    # mid still backs off; high preempts the rest and clears its nomination
    _feed((js, ts), pods=[make_pod("high", cpu_milli=1500, priority=50)])
    r = _cycle_matches(js, ts)[1]
    assert (r.preempted, r.nominations) == (1, {"default/high": "n0"})
    assert ts.queue.nominated.node_of("default/mid") is None
    _advance(clocks, 2.0)
    r = _cycle_matches(js, ts)[1]
    assert r.assignments == {"default/high": "n0"}
    assert "default/mid" in r.failure_reasons and not r.nominations


SCENARIOS = {
    "preempts_then_binds": (_scn_preempts_then_binds, {}),
    "poacher_held_off": (_scn_poacher_held_off, {}),
    "pdb_across_nodes": (_scn_pdb_across_nodes, {}),
    "two_preemptors": (_scn_two_preemptors, {}),
    "hub_deleter": (_scn_hub_deleter, {"victim_deleter": True}),
    "disabled": (_scn_disabled, {"enable_preemption": False}),
    "clears_lower_nomination": (_scn_clears_lower_nomination, {}),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_preemption_scenarios_match(name):
    run, kw = SCENARIOS[name]
    kw = dict(kw)
    deleted = ([], [])
    if kw.pop("victim_deleter", False):
        kw["victim_deleter"] = (deleted[0].append, deleted[1].append)
    jkw = {k: (v[0] if k == "victim_deleter" else v) for k, v in kw.items()}
    tkw = {k: (v[1] if k == "victim_deleter" else v) for k, v in kw.items()}
    if name == "pdb_across_nodes":
        pdb = PodDisruptionBudget(
            selector=LabelSelector(match_labels={"app": "guarded"}),
            disruptions_allowed=0)
        jkw["pdb_lister"] = lambda: [pdb]
        tkw["pdb_lister"] = lambda: [to_port(pdb)]
    jc, tc = FakeClock(), FakeClock()
    js = JScheduler(pipeline_depth=1, clock=jc, **jkw)
    ts = TScheduler(device="cpu", clock=tc, **tkw)
    ev = ([], [])
    js.event_sink = lambda reason, pod, msg: ev[0].append((reason, pod.name))
    ts.event_sink = lambda reason, pod, msg: ev[1].append((reason, pod.name))
    run(js, ts, (jc, tc), ev)
    assert ev[1] == ev[0]
    assert [p.key() for p in deleted[1]] == [p.key() for p in deleted[0]]
    assert ({k: pe.to_json() for k, pe in ts.why_pending.items()}
            == {k: pe.to_json() for k, pe in js.why_pending.items()})


def test_why_pending_leaves_with_the_pod():
    """A pending pod's report row is dropped when it is deleted or stops
    being this scheduler's, as in the reference."""
    js, ts, _clocks = _pair()
    pods = [make_pod(f"big{i}", cpu_milli=5000) for i in range(3)]
    _feed((js, ts), [make_node("n0", cpu_milli=1000)], pods)
    _cycle_matches(js, ts)
    assert set(ts.why_pending) == {p.key() for p in pods}
    for s, conv in ((js, lambda p: p), (ts, to_port)):
        s.on_pod_delete(conv(pods[0]))
        s.on_pod_update(conv(pods[1]), conv(dataclasses.replace(
            pods[1], scheduler_name="other")))
    assert set(ts.why_pending) == set(js.why_pending) == {pods[2].key()}


def test_preempt_burst_cell_matches():
    """The chip cell preempt-5k-burst shrunk to 64 nodes (8 preemptors, at
    most 4 preemptions a cycle, 8 poachers): wave 1 binds and preempts,
    pass A holds the poachers off the freed nodes, the poachers leave,
    and the preemptors bind over the next cycles — equal, cycle by cycle,
    on both schedulers."""
    nodes, bound, wave1, poachers, pdb = preempt_burst_cluster(5)
    js, ts, clocks = _pair(max_preemptions_per_cycle=4)
    js.pdb_lister = lambda: [pdb]
    ts.pdb_lister = lambda: [to_port(pdb)]
    _feed((js, ts), nodes, bound + wave1)
    r1 = _cycle_matches(js, ts)[1]
    assert r1.scheduled == 52 and len(r1.nominations) == 4
    _advance(clocks, 0.5)
    _feed((js, ts), pods=poachers)
    r2 = _cycle_matches(js, ts)[1]
    assert r2.scheduled == 0 and r2.preempted == 0
    freed = set(r1.nominations.values())
    for p in poachers:
        assert r2.explain.pods[p.key()].feasible_nodes == len(freed)
    for p in poachers:
        js.on_pod_delete(p)
        ts.on_pod_delete(to_port(p))
    bound_keys = set(r1.assignments)
    for _ in range(4):
        _advance(clocks, 11.0)
        bound_keys.update(_cycle_matches(js, ts)[1].assignments)
    assert {p.key() for p in wave1} <= bound_keys
