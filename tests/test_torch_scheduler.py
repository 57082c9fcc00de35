"""The slice as a whole: one event sequence fed to the JAX package's
``Scheduler(pipeline_depth=1)`` and to the port's
``Scheduler(device="cpu")`` binds the same pods to the same nodes, cycle
by cycle, with the same ``CycleResult`` failure reasons, FitError texts
and round counts — on the chip smoke cells shrunk to 64 nodes (the
preferred-zone cell through node and pod churn, on every ladder tier the
port runs; the mixed affinity/anti-affinity/spread cell over three
cycles), on topology failures, and on snapshot modes as new topology
groups arrive."""

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
    TopologySpreadConstraint,
)
from kubernetes_tpu.testing import make_node, make_pod
from torch_parity import pref_affinity_cluster, to_port, topo_mixed_cluster


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _pair(**kw):
    jc, tc = FakeClock(), FakeClock()
    js = JScheduler(pipeline_depth=1, enable_preemption=False, clock=jc, **kw)
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
