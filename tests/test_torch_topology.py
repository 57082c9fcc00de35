"""The port's inter-pod affinity and topology spread against the JAX
package's, on the seeded clusters of tests/test_topology.py and the
hand-computed scenario tables of tests/test_topology_tables.py: the
device tables field by field, both masks, both scores, the solver's
sensitivity set and self-escape flags, and ``batch_assign`` /
``greedy_assign`` placements and rounds. Every count is integer-valued,
so every comparison is bit-exact (no tolerance)."""

import random

import numpy as np
import pytest

import kubernetes_tpu.ops.assign as ja
import kubernetes_tpu.ops.predicates as jpred
import kubernetes_tpu.ops.priorities as jprio
import kubernetes_tpu.ops.topology as jt
import kubernetes_tpu_torch.ops.assign as ta
import kubernetes_tpu_torch.ops.predicates as tpred
import kubernetes_tpu_torch.ops.priorities as tprio
import kubernetes_tpu_torch.ops.topology as tt
from kubernetes_tpu.api.types import Affinity, WeightedPodAffinityTerm
from kubernetes_tpu.models.cluster import (
    make_nodes,
    make_pods,
    make_spread_constraint_pods,
)
from kubernetes_tpu.testing import make_node, make_pod
from kubernetes_tpu_torch.ops.arrays import DeviceTopology, topology_to_device
from kubernetes_tpu_torch.snapshot import SnapshotPacker as TPacker
from test_topology import (
    HOSTNAME,
    ZONE,
    random_affinity_cluster,
    random_spread_cluster,
    term,
)
from test_topology_tables import six_zone_nodes, spread, zone_nodes
from torch_parity import (
    jax_topo_tables,
    port_topo_tables,
    to_port,
    topo_mixed_cluster,
)


def _eq(j, t):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ---------------------------------------------------------------------------
# the clusters: seeded generators and the hand-computed scenario tables
# ---------------------------------------------------------------------------


def _zone_affinity():
    web = make_pod("web", node_name="n0", labels={"app": "web"})
    wants = make_pod("p", affinity=Affinity(
        pod_affinity_required=(term(ZONE, {"app": "web"}),)))
    return zone_nodes(), [web], [wants]


def _anti_zone_vs_host():
    web = make_pod("web", node_name="n0", labels={"app": "web"})
    pz = make_pod("pz", affinity=Affinity(
        pod_anti_affinity_required=(term(ZONE, {"app": "web"}),)))
    ph = make_pod("ph", affinity=Affinity(
        pod_anti_affinity_required=(term(HOSTNAME, {"app": "web"}),)))
    return zone_nodes(), [web], [pz, ph]


def _namespace_scoping():
    other = make_pod("w", node_name="n0", labels={"app": "web"},
                     namespace="other")
    own = make_pod("p0", affinity=Affinity(
        pod_affinity_required=(term(ZONE, {"app": "web"}),)))
    cross = make_pod("p1", affinity=Affinity(pod_affinity_required=(
        term(ZONE, {"app": "web"}, namespaces=("other",)),)))
    return zone_nodes(), [other], [own, cross]


def _symmetry():
    hermit = make_pod("hermit", node_name="n2", labels={"app": "db"},
                      affinity=Affinity(pod_anti_affinity_required=(
                          term(ZONE, {"app": "web"}),)))
    clingy = make_pod("clingy", node_name="n0", labels={"app": "db"},
                      affinity=Affinity(pod_affinity_required=(
                          term(ZONE, {"app": "web"}),)))
    bare = make_pod("p0", labels={"app": "web"})
    chatty = make_pod("p1", labels={"app": "web"}, affinity=Affinity(
        pod_affinity_preferred=(
            WeightedPodAffinityTerm(1, term(ZONE, {"app": "nothing"})),)))
    db = make_pod("p2", labels={"app": "db"})
    return zone_nodes(), [hermit, clingy], [bare, chatty, db]


def _preferred_weights():
    web = make_pod("web", node_name="n0", labels={"app": "web"})
    db = make_pod("db", node_name="n2", labels={"app": "db"})
    p = make_pod("p", affinity=Affinity(
        pod_affinity_preferred=(
            WeightedPodAffinityTerm(7, term(ZONE, {"app": "web"})),),
        pod_anti_affinity_preferred=(
            WeightedPodAffinityTerm(3, term(ZONE, {"app": "db"})),)))
    return zone_nodes(), [web, db], [p]


def _spread_tables():
    existing = [make_pod(f"e{i}", node_name=f"n{2 * i}",
                         labels={"app": "web"}) for i in range(3)]
    existing.append(make_pod("e3", node_name="n1", labels={"app": "db"}))
    pending = [
        make_pod("p1", labels={"app": "web"},
                 topology_spread=(spread(max_skew=1),)),
        make_pod("p2", labels={"app": "web"},
                 topology_spread=(spread(max_skew=2),)),
        make_pod("soft", labels={"app": "web"},
                 topology_spread=(spread(when="ScheduleAnyway"),)),
        make_pod("both", labels={"app": "web"},
                 topology_spread=(spread(), spread(key=HOSTNAME))),
        make_pod("db", labels={"app": "db"},
                 topology_spread=(spread(labels={"app": "db"}),)),
    ]
    # a node without the zone key cannot satisfy a DoNotSchedule spread
    return six_zone_nodes() + [make_node("bare")], existing, pending


def _padding_rows():
    """test_topology.py::test_padding_rows_do_not_alias_matcher_zero."""
    return (make_nodes(16, zones=4),
            make_pods(8, "old", assigned_round_robin_over=16),
            make_spread_constraint_pods(32, hard=False))


CLUSTERS = {
    **{f"affinity-{s}": (lambda s=s: random_affinity_cluster(
        random.Random(500 + s))) for s in range(4)},
    **{f"spread-{s}": (lambda s=s: random_spread_cluster(
        random.Random(700 + s))) for s in range(4)},
    "zone-affinity": _zone_affinity,
    "anti-zone-vs-host": _anti_zone_vs_host,
    "namespace-scoping": _namespace_scoping,
    "symmetry": _symmetry,
    "preferred-weights": _preferred_weights,
    "spread-tables": _spread_tables,
    "padding-rows": _padding_rows,
    "mixed": lambda: topo_mixed_cluster(3, n_nodes=24, n_bound=8,
                                        n_pending=60),
}


# ---------------------------------------------------------------------------
# tables and passes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_topology_to_device_matches_field_by_field(name):
    nodes, scheduled, pending = CLUSTERS[name]()
    jdt = jax_topo_tables(nodes, scheduled, pending)[3]
    # the port packs the port-typed cluster with its own packer
    pk = TPacker()
    t_sched, t_pend = to_port(scheduled), to_port(pending)
    for p in t_sched + t_pend:
        pk.intern_pod(p)
    pk.pack_nodes(to_port(nodes), t_sched)
    pk.pack_pods(t_pend)
    dt = topology_to_device(pk.pack_topology_tables(), device="cpu")
    for f in DeviceTopology._fields:
        want, got = np.asarray(getattr(jdt, f)), getattr(dt, f).numpy()
        assert got.dtype == want.dtype, f
        assert got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_topology_passes_bit_identical(name):
    nodes, scheduled, pending = CLUSTERS[name]()
    jdn, jdp, jds, jdt, *_ = jax_topo_tables(nodes, scheduled, pending)
    dn, dp, ds, dt = port_topo_tables(jdn, jdp, jds, jdt)
    _eq(jt.inter_pod_affinity_mask(jdp, jdn, jdt),
        tt.inter_pod_affinity_mask(dp, dn, dt))
    jsm = jpred.selector_program_match(jds, jdn)
    sm = tpred.selector_program_match(ds, dn)
    _eq(jt.even_pods_spread_mask(jdp, jdn, jdt, jsm),
        tt.even_pods_spread_mask(dp, dn, dt, sm))
    jmask = jpred.run_predicates(jdp, jdn, jds, jdt).mask
    mask = tpred.run_predicates(dp, dn, ds, dt).mask
    _eq(jmask, mask)
    _eq(jt.inter_pod_affinity_score(jdp, jdn, jdt, jmask),
        tt.inter_pod_affinity_score(dp, dn, dt, mask))
    _eq(jt.inter_pod_affinity_score(jdp, jdn, jdt, jmask, 3.0),
        tt.inter_pod_affinity_score(dp, dn, dt, mask, 3.0))
    _eq(jt.even_pods_spread_score(jdp, jdn, jdt, jsm, jmask),
        tt.even_pods_spread_score(dp, dn, dt, sm, mask))
    K = dn.topo_pair_id.shape[1]
    _eq(jt.sensitive_keys(jdp, jdt, K), tt.sensitive_keys(dp, dt, K))
    _eq(jt.self_escape_active(jdp, jdn, jdt),
        tt.self_escape_active(dp, dn, dt))


def test_padding_rows_are_not_sensitive():
    """The pad rows of the anti/sym term tables carry matcher -1 and get
    all-zero one-hot rows: soft-only spread pods are not serialized, and
    the batch places everything in a few rounds."""
    nodes, scheduled, pending = _padding_rows()
    jdn, jdp, jds, jdt, *_ = jax_topo_tables(nodes, scheduled, pending)
    dn, dp, ds, dt = port_topo_tables(jdn, jdp, jds, jdt)
    assert not tt.sensitive_keys(dp, dt, dn.topo_pair_id.shape[1]).any()
    assert not dt.at_m_onehot.any() and not dt.st_m_onehot.any()
    a, _, rounds = ta.batch_assign(dp, dn, ds, topo=dt, per_node_cap=8)
    assert int((a[:32] >= 0).sum()) == 32 and int(rounds) <= 4


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------


def _same(j_out, t_out):
    ja_, ju, jr = j_out[:3]
    ta_, tu, tr = t_out[:3]
    np.testing.assert_array_equal(ta_.numpy(), np.asarray(ja_))
    for f in ("requested", "matcher_counts", "anti_counts", "sym_counts",
              "aff_pod_count"):
        np.testing.assert_array_equal(getattr(tu, f).numpy(),
                                      np.asarray(getattr(ju, f)), err_msg=f)
    assert int(jr) == int(tr)


def _pods(prefix, n, **kw):
    return [make_pod(f"{prefix}{i}", cpu_milli=100, memory=2**28, **kw)
            for i in range(n)]


def _grid_anti_host():
    pend = _pods("x", 4, labels={"app": "x"}, affinity=Affinity(
        pod_anti_affinity_required=(term(HOSTNAME, {"app": "x"}),)))
    nodes = [make_node(f"n{i}", labels={ZONE: f"z{i % 2}"}) for i in range(4)]
    return nodes, [], pend


def _grid_anti_zone():
    pend = _pods("x", 4, labels={"app": "x"}, affinity=Affinity(
        pod_anti_affinity_required=(term(ZONE, {"app": "x"}),)))
    nodes = [make_node(f"n{i}", labels={ZONE: f"z{i % 2}"}) for i in range(6)]
    return nodes, [], pend


def _grid_spread():
    pend = _pods("s", 9, labels={"app": "web"},
                 topology_spread=(spread(),))
    nodes = [make_node(f"n{i}", labels={ZONE: f"z{i % 3}"}) for i in range(9)]
    return nodes, [], pend


def _grid_escapee():
    pend = _pods("g", 3, labels={"app": "gang"}, affinity=Affinity(
        pod_affinity_required=(term(ZONE, {"app": "gang"}),)))
    nodes = [make_node(f"n{i}", labels={ZONE: f"z{i % 3}"}) for i in range(6)]
    return nodes, [], pend


#: the in-round grids of tests/test_topology.py (name -> (builder, caps))
GRIDS = {
    "anti-host-in-round": (_grid_anti_host, (1, 4)),
    "anti-zone-in-round": (_grid_anti_zone, (1, 4)),
    "spread-in-round": (_grid_spread, (1, 8)),
    "single-escapee": (_grid_escapee, (1, 4)),
    "padding-rows": (_padding_rows, (8,)),
    "affinity-0": (CLUSTERS["affinity-0"], (1, 4)),
    "affinity-1": (CLUSTERS["affinity-1"], (1, 4)),
    "spread-0": (CLUSTERS["spread-0"], (1, 4)),
    "spread-1": (CLUSTERS["spread-1"], (1, 4)),
    "mixed": (CLUSTERS["mixed"], (1, 4)),
}


def _gates(nt, pt):
    skip, no_ports, no_aff, no_spread = jprio.solver_gates(nt, pt)
    return dict(skip_priorities=skip, no_ports=no_ports,
                no_pod_affinity=no_aff, no_spread=no_spread)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_batch_assign_with_topology_matches(name):
    build, caps = GRIDS[name]
    nodes, scheduled, pending = build()
    jdn, jdp, jds, jdt, nt, pt, _pk = jax_topo_tables(nodes, scheduled,
                                                      pending)
    dn, dp, ds, dt = port_topo_tables(jdn, jdp, jds, jdt)
    for cap in caps:
        for kw in ({}, _gates(nt, pt)):
            _same(ja.batch_assign(jdp, jdn, jds, per_node_cap=cap, topo=jdt,
                                  **kw),
                  ta.batch_assign(dp, dn, ds, per_node_cap=cap, topo=dt,
                                  **kw))


def test_in_round_guards_hold():
    """The reference's in-round invariants, on the port: distinct hosts for
    hostname anti-affinity, one pod per zone for zone anti-affinity,
    skew <= 1 for hard spread, and one zone for a self-escaping group."""
    def solve(build, cap):
        nodes, scheduled, pending = build()
        dn, dp, ds, dt = port_topo_tables(
            *jax_topo_tables(nodes, scheduled, pending)[:4])
        a, _, _ = ta.batch_assign(dp, dn, ds, per_node_cap=cap, topo=dt)
        return a.numpy()[: len(pending)]

    a = solve(_grid_anti_host, 4)
    assert (a >= 0).all() and len(set(a.tolist())) == 4
    a = solve(_grid_anti_zone, 4)
    placed = a[a >= 0]
    assert len(placed) == 2 and len({int(n) % 2 for n in placed}) == 2
    a = solve(_grid_spread, 8)
    zc = np.bincount(a % 3, minlength=3)
    assert (a >= 0).all() and zc.max() - zc.min() <= 1
    a = solve(_grid_escapee, 4)
    assert (a >= 0).all() and len({int(n) % 3 for n in a}) == 1


@pytest.mark.parametrize("name", ["anti-host-in-round", "spread-in-round",
                                  "single-escapee", "affinity-2", "mixed"])
def test_greedy_assign_with_topology_matches(name):
    build = GRIDS[name][0] if name in GRIDS else CLUSTERS[name]
    nodes, scheduled, pending = build()
    jdn, jdp, jds, jdt, nt, pt, _pk = jax_topo_tables(nodes, scheduled,
                                                      pending)
    dn, dp, ds, dt = port_topo_tables(jdn, jdp, jds, jdt)
    ja_, ju = ja.greedy_assign(jdp, jdn, jds, topo=jdt, **_gates(nt, pt))
    ta_, tu = ta.greedy_assign(dp, dn, ds, topo=dt, **_gates(nt, pt))
    _same((ja_, ju, 0), (ta_, tu, 0))


def test_plan_route_with_topology_matches(monkeypatch):
    # the JAX package's Pallas transport plan in interpret mode: the
    # semantics the port's Sinkhorn kernels follow
    monkeypatch.setenv("KTPU_PALLAS", "1")
    nodes, scheduled, pending = topo_mixed_cluster(5, n_nodes=12, n_bound=4,
                                                   n_pending=30)
    jdn, jdp, jds, jdt, nt, pt, _pk = jax_topo_tables(nodes, scheduled,
                                                      pending)
    dn, dp, ds, dt = port_topo_tables(jdn, jdp, jds, jdt)
    kw = dict(per_node_cap=4, use_sinkhorn=True, **_gates(nt, pt))
    _same(ja.batch_assign(jdp, jdn, jds, topo=jdt, **kw),
          ta.batch_assign(dp, dn, ds, topo=dt, **kw))


# ---------------------------------------------------------------------------
# scoring totals with the fused pair and both topology scores live
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(2))
def test_fused_pair_with_topology_scores_bit_identical(monkeypatch, seed):
    nodes, scheduled, pending = topo_mixed_cluster(
        40 + seed, n_nodes=30, n_bound=20, n_pending=60)
    # bound members of affinity groups: their required terms credit
    # matching incoming pods (the symmetric half of the affinity score)
    scheduled = scheduled + [make_pod(
        f"anchor-{g}", node_name=f"node-{7 * g}",
        labels={"aff-group": f"g{g}"},
        affinity=Affinity(pod_affinity_required=(term(
            "failure-domain.beta.kubernetes.io/zone", {"aff-group": f"g{g}"}),
        ))) for g in range(2)]
    jdn, jdp, jds, jdt, nt, pt, _pk = jax_topo_tables(nodes, scheduled,
                                                      pending)
    dn, dp, ds, dt = port_topo_tables(jdn, jdp, jds, jdt)
    skip = jprio.empty_priorities(nt, pt)
    assert tprio.empty_priorities(nt, pt) == skip
    for live in ("NodeAffinityPriority", "TaintTolerationPriority",
                 "InterPodAffinityPriority", "EvenPodsSpreadPriority"):
        assert live not in skip
    calls = []
    fused_pair = tprio._fused_pair_normalize
    monkeypatch.setattr(tprio, "_fused_pair_normalize",
                        lambda *a: calls.append(1) or fused_pair(*a))
    jmask = jpred.run_predicates(jdp, jdn, jds, jdt).mask
    mask = tpred.run_predicates(dp, dn, ds, dt).mask
    th = tprio.hoist_priorities(dp, dn, ds, None, skip)
    for w in (None, dict(jprio.DEFAULT_WEIGHTS, EvenPodsSpreadPriority=2,
                         InterPodAffinityPriority=3)):
        assert tprio._fusable(w or tprio.DEFAULT_WEIGHTS, skip)
        want = jprio.run_priorities(jdp, jdn, jds, jmask, w, jdt, skip=skip)
        got = tprio.run_priorities(dp, dn, ds, mask, w, dt, skip=skip,
                                   hoisted=th, fused=True)
        _eq(want, got)
        _eq(want, tprio.run_priorities(dp, dn, ds, mask, w, dt, skip=skip))
    assert len(calls) == 2  # the fused pair ran in each fused total
    # and the topology scores are really live on this cluster
    assert tt.inter_pod_affinity_score(dp, dn, dt, mask).any()
    assert tt.even_pods_spread_score(
        dp, dn, dt, tpred.selector_program_match(ds, dn), mask).any()
