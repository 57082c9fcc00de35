"""The port's preemption (``kubernetes_tpu_torch/preemption.py``) against
the JAX package's (``kubernetes_tpu/preemption.py``): every function on
the cases of ``tests/test_preemption.py``, then a seeded sweep of small
clusters whose preemptors and bound pods carry required pod affinity and
anti-affinity, hard topology spread, PDBs and nominated phantoms. The
port's answer must equal the reference's exactly: the chosen node, the
victims in order, the PDB violation count and the nominations to clear.

The sweep covers both of the port's what-if paths: the node-local one
(:func:`what_if_is_local` holds) and the full ``seqref`` one."""

import numpy as np
import pytest

from kubernetes_tpu import preemption as jpre
from kubernetes_tpu.api.types import (
    Affinity,
    LabelSelector,
    PodAffinityTerm,
    PodDisruptionBudget,
    TopologySpreadConstraint,
)
from kubernetes_tpu.ops.predicates import BIT
from kubernetes_tpu.testing import make_node, make_pod
from kubernetes_tpu_torch import preemption as tpre
from torch_parity import to_port

ZONE = "failure-domain.beta.kubernetes.io/zone"
HOST = "kubernetes.io/hostname"


def _keys(pods):
    return [p.key() for p in pods]


def _victims(r):
    return None if r is None else (_keys(r[0]), r[1])


def _result(r):
    if r is None:
        return None
    return (r.node_name, _keys(r.victims), r.num_pdb_violations,
            _keys(r.clear_nominations))


def test_resolvable_bits_match():
    assert tpre.RESOLVABLE_BITS == jpre.RESOLVABLE_BITS


def test_nodes_where_preemption_might_help_matches():
    bits = {
        "res": 1 << BIT["PodFitsResources"],
        "sel": 1 << BIT["PodMatchNodeSelector"],
        "mixed": (1 << BIT["PodFitsResources"])
        | (1 << BIT["PodToleratesNodeTaints"]),
        "ok": 0,
        "ports": 1 << BIT["PodFitsHostPorts"],
        "aff": 1 << BIT["MatchInterPodAffinity"],
        "vol": (1 << BIT["NoDiskConflict"]) | (1 << BIT["MaxVolumeCount"]),
        "zone": 1 << BIT["NoVolumeZoneConflict"],
    }
    assert (tpre.nodes_where_preemption_might_help(bits)
            == jpre.nodes_where_preemption_might_help(bits))


def _victim_cases():
    """The selectVictimsOnNode cases of tests/test_preemption.py:
    (preemptor, node, nodes, node_pods_of, pdbs)."""
    n2000 = [make_node("n0", cpu_milli=2000, pods=10)]
    minimal = (make_pod("p", cpu_milli=800, priority=10), n2000, {"n0": [
        make_pod("lo", cpu_milli=500, priority=1, node_name="n0"),
        make_pod("mid", cpu_milli=500, priority=5, node_name="n0"),
        make_pod("hi", cpu_milli=500, priority=8, node_name="n0")]}, [])
    n1000 = [make_node("n0", cpu_milli=1000, pods=10)]
    blocked = (make_pod("p", cpu_milli=500, priority=10), n1000, {"n0": [
        make_pod("b", cpu_milli=900, priority=100, node_name="n0")]}, [])
    pdb = PodDisruptionBudget(
        name="pdb", selector=LabelSelector(match_labels={"app": "critical"}),
        disruptions_allowed=0)
    reprieve = (make_pod("p", cpu_milli=1200, priority=10), n2000, {"n0": [
        make_pod("prot", cpu_milli=700, priority=2, node_name="n0",
                 labels={"app": "critical"}),
        make_pod("plain", cpu_milli=700, priority=2, node_name="n0")]}, [pdb])
    return {"minimal": minimal, "blocked": blocked, "pdb": reprieve}


@pytest.mark.parametrize("case", ["minimal", "blocked", "pdb"])
def test_select_victims_on_node_matches(case):
    pod, nodes, pods_of, pdbs = _victim_cases()[case]
    want = jpre.select_victims_on_node(pod, nodes[0], nodes, pods_of,
                                       pdbs=pdbs)
    tp, tn, tpods, tpdbs = to_port((pod, nodes, pods_of, pdbs))
    for local in (False, True):
        got = tpre.select_victims_on_node(tp, tn[0], tn, tpods, pdbs=tpdbs,
                                          local=local)
        assert _victims(got) == _victims(want)
    assert tpre.what_if_is_local(tp, tpods)


def test_filter_pods_with_pdb_violation_matches():
    pods = [make_pod("a", labels={"app": "x"}),
            make_pod("b", labels={"app": "y"}),
            make_pod("c", labels={"app": "x"}, namespace="other")]
    pdbs = [PodDisruptionBudget(
        selector=LabelSelector(match_labels={"app": "x"}),
        disruptions_allowed=0),
        PodDisruptionBudget(selector=LabelSelector(match_labels={"app": "y"}),
                            disruptions_allowed=2)]
    want = jpre.filter_pods_with_pdb_violation(pods, pdbs)
    got = tpre.filter_pods_with_pdb_violation(*to_port((pods, pdbs)))
    assert [_keys(g) for g in got] == [_keys(w) for w in want]


def _pick_cases():
    v = lambda name, pri, start=0.0: make_pod(name, priority=pri,
                                              start_time=start)
    return [
        {"a": ([v("x", 5)], 1), "b": ([v("y", 9)], 0)},
        {"a": ([v("x", 9)], 0), "b": ([v("y", 3)], 0)},
        {"a": ([v("x", 5), v("x2", 5)], 0), "b": ([v("y", 5), v("y2", 1)], 0)},
        {"a": ([v("x", 5), v("x2", 5)], 0),
         "b": ([v("y", 5), v("y2", 5), v("y3", 0)], 0)},
        {"a": ([v("x", 5, start=10.0)], 0), "b": ([v("y", 5, start=99.0)], 0)},
        {"a": ([v("x", 5)], 0), "b": ([], 0)},
        {"a": ([v("x", -5), v("x2", -5)], 0), "b": ([v("y", -1)], 0)},
        {"a": ([v("x", 5)], 0), "b": ([v("y", 5)], 0)},
        {},
    ]


@pytest.mark.parametrize("case", range(len(_pick_cases())))
def test_pick_one_node_matches(case):
    cands = _pick_cases()[case]
    assert tpre.pick_one_node(to_port(cands)) == jpre.pick_one_node(cands)


@pytest.mark.parametrize("deleting, non_preempting",
                         [(123.0, False), (0.0, False), (0.0, True)])
def test_eligibility_matches(deleting, non_preempting):
    p = make_pod("p", priority=10, preemption_policy="Never")
    p.nominated_node_name = "n0"
    dying = make_pod("victim", priority=1, node_name="n0")
    dying.deletion_timestamp = deleting
    want = jpre.pod_eligible_to_preempt_others(p, {"n0": [dying]},
                                               non_preempting)
    tp, tpods = to_port((p, {"n0": [dying]}))
    assert tpre.pod_eligible_to_preempt_others(tp, tpods,
                                               non_preempting) == want


def test_preempt_function_matches():
    nodes = [make_node(f"n{i}", cpu_milli=1000, pods=10) for i in range(2)]
    pods_of = {"n0": [make_pod("l0", cpu_milli=900, priority=1,
                               node_name="n0")],
               "n1": [make_pod("l1", cpu_milli=900, priority=5,
                               node_name="n1")]}
    preemptor = make_pod("p", cpu_milli=900, priority=10)
    bits = {"n0": 1 << BIT["PodFitsResources"],
            "n1": 1 << BIT["PodFitsResources"]}
    want = jpre.preempt(preemptor, nodes, pods_of, bits)
    got = tpre.preempt(*to_port((preemptor, nodes, pods_of)), bits)
    assert _result(got) == _result(want) == ("n0", ["default/l0"], 0, [])


# -- seeded sweep ------------------------------------------------------------


def _term(key, app):
    return PodAffinityTerm(
        label_selector=LabelSelector(match_labels={"app": app}),
        topology_key=key)


def _sweep_case(seed):
    """A small seeded cluster and one preemptor. Returns
    ``(preemptor, nodes, node_pods_of, reason_bits, pdbs, nominated)``
    with the JAX package's types."""
    g = np.random.default_rng(seed)
    n_nodes = int(g.integers(3, 8))
    nodes = [make_node(f"n{i}", cpu_milli=2000, pods=int(g.choice([4, 10])),
                       zone=f"z{i % 2}") for i in range(n_nodes)]
    apps = ["a", "b", "guarded", "sp"]
    p_anti = float(g.choice([0.0, 0.0, 0.0, 0.3]))
    pods_of = {}
    for nd in nodes:
        here = []
        for k in range(int(g.integers(0, 5))):
            app = str(g.choice(apps))
            aff = Affinity()
            if g.random() < p_anti:
                aff = Affinity(pod_anti_affinity_required=(
                    _term(str(g.choice([HOST, ZONE])), str(g.choice(apps))),))
            here.append(make_pod(
                f"{nd.name}-{k}", cpu_milli=int(g.choice([300, 500, 700, 900])),
                priority=int(g.choice([0, 1, 5, 10, 30])),
                node_name=nd.name, labels={"app": app}, affinity=aff,
                start_time=float(g.integers(0, 100))))
        pods_of[nd.name] = here
    kind = int(g.integers(0, 6))  # 0, 4, 5: no terms of its own
    kw = {}
    if kind == 1:
        kw["affinity"] = Affinity(pod_affinity_required=(
            _term(ZONE, str(g.choice(["a", "sp"]))),))
    elif kind == 2:
        kw["affinity"] = Affinity(pod_anti_affinity_required=(
            _term(str(g.choice([HOST, ZONE])), "b"),))
    elif kind == 3:
        kw["topology_spread"] = (TopologySpreadConstraint(
            max_skew=1, topology_key=str(g.choice([ZONE, HOST])),
            when_unsatisfiable="DoNotSchedule",
            label_selector=LabelSelector(match_labels={"app": "sp"})),)
    preemptor = make_pod("pre", cpu_milli=int(g.choice([500, 900, 1500])),
                         priority=20, labels={"app": "sp"}, **kw)
    pdbs = []
    if g.random() < 0.6:
        pdbs.append(PodDisruptionBudget(
            name="g", selector=LabelSelector(match_labels={"app": "guarded"}),
            disruptions_allowed=0))
    if g.random() < 0.4:
        pdbs.append(PodDisruptionBudget(
            name="a", selector=LabelSelector(match_labels={"app": "a"}),
            disruptions_allowed=int(g.integers(0, 2))))
    nominated = {}
    for j in range(int(g.integers(0, 4))):
        nd = nodes[int(g.integers(0, n_nodes))].name
        aff = Affinity()
        if g.random() < 0.1:
            aff = Affinity(pod_anti_affinity_required=(_term(HOST, "sp"),))
        nominated.setdefault(nd, []).append(make_pod(
            f"nom{j}", cpu_milli=int(g.choice([300, 900])),
            priority=int(g.choice([10, 20, 30])), labels={"app": "a"},
            affinity=aff))
    choices = [1 << BIT["PodFitsResources"],
               (1 << BIT["PodFitsResources"])
               | (1 << BIT["MatchInterPodAffinity"]),
               1 << BIT["EvenPodsSpread"],
               1 << BIT["PodToleratesNodeTaints"], 0]
    bits = {nd.name: int(g.choice(choices, p=[0.5, 0.15, 0.15, 0.1, 0.1]))
            for nd in nodes}
    return preemptor, nodes, pods_of, bits, pdbs, nominated


SEEDS = range(120)


def test_sweep_matches_on_both_paths():
    """Port == JAX on every seeded case (``preempt``, and ``_fits_with``
    and ``select_victims_on_node`` on every node); where the gate holds
    the local what-if equals the full one on every node; and the sweep reaches both
    paths, including cases where skipping the cluster-wide checks WOULD
    change an answer (so a gate that admitted them would fail here)."""
    n_local = n_full = n_full_differs = n_preempted = 0
    for seed in SEEDS:
        pod, nodes, pods_of, bits, pdbs, nominated = _sweep_case(seed)
        want = jpre.preempt(pod, nodes, pods_of, bits, pdbs,
                            nominated_pods_of=nominated)
        tpod, tnodes, tpods, tpdbs, tnom = to_port(
            (pod, nodes, pods_of, pdbs, nominated))
        got = tpre.preempt(tpod, tnodes, tpods, bits, tpdbs,
                           nominated_pods_of=tnom)
        assert _result(got) == _result(want), seed
        n_preempted += want is not None
        local = tpre.what_if_is_local(tpod, tpods, tnom)
        n_local += local
        n_full += not local
        for nd, tnd in zip(nodes, tnodes):
            fits = jpre._fits_with(pod, nd, nodes, pods_of)
            assert tpre._fits_with(tpod, tnd, tnodes, tpods) == fits
            if local:
                assert tpre._fits_with(tpod, tnd, tnodes, tpods,
                                       local=True) == fits
            full = jpre.select_victims_on_node(
                pod, nd, nodes, pods_of, pdbs, nominated_pods_of=nominated)
            port_full = tpre.select_victims_on_node(
                tpod, tnd, tnodes, tpods, tpdbs, nominated_pods_of=tnom)
            only_here = tpre.select_victims_on_node(
                tpod, tnd, tnodes, tpods, tpdbs, nominated_pods_of=tnom,
                local=True)
            assert _victims(port_full) == _victims(full), (seed, nd.name)
            if local:
                assert _victims(only_here) == _victims(full), (seed, nd.name)
            elif _victims(only_here) != _victims(full):
                n_full_differs += 1
    assert n_local >= 25 and n_full >= 25, (n_local, n_full)
    assert n_full_differs > 0
    assert n_preempted >= 30


@pytest.mark.parametrize("seed", [3, 7, 11])
def test_preempt_with_volume_state_matches(seed):
    """The what-if's volume predicates read the node's own pods on both
    paths."""
    from torch_parity import random_volume_cluster
    from kubernetes_tpu.snapshot import SnapshotPacker as JPacker
    from kubernetes_tpu_torch.snapshot import SnapshotPacker as TPacker

    nodes, scheduled, pending, pvcs, pvs, classes = random_volume_cluster(
        seed)
    for p in scheduled:
        p.priority = 1
    pods_of = {nd.name: [p for p in scheduled if p.node_name == nd.name]
               for nd in nodes}
    jpk, tpk = JPacker(), TPacker()
    jpk.set_volume_state(pvcs, pvs, classes)
    tpk.set_volume_state(*to_port((pvcs, pvs, classes)))
    bits = {nd.name: ((1 << BIT["NoDiskConflict"])
                      | (1 << BIT["MaxVolumeCount"])) for nd in nodes}
    tnodes, tpods = to_port((nodes, pods_of))
    for pod in pending:
        pod.priority = 50
        want = jpre.preempt(pod, nodes, pods_of, bits,
                            vol_state=jpk.resolve_volumes)
        tpod = to_port(pod)
        assert tpre.what_if_is_local(tpod, tpods)
        got = tpre.preempt(tpod, tnodes, tpods, bits,
                           vol_state=tpk.resolve_volumes)
        assert _result(got) == _result(want), pod.name
