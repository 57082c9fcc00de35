"""The port's scenario packs end to end (``kubernetes_tpu_torch/
scenarios``, the scheduler's scenario seams) held against the JAX
package on the CPU: each case of tests/test_scenarios.py runs one seeded
script through both packages' schedulers and compares the cycle results'
assignments, counts, failure rows, nominations and ``scenario_quality``,
the flight record's ``scenario`` block, the ``scheduler_scenario_*``
samples and the events. The pack objects themselves (weights, cost terms,
candidate hints, the gang pack's home slices) and the cascade's victim
selection are compared directly.

Quality scores: the counts are exact; the fractions, decoded to 4 places
from vectors that agree within ``rtol=1e-5, atol=1e-6``
(tests/test_torch_scenario_cost.py), may differ by one rounding step,
``FRAC_ATOL``.

Left out: the reference cases that read ``scripts/bench_compare.py``'s
scenario gate family and graftlint's parse and lint roots
(tests/test_scenarios.py:617-738), and the single source of
``bench.node_resources_score``: they test files that are not ported
(the port's ``node_resources_score`` is compared in
tests/test_torch_scenario_cost.py)."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import kubernetes_tpu.api.config_v1alpha1 as jv1
import kubernetes_tpu.cli as jcli
import kubernetes_tpu.config as jconfig
import kubernetes_tpu.scenarios as jscen
import kubernetes_tpu.scenarios.cascade as jcascade
import kubernetes_tpu.scheduler as jscheduler
import kubernetes_tpu.testing as jtesting
import kubernetes_tpu_torch.api.config_v1alpha1 as tv1
import kubernetes_tpu_torch.cli as tcli
import kubernetes_tpu_torch.config as tconfig
import kubernetes_tpu_torch.scenarios as tscen
import kubernetes_tpu_torch.scheduler as tscheduler
import kubernetes_tpu_torch.testing as ttesting
from torch_parity import jax_tables, port_tables, to_port

REF = SimpleNamespace(config=jconfig, scheduler=jscheduler, testing=jtesting,
                      scenarios=jscen, cli=jcli, v1=jv1, kw={})
PORT = SimpleNamespace(config=tconfig, scheduler=tscheduler,
                       testing=ttesting, scenarios=tscen, cli=tcli, v1=tv1,
                       kw={"device": "cpu"})

#: decoded fractions (4 places) of vectors that agree to rtol 1e-5
FRAC_ATOL = 1e-4

#: the scenario metric families
FAMILIES = ("scenario_quality", "scenario_cascade_victims",
            "scenario_displaced_replaced", "scenario_repacks",
            "scenario_repack_drained")


def _close(got, want, path="") -> None:
    """Equal, but floats (decoded quality fractions) within FRAC_ATOL."""
    if isinstance(want, float) and isinstance(got, (float, int)):
        assert abs(got - want) <= FRAC_ATOL, (path, got, want)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (path, got, want)
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def both(script):
    """``script(pkg)`` on each package; the port returns what the
    reference returns (quality fractions within FRAC_ATOL). Returns the
    port's result."""
    want, got = script(REF), script(PORT)
    _close(got, want)
    return got


def _samples(s) -> dict:
    """The scenario families' samples: {series: value}."""
    out = {}
    for attr in FAMILIES:
        for line in getattr(s.metrics, attr).expose():
            series, value = line.rsplit(" ", 1)
            out[series] = float(value)
    return out


def _sched(pkg, scenario=None, events=None, **kw):
    kw.setdefault("clock", lambda: 0.0)
    if events is not None:
        kw["event_sink"] = lambda r, p, m: events.append(
            (r, getattr(p, "name", ""), m))
    return pkg.scheduler.Scheduler(scenario=scenario, **pkg.kw, **kw)


def _cluster(pkg, s, n=8, cpu=4000.0, mem=8 * 2**30, zones=0):
    for i in range(n):
        zone = f"slice-{i % zones}" if zones else None
        s.on_node_add(pkg.testing.make_node(f"n{i}", cpu_milli=cpu,
                                            memory=mem, pods=110, zone=zone))


def _outcome(s, r) -> dict:
    """What a cycle decided and what it published."""
    recs = s.obs.recorder.records()
    return {"assignments": r.assignments, "scheduled": r.scheduled,
            "unschedulable": r.unschedulable,
            "failure_reasons": r.failure_reasons,
            "preempted": r.preempted, "nominations": r.nominations,
            "solver_tier": r.solver_tier, "solve_scope": r.solve_scope,
            "quality": r.scenario_quality,
            "record": recs[-1].scenario if recs else None,
            "samples": _samples(s)}


# ---------------------------------------------------------------------------
# the pack objects
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pack", ["consolidation", "gang-topology"])
def test_pack_weights_cost_and_hint_match_the_reference(pack):
    """On one snapshot: the weight override, the (P, N) cost term (bit
    for bit), the candidate hint and the gang pack's home slices."""
    rng = np.random.RandomState(4)
    nodes = [jtesting.make_node(f"n{i}", cpu_milli=4000, memory=8 * 2**30,
                                zone=(None if i % 7 == 6
                                      else f"slice-{i % 5}"))
             for i in range(30)]
    bound = [jtesting.make_pod(f"b{i}", cpu_milli=int(rng.choice([500, 900])),
                               node_name=f"n{rng.randint(0, 30)}")
             for i in range(25)]
    pending = []
    for g in range(6):
        for m in range(int(rng.randint(2, 5))):
            pending.append(jtesting.make_pod(
                f"g{g}m{m}", cpu_milli=int(rng.choice([500, 1000])),
                pod_group=f"gang{g % 5}", pod_group_min_available=2))
    pending += [jtesting.make_pod(f"solo{i}", cpu_milli=100)
                for i in range(5)]
    jdn, jdp, jds, _dv, jnt, _pt, _pk = jax_tables(nodes, bound, pending)
    dn, dp, _ds, _ = port_tables(jdn, jdp, jds)
    for cw in (10.0, 2.5):
        jcfg = jconfig.ScenarioConfig(pack=pack, cost_weight=cw,
                                      fill_block=4, superpod=2)
        tcfg = tconfig.ScenarioConfig(pack=pack, cost_weight=cw,
                                      fill_block=4, superpod=2)
        jp, tp = jscen.resolve_pack(jcfg), tscen.resolve_pack(tcfg)
        assert type(tp).__name__ == type(jp).__name__
        assert tp.restricted_ok == jp.restricted_ok
        assert tp.wants_cascade == jp.wants_cascade
        for base in (None, {"LeastRequestedPriority": 1}):
            assert tp.weights(base) == jp.weights(base)
        tbatch = to_port(pending)
        order = [f"n{i}" for i in range(30)]
        want = np.asarray(jp.cost(pending, jnt, order, jdp, jdn), np.float32)
        got = tp.cost(tbatch, jnt, order, dp, dn)
        assert got.device == dn.valid.device
        assert np.array_equal(got.numpy().view(np.int32),
                              np.ascontiguousarray(want).view(np.int32))
        hj = jp.candidate_hint(pending, jnt, order)
        ht = tp.candidate_hint(tbatch, jnt, order)
        assert (hj is None) == (ht is None)
        if hj is not None:
            assert np.array_equal(ht, hj)
        if pack == "gang-topology":
            assert np.array_equal(tp._home_zones(tbatch, jnt),
                                  jp._home_zones(pending, jnt))
            assert (tp._home_zones(tbatch, jnt) >= 0).any()


def test_gang_home_zone_ties_keep_the_reference_order():
    """Gangs of equal demand take slices in name order, each the first of
    the freest slices (``np.argmax``); a gangless batch is all -1."""
    nodes = [jtesting.make_node(f"n{i}", cpu_milli=4000, zone=f"z{i % 4}")
             for i in range(8)]
    pending = [jtesting.make_pod(f"{g}{m}", cpu_milli=1000, pod_group=g,
                                 pod_group_min_available=2)
               for g in ("c", "a", "b") for m in range(2)]
    _jdn, _jdp, _jds, _dv, nt, _pt, _pk = jax_tables(nodes, [], pending)
    jp = jscen.resolve_pack(jconfig.ScenarioConfig(pack="gang-topology"))
    tp = tscen.resolve_pack(tconfig.ScenarioConfig(pack="gang-topology"))
    got = tp._home_zones(to_port(pending), nt)
    assert np.array_equal(got, jp._home_zones(pending, nt))
    solo = [jtesting.make_pod("s", cpu_milli=100)]
    assert tp._home_zones(to_port(solo), nt).tolist() == [-1]
    assert tp.candidate_hint(to_port(solo), nt, []) is None


def test_resolve_pack_and_registry():
    assert set(tscen.SCENARIO_REGISTRY) == set(jscen.SCENARIO_REGISTRY)
    assert tscen.resolve_pack(None) is None
    assert tscen.resolve_pack(tconfig.ScenarioConfig()) is None
    with pytest.raises(ValueError, match="unknown pack"):
        tscen.resolve_pack(tconfig.ScenarioConfig(pack="nope"))
    assert tscen.__all__ == jscen.__all__


# ---------------------------------------------------------------------------
# consolidation pack
# ---------------------------------------------------------------------------


def test_consolidation_beats_stock_nodes_used():
    def script(pkg):
        out = []
        for sc in (pkg.config.ScenarioConfig(pack="consolidation",
                                             fill_block=1), None):
            s = _sched(pkg, sc, enable_preemption=False)
            _cluster(pkg, s, n=8)
            for i in range(12):
                s.on_pod_add(pkg.testing.make_pod(f"p{i}", cpu_milli=500,
                                                  memory=2**30))
            out.append(_outcome(s, s.schedule_cycle()))
        return out

    pack, stock = both(script)
    assert pack["scheduled"] == stock["scheduled"] == 12
    used = len(set(pack["assignments"].values()))
    assert used < len(set(stock["assignments"].values()))
    assert pack["quality"]["nodes_used"] == used
    assert pack["quality"]["placed"] == 12
    assert 0.0 <= pack["quality"]["headroom"] <= 1.0
    assert pack["record"]["nodes_used"] == used
    assert pack["samples"][
        'scheduler_scenario_quality{score="nodes_used"}'] == used
    assert stock["quality"] == {} and stock["record"] == {}


def test_consolidation_objective_rides_greedy_tier():
    def script(pkg):
        s = _sched(pkg, pkg.config.ScenarioConfig(pack="consolidation",
                                                  fill_block=1),
                   solver="greedy", enable_preemption=False)
        _cluster(pkg, s, n=8)
        for i in range(12):
            s.on_pod_add(pkg.testing.make_pod(f"p{i}", cpu_milli=500,
                                              memory=2**30))
        return _outcome(s, s.schedule_cycle())

    out = both(script)
    assert out["solver_tier"] == "greedy" and out["scheduled"] == 12
    assert len(set(out["assignments"].values())) <= 3


def test_scenario_pack_overrides_weights():
    def script(pkg):
        s = _sched(pkg, pkg.config.ScenarioConfig(pack="consolidation"))
        return s.weights, s.scenario_pack is not None, \
            _sched(pkg).scenario_pack is None

    assert both(script) == ({"MostRequestedPriority": 3,
                             "BalancedResourceAllocation": 1}, True, True)


# ---------------------------------------------------------------------------
# the in-batch preemption cascade
# ---------------------------------------------------------------------------


def _preemption_cluster(pkg, seed):
    """The reference's seeded cluster: bound low-priority pods fed
    pre-bound, one high-priority pod that fits nowhere without
    eviction."""
    rng = np.random.RandomState(seed)
    n = rng.randint(3, 6)
    nodes = [pkg.testing.make_node(f"n{i}", cpu_milli=2000,
                                   memory=4 * 2**30, pods=10)
             for i in range(n)]
    bound = []
    for i in range(n):
        for j in range(rng.randint(1, 3)):
            bound.append(pkg.testing.make_pod(
                f"low{i}{j}", cpu_milli=float(rng.choice([600, 900, 1200])),
                memory=2**28, priority=int(rng.randint(0, 3)),
                node_name=f"n{i}", start_time=float(j)))
    high = pkg.testing.make_pod("high", cpu_milli=1800, memory=2**28,
                                priority=100)
    return nodes, bound, high


def _run_preemption(pkg, scenario, seed):
    events = []
    s = _sched(pkg, scenario, events)
    nodes, bound, high = _preemption_cluster(pkg, seed)
    for nd in nodes:
        s.on_node_add(nd)
    for p in bound:
        s.on_pod_add(p)
    s.on_pod_add(high)
    r = s.schedule_cycle()
    return _outcome(s, r), sorted(n for e, n, _ in events
                                  if e == "Preempted"), events


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_cascade_victim_parity_single_pod_batches(seed):
    """A single-pod batch: the cascade's victims equal the stock path's
    (one source of selection), and in both packages; the cascade binds
    the preemptor in the same cycle where the stock path nominates."""
    def script(pkg):
        return (_run_preemption(pkg, None, seed),
                _run_preemption(pkg, pkg.config.ScenarioConfig(
                    pack="consolidation", preempt_in_batch=True), seed))

    (stock, v_stock, _e1), (casc, v_casc, _e2) = both(script)
    assert v_casc == v_stock
    assert casc["preempted"] == stock["preempted"]
    if v_stock:
        assert "default/high" in casc["assignments"]
        assert "default/high" not in stock["assignments"]
        assert stock["nominations"].get("default/high")
        assert casc["samples"][
            "scheduler_scenario_cascade_victims_total"] == len(v_casc)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_select_cascade_victims_match_the_reference(seed):
    """``select_cascade`` itself, on the seeded cluster and a second
    preemptor: the chosen nodes, victims and their claims."""
    def script(pkg):
        nodes, bound, high = _preemption_cluster(pkg, seed)
        second = pkg.testing.make_pod("second", cpu_milli=1500,
                                      memory=2**28, priority=50)
        pods_of = {nd.name: [p for p in bound if p.node_name == nd.name]
                   for nd in nodes}
        # every node fails the preemptors on resources alone
        bits = {nd.name: 1 << 3 for nd in nodes}
        attempts = []
        sel = pkg.scenarios.select_cascade(
            [(high, bits), (second, bits)], nodes, pods_of,
            on_attempt=lambda: attempts.append(1), max_preemptions=2)
        return (sel.chosen, [v.key() for v in sel.victims], sel.victim_of,
                [p.key() for p in sel.clear_nominations],
                sel.num_pdb_violations, len(attempts))

    both(script)


def test_cascade_displaced_pods_replace_same_cycle():
    def script(pkg):
        s = _sched(pkg, pkg.config.ScenarioConfig(pack="consolidation",
                                                  fill_block=1))
        s.on_node_add(pkg.testing.make_node("n0", cpu_milli=2000,
                                            memory=4 * 2**30))
        s.on_node_add(pkg.testing.make_node("n1", cpu_milli=1700,
                                            memory=4 * 2**30))
        for j in range(2):
            s.on_pod_add(pkg.testing.make_pod(f"low{j}", cpu_milli=800,
                                              memory=2**28, priority=0,
                                              node_name="n0"))
        s.on_pod_add(pkg.testing.make_pod("high", cpu_milli=1900,
                                          memory=2**28, priority=100))
        out = _outcome(s, s.schedule_cycle())
        out["used"] = {nd.name: sum(p.requests.cpu_milli
                                    for p in s.cache.pods_on(nd.name))
                       for nd in s.cache.nodes()}
        return out

    out = both(script)
    assert out["assignments"] == {"default/high": "n0",
                                  "default/low0": "n1", "default/low1": "n1"}
    assert out["preempted"] == 2 and out["unschedulable"] == 0
    assert out["samples"][
        "scheduler_scenario_displaced_replaced_total"] == 2
    assert out["samples"]["scheduler_scenario_cascade_victims_total"] == 2
    assert out["used"] == {"n0": 1900, "n1": 1600}


def test_cascade_multi_preemptor_victims_match_stock():
    def build(pkg, scenario):
        events = []
        s = _sched(pkg, scenario, events)
        for n in ("x", "y"):
            s.on_node_add(pkg.testing.make_node(n, cpu_milli=2000,
                                                memory=4 * 2**30))
        for j in range(2):
            s.on_pod_add(pkg.testing.make_pod(f"low{j}", cpu_milli=800,
                                              memory=2**28, priority=0,
                                              node_name="x"))
            s.on_pod_add(pkg.testing.make_pod(f"mid{j}", cpu_milli=800,
                                              memory=2**28, priority=50,
                                              node_name="y"))
        s.on_pod_add(pkg.testing.make_pod("p1", cpu_milli=1900,
                                          memory=2**28, priority=200))
        s.on_pod_add(pkg.testing.make_pod("p2", cpu_milli=1900,
                                          memory=2**28, priority=100))
        out = _outcome(s, s.schedule_cycle())
        return out, sorted(n for e, n, _ in events if e == "Preempted")

    def script(pkg):
        return build(pkg, None), build(pkg, pkg.config.ScenarioConfig(
            pack="consolidation", preempt_in_batch=True))

    (_s, v_stock), (_c, v_casc) = both(script)
    assert v_stock == ["low0", "low1", "mid0", "mid1"]
    assert v_casc == v_stock


def test_cascade_never_binds_gang_members_solo():
    def script(pkg):
        s = _sched(pkg, pkg.config.ScenarioConfig(pack="consolidation",
                                                  fill_block=1))
        s.on_node_add(pkg.testing.make_node("n0", cpu_milli=2000,
                                            memory=4 * 2**30))
        for j in range(2):
            s.on_pod_add(pkg.testing.make_pod(f"low{j}", cpu_milli=800,
                                              memory=2**28, priority=0,
                                              node_name="n0"))
        for m in range(2):
            s.on_pod_add(pkg.testing.make_pod(
                f"gm{m}", cpu_milli=1900, memory=2**28, priority=100,
                pod_group="gang0", pod_group_min_available=2))
        out = _outcome(s, s.schedule_cycle())
        out["low0_queued"] = s.queue.pod("default/low0") is not None
        return out

    out = both(script)
    assert not any("gm" in k for k in out["assignments"])
    assert out["quality"].get("gang_partial_binds", 0) == 0
    assert not any("low" in k for k in out["assignments"])
    assert out["low0_queued"] and out["nominations"]


def test_cascade_budget_overflow_requeues_displaced():
    def script(pkg):
        s = _sched(pkg, pkg.config.ScenarioConfig(
            pack="consolidation", fill_block=1, cascade_max_pods=1))
        s.on_node_add(pkg.testing.make_node("n0", cpu_milli=2000,
                                            memory=4 * 2**30))
        s.on_node_add(pkg.testing.make_node("n1", cpu_milli=1700,
                                            memory=4 * 2**30))
        for j in range(2):
            s.on_pod_add(pkg.testing.make_pod(f"low{j}", cpu_milli=800,
                                              memory=2**28, priority=0,
                                              node_name="n0"))
        s.on_pod_add(pkg.testing.make_pod("high", cpu_milli=1900,
                                          memory=2**28, priority=100))
        out = _outcome(s, s.schedule_cycle())
        out["queued"] = [s.queue.pod(f"default/low{j}") is not None
                         for j in range(2)]
        return out

    out = both(script)
    assert out["preempted"] == 2 and out["queued"] == [True, True]
    for j in range(2):
        assert f"default/low{j}" in out["failure_reasons"]
    assert out["assignments"].get("default/high") == "n0"
    assert out["unschedulable"] == 2


def test_cascade_victimless_win_still_nominates(monkeypatch):
    def fake(pkg):
        def select(preemptors, *a, **k):
            sel = pkg.scenarios.CascadeSelection()
            sel.chosen[preemptors[0][0].key()] = "n0"
            return sel
        return select

    # the reference imports select_cascade from its module at call time,
    # the port's scheduler at import time
    monkeypatch.setattr(jcascade, "select_cascade", fake(REF))
    monkeypatch.setattr(tscheduler, "select_cascade", fake(PORT))

    def script(pkg):
        s = _sched(pkg, pkg.config.ScenarioConfig(pack="consolidation"))
        s.on_node_add(pkg.testing.make_node("n0", cpu_milli=2000,
                                            memory=4 * 2**30))
        s.on_pod_add(pkg.testing.make_pod("low", cpu_milli=1500,
                                          memory=2**28, priority=0,
                                          node_name="n0"))
        s.on_pod_add(pkg.testing.make_pod("high", cpu_milli=1900,
                                          memory=2**28, priority=100))
        return _outcome(s, s.schedule_cycle())

    out = both(script)
    assert out["nominations"].get("default/high") == "n0"
    assert out["preempted"] == 0


def test_cascade_off_keeps_stock_path():
    def script(pkg):
        return _run_preemption(pkg, pkg.config.ScenarioConfig(
            pack="consolidation", preempt_in_batch=False), 1)

    out, victims, _events = both(script)
    if victims:
        assert "default/high" not in out["assignments"]
        assert out["nominations"].get("default/high")


def test_cascade_solve_lets_a_kernel_error_out(monkeypatch):
    """A ``KernelError`` inside the cascade's re-solve is a kernel fault,
    not a solver fault: it leaves the cycle instead of falling back."""
    from kubernetes_tpu_torch import kernels

    s = _sched(PORT, tconfig.ScenarioConfig(pack="consolidation",
                                            fill_block=1))
    s.on_node_add(ttesting.make_node("n0", cpu_milli=2000, memory=4 * 2**30))
    s.on_node_add(ttesting.make_node("n1", cpu_milli=1700, memory=4 * 2**30))
    for j in range(2):
        s.on_pod_add(ttesting.make_pod(f"low{j}", cpu_milli=800,
                                       memory=2**28, node_name="n0"))
    s.on_pod_add(ttesting.make_pod("high", cpu_milli=1900, memory=2**28,
                                   priority=100))
    real = s._solve_ladder
    calls = []

    def ladder(*a, **k):
        calls.append(1)
        if len(calls) == 2:  # the cascade's re-solve
            raise kernels.KernelError("injected: kernel launch failed")
        return real(*a, **k)

    monkeypatch.setattr(s, "_solve_ladder", ladder)
    with pytest.raises(kernels.KernelError):
        s.schedule_cycle()
    assert len(calls) == 2


# ---------------------------------------------------------------------------
# gang-topology pack
# ---------------------------------------------------------------------------


def test_scenario_quality_gauge_freshness():
    def script(pkg):
        s = _sched(pkg, pkg.config.ScenarioConfig(pack="gang-topology"),
                   enable_preemption=False)
        _cluster(pkg, s, n=4, cpu=8000, mem=16 * 2**30, zones=2)
        for m in range(2):
            s.on_pod_add(pkg.testing.make_pod(
                f"gm{m}", cpu_milli=1000, memory=2**30, pod_group="gang0",
                pod_group_min_available=2))
        first = _outcome(s, s.schedule_cycle())
        s.on_pod_add(pkg.testing.make_pod("solo", cpu_milli=1000,
                                          memory=2**30))
        return first, _outcome(s, s.schedule_cycle())

    first, second = both(script)
    key = 'scheduler_scenario_quality{score="gang_locality"}'
    assert first["samples"][key] == 2.0
    assert second["samples"][key] == 0.0
    assert "gang_locality" not in second["quality"]


def test_gang_topology_colocates_whole_gangs():
    def script(pkg):
        s = _sched(pkg, pkg.config.ScenarioConfig(pack="gang-topology"),
                   enable_preemption=False)
        _cluster(pkg, s, n=8, cpu=8000, mem=16 * 2**30, zones=4)
        for g in range(2):
            for m in range(4):
                s.on_pod_add(pkg.testing.make_pod(
                    f"g{g}m{m}", cpu_milli=1000, memory=2**30,
                    pod_group=f"gang{g}", pod_group_min_available=4))
        return _outcome(s, s.schedule_cycle())

    out = both(script)
    q = out["quality"]
    assert out["scheduled"] == 8
    assert q["gang_groups"] == 2 and q["gang_success_rate"] == 1.0
    assert q["gang_partial_binds"] == 0 and q["gang_locality"] == 2.0
    zones = {}
    for k, n in out["assignments"].items():
        zones.setdefault(k.split("/")[-1][:2], set()).add(int(n[1:]) % 4)
    assert all(len(z) == 1 for z in zones.values())
    assert zones["g0"] != zones["g1"]


def test_gang_topology_rides_restricted_with_home_slice_hint():
    def script(pkg):
        s = _sched(pkg, pkg.config.ScenarioConfig(pack="gang-topology",
                                                  quality=False),
                   incremental=pkg.config.IncrementalConfig(
                       enabled=True, primary=True, candidate_bucket=8),
                   enable_preemption=False)
        _cluster(pkg, s, n=32, cpu=8000, mem=16 * 2**30, zones=4)
        s.on_pod_add(pkg.testing.make_pod("warm0", cpu_milli=100,
                                          memory=2**28))
        first = _outcome(s, s.schedule_cycle())
        for m in range(3):
            s.on_pod_add(pkg.testing.make_pod(
                f"gm{m}", cpu_milli=1000, memory=2**30, pod_group="dl",
                pod_group_min_available=3))
        return first, _outcome(s, s.schedule_cycle())

    _first, out = both(script)
    assert out["solve_scope"] == "restricted" and out["scheduled"] == 3
    assert len({int(n[1:]) % 4 for n in out["assignments"].values()}) == 1


def test_restricted_quality_is_frame_local():
    """A quality-on restricted cycle (the gang pack with quality on, a
    steady micro-batch) reduces over the candidate frame, as the
    reference's does."""
    def script(pkg):
        s = _sched(pkg, pkg.config.ScenarioConfig(pack="gang-topology"),
                   incremental=pkg.config.IncrementalConfig(
                       enabled=True, candidate_bucket=8),
                   enable_preemption=False)
        _cluster(pkg, s, n=32, cpu=8000, mem=16 * 2**30, zones=4)
        s.on_pod_add(pkg.testing.make_pod("warm0", cpu_milli=100,
                                          memory=2**28))
        out = [_outcome(s, s.schedule_cycle())]
        for m in range(2):
            s.on_pod_add(pkg.testing.make_pod(
                f"gm{m}", cpu_milli=1000, memory=2**30, pod_group="dl",
                pod_group_min_available=2))
        out.append(_outcome(s, s.schedule_cycle()))
        return out

    out = both(script)
    assert out[1]["solve_scope"] == "restricted"
    assert out[1]["quality"]["placed"] == 2


def test_gang_all_or_nothing_with_pack():
    def script(pkg):
        s = _sched(pkg, pkg.config.ScenarioConfig(pack="gang-topology"),
                   enable_preemption=False)
        _cluster(pkg, s, n=2, cpu=2000, mem=4 * 2**30, zones=2)
        for m in range(8):
            s.on_pod_add(pkg.testing.make_pod(
                f"gm{m}", cpu_milli=1000, memory=2**28, pod_group="gang0",
                pod_group_min_available=8))
        return _outcome(s, s.schedule_cycle())

    out = both(script)
    q = out["quality"]
    assert out["scheduled"] == 0
    assert q["gang_partial_binds"] == 0 and q["gang_success_rate"] == 0.0
    assert q["gangs_placed"] == 0


@pytest.mark.parametrize("solver", ["batch", "sinkhorn"])
def test_pipelined_pack_cost_per_chunk(solver):
    """Quality off: a restricted_ok pack's cycle pipelines, its cost
    added per chunk; placements equal the reference's at depth 2."""
    def script(pkg):
        s = _sched(pkg, pkg.config.ScenarioConfig(pack="consolidation",
                                                  fill_block=4,
                                                  quality=False),
                   solver=solver, pipeline_chunk=16,
                   enable_preemption=False)
        _cluster(pkg, s, n=12, cpu=4000, mem=8 * 2**30)
        for i in range(40):
            s.on_pod_add(pkg.testing.make_pod(f"p{i}", cpu_milli=300,
                                              memory=2**28))
        r = s.schedule_cycle()
        return _outcome(s, r), r.pipeline_chunks

    out, chunks = both(script)
    assert chunks == 3 and out["scheduled"] == 40
    assert out["quality"] == {}


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


def test_scenario_config_native_decode_and_validation():
    def script(pkg):
        cfg = pkg.cli.decode_config({"scenario": {"pack": "consolidation",
                                                  "cost_weight": 2.0,
                                                  "fill_block": 32}})
        out = [cfg.scenario.pack, cfg.scenario.fill_block,
               pkg.cli.validate_config(cfg)]
        with pytest.raises(pkg.cli.ConfigError):
            pkg.cli.decode_config({"scenario": {"packk": "x"}})
        bad = pkg.cli.decode_config({"scenario": {
            "pack": "nope", "cost_weight": -1, "cascade_max_pods": 0,
            "superpod": 0, "fill_block": 0}})
        return out + [pkg.cli.validate_config(bad)]

    pack, fb, errs0, errs = both(script)
    assert (pack, fb, errs0) == ("consolidation", 32, [])
    for field in ("scenario.pack", "scenario.costWeight",
                  "scenario.cascadeMaxPods", "scenario.superpod",
                  "scenario.fillBlock"):
        assert any(field in e for e in errs), field


def test_scenario_v1alpha1_roundtrip():
    doc = {
        "apiVersion": "kubescheduler.config.k8s.io/v1alpha1",
        "kind": "KubeSchedulerConfiguration",
        "scenario": {"pack": "gang-topology", "costWeight": 6.0,
                     "preemptInBatch": False, "cascadeMaxPods": 256,
                     "superpod": 8, "fillBlock": 16, "quality": False},
    }

    def script(pkg):
        cfg = pkg.v1.decode(doc)
        wire = pkg.v1.encode(cfg)
        empty = pkg.v1.decode({"apiVersion": doc["apiVersion"],
                               "kind": doc["kind"]})
        return (dataclasses.asdict(cfg.scenario), wire["scenario"],
                pkg.v1.decode(wire) == cfg,
                empty.scenario == pkg.config.KubeSchedulerConfiguration(
                ).scenario)

    sn, wire, roundtrip, default = both(script)
    assert sn["pack"] == "gang-topology" and sn["quality"] is False
    assert wire["pack"] == "gang-topology" and roundtrip and default


def test_scenario_cli_flag():
    def script(pkg):
        args = pkg.cli.build_parser().parse_args(
            ["--scenario", "consolidation"])
        cfg = pkg.cli.resolve_config(args)
        with pytest.raises(pkg.cli.ConfigError):
            pkg.cli.resolve_config(pkg.cli.build_parser().parse_args(
                ["--scenario", "bogus"]))
        return cfg.scenario.pack, pkg.cli.unported_features(cfg) \
            if pkg is PORT else []

    assert both(script) == ("consolidation", [])


# ---------------------------------------------------------------------------
# warmup
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pack", ["consolidation", "gang-topology"])
def test_scenario_warmup_covers_cost_and_quality(pack):
    """After the warmup a scenario cycle presents no new solve signature
    (the reference's retrace count) and no round-loop key the warmup did
    not run (the port's graph cache key)."""
    from kubernetes_tpu_torch.ops import device_loop

    def script(pkg):
        s = _sched(pkg, pkg.config.ScenarioConfig(pack=pack, fill_block=1),
                   warmup=pkg.config.WarmupConfig(enabled=True,
                                                  pod_buckets=(8,)),
                   enable_preemption=False)
        _cluster(pkg, s, n=4, zones=2)
        compiled = s.warmup(sample_pods=[pkg.testing.make_pod(
            "warm", cpu_milli=500, memory=2**30)])
        keys0 = set(device_loop.KEYS)
        for i in range(6):
            s.on_pod_add(pkg.testing.make_pod(
                f"p{i}", cpu_milli=500, memory=2**30,
                pod_group="g" if pack == "gang-topology" else "",
                pod_group_min_available=6 if pack == "gang-topology"
                else 0))
        r = s.schedule_cycle()
        new_keys = (set(device_loop.KEYS) - keys0) if pkg is PORT else set()
        return (compiled, r.scheduled, r.scenario_quality["placed"],
                s.obs.jax.retrace_total(), sorted(map(repr, new_keys)))

    compiled, scheduled, placed, retraces, new_keys = both(script)
    assert compiled >= 1 and scheduled == placed == 6
    assert retraces == 0 and new_keys == []


def test_quality_cycle_pays_one_readback_more_than_its_twin():
    """A quality-on cycle reads back exactly once more than the same
    cycle without a pack's quality (the ``scenario-quality`` site)."""
    out = []
    for quality in (False, True):
        s = _sched(PORT, tconfig.ScenarioConfig(pack="consolidation",
                                                fill_block=1,
                                                quality=quality),
                   enable_preemption=False)
        _cluster(PORT, s, n=8)
        for i in range(12):
            s.on_pod_add(ttesting.make_pod(f"p{i}", cpu_milli=500,
                                           memory=2**30))
        r = s.schedule_cycle()
        out.append((r.host_syncs, r.assignments))
    assert out[1][0] == out[0][0] + 1
    assert out[1][1] == out[0][1]


def test_cost_term_stays_on_the_tables_device():
    """The pack's cost and the weight tensor live on the tables' device;
    a new cost weight is new data in the same tensor shape."""
    pack = tscen.resolve_pack(tconfig.ScenarioConfig(pack="consolidation"))
    w1 = pack.weight_on(torch.device("cpu"))
    assert w1.shape == () and w1.dtype == torch.float32
    assert pack.weight_on(torch.device("cpu")) is w1
    pack.config = dataclasses.replace(pack.config, cost_weight=3.0)
    w2 = pack.weight_on(torch.device("cpu"))
    assert float(w2) == 3.0 and w2.shape == w1.shape
