"""The metric families the port registered but never set (ROADMAP C.1)
and the Sinkhorn convergence families it never observed (C.2), held
against the JAX package on the CPU, sample for sample.

C.1: ``scheduler_unschedulable_pods_total`` and
``scheduler_unschedulable_node_counts`` (the explain report's counts),
``scheduler_incremental_cycles_total``,
``scheduler_incremental_reuse_fraction`` and
``scheduler_incremental_invalidations_total`` (the sparse routes' scope
counts and the warm state's drops), and the preemption histogram
``scheduler_scheduling_algorithm_preemption_evaluation_seconds``, which
reads the scheduler's injected clock as the reference's does.

C.2: ``scheduler_sinkhorn_iterations`` and
``scheduler_sinkhorn_final_residual``: the stats ride the solve's own
readback. Iterations are compared exactly, the residual at the Sinkhorn
tolerance of tests/test_torch_sinkhorn.py (``atol=1e-5, rtol=1e-4``).

The device backends of observability, exactly:
``scheduler_cycle_model_efficiency``, ``scheduler_cycle_phase_seconds``,
``scheduler_slo_burn_rate`` (the perf ledger and its watchdog, over
cycles whose spans a fake clock sets), and
``scheduler_device_memory_bytes{kind="modeled"}``,
``scheduler_memory_model_efficiency`` and
``scheduler_memory_preflight_total`` (the memory ledger, through driven
cycles that split, shed and fit against the same injected bucket table).
The measured series of ``scheduler_device_memory_bytes`` (the CPU census)
are each package's own and are not compared.

The scenario packs' families, exactly: ``scheduler_scenario_quality``,
``scheduler_scenario_cascade_victims_total``,
``scheduler_scenario_displaced_replaced_total``,
``scheduler_scenario_repacks_total`` and
``scheduler_scenario_repack_drained_total``, over a consolidation cycle,
a cascade and a re-pack sweep."""

import dataclasses
import random

import pytest

from kubernetes_tpu.testing import make_node, make_pod
from test_sinkhorn import tied_preferences_workload
from torch_parity import (
    FakeClock,
    drive_pair,
    feed_cluster,
    incremental_cluster,
    incremental_pair,
    scheduler_pair,
    to_port,
)

ATOL, RTOL = 1e-5, 1e-4


def _samples(sched, attr):
    """One family's exposition lines (its samples; HELP/TYPE excluded)."""
    return getattr(sched.metrics, attr).expose()


def _same_family(js, ts, attr):
    got, want = _samples(ts, attr), _samples(js, attr)
    assert got == want, (attr, got, want)
    return got


# ---------------------------------------------------------------------------
# C.1
# ---------------------------------------------------------------------------


def test_unschedulable_families_match_the_reference():
    """ROADMAP C.1's first seeded input: 4 nodes of 1 CPU, 6 pods of
    500m and 3 of 4000m; both schedule 6 and fail 3."""
    js, ts = scheduler_pair(enable_preemption=False)
    nodes = [make_node(f"n{i}", cpu_milli=1000, memory=2**30)
             for i in range(4)]
    pods = ([make_pod(f"s{i}", cpu_milli=500) for i in range(6)]
            + [make_pod(f"b{i}", cpu_milli=4000) for i in range(3)])
    feed_cluster(js, ts, nodes, pods)
    rj, rt = js.schedule_cycle(), ts.schedule_cycle()
    assert (rt.scheduled, rt.unschedulable) == (rj.scheduled,
                                                rj.unschedulable) == (6, 3)
    pods_total = _same_family(js, ts, "unschedulable_pods")
    assert pods_total == [
        'scheduler_unschedulable_pods_total{reason="PodFitsResources"} 3.0']
    counts = _same_family(js, ts, "unschedulable_node_counts")
    assert counts == [
        'scheduler_unschedulable_node_counts{reason="PodFitsResources"} '
        '12.0']
    # the failed pods leave: an idle cycle retires the report and zeroes
    # the gauge on both
    for i in range(3):
        js.on_pod_delete(pods[6 + i])
        ts.on_pod_delete(to_port(pods[6 + i]))
    js.schedule_cycle(), ts.schedule_cycle()
    assert _same_family(js, ts, "unschedulable_node_counts") == [
        'scheduler_unschedulable_node_counts{reason="PodFitsResources"} '
        '0.0']


def test_incremental_families_match_the_reference():
    """ROADMAP C.1's second seeded input: the 96-node cluster, four
    cycles of 8 pods of 100m, every one scope ``full``."""
    js, ts = incremental_pair()
    nodes = incremental_cluster()
    cycles = [[("node_add", nd) for nd in nodes]] + [[] for _ in range(3)]
    for c in range(4):
        cycles[c] += [("pod_add", make_pod(f"p{c}-{i}", cpu_milli=100))
                      for i in range(8)]
    got = drive_pair(js, ts, cycles)
    assert [r.solve_scope for r in got] == ["full"] * 4
    assert _same_family(js, ts, "incremental_cycles") == [
        'scheduler_incremental_cycles_total{scope="full"} 4.0']
    assert _same_family(js, ts, "incremental_reuse_fraction") == [
        "scheduler_incremental_reuse_fraction 0.0"]


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("primary", [False, True])
def test_incremental_scopes_and_invalidations_match_through_churn(primary,
                                                                  seed):
    """Restricted cycles, a node add (a full snapshot that drops the warm
    state), an under-placed restricted cycle and a dirty-frac blowout:
    every scope count, the reuse gauge and every invalidation reason."""
    rng = random.Random(seed)
    js, ts = incremental_pair(solver="sinkhorn", primary=primary,
                              candidate_bucket=32, max_dirty_frac=0.05)
    js.cache.max_dirty_frac = ts.cache.max_dirty_frac = 0.5

    def batch(tag, n):
        return [("pod_add", make_pod(f"{tag}{i}",
                                     cpu_milli=rng.choice([50, 100, 250])))
                for i in range(n)]

    nodes = incremental_cluster(hetero=False)
    cycles = [
        [("node_add", nd) for nd in nodes] + batch("a", 3),
        batch("b", 4),
        batch("c", 2),
        [("node_add", make_node("late", cpu_milli=64000,
                                memory=256 * 2**30, pods=500))]
        + batch("d", 3),
        batch("e", 2),
        [("pod_add", make_pod("giant", cpu_milli=10_000_000))]
        + batch("f", 2),
        [("node_update", make_node(f"n{i}", cpu_milli=64000,
                                   memory=256 * 2**30, pods=499))
         for i in range(10)] + batch("g", 2),
        batch("h", 3),
    ]
    got = drive_pair(js, ts, cycles)
    scopes = [r.solve_scope for r in got]
    assert "restricted" in scopes
    for attr in ("incremental_cycles", "incremental_reuse_fraction",
                 "incremental_invalidations"):
        _same_family(js, ts, attr)
    inval = _samples(ts, "incremental_invalidations")
    assert any('reason="full-snapshot"' in s for s in inval), inval
    assert any('reason="dirty-frac"' in s for s in inval), inval
    assert any('scope="under-placed"' in s
               for s in _samples(ts, "incremental_cycles"))


def test_preemption_histogram_reads_the_injected_clock():
    """Under a fake clock the preemption pass takes 0 s on both: the
    histogram is observed on the scheduler's clock, not on the host's
    wall clock."""
    js, ts = scheduler_pair(enable_preemption=True, pipeline_depth=1)
    clocks = FakeClock(5.0), FakeClock(5.0)
    js.clock, ts.clock = clocks
    nodes = [make_node(f"n{i}", cpu_milli=1000) for i in range(2)]
    low = [make_pod(f"low{i}", cpu_milli=1000, priority=0,
                    node_name=f"n{i}") for i in range(2)]
    high = [make_pod(f"high{i}", cpu_milli=600, priority=100)
            for i in range(2)]
    feed_cluster(js, ts, nodes, low + high)
    rj, rt = js.schedule_cycle(), ts.schedule_cycle()
    assert rt.preempted == rj.preempted and rt.preempted
    got = _same_family(js, ts, "preemption_duration")
    assert got[-1].endswith(" 1") and got[-2].endswith(" 0.0"), got


# ---------------------------------------------------------------------------
# C.2
# ---------------------------------------------------------------------------


def _sinkhorn_families(js, ts):
    """Iterations exactly; the residual within the Sinkhorn tolerance."""
    its = _same_family(js, ts, "sinkhorn_iterations")
    got, want = (_samples(ts, "sinkhorn_residual"),
                 _samples(js, "sinkhorn_residual"))
    assert [s.rsplit(" ", 1)[0] for s in got] == [
        s.rsplit(" ", 1)[0] for s in want]
    for g, w in zip(got, want):
        a, b = float(g.rsplit(" ", 1)[1]), float(w.rsplit(" ", 1)[1])
        assert a == pytest.approx(b, abs=ATOL, rel=RTOL), (g, w)
    return its, got


def test_sinkhorn_families_match_the_reference_on_the_probe():
    """ROADMAP C.2's seeded probe: 8 nodes of 4 CPU, 24 pods of 500m, one
    sinkhorn cycle: the reference observes 1 sample of 2 iterations and a
    residual of 0."""
    js, ts = scheduler_pair(solver="sinkhorn", enable_preemption=False)
    nodes = [make_node(f"n{i}", cpu_milli=4000, memory=2**33)
             for i in range(8)]
    feed_cluster(js, ts, nodes,
                 [make_pod(f"p{i}", cpu_milli=500) for i in range(24)])
    rj, rt = js.schedule_cycle(), ts.schedule_cycle()
    assert (rt.scheduled, rt.solver_tier) == (rj.scheduled,
                                              rj.solver_tier) == (24,
                                                                  "sinkhorn")
    its, res = _sinkhorn_families(js, ts)
    assert "scheduler_sinkhorn_iterations_count 1" in its
    assert "scheduler_sinkhorn_iterations_sum 2.0" in its
    assert res == ["scheduler_sinkhorn_final_residual 0.0"]
    # the stats rode the solve's one readback: no read of their own
    assert rt.host_syncs == 1
    rec = ts.obs.recorder.records()[-1]
    assert (rec.sinkhorn_iters, rec.sinkhorn_residual) == (2.0, 0.0)


@pytest.mark.parametrize("solver", ["batch", "sinkhorn"])
def test_sinkhorn_families_match_on_tied_preferences(solver):
    """The tied-preference workload (tests/test_sinkhorn.py): the batch
    solver's round router engages the plan on its tie-contended cohort,
    the sinkhorn solver plans every round."""
    nodes, pods, _ = tied_preferences_workload()
    js, ts = scheduler_pair(solver=solver, enable_preemption=False,
                            per_node_cap=2, pipeline_depth=1)
    feed_cluster(js, ts, nodes, pods)
    rj, rt = js.schedule_cycle(), ts.schedule_cycle()
    assert rt.assignments == rj.assignments
    its, _ = _sinkhorn_families(js, ts)
    assert "scheduler_sinkhorn_iterations_count 1" in its


# ---------------------------------------------------------------------------
# the device backends: the perf ledger and the memory ledger
# ---------------------------------------------------------------------------


def _feed(cycle_result, s, clk, cycle, latencies, solve_s):
    obs = s.obs
    obs.begin_cycle(cycle)
    obs.note_batch_shape("P8xN8" if cycle % 3 else "P16xN8")
    with obs.span("snapshot"):
        clk.advance(solve_s / 4)
    with obs.span("solve:batch"):
        clk.advance(solve_s)
        if cycle % 2:
            with obs.span("validate"):
                clk.advance(solve_s / 8)
    res = cycle_result(
        attempted=max(len(latencies), 1), scheduled=len(latencies),
        rounds=1 + cycle % 2, solver_tier="batch",
        e2e_latency_s={f"e{cycle}-{i}": v for i, v in enumerate(latencies)})
    obs.end_cycle(res)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ledger_families_match_the_reference(seed):
    """Seeded cycles through both facades (the spans set on one fake
    clock each): the efficiency and modeled-cost gauges, the per-phase
    gauge and both windows of both objectives' burn rates, after every
    cycle."""
    import kubernetes_tpu.config as jconfig
    import kubernetes_tpu.scheduler as jscheduler
    import kubernetes_tpu_torch.config as tconfig
    import kubernetes_tpu_torch.scheduler as tscheduler

    out = []
    for config, sched in ((jconfig, jscheduler), (tconfig, tscheduler)):
        rng = random.Random(seed)
        clk = FakeClock(100.0)
        s = sched.Scheduler(
            enable_preemption=False, clock=clk,
            observability=config.ObservabilityConfig(
                ledger=config.LedgerConfig(
                    e2e_p99_objective_s=0.05, cost_drift_ratio=2.0,
                    fast_window_s=4.0, slow_window_s=16.0)),
            **({"device": "cpu"} if sched is tscheduler else {}))
        rows = []
        for c in range(40):
            slow = rng.random() < 0.3
            lat = [rng.expovariate(10.0 if slow else 100.0)
                   for _ in range(rng.randrange(0, 5))]
            _feed(sched.CycleResult, s, clk, c, lat,
                  rng.expovariate(50.0 if slow else 500.0))
            clk.advance(rng.uniform(0.1, 1.0))
            rows.append([_samples(s, a) for a in (
                "cycle_model_efficiency", "cycle_modeled_cost",
                "cycle_phase_seconds", "slo_burn_rate")])
        out.append(rows)
    assert out[1] == out[0]
    last = out[1][-1]
    assert any('phase="validate"' in line for line in last[2])
    assert any('objective="cost_drift"' in line for line in last[3])


def _table(s, totals):
    ml = s.obs.memledger
    for P, total in totals.items():
        ml.record_bucket_memory(P, 8, 0, {"argument_bytes": 1,
                                          "output_bytes": 2,
                                          "temp_bytes": 3, "code_bytes": 0,
                                          "alias_bytes": 0,
                                          "total_bytes": total})


def _modeled(lines):
    return [line for line in lines if 'kind="modeled"' in line]


def test_memory_families_match_the_reference():
    """Cycles that fit, split and shed against the same injected bucket
    table: the preflight counter by action and the modeled resident bytes
    after every cycle, and the efficiency gauge (-1 on the sample-free
    cycles that follow the first, as in the reference)."""
    js, ts = scheduler_pair(enable_preemption=False)
    rng = random.Random(3)
    nodes = [make_node(f"n{i}", cpu_milli=16000, memory=2**35)
             for i in range(4)]
    feed_cluster(js, ts, nodes, [])
    for s in (js, ts):
        _table(s, {8: 400, 16: 900, 32: 1800})
    rows = []
    for c, (n, limit) in enumerate(((6, 1000), (16, 1000), (20, 999),
                                    (4, 100), (3, 0), (30, 2100))):
        pods = [make_pod(f"c{c}-{i}", cpu_milli=rng.choice((50, 100, 200)))
                for i in range(n)]
        feed_cluster(js, ts, [], pods)
        for s in (js, ts):
            s.obs.memledger.config.limit_bytes = limit
        rj, rt = js.schedule_cycle(), ts.schedule_cycle()
        assert (rt.attempted, rt.assignments) == (rj.attempted,
                                                  rj.assignments)
        # the first boundary samples (the efficiency then divides by a
        # measured census, each package's own); the later ones are
        # sample-free on the constant clock and publish -1 in both
        eff = "memory_model_efficiency"
        got = [_samples(ts, "memory_preflight"),
               _modeled(_samples(ts, "device_memory_bytes")),
               _samples(ts, eff) if c else len(_samples(ts, eff))]
        want = [_samples(js, "memory_preflight"),
                _modeled(_samples(js, "device_memory_bytes")),
                _samples(js, eff) if c else len(_samples(js, eff))]
        assert got == want, (c, got, want)
        rows.append(got)
    counts = {line.split('"')[1]: float(line.split()[-1])
              for line in rows[-1][0]}
    assert counts["split"] >= 1 and counts["shed"] >= 1
    assert counts["ok"] >= 1
    assert rows[-1][2] == ["scheduler_memory_model_efficiency -1.0"]


# ---------------------------------------------------------------------------
# the scenario packs' families
# ---------------------------------------------------------------------------

SCENARIO_FAMILIES = ("scenario_quality", "scenario_cascade_victims",
                     "scenario_displaced_replaced", "scenario_repacks",
                     "scenario_repack_drained")


def _confirm(s, res):
    """Relay the bind confirmations a watch stream would deliver."""
    for key, node in dict(res.assignments).items():
        cached = s.cache.pod(key)
        if cached is not None:
            s.on_pod_update(cached, dataclasses.replace(cached,
                                                        node_name=node))


@pytest.mark.parametrize("seed", [1, 2])
def test_scenario_families_match_the_reference(seed):
    """The five ``scheduler_scenario_*`` families, sample for sample,
    after a seeded consolidation cycle, a cascade (victims evicted and
    re-placed in the same cycle) and a re-pack sweep on a fake clock."""
    import kubernetes_tpu.config as jconfig
    import kubernetes_tpu_torch.config as tconfig
    from kubernetes_tpu.scheduler import Scheduler as JScheduler
    from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler

    rng = random.Random(seed)
    clocks = (FakeClock(), FakeClock())

    def build(S, clock, cfg, **kw):
        return S(clock=clock, scenario=cfg.ScenarioConfig(
            pack="consolidation", fill_block=1, preempt_in_batch=True,
            repack_interval_s=5.0, repack_max_pods=4), **kw)

    js = build(JScheduler, clocks[0], jconfig)
    ts = build(TScheduler, clocks[1], tconfig, device="cpu")
    nodes = [make_node(f"n{i}", cpu_milli=4000, memory=8 * 2**30)
             for i in range(6)]
    bound = [make_pod(f"low{i}", cpu_milli=rng.choice([600, 800]),
                      memory=2**28, node_name=f"n{i % 6}")
             for i in range(8)]
    feed_cluster(js, ts, nodes, bound)
    # a consolidation cycle (it also arms the re-pack cadence)
    pods = [make_pod(f"p{i}", cpu_milli=rng.choice([200, 300]),
                     memory=2**28) for i in range(10)]
    feed_cluster(js, ts, [], pods)
    rj, rt = js.schedule_cycle(), ts.schedule_cycle()
    assert rt.assignments == rj.assignments
    assert rt.scenario_quality["placed"] == 10
    for attr in SCENARIO_FAMILIES:
        _same_family(js, ts, attr)
    _confirm(js, rj)
    _confirm(ts, rt)
    # a cascade: a preemptor that fits nowhere without evictions
    feed_cluster(js, ts, [], [make_pod("high", cpu_milli=3900,
                                       memory=2**28, priority=100)])
    rj, rt = js.schedule_cycle(), ts.schedule_cycle()
    assert (rt.preempted, rt.assignments) == (rj.preempted, rj.assignments)
    assert rt.preempted > 0 and "default/high" in rt.assignments
    victims = _same_family(js, ts, "scenario_cascade_victims")
    assert victims == [
        f"scheduler_scenario_cascade_victims_total {float(rt.preempted)}"]
    for attr in SCENARIO_FAMILIES:
        _same_family(js, ts, attr)
    _confirm(js, rj)
    _confirm(ts, rt)
    # a re-pack sweep, an interval after the cadence armed
    for c in clocks:
        c.advance(6.0)
    drained = (ts.maybe_repack(), js.maybe_repack())
    assert drained[0] == drained[1] > 0
    sweeps = _same_family(js, ts, "scenario_repacks")
    assert sweeps == ["scheduler_scenario_repacks_total 1.0"]
    for attr in SCENARIO_FAMILIES:
        _same_family(js, ts, attr)
