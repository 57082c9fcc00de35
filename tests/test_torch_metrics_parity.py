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
tolerance of tests/test_torch_sinkhorn.py (``atol=1e-5, rtol=1e-4``)."""

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
