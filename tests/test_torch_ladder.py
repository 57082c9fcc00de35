"""The degradation ladder of the PyTorch port held against the JAX
package's: the cases of ``tests/test_fault_injection.py`` (each fault kind
at each tier, the breaker's transitions, the deadline skip, retries, a
total outage, the fallback oracle) run through both packages'
``Scheduler`` with identically seeded ``FaultInjector`` s, and the tiers,
placements, failure reasons, events and metric counts must be equal. A
kernel fault (``kernels.KernelError``) is the port's own case: it must
reach the caller through every retry, tier and breaker."""

import random

import pytest

import pyref
from kubernetes_tpu.testing import make_node, make_pod
from kubernetes_tpu_torch import faults as tfaults
from kubernetes_tpu_torch.config import RobustnessConfig as TRobustness
from kubernetes_tpu_torch.kernels import KernelError
from kubernetes_tpu_torch.ops.sync import SYNCS
from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler
from torch_parity import FakeClock, Pair, pref_affinity_cluster, to_port


# -- units: breaker + retry ---------------------------------------------------


@pytest.mark.parametrize("pkg", ["kubernetes_tpu", "kubernetes_tpu_torch"])
def test_circuit_breaker_state_machine(pkg):
    import importlib

    f = importlib.import_module(f"{pkg}.faults")
    clk = FakeClock()
    transitions = []
    br = f.CircuitBreaker(failure_threshold=2, open_duration_s=10.0,
                          half_open_probes=1, clock=clk,
                          on_transition=lambda o, n: transitions.append(
                              (o, n)))
    assert br.state == f.CLOSED and br.allow()
    br.record_failure()
    assert br.state == f.CLOSED
    br.record_failure()
    assert br.state == f.OPEN and not br.allow()
    clk.advance(9.0)
    assert not br.allow()
    clk.advance(2.0)
    assert br.allow() and br.state == f.HALF_OPEN
    assert not br.allow()
    br.record_failure()
    assert br.state == f.OPEN
    clk.advance(11.0)
    assert br.allow()
    br.record_success()
    assert br.state == f.CLOSED and br.allow()
    assert transitions == [
        (f.CLOSED, f.OPEN), (f.OPEN, f.HALF_OPEN), (f.HALF_OPEN, f.OPEN),
        (f.OPEN, f.HALF_OPEN), (f.HALF_OPEN, f.CLOSED)]


def test_retry_policy_backoff_is_the_references():
    from kubernetes_tpu.faults import RetryPolicy as JRetry

    sleeps = ([], [])
    for k, R in enumerate((JRetry, tfaults.RetryPolicy)):
        rp = R(max_retries=3, base_s=0.1, max_s=0.5, jitter=0.5, seed=42,
               sleep=sleeps[k].append)
        with pytest.raises(ConnectionError):
            rp.call(lambda: (_ for _ in ()).throw(ConnectionError("x")))
        assert rp.retries == 3
    assert sleeps[1] == sleeps[0] and len(sleeps[1]) == 3


# -- the satellite pin: the reference's default ladder ------------------------


@pytest.mark.parametrize("count, tier", [(1, "batch"), (None, "batch-cpu")])
def test_default_ladder_retries_then_solves_on_batch_cpu_like_the_reference(
        count, tier):
    """At the defaults (``solver_retries=1``, ``fallback_chain=
    ("batch-cpu", "greedy")``) a transient ``solve:batch`` fault is
    retried on the same tier, and a persistent one solves the batch with
    the batch solver on CPU tensors — as the reference does, never the
    greedy oracle."""
    nodes, bound, pending = pref_affinity_cluster(3, n_nodes=16, n_bound=8,
                                                  n_pending=24)
    pair = Pair(arm=[("solve:batch", "crash", count)], seed=1,
                rc={}, clocks=(lambda: 0.0, lambda: 0.0))
    pair.feed(nodes, bound + pending)
    rt = pair.cycle()
    assert rt.solver_tier == tier and rt.scheduled >= len(pending) - 1
    want = (["batch", "batch"] if count == 1
            else ["batch", "batch", "batch-cpu"])
    assert rt.tier_attempts == want


# -- every fault kind at every tier -------------------------------------------

FAULT_KINDS = ("timeout", "connection", "crash", "device_lost", "device_oom",
               "partial", "stale", "garbage", "nan", "infeasible")

#: tier under test -> (configured solver, armed site pattern)
TIER_SITES = {"batch": ("batch", "solve:batch"),
              "batch-cpu": ("batch", "solve:batch*"),
              "sinkhorn": ("sinkhorn", "solve:sinkhorn"),
              "exact": ("exact", "solve:exact"),
              "greedy": ("greedy", "solve:greedy")}


@pytest.mark.parametrize("tier", list(TIER_SITES))
@pytest.mark.parametrize("kind", FAULT_KINDS)
def test_every_fault_kind_at_every_tier_degrades_like_the_reference(
        monkeypatch, kind, tier):
    # the sinkhorn tier: the reference's Pallas kernels in interpret mode,
    # the transport plan the port's kernels are held to
    monkeypatch.setenv("KTPU_PALLAS", "1")
    solver, site = TIER_SITES[tier]
    pair = Pair(arm=[(site, kind, None)], seed=11, solver=solver)
    # infeasible poisoning routes everything to node 0: one node cannot
    # hold the batch, so the lie is detectable
    pair.fill(n_nodes=6, n_pods=18, cpu=600)
    rt = pair.cycle()
    if tier == "greedy":
        # the floor itself failed: the batch requeues, nothing binds
        assert rt.solver_tier == "" and rt.scheduled == 0
        assert set(rt.failure_reasons.values()) == {("SolverUnavailable",)}
    else:
        assert rt.scheduled == 18
        assert rt.solver_tier == ("greedy" if tier == "batch-cpu"
                                  else "batch-cpu")
    assert pair.inj[1].fired == pair.inj[0].fired


def test_faults_off_uses_batch_path_unchanged():
    pair = Pair()
    pair.fill()
    rt = pair.cycle()
    assert rt.solver_tier == "batch" and rt.solver_fallbacks == 0
    assert rt.tier_attempts == ["batch"]
    assert not pair.s[1].metrics.solver_fallbacks._values


@pytest.mark.parametrize("rc", [{"solver_retries": 0},
                                {"solver_retries": 0, "host_validate": True}])
def test_validation_catches_a_lying_solver_on_device_and_host(rc):
    pair = Pair(arm=[("solve:batch", "infeasible", 1)], seed=3, rc=rc)
    pair.fill(n_nodes=4, n_pods=12, cpu=900)
    rt = pair.cycle()
    assert rt.scheduled == 12 and rt.solver_tier == "batch-cpu"
    assert {k[1] for k in pair.s[1].metrics.solver_rejections._values} == {
        "capacity"}


def test_transient_fault_recovers_via_in_cycle_retry():
    pair = Pair(arm=[("solve:batch", "timeout", 1)], seed=5,
                rc={"solver_retries": 1})
    pair.fill()
    rt = pair.cycle()
    assert rt.solver_tier == "batch" and rt.solver_fallbacks == 0
    assert pair.s[1].metrics.solver_retries.value(tier="batch") == 1


def test_breaker_opens_emits_degraded_event_and_recovers():
    pair = Pair(arm=[("solve:batch*", "crash", 4)], seed=9,
                rc={"solver_retries": 0, "breaker_failure_threshold": 2,
                    "breaker_open_duration_s": 30.0})
    pair.feed([make_node(f"n{i}", cpu_milli=8000) for i in range(4)])
    for cyc in range(3):
        pair.feed(pods=[make_pod(f"p{cyc}", cpu_milli=100)])
        rt = pair.cycle()
        assert rt.scheduled == 1 and rt.solver_tier == "greedy"
        pair.advance(1.0)
    # cycle 3 ran with both breakers open: shed without an attempt
    assert rt.tier_attempts == ["batch:shed", "batch-cpu:shed", "greedy"]
    assert pair.s[1]._breakers["solver:batch"].state == tfaults.OPEN
    assert any(r == "SchedulerDegraded" for r, _, _ in pair.events[1])
    # past the open duration the half-open probe solves for real
    pair.advance(60.0)
    pair.feed(pods=[make_pod("probe", cpu_milli=100)])
    rt = pair.cycle()
    assert rt.solver_tier == "batch" and rt.scheduled == 4
    assert pair.s[1]._breakers["solver:batch"].state == tfaults.CLOSED
    assert any(r == "SchedulerRecovered" for r, _, _ in pair.events[1])


def test_total_outage_requeues_batch_without_stalling():
    pair = Pair(arm=[("solve:*", "crash", None)], seed=13)
    pair.feed([make_node("n0")], [make_pod("p0", cpu_milli=100)])
    rt = pair.cycle()
    assert rt.failure_reasons["default/p0"] == ("SolverUnavailable",)
    for inj in pair.inj:
        inj.rules.clear()
    for s in pair.s:
        s.queue.move_all_to_active()
    pair.advance(10.0)
    assert pair.cycle().scheduled == 1


def test_deadline_blown_jumps_to_sequential_oracle():
    class TickingClock:
        def __init__(self):
            self.t = 0.0

        def __call__(self):
            self.t += 1.0
            return self.t

        def advance(self, dt):
            self.t += dt

    pair = Pair(rc={"cycle_deadline_s": 1e-3, "solver_retries": 0},
                clocks=(TickingClock(), TickingClock()))
    pair.fill(n_nodes=4, n_pods=8)
    rt = pair.cycle()
    assert rt.solver_tier == "greedy" and rt.scheduled == 8
    assert rt.tier_attempts == ["batch:shed", "greedy"]
    assert pair.s[1].metrics.deadline_exceeded.value() == 1


def test_fallback_placements_match_sequential_oracle():
    """With every batch-tier call poisoned the ladder lands on the greedy
    oracle, whose placements equal the reference's serial scheduler pod
    for pod."""
    for seed in range(3):
        rng = random.Random(4200 + seed)
        nodes = [make_node(f"n{i}", cpu_milli=rng.choice([2000, 4000, 8000]),
                           memory=rng.choice([4, 8]) * 2 ** 30,
                           zone=f"z{i % 3}") for i in range(12)]
        pending = [make_pod(f"p{i}", cpu_milli=rng.choice([100, 300, 700]),
                            memory=rng.choice([1, 2]) * 2 ** 28,
                            priority=rng.choice([0, 0, 100]),
                            labels={"app": f"a{i % 4}"}) for i in range(30)]
        pair = Pair(arm=[("solve:batch*", "garbage", None)], seed=seed)
        pair.feed(nodes, pending)
        rt = pair.cycle()
        assert rt.solver_tier == "greedy"
        want = pyref.serial_schedule(pending, nodes, [])
        for i, pod in enumerate(pending):
            exp = nodes[want[i][0]].name if want[i][0] >= 0 else None
            assert rt.assignments.get(pod.key()) == exp


def test_batch_cpu_copies_the_tables_as_one_counted_transfer():
    s = TScheduler(device="cpu", enable_preemption=False, clock=FakeClock(),
                   fault_injector=tfaults.FaultInjector().arm(
                       "solve:batch", "crash"),
                   robustness=TRobustness(solver_retries=0),
                   retry_sleep=lambda _s: None)
    for i in range(4):
        s.on_node_add(to_port(make_node(f"n{i}", cpu_milli=4000)))
    for i in range(8):
        s.on_pod_add(to_port(make_pod(f"p{i}", cpu_milli=300)))
    b0 = SYNCS.cpu_bytes
    r = s.schedule_cycle()
    assert r.solver_tier == "batch-cpu" and r.scheduled == 8
    assert SYNCS.cpu_bytes > b0
    # the solve's validated readback plus the table copy
    assert r.host_syncs >= 2


class _KernelFaultAfterCrash(tfaults.FaultInjector):
    """The first ``solve:batch`` attempt crashes (a solver fault: the
    ladder retries); the retry hits a broken kernel."""

    def solver_hook(self, site, assigned, usage, rounds, n_nodes):
        self.calls = getattr(self, "calls", 0) + 1
        if self.calls == 1:
            raise tfaults.SolverCrash("injected crash")
        raise KernelError("injected kernel fault")


def test_kernel_error_propagates_through_a_retry_and_open_breakers():
    s = TScheduler(device="cpu", enable_preemption=False, clock=FakeClock(),
                   fault_injector=_KernelFaultAfterCrash(),
                   robustness=TRobustness(solver_retries=1),
                   retry_sleep=lambda _s: None)
    s.on_node_add(to_port(make_node("n0", cpu_milli=4000)))
    s.on_pod_add(to_port(make_pod("p0", cpu_milli=100)))
    with pytest.raises(KernelError, match="injected kernel fault"):
        s.schedule_cycle()
    # a kernel fault is not a tier failure: no fallback was counted
    assert not s.metrics.solver_fallbacks._values
