"""The slice as a whole: one event sequence fed to the JAX package's
``Scheduler(pipeline_depth=1)`` and to the port's
``Scheduler(device="cpu")`` binds the same pods to the same nodes, cycle
by cycle, with the same ``CycleResult`` failure reasons, FitError texts
and round counts — on the chip smoke cell shrunk to 64 nodes and 512
pods, through node and pod churn, on every ladder tier the port runs."""

import dataclasses

import pytest

from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu_torch import scheduler as tsched
from kubernetes_tpu_torch.kernels import KernelError
from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler
from torch_parity import pref_affinity_cluster, to_port


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
    from kubernetes_tpu.testing import make_node, make_pod

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
