"""The port's hollow cluster (``kubernetes_tpu_torch/sim.py``) held
against the JAX package's: each case drives both packages'
``HollowCluster`` with one script (the same seed, the same nodes, pods
and controllers built from each package's own types), the reference
scheduler on JAX's CPU backend and the port's on CPU tensors. After every
step the two hubs must agree exactly on the truth bindings, every
object's resourceVersion, the global revision, the binder's conflicts,
the bind count and the Event registry (reason, object, count), and both
must pass ``check_consistency``."""

import types

import pytest

import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu.sim as jsim
import kubernetes_tpu.testing as jtesting
import kubernetes_tpu_torch.api.types as ttypes
import kubernetes_tpu_torch.sim as tsim
import kubernetes_tpu_torch.testing as ttesting

REF = types.SimpleNamespace(sim=jsim, testing=jtesting, types=jtypes, kw={})
PORT = types.SimpleNamespace(sim=tsim, testing=ttesting, types=ttypes,
                             kw={"device": "cpu"})


def hub_state(hub) -> dict:
    return {
        "bindings": {k: p.node_name for k, p in hub.truth_pods.items()},
        "resource_version": dict(hub.resource_version),
        "revision": hub._revision,
        "conflicts": hub.binder.conflicts,
        "bound_total": hub.bound_total,
        "events": sorted((k, e.reason, e.object_key, e.count)
                         for k, e in hub.events_v1.items()),
    }


def nodes(pkg, hub, n=16, cpu=4000):
    for i in range(n):
        hub.add_node(pkg.testing.make_node(f"n{i}", zone=f"z{i % 3}",
                                           cpu_milli=cpu))


def churn(pkg, tmp):
    hub = pkg.sim.HollowCluster(seed=42, scheduler_kw=dict(pkg.kw))
    nodes(pkg, hub)
    hub.add_replicaset(pkg.sim.ReplicaSet("web", replicas=40,
                                          cpu_milli=200))
    hub.add_replicaset(pkg.sim.ReplicaSet("db", replicas=8, cpu_milli=800,
                                          priority=100))
    for tick in range(12):
        hub.step()
        if tick % 3 == 2:
            hub.churn(kill_pods=6)
        yield hub


def flaky(pkg, tmp):
    hub = pkg.sim.HollowCluster(seed=5, bind_fail_rate=0.3,
                                scheduler_kw=dict(pkg.kw))
    nodes(pkg, hub)
    hub.add_replicaset(pkg.sim.ReplicaSet("web", replicas=48,
                                          cpu_milli=300))
    for _ in range(12):
        hub.step()
        yield hub


def flap(pkg, tmp):
    hub = pkg.sim.HollowCluster(seed=3, scheduler_kw=dict(pkg.kw))
    nodes(pkg, hub)
    hub.add_replicaset(pkg.sim.ReplicaSet("svc", replicas=60,
                                          cpu_milli=400))
    for tick in range(14):
        if tick in (3, 6):
            hub.churn(flap_nodes=2)
        if tick == 9:
            hub.add_node(pkg.testing.make_node("late", zone="z0",
                                               cpu_milli=8000))
        hub.step()
        yield hub


def delayed_competing(pkg, tmp):
    hub = pkg.sim.HollowCluster(seed=11, event_delay_ticks=2,
                                competing_bind_rate=0.2,
                                scheduler_kw=dict(pkg.kw))
    nodes(pkg, hub)
    hub.add_replicaset(pkg.sim.ReplicaSet("web", replicas=50,
                                          cpu_milli=250))
    for tick in range(14):
        hub.step()
        if tick % 4 == 3:
            hub.churn(kill_pods=5)
        yield hub


def kubelets(pkg, tmp):
    hub = pkg.sim.HollowCluster(seed=21, scheduler_kw=dict(pkg.kw))
    nodes(pkg, hub)
    hub.add_replicaset(pkg.sim.ReplicaSet("web", replicas=40,
                                          cpu_milli=300))
    hub.add_daemonset(pkg.sim.DaemonSet("agent"))
    for tick in range(16):
        if tick == 3:
            for name in ("n1", "n4", "n7"):
                hub.kill_kubelet(name)
        if tick == 12:
            for name in ("n1", "n4", "n7"):
                hub.heal_kubelet(name)
        hub.step()
        yield hub


def pdb_preemption(pkg, tmp):
    t = pkg.types
    hub = pkg.sim.HollowCluster(seed=13, scheduler_kw=dict(pkg.kw))
    nodes(pkg, hub, n=6, cpu=2000)
    hub.add_pdb(t.PodDisruptionBudget(
        name="guard", selector=t.LabelSelector(match_labels={"rs": "low"}),
        min_available=8))
    hub.add_replicaset(pkg.sim.ReplicaSet("low", replicas=12,
                                          cpu_milli=900))
    for tick in range(14):
        if tick == 4:
            hub.add_replicaset(pkg.sim.ReplicaSet(
                "high", replicas=5, cpu_milli=900, priority=100))
        hub.step()
        for key, p in list(hub.truth_pods.items()):
            if p.deletion_timestamp:
                hub.delete_pod(key)
        yield hub


def workloads(pkg, tmp):
    sim = pkg.sim
    hub = sim.HollowCluster(seed=17, scheduler_kw=dict(pkg.kw))
    nodes(pkg, hub)
    hub.add_deployment(sim.Deployment("web", replicas=12, cpu_milli=200))
    hub.add_daemonset(sim.DaemonSet("agent"))
    hub.add_statefulset(sim.StatefulSet("db", replicas=4))
    hub.add_job(sim.Job("batch", completions=6, parallelism=3,
                        duration_s=20.0))
    hub.add_cronjob(sim.CronJob("nightly", every_s=45.0, completions=2,
                                parallelism=2, duration_s=10.0))
    load = iter([0.9, 0.9, 1.2, 0.3] + [0.5] * 20)
    hub.add_hpa(sim.HorizontalPodAutoscaler(
        "web-hpa", deployment="web", min_replicas=4, max_replicas=30,
        load_fn=lambda: next(load)))
    for tick in range(16):
        if tick == 6:
            hub.deployments["web"].rollout(cpu_milli=250)
        if tick == 9:
            hub.statefulsets["db"].replicas = 2
        hub.step()
        yield hub


def checkpoint(pkg, tmp):
    hub = pkg.sim.HollowCluster(seed=29, competing_bind_rate=0.1,
                                scheduler_kw=dict(pkg.kw))
    nodes(pkg, hub)
    hub.add_replicaset(pkg.sim.ReplicaSet("web", replicas=30,
                                          cpu_milli=300))
    hub.add_statefulset(pkg.sim.StatefulSet("db", replicas=3))
    for _ in range(6):
        hub.step()
        yield hub
    path = str(tmp / f"{pkg.sim.__name__}.ckpt")
    hub.save_checkpoint(path)
    hub = pkg.sim.HollowCluster(seed=29, competing_bind_rate=0.1,
                                scheduler_kw=dict(pkg.kw))
    hub.restore_checkpoint(path)
    yield hub
    for tick in range(6):
        if tick == 2:
            hub.churn(kill_pods=4)
        hub.step()
        yield hub


SCENARIOS = [churn, flaky, flap, delayed_competing, kubelets,
             pdb_preemption, workloads, checkpoint]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_hollow_cluster_matches_reference_step_by_step(scenario, tmp_path):
    steps = 0
    for ref, port in zip(scenario(REF, tmp_path), scenario(PORT, tmp_path)):
        ref.check_consistency()
        port.check_consistency()
        want, got = hub_state(ref), hub_state(port)
        for field in want:
            assert got[field] == want[field], (steps, field)
        steps += 1
    assert steps >= 10
    assert want["bound_total"] > 0


def test_scenarios_exercise_what_they_name(tmp_path):
    """The scripts reach the paths they are named for (read on the port;
    the test above holds the reference to the same values)."""
    last = {f.__name__: list(f(PORT, tmp_path))[-1]
            for f in (flaky, delayed_competing, pdb_preemption, workloads)}
    assert last["flaky"].binder.failures > 0
    assert last["delayed_competing"].competing_bound > 0
    assert last["delayed_competing"].binder.conflicts > 0
    reasons = {e.reason for e in last["pdb_preemption"].events_v1.values()}
    assert "Preempted" in reasons
    wl = last["workloads"]
    assert wl.jobs["batch"].succeeded == 6
    assert wl.cronjobs["nightly"].runs >= 2
    assert wl.deployments["web"].replicas == 18  # the HPA's last answer
    assert sorted(k for k in wl.truth_pods if k.startswith("default/db-")) \
        == ["default/db-0", "default/db-1"]
    tainted = []
    for hub in kubelets(PORT, tmp_path):
        tainted.append(sum(
            any(t.key == hub.TAINT_UNREACHABLE for t in nd.taints)
            for nd in hub.truth_nodes.values()))
    # the killed nodes were tainted, their pods evicted and rebound
    # elsewhere, and the taints lifted once the kubelets healed
    assert max(tainted) == 3 and tainted[-1] == 0
    assert hub.bound_total > 40 + 16
