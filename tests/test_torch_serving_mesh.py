"""The composed serving posture on the mesh, the port against the JAX
package: ``ServingRuntime`` driving a mesh-backed scheduler through churn,
one takeover and one shard loss on a fake clock (``run_once`` with an
immediate-flush window), and the satellites around it (backend pressure,
the runtime's warmup adaptation, the host-fallback warmup, the shard-loss
fault, the warmup/serving config, gang atomicity across a shard loss).

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``,
the port on logical meshes of the CPU device. Each case runs one script
through both packages and compares what it returns: every bind, the
snapshot modes, the chaos report, the retrace counts. The port adds the
round-loop graph keys: after warmup, no cycle of the arc presents a key
the warmup did not (on the card: no capture), the cooloff's included."""

from __future__ import annotations

import dataclasses
import types

import pytest
import torch

import kubernetes_tpu.api.config_v1alpha1 as jv1
import kubernetes_tpu.chaos as jchaos
import kubernetes_tpu.cli as jcli
import kubernetes_tpu.config as jconfig
import kubernetes_tpu.faults as jfaults
import kubernetes_tpu.leaderelection as jle
import kubernetes_tpu.scheduler as jscheduler
import kubernetes_tpu.serving as jserving
import kubernetes_tpu.testing as jtesting
import kubernetes_tpu_torch.api.config_v1alpha1 as tv1
import kubernetes_tpu_torch.chaos as tchaos
import kubernetes_tpu_torch.cli as tcli
import kubernetes_tpu_torch.config as tconfig
import kubernetes_tpu_torch.faults as tfaults
import kubernetes_tpu_torch.leaderelection as tle
import kubernetes_tpu_torch.parallel.mesh as tmesh
import kubernetes_tpu_torch.scheduler as tscheduler
import kubernetes_tpu_torch.serving as tserving
import kubernetes_tpu_torch.testing as ttesting
from kubernetes_tpu_torch.ops import device_loop

CPU = torch.device("cpu")
POD_CPU = 50.0
POD_MEM = 128 * 2**20

REF = types.SimpleNamespace(
    chaos=jchaos, cli=jcli, config=jconfig, faults=jfaults, le=jle,
    scheduler=jscheduler, serving=jserving, testing=jtesting, v1=jv1, kw={})
PORT = types.SimpleNamespace(
    chaos=tchaos, cli=tcli, config=tconfig, faults=tfaults, le=tle,
    scheduler=tscheduler, serving=tserving, testing=ttesting, v1=tv1,
    kw={"device": "cpu"})


@pytest.fixture(autouse=True)
def eight_logical_devices(monkeypatch):
    monkeypatch.setattr(tmesh, "local_devices",
                        lambda kind="cuda": [CPU] * 8)


def both(script):
    want, got = script(REF), script(PORT)
    assert got == want, (got, want)
    return got


class FakeClock:
    def __init__(self, t: float = 100.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class Truth:
    """The hub's Binding subresource in miniature: a CAS'd bind truth
    where a second bind of the same key raises and counts."""

    def __init__(self) -> None:
        self.bound: dict = {}
        self.created: dict = {}
        self.double_bind_attempts = 0

    def binder(self):
        truth = self

        class _B:
            def bind(self, pod, node_name):
                if pod.key() in truth.bound:
                    truth.double_bind_attempts += 1
                    raise RuntimeError(f"{pod.key()} double bind")
                truth.bound[pod.key()] = node_name

        return _B()

    def lister(self):
        return [dataclasses.replace(pod, node_name=self.bound.get(key, ""))
                for key, pod in self.created.items()]


def _replica(pkg, mesh, clk, truth, nodes=8):
    s = pkg.scheduler.Scheduler(
        clock=clk, enable_preemption=False, binder=truth.binder(),
        parallel=pkg.config.ParallelConfig(mesh=mesh),
        recovery=pkg.config.RecoveryConfig(device_reset_limit=1,
                                           device_cooloff_s=5.0),
        warmup=pkg.config.WarmupConfig(enabled=True, pod_buckets=(8, 16)),
        **pkg.kw)
    for i in range(nodes):
        s.on_node_add(pkg.testing.make_node(f"n{i}", cpu_milli=64000,
                                            memory=256 * 2**30, pods=500))
    # max_wait 0: every observe with pending depth flushes at once, so
    # run_once never parks on the (real-time) doorbell
    rt = pkg.serving.ServingRuntime(
        s, pkg.config.ServingConfig(enabled=True, min_wait_s=0.0,
                                    max_wait_s=0.0, target_bucket=16,
                                    idle_wait_s=0.05),
        clock=clk)
    compiled = rt.warm_if_pending(sample_pods=[
        pkg.testing.make_pod("warm", cpu_milli=POD_CPU, memory=POD_MEM)])
    assert compiled > 0
    return rt


def _composed(pkg, mesh):
    """The reference's composed smoke: churn on the leader with the
    standby fed by informer, a leader kill and takeover onto the mesh,
    a shard lost mid-churn, the cooloff and the sharded heal."""
    clk = FakeClock()
    truth = Truth()
    le = pkg.config.LeaderElectionConfig(lease_duration_s=2.0,
                                         renew_deadline_s=1.4,
                                         retry_period_s=0.3)
    lock = pkg.le.InMemoryLock()
    device_loop.KEYS.clear()
    a = _replica(pkg, mesh, clk, truth)
    b = _replica(pkg, mesh, clk, truth)
    warmed = set(device_loop.KEYS)
    device_loop.KEYS.clear()
    ea = pkg.le.LeaderElector("a", lock, le, clk)
    eb = pkg.le.LeaderElector("b", lock, le, clk)
    a.attach_elector(ea, lister=truth.lister)
    b.attach_elector(eb, lister=truth.lister)
    b_watchers = [b.hub.register() for _ in range(2)]
    with a.loop.lock:
        assert ea.tick()
    seq = [0]
    arc = []

    def churn(rt, n_pods, peer=None):
        batch = []
        for _ in range(n_pods):
            p = pkg.testing.make_pod(f"c{seq[0]}", cpu_milli=POD_CPU,
                                     memory=POD_MEM)
            truth.created[p.key()] = p
            seq[0] += 1
            batch.append(p)
        for rep in (rt, peer) if peer is not None else (rt,):
            for p in batch:
                rep.loop.ingest(rep.sched.on_pod_add, p)
        res = rt.loop.run_once()
        assert res is not None and res.scheduled == n_pods
        if peer is not None:
            for key, node in res.assignments.items():
                old = truth.created[key]
                peer.loop.ingest(peer.sched.on_pod_update, old,
                                 dataclasses.replace(old, node_name=node))
        rec = rt.sched.obs.recorder.records()[-1]
        arc.append((res.snapshot_mode, res.solver_tier, rec.mesh,
                    rec.batch_shape))
        clk.advance(0.25)
        return res

    for n in (3, 5, 8, 2):
        with a.loop.lock:
            assert ea.tick()
        churn(a, n, peer=b)
    evicted_before = b.hub.stats()["evicted"]
    clk.advance(3.0)  # past the lease decay (no graceful release)
    acquired = False
    for _ in range(30):
        with b.loop.lock:
            if eb.tick():
                acquired = True
                break
        clk.advance(le.retry_period_s)
    assert acquired
    assert b.sched.metrics.recovery_takeovers.value() >= 1
    assert b.hub.stats()["evicted"] >= evicted_before + len(b_watchers)
    _, _, mode = b.sched.cache.device_snapshot()
    takeover = (mode in ("full", "clean"), _width(pkg, b.sched))
    for n in (4, 8):
        with b.loop.lock:
            assert eb.tick()
        churn(b, n)
    chaos = pkg.chaos.MeshChaos(b.sched, shard=1)
    chaos.lose_shard(clk())
    with b.loop.lock:
        assert eb.tick()
    chaos.observe(churn(b, 6), clk())
    clk.advance(6.0)  # past device_cooloff_s: the heal probe fires
    with b.loop.lock:
        assert eb.tick()
    chaos.observe(churn(b, 5), clk())
    if pkg is PORT:
        # every round-loop key of the arc (takeover, cooloff, heal) was
        # warmed: on the card the whole arc captures nothing
        assert device_loop.KEYS and device_loop.KEYS <= warmed
    return (arc, takeover, chaos.report(), _width(pkg, b.sched),
            truth.double_bind_attempts, dict(truth.bound),
            sorted(truth.created),
            a.sched.obs.jax.retrace_total(), b.sched.obs.jax.retrace_total())


def _width(pkg, sched):
    _, dev, _ = sched.cache.device_snapshot()
    if pkg is PORT:
        return tmesh.mesh_size(sched.cache.resident_mesh)
    return int(dev.allocatable.sharding.mesh.devices.size)


@pytest.mark.parametrize("mesh", [2, 4])
def test_composed_churn_takeover_shard_loss_smoke(mesh):
    (arc, takeover, rep, width, doubles, bound, created, ra,
     rb) = both(lambda pkg: _composed(pkg, mesh))
    assert takeover == (True, mesh)
    assert [m for m, *_ in arc[-2:]] == ["host", "full"]
    assert [r[2] for r in arc] == [mesh] * 6 + [0, mesh]
    assert all(r[3].endswith(f"+mesh{mesh}") for r in arc if r[2])
    assert rep["healed_sharded"] and rep["host_mode_cycles"] == 1
    assert rep["shard_losses_fired"] == 2 and width == mesh
    assert doubles == 0 and sorted(bound) == created
    assert ra == rb == 0
    # the single-device replay of the same batches binds identically
    truth = Truth()
    s = tscheduler.Scheduler(
        clock=FakeClock(), enable_preemption=False, binder=truth.binder(),
        warmup=tconfig.WarmupConfig(enabled=True, pod_buckets=(8, 16)),
        device="cpu")
    for i in range(8):
        s.on_node_add(ttesting.make_node(f"n{i}", cpu_milli=64000,
                                         memory=256 * 2**30, pods=500))
    seq = 0
    for n in (3, 5, 8, 2, 4, 8, 6, 5):
        for _ in range(n):
            s.on_pod_add(ttesting.make_pod(f"c{seq}", cpu_milli=POD_CPU,
                                           memory=POD_MEM))
            seq += 1
        assert s.schedule_cycle().scheduled == n
    assert truth.bound == bound


# ---------------------------------------------------------------------------
# satellites: backend pressure, the runtime's adaptation, host fallback
# ---------------------------------------------------------------------------


def test_backend_pressure_reads_ladder_and_queue():
    def script(pkg):
        clk = FakeClock()
        s = pkg.scheduler.Scheduler(clock=clk, enable_preemption=False,
                                    **pkg.kw)
        s.on_node_add(pkg.testing.make_node("n0"))
        for i in range(6):
            s.queue.add(pkg.testing.make_pod(f"p{i}", cpu_milli=10))
        out = [s.backend_pressure()]
        s.last_solver_tier = "greedy"
        s.last_solver_fallbacks = 2
        out += [s.is_degraded(), s.backend_pressure(degraded_factor=4.0)]
        s.last_solver_tier = "batch"
        s.last_solver_fallbacks = 0
        out.append(s.is_degraded())
        s._device_cooloff_until = clk() + 10
        out += [s.is_degraded(), s.backend_pressure(degraded_factor=10.0)]
        return out

    assert both(script) == [6.0, True, 24.0, False, True, 60.0]


def test_serving_runtime_wires_saturation_to_backend_pressure():
    def script(pkg):
        clk = FakeClock()
        s = pkg.scheduler.Scheduler(clock=clk, enable_preemption=False,
                                    **pkg.kw)
        s.on_node_add(pkg.testing.make_node("n0"))
        rt = pkg.serving.ServingRuntime(
            s, pkg.config.ServingConfig(enabled=True, target_bucket=16,
                                        shed_queue_bound=8,
                                        degraded_pressure_factor=10.0),
            clock=clk)
        out = [rt.shed_bound()]
        for i in range(4):
            s.queue.add(pkg.testing.make_pod(f"q{i}", cpu_milli=10))
        rt.flow.release(rt.flow.acquire("mutating"))
        s._device_cooloff_until = clk() + 60
        with pytest.raises(pkg.serving.RequestRejected):
            rt.flow.acquire("mutating")
        s._device_cooloff_until = 0.0
        rt.flow.release(rt.flow.acquire("mutating"))
        for i in range(8):
            s.queue.add(pkg.testing.make_pod(f"r{i}", cpu_milli=10))
        with pytest.raises(pkg.serving.RequestRejected):
            rt.flow.acquire("mutating")
        return out

    assert both(script) == [8]


@pytest.mark.parametrize("mesh", [None, 2])
def test_runtime_auto_shed_bound_and_warmup_adaptation(mesh):
    """Serving extends the warmup grid down to the micro-batch floor; a
    mesh-backed scheduler gains the host-fallback sweep (a shard loss
    must not capture on the hot path). Auto shed bound = two targets."""
    def script(pkg):
        par = (pkg.config.ParallelConfig(mesh=mesh) if mesh is not None
               else None)
        s = pkg.scheduler.Scheduler(clock=FakeClock(), enable_preemption=False,
                                    parallel=par,
                                    warmup=pkg.config.WarmupConfig(
                                        enabled=True), **pkg.kw)
        rt = pkg.serving.ServingRuntime(
            s, pkg.config.ServingConfig(enabled=True, target_bucket=64),
            clock=FakeClock())
        return (s.warmup_config.min_bucket, s.warmup_config.host_fallback,
                rt.shed_bound(), s.metrics.mesh_devices.value())

    assert both(script) == (8, mesh is not None, 128, mesh or 0)


@pytest.mark.parametrize("host_fallback", [True, False])
def test_host_fallback_warmup_covers_cooloff_cycles(host_fallback):
    """With host_fallback the device-loss cooloff cycle solves on warmed
    single-device signatures (no retrace); without it the cooloff cycle
    meets signatures the warmup never saw. On the port the same holds of
    the round-loop graphs: the mesh sweep warms the partitioned program,
    whose keys carry the shard count, so only the host-fallback sweep
    warms the cooloff's unsharded graphs."""
    def script(pkg):
        fi = pkg.faults.FaultInjector(seed=0)
        s = pkg.scheduler.Scheduler(
            clock=FakeClock(), enable_preemption=False, fault_injector=fi,
            parallel=pkg.config.ParallelConfig(mesh=4),
            recovery=pkg.config.RecoveryConfig(device_reset_limit=1,
                                               device_cooloff_s=5.0),
            warmup=pkg.config.WarmupConfig(enabled=True, pod_buckets=(8,),
                                           host_fallback=host_fallback),
            **pkg.kw)
        s.on_node_add(pkg.testing.make_node("n0", cpu_milli=64000,
                                            pods=200))
        device_loop.KEYS.clear()
        compiled = s.warmup(sample_pods=[pkg.testing.make_pod(
            "w", cpu_milli=10)])
        warmed = set(device_loop.KEYS)
        device_loop.KEYS.clear()
        # armed AFTER the warmup: the loss lands on the hot path
        fi.arm("snapshot:device", "shard_lost", count=2)
        s.on_pod_add(pkg.testing.make_pod("p0", cpu_milli=10))
        res = s.schedule_cycle()
        rec = s.obs.recorder.records()[-1]
        if pkg is PORT:
            assert device_loop.KEYS
            assert (device_loop.KEYS <= warmed) is host_fallback
        return (compiled, res.snapshot_mode, res.scheduled, rec.mesh,
                s.obs.jax.retrace_total() > 0)

    compiled, mode, scheduled, mesh, retraced = both(script)
    assert (mode, scheduled, mesh) == ("host", 1, 0)
    assert compiled == (2 if host_fallback else 1)
    assert retraced is not host_fallback


def test_shard_lost_carries_mesh_index():
    def script(pkg):
        fi = pkg.faults.FaultInjector().arm("snapshot:device", "shard_lost",
                                            count=1, shard=3)
        with pytest.raises(pkg.faults.ShardLost) as ei:
            fi.device_hook("snapshot:device")
        return (ei.value.shard, isinstance(ei.value, pkg.faults.DeviceLost),
                fi.device_hook("snapshot:device"))

    assert both(script) == (3, True, None)


def test_warmup_host_fallback_config_round_trips():
    def script(pkg):
        dc, vc = pkg.cli.decode_config, pkg.cli.validate_config
        cfg = dc({"warmup": {"enabled": True, "host_fallback": True},
                  "serving": {"enabled": True, "shed_queue_bound": 32,
                              "degraded_pressure_factor": 2.5}})
        doc = pkg.v1.encode(cfg)
        back = pkg.v1.decode(doc)
        return (cfg.warmup.host_fallback, cfg.serving.shed_queue_bound,
                cfg.serving.degraded_pressure_factor, vc(cfg),
                doc["warmup"]["hostFallback"],
                doc["serving"]["shedQueueBound"],
                doc["serving"]["degradedPressureFactor"],
                back.warmup.host_fallback, back.serving.shed_queue_bound,
                vc(dc({"serving": {"shed_queue_bound": -1}})),
                vc(dc({"serving": {"degraded_pressure_factor": 0.5}})))

    got = both(script)
    assert got[:9] == (True, 32, 2.5, [], True, 32, 2.5, True, 32)
    assert any("shedQueueBound" in e for e in got[9])
    assert any("degradedPressureFactor" in e for e in got[10])


def test_gang_atomicity_under_shard_loss():
    """The gang-topology pack churns all-or-nothing gangs through a live
    shard loss (loss, host-mode cooloff, sharded heal): after every cycle
    each gang is bound whole or not at all."""
    gang = 8

    def script(pkg):
        clk = FakeClock()
        truth = Truth()
        s = pkg.scheduler.Scheduler(
            clock=clk, enable_preemption=False, binder=truth.binder(),
            parallel=pkg.config.ParallelConfig(mesh=2),
            recovery=pkg.config.RecoveryConfig(device_reset_limit=1,
                                               device_cooloff_s=5.0),
            warmup=pkg.config.WarmupConfig(enabled=True, pod_buckets=(8,),
                                           host_fallback=True),
            scenario=pkg.config.ScenarioConfig(pack="gang-topology"),
            **pkg.kw)
        for i in range(8):
            s.on_node_add(pkg.testing.make_node(
                f"n{i}", cpu_milli=64000, memory=256 * 2**30, pods=500,
                zone=f"slice-{i % 4}"))
        assert s.warmup(sample_pods=[pkg.testing.make_pod(
            "warm", cpu_milli=POD_CPU, memory=POD_MEM)]) > 0
        out = []

        def churn_one_gang(g):
            for m in range(gang):
                p = pkg.testing.make_pod(
                    f"g{g}m{m}", cpu_milli=POD_CPU, memory=POD_MEM,
                    pod_group=f"gang{g}", pod_group_min_available=gang)
                truth.created[p.key()] = p
                s.on_pod_add(p)
            r = s.schedule_cycle()
            clk.advance(0.25)
            per_gang = {}
            for key in truth.created:
                g = key.split("/")[-1].split("m")[0]
                per_gang.setdefault(g, [0, 0])
                per_gang[g][0] += 1
                per_gang[g][1] += key in truth.bound
            assert all(b in (0, t) for t, b in per_gang.values())
            out.append((r.snapshot_mode, r.scheduled,
                        r.scenario_quality.get("gang_partial_binds"),
                        s.obs.recorder.records()[-1].mesh))
            return r

        chaos = pkg.chaos.MeshChaos(s, shard=1)
        for g in range(2):
            chaos.observe(churn_one_gang(g), clk())
        chaos.lose_shard(clk())
        chaos.observe(churn_one_gang(2), clk())
        clk.advance(6.0)
        chaos.observe(churn_one_gang(3), clk())
        return (out, chaos.report(), truth.double_bind_attempts,
                dict(truth.bound), s.obs.jax.retrace_total())

    out, rep, doubles, _bound, retraces = both(script)
    assert [o[0] for o in out][2] == "host"
    assert all(o[1] == gang for o in out)
    assert [o[3] for o in out] == [2, 2, 0, 2]
    assert all(o[2] in (0, None) for o in out)
    assert rep["healed_sharded"] and rep["host_mode_cycles"] == 1
    assert doubles == 0 and retraces == 0
