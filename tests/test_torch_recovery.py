"""The port's crash, failover and device-loss recovery held against the
JAX package: ``chaos.HAReplica`` failovers on the simulated cluster, the
resident snapshot's rebuild after a device loss, the host-mode cooloff
and its heal, the ladder absorbing a solver-side loss, the warmup's abort,
the recovery configuration's decodes, host mode placing as the resident
mode does, and a ``kernels.KernelError`` that no recovery path may take
for a device loss. Each case runs one script through both packages (the
port on CPU tensors) and compares what it returns."""

import dataclasses
import types

import pytest

import kubernetes_tpu.api.config_v1alpha1 as jv1
import kubernetes_tpu.cache as jcache
import kubernetes_tpu.chaos as jchaos
import kubernetes_tpu.cli as jcli
import kubernetes_tpu.config as jconfig
import kubernetes_tpu.faults as jfaults
import kubernetes_tpu.scheduler as jscheduler
import kubernetes_tpu.sim as jsim
import kubernetes_tpu.testing as jtesting
import kubernetes_tpu_torch.api.config_v1alpha1 as tv1
import kubernetes_tpu_torch.cache as tcache
import kubernetes_tpu_torch.chaos as tchaos
import kubernetes_tpu_torch.cli as tcli
import kubernetes_tpu_torch.config as tconfig
import kubernetes_tpu_torch.faults as tfaults
import kubernetes_tpu_torch.scheduler as tscheduler
import kubernetes_tpu_torch.sim as tsim
import kubernetes_tpu_torch.testing as ttesting
from kubernetes_tpu_torch import kernels

REF = types.SimpleNamespace(
    cache=jcache, chaos=jchaos, cli=jcli, config=jconfig, faults=jfaults,
    scheduler=jscheduler, sim=jsim, testing=jtesting, v1=jv1, kw={})
PORT = types.SimpleNamespace(
    cache=tcache, chaos=tchaos, cli=tcli, config=tconfig, faults=tfaults,
    scheduler=tscheduler, sim=tsim, testing=ttesting, v1=tv1,
    kw={"device": "cpu"})


def both(script):
    want, got = script(REF), script(PORT)
    assert got == want, (got, want)
    return got


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _le(pkg):
    return pkg.config.LeaderElectionConfig(
        lease_duration_s=15, renew_deadline_s=10, retry_period_s=2)


def _hub(pkg, seed):
    return pkg.sim.HollowCluster(seed=seed, scheduler_kw=dict(pkg.kw))


def _replica(pkg, name, hub):
    return pkg.chaos.HAReplica(name, hub, _le(pkg),
                               scheduler_kw=dict(pkg.kw))


# ---------------------------------------------------------------------------
# HAReplica failovers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_failover_leader_kill_mid_churn(seed):
    """The leader dies mid-churn; the standby takes over after the lease
    decays, reconciles and finishes the queue: the reference's bindings,
    zero double binds, zero leaks."""
    def script(pkg):
        hub = _hub(pkg, seed)
        for i in range(4):
            hub.add_node(pkg.testing.make_node(f"n{i}", cpu_milli=4000))
        clk = hub.clock
        a, b = _replica(pkg, "a", hub), _replica(pkg, "b", hub)
        for i in range(6):
            hub.create_pod(pkg.testing.make_pod(f"pre{i}", cpu_milli=500))
        for _ in range(3):
            a.tick()
            b.tick()
            clk.advance(2)
        before = (a.cycles, b.cycles)
        for i in range(6):
            hub.create_pod(pkg.testing.make_pod(f"mid{i}", cpu_milli=500))
        a.kill()
        for _ in range(14):
            b.tick()
            clk.advance(2)
        hub.check_consistency()
        return {"before": before, "leader": b.elector.is_leader(),
                "b_cycles": b.cycles,
                "takeovers": b.sched.metrics.recovery_takeovers.value(),
                "bound_total": hub.bound_total,
                "bound": {k: p.node_name for k, p in hub.truth_pods.items()},
                "conflicts": hub.binder.conflicts,
                "leaked": (a.sched.cache.assumed_keys(),
                           b.sched.cache.assumed_keys())}

    got = both(script)
    assert got["before"][0] > 0 and got["before"][1] == 0
    assert got["leader"] and got["b_cycles"] > 0 and got["takeovers"] >= 1
    assert got["bound_total"] == 12 and all(got["bound"].values())
    assert got["conflicts"] == 0 and got["leaked"] == ([], [])


def test_failover_graceful_release_skips_lease_decay():
    def script(pkg):
        hub = _hub(pkg, 21)
        a, b = _replica(pkg, "a", hub), _replica(pkg, "b", hub)
        a.tick()
        b.tick()
        out = [a.elector.is_leader(), b.elector.is_leader()]
        a.shutdown()
        out.append(a.elector.is_leader())
        b.tick()  # no clock advance: the released record is expired
        rec, _ = hub.get_lease("kube-system", "kube-scheduler")
        return out + [b.elector.is_leader(), rec.holder_identity]

    assert both(script) == [True, False, False, True, "b"]


def test_failover_cas_race_rejects_cleanly():
    def script(pkg):
        hub = _hub(pkg, 22)
        hub.add_node(pkg.testing.make_node("n0", cpu_milli=4000))
        hub.add_node(pkg.testing.make_node("n1", cpu_milli=4000))
        a = _replica(pkg, "a", hub)
        a.tick()
        hub.create_pod(pkg.testing.make_pod("raced", cpu_milli=100))
        a.reflector.pump()
        hub.confirm_binding(hub.truth_pods["default/raced"], "n1")
        assert a.elector.tick()
        a.sched.schedule_cycle()
        out = [hub.truth_pods["default/raced"].node_name, hub.bound_total,
               hub.binder.conflicts, a.sched.cache.is_assumed("default/raced")]
        for _ in range(3):
            hub.clock.advance(2)
            a.tick()
        return out + [hub.bound_total, hub.binder.conflicts,
                      a.sched.queue.pod("default/raced") is None]

    got = both(script)
    assert got[:2] == ["n1", 1] and got[2] >= 1 and got[3] is False
    assert got[4] == 1 and got[6]


# ---------------------------------------------------------------------------
# device loss
# ---------------------------------------------------------------------------


def test_device_loss_rebuilds_resident_snapshot():
    def script(pkg):
        fi = pkg.faults.FaultInjector(seed=0).arm(
            "snapshot:device", "device_lost", count=1)
        s = pkg.scheduler.Scheduler(clock=FakeClock(), enable_preemption=False,
                                    fault_injector=fi, **pkg.kw)
        s.on_node_add(pkg.testing.make_node("n0"))
        s.on_pod_add(pkg.testing.make_pod("p0"))
        res = s.schedule_cycle()
        return (res.scheduled, res.snapshot_mode,
                s.metrics.recovery_device_resets.value(),
                fi.fired_total("snapshot:device"))

    assert both(script) == (1, "full", 1, 1)

    # the reset lands on the cycle's flight record with the memory
    # ledger's forensic flag, and the ranked record in its ring, as the
    # reference's (a second loss, once the node table was resident)
    def forensic(pkg):
        fi = pkg.faults.FaultInjector(seed=0)
        s = pkg.scheduler.Scheduler(clock=FakeClock(), enable_preemption=False,
                                    fault_injector=fi, **pkg.kw)
        s.on_node_add(pkg.testing.make_node("n0"))
        for i in range(2):
            if i:
                fi.arm("snapshot:device", "device_lost", count=1)
            s.on_pod_add(pkg.testing.make_pod(f"p{i}"))
            s.schedule_cycle()
        rec = s.obs.recorder.records()[-1]
        return (rec.device_resets, rec.oom_forensic,
                [{k: v for k, v in o.items()
                  if k not in ("measured_bytes", "watermarks", "error")}
                 for o in s.obs.memledger.oom_records()])

    resets, flag, ooms = both(forensic)
    assert resets == 1 and flag.startswith("oom@snapshot:device top=")
    assert ooms[0]["top_residents"][0]["name"] == "cache.node_table"


@pytest.mark.parametrize("kind", ["device_lost", "device_oom"])
def test_device_loss_cooloff_then_heal(kind):
    """A persistent outage exhausts the per-cycle rebuild budget: host
    mode for device_cooloff_s, degraded meanwhile; once the cooloff passes
    and the device heals, the resident path resumes."""
    def script(pkg):
        fi = pkg.faults.FaultInjector(seed=0).arm("snapshot:device", kind,
                                                  count=4)
        clk = FakeClock()
        s = pkg.scheduler.Scheduler(
            clock=clk, enable_preemption=False, fault_injector=fi,
            recovery=pkg.config.RecoveryConfig(device_reset_limit=1,
                                               device_cooloff_s=5.0),
            **pkg.kw)
        s.on_node_add(pkg.testing.make_node("n0", cpu_milli=64000,
                                            pods=200))
        out = []
        for i in range(4):
            s.on_pod_add(pkg.testing.make_pod(f"p{i}", cpu_milli=10))
            res = s.schedule_cycle()
            out.append((res.scheduled, res.snapshot_mode, s.is_degraded()))
            clk.advance(6)
        return out, s.metrics.recovery_device_resets.value(), \
            dict(s.metrics.snapshot_packs._values)

    modes, resets, _ = both(script)
    assert [m[1] for m in modes[:3]] == ["host", "host", "full"]
    assert modes[3][1] != "host" and all(m[0] == 1 for m in modes)
    assert modes[0][2] and not modes[2][2] and resets == 4


def test_cooloff_cycles_stay_in_host_mode_until_the_clock_passes():
    """Inside the cooloff every cycle runs in host mode without probing the
    device (the injector is not consulted), and the process tally counts
    the resets and the host-mode cycles."""
    def script(pkg):
        fi = pkg.faults.FaultInjector(seed=0).arm(
            "snapshot:device", "device_lost", count=3)
        clk = FakeClock()
        s = pkg.scheduler.Scheduler(
            clock=clk, enable_preemption=False, fault_injector=fi,
            recovery=pkg.config.RecoveryConfig(device_reset_limit=2,
                                               device_cooloff_s=30.0),
            **pkg.kw)
        for i in range(3):
            s.on_node_add(pkg.testing.make_node(f"n{i}", cpu_milli=8000))
        out = []
        for step in range(4):
            s.on_pod_add(pkg.testing.make_pod(f"p{step}", cpu_milli=100))
            res = s.schedule_cycle()
            out.append((res.snapshot_mode, dict(res.assignments),
                        s.is_degraded(), fi.fired_total("snapshot:device")))
            clk.advance(12)
        return out

    tscheduler.RECOVERY.reset()
    got = both(script)
    assert [g[0] for g in got] == ["host", "host", "host", "full"]
    assert [g[2] for g in got] == [True, True, True, False]
    assert tscheduler.RECOVERY.device_resets == 3
    assert tscheduler.RECOVERY.host_cycles == 3


def test_device_loss_in_solver_absorbed_by_ladder():
    def script(pkg):
        fi = pkg.faults.FaultInjector(seed=0).arm("solve:batch",
                                                  "device_lost")
        s = pkg.scheduler.Scheduler(clock=FakeClock(), enable_preemption=False,
                                    fault_injector=fi, **pkg.kw)
        s.on_node_add(pkg.testing.make_node("n0"))
        s.on_pod_add(pkg.testing.make_pod("p0"))
        res = s.schedule_cycle()
        return res.scheduled, res.solver_tier, res.solver_fallbacks >= 1

    assert both(script) == (1, "batch-cpu", True)


def test_device_loss_aborts_warmup_cleanly():
    def script(pkg):
        fi = pkg.faults.FaultInjector(seed=0).arm("warmup:compile",
                                                  "device_oom", count=1)
        s = pkg.scheduler.Scheduler(
            clock=FakeClock(), enable_preemption=False, fault_injector=fi,
            warmup=pkg.config.WarmupConfig(enabled=True, pod_buckets=(8, 16)),
            **pkg.kw)
        s.on_node_add(pkg.testing.make_node("n0"))
        sample = [pkg.testing.make_pod("w", cpu_milli=10)]
        first = s.warmup(sample_pods=sample)
        resets = s.metrics.recovery_device_resets.value()
        dropped = not s.cache.has_device_snapshot()
        again = s.warmup(sample_pods=sample)
        s.on_pod_add(pkg.testing.make_pod("p0", cpu_milli=10))
        res = s.schedule_cycle()
        return first, resets, dropped, again, dict(res.assignments), \
            res.snapshot_mode

    assert both(script) == (0, 1, True, 2, {"default/p0": "n0"}, "clean")


class _KernelFaultInjector:
    """Duck-typed injector whose device seams raise a KernelError, as a
    hand kernel that cannot build or launch would."""

    def device_hook(self, site):
        raise kernels.KernelError(f"injected kernel fault at {site}")

    def solver_hook(self, site, assigned, usage, rounds, n_nodes):
        return assigned, usage, rounds


def test_kernel_error_is_never_taken_for_a_device_loss():
    """A KernelError escapes _device_snapshot_recovering (so the cycle)
    and the warmup: no reset is counted, no host mode entered."""
    s = tscheduler.Scheduler(clock=FakeClock(), enable_preemption=False,
                             fault_injector=_KernelFaultInjector(),
                             device="cpu")
    s.on_node_add(ttesting.make_node("n0"))
    s.on_pod_add(ttesting.make_pod("p0"))
    with pytest.raises(kernels.KernelError):
        s._device_snapshot_recovering()
    with pytest.raises(kernels.KernelError):
        s.schedule_cycle()
    s2 = tscheduler.Scheduler(
        clock=FakeClock(), enable_preemption=False, device="cpu",
        warmup=tconfig.WarmupConfig(enabled=True, pod_buckets=(8,)))
    s2.on_node_add(ttesting.make_node("n0"))
    s2.fault_injector = _KernelFaultInjector()  # after the snapshot seam
    with pytest.raises(kernels.KernelError):
        s2.warmup(sample_pods=[ttesting.make_pod("w", cpu_milli=10)])
    for sched in (s, s2):
        assert sched.metrics.recovery_device_resets.value() == 0
        assert sched._device_cooloff_until == 0.0


def test_a_cuda_out_of_memory_error_takes_the_device_loss_path():
    """torch.cuda.OutOfMemoryError is a RuntimeError: a real one out of the
    resident snapshot resets and rebuilds like the injected device_oom."""
    import torch

    class OOMOnce:
        fired = 0

        def device_hook(self, site):
            if not self.fired:
                self.fired += 1
                raise torch.cuda.OutOfMemoryError("CUDA out of memory")

        def solver_hook(self, site, assigned, usage, rounds, n_nodes):
            return assigned, usage, rounds

    s = tscheduler.Scheduler(clock=FakeClock(), enable_preemption=False,
                             fault_injector=OOMOnce(), device="cpu")
    s.on_node_add(ttesting.make_node("n0"))
    s.on_pod_add(ttesting.make_pod("p0"))
    res = s.schedule_cycle()
    assert res.scheduled == 1 and res.snapshot_mode == "full"
    assert s.metrics.recovery_device_resets.value() == 1


# ---------------------------------------------------------------------------
# host mode places as the resident mode does
# ---------------------------------------------------------------------------


def _churn(pkg, resident, seed=5):
    import random

    rng = random.Random(seed)
    s = pkg.scheduler.Scheduler(clock=FakeClock(), enable_preemption=False,
                                device_resident_snapshot=resident, **pkg.kw)
    zones = ("z0", "z1", "z2")
    for i in range(12):
        s.on_node_add(pkg.testing.make_node(
            f"n{i}", cpu_milli=4000, labels={
                "failure-domain.beta.kubernetes.io/zone": zones[i % 3]}))
    out, n = [], 0
    for cycle in range(5):
        for _ in range(rng.randrange(4, 12)):
            s.on_pod_add(pkg.testing.make_pod(
                f"p{n}", cpu_milli=rng.choice((100, 300, 700))))
            n += 1
        res = s.schedule_cycle()
        out.append((res.snapshot_mode, dict(res.assignments)))
        for key in list(res.assignments)[:2]:
            s.on_pod_delete(dataclasses.replace(
                s.cache.pod(key) or pkg.testing.make_pod(key.split("/")[1]),
                node_name=res.assignments[key]))
    return out


def test_host_mode_places_as_the_resident_mode_does():
    """``device_resident_snapshot=False`` (host mode every cycle) places
    every cycle of a churned cluster exactly as the resident snapshot
    does, in both packages."""
    host = both(lambda pkg: _churn(pkg, False))
    resident = both(lambda pkg: _churn(pkg, True))
    assert [m for m, _ in host] == ["host"] * 5
    assert [m for m, _ in resident][0] == "full"
    assert [a for _, a in host] == [a for _, a in resident]


def test_host_mode_from_a_config_file():
    def script(pkg):
        cfg = pkg.cli.decode_config({"device_resident_snapshot": False})
        s = pkg.scheduler.Scheduler.from_config(cfg, clock=FakeClock(),
                                                **pkg.kw)
        s.on_node_add(pkg.testing.make_node("n0"))
        s.on_pod_add(pkg.testing.make_pod("p0"))
        res = s.schedule_cycle()
        return (s.device_resident_snapshot, res.snapshot_mode,
                dict(res.assignments), s.cache.has_device_snapshot())

    assert both(script) == (False, "host", {"default/p0": "n0"}, False)


# ---------------------------------------------------------------------------
# the recovery configuration's decodes
# ---------------------------------------------------------------------------


def test_recovery_config_native_decode_and_validation():
    def script(pkg):
        cfg = pkg.cli.decode_config({"recovery": {
            "fenced_binds": False, "device_reset_limit": 4,
            "device_cooloff_s": 2.5}})
        bad = pkg.config.KubeSchedulerConfiguration(
            recovery=pkg.config.RecoveryConfig(device_reset_limit=-1,
                                               device_cooloff_s=-2))
        with pytest.raises(Exception):
            pkg.cli.decode_config({"recovery": {"nope": 1}})
        return (cfg.recovery, pkg.cli.validate_config(cfg),
                pkg.cli.validate_config(bad))

    rec, ok, errs = both(lambda pkg: _as_plain(script(pkg)))
    assert ok == [] and any("deviceResetLimit" in e for e in errs)
    assert any("deviceCooloff" in e for e in errs)


def _as_plain(out):
    rec, ok, errs = out
    return dataclasses.asdict(rec), ok, errs


def test_recovery_config_v1alpha1_round_trip():
    doc = {"apiVersion": "kubescheduler.config.k8s.io/v1alpha1",
           "kind": "KubeSchedulerConfiguration",
           "recovery": {"fencedBinds": False, "deviceCooloff": "1m30s",
                        "deviceResetLimit": 7,
                        "releaseLeaseOnShutdown": False}}

    def script(pkg):
        cfg = pkg.v1.decode(doc)
        enc = pkg.v1.encode(cfg)
        s = pkg.scheduler.Scheduler.from_config(cfg, **pkg.kw)
        return (dataclasses.asdict(cfg.recovery), enc["recovery"],
                pkg.v1.decode(enc).recovery == cfg.recovery,
                s.recovery.device_reset_limit,
                s.recovery.device_cooloff_s)

    rec, enc, same, limit, cooloff = both(script)
    assert rec["device_cooloff_s"] == 90.0 and enc["deviceCooloff"] == "1m30s"
    assert same and limit == 7 and cooloff == 90.0


# ---------------------------------------------------------------------------
# small public surfaces: run_until_settled, cleanup_expired, pod_states
# ---------------------------------------------------------------------------


def test_run_until_settled_matches_the_reference():
    def script(pkg):
        s = pkg.scheduler.Scheduler(clock=FakeClock(), enable_preemption=False,
                                    **pkg.kw)
        for i in range(3):
            s.on_node_add(pkg.testing.make_node(f"n{i}", cpu_milli=1000))
        for i in range(8):
            s.on_pod_add(pkg.testing.make_pod(f"p{i}", cpu_milli=400))
        return [(r.attempted, r.scheduled, dict(r.assignments))
                for r in s.run_until_settled(max_cycles=5)]

    got = both(script)
    assert got[-1][:2] == (0, 0) and sum(r[1] for r in got) == 6


def test_cache_cleanup_expired_and_pod_states_match_the_reference():
    def script(pkg):
        clk = FakeClock()
        c = pkg.cache.SchedulerCache(clock=clk, ttl_s=10.0, **pkg.kw)
        c.add_node(pkg.testing.make_node("n0"))
        c.add_pod(pkg.testing.make_pod("bound", node_name="n0"))
        for name in ("a", "b"):
            c.assume_pod(pkg.testing.make_pod(name), "n0")
        c.finish_binding("default/a")
        states = c.pod_states()
        early = c.cleanup_expired()
        clk.advance(11)
        late = c.cleanup_expired()
        return states, early, late, c.pod_states()

    assert both(script) == (
        {"default/bound": "bound", "default/a": "assumed",
         "default/b": "assumed"}, [], ["default/a"],
        {"default/bound": "bound", "default/b": "assumed"})
