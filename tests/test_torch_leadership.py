"""The port's leadership and recovery (``kubernetes_tpu_torch/
leaderelection.py``, ``chaos.py`` and the scheduler's ``attach_elector``
/ ``reconcile`` / fence) against the JAX package's: the elector's
lifecycle on both locks, fenced binds, the drain when leadership stops,
takeover reconciliation, the stale-view conflicts, two replicas failing
over, and ``CrashLoop``'s invariant triple at the reference's seeds.
Each case runs the same script through both packages (the port on CPU
tensors) and compares counts and bindings."""

import dataclasses

import pytest

import kubernetes_tpu.framework as jfw
import kubernetes_tpu.leaderelection as jle
import kubernetes_tpu_torch.framework as tfw
import kubernetes_tpu_torch.leaderelection as tle
from kubernetes_tpu.config import LeaderElectionConfig as JLE
from kubernetes_tpu.config import RecoveryConfig as JRecovery
from kubernetes_tpu.scheduler import RecordingBinder as JBinder
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.testing import make_node, make_pod
from kubernetes_tpu_torch.config import LeaderElectionConfig as TLE
from kubernetes_tpu_torch.config import RecoveryConfig as TRecovery
from kubernetes_tpu_torch.scheduler import RecordingBinder as TBinder
from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler
from torch_parity import FakeClock, MiniHub, to_port

PKGS = {"jax": dict(le=jle, LE=JLE, S=JScheduler, B=JBinder, R=JRecovery,
                    fw=jfw, conv=lambda x: x, kw={}),
        "port": dict(le=tle, LE=TLE, S=TScheduler, B=TBinder, R=TRecovery,
                     fw=tfw, conv=to_port, kw={"device": "cpu"})}

_LE = dict(lease_duration_s=15, renew_deadline_s=10, retry_period_s=2)


def _both(fn):
    got = {pkg: fn(PKGS[pkg]) for pkg in PKGS}
    assert got["port"] == got["jax"], got
    return got["port"]


def _sched(P, clk, **kw):
    kw.setdefault("enable_preemption", False)
    return P["S"](clock=clk, **P["kw"], **kw)


def _lock(P, kind, tmp_path, tag):
    if kind == "memory":
        return P["le"].InMemoryLock()
    return P["le"].FileLock(str(tmp_path / f"{tag}.lease"))


# ---------------------------------------------------------------------------
# the elector on both locks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["memory", "file"])
def test_elector_epoch_and_allow_bind_lifecycle(kind, tmp_path):
    def script(P):
        clk = FakeClock()
        lock = _lock(P, kind, tmp_path, f"epoch-{P['le'].__name__}")
        el = P["le"].LeaderElector("me", lock, P["LE"](**_LE), clk)
        out = [el.epoch, el.allow_bind(), el.tick(), el.epoch,
               el.allow_bind()]
        clk.advance(9)
        out.append(el.allow_bind())
        clk.advance(2)
        out += [el.allow_bind(), el.tick(), el.allow_bind(), el.epoch]
        rival = P["le"].LeaderElector("rival", lock, P["LE"](**_LE), clk)
        out.append(rival.tick())
        clk.advance(16)
        out += [rival.tick(), el.tick()]
        clk.advance(16)
        out += [el.tick(), el.epoch, lock.get().holder_identity,
                lock.get().leader_transitions]
        return out

    assert _both(script) == [0, False, True, 1, True, True, False, True,
                             True, 1, False, True, False, True, 2, "me", 2]


@pytest.mark.parametrize("kind", ["memory", "file"])
def test_elector_release_is_immediate_and_never_clobbers(kind, tmp_path):
    def script(P):
        clk = FakeClock()
        tag = P["le"].__name__
        lock = _lock(P, kind, tmp_path, f"rel-{tag}")
        a = P["le"].LeaderElector("a", lock, P["LE"](**_LE), clk)
        b = P["le"].LeaderElector("b", lock, P["LE"](**_LE), clk)
        out = [a.tick(), b.tick(), a.release(), a.is_leader(),
               a.allow_bind(), b.tick(), b.is_leader(), a.release()]
        # a wedged ex-leader with a stale local flag must not clobber its
        # successor's live lease
        lock2 = _lock(P, kind, tmp_path, f"wedge-{tag}")
        c = P["le"].LeaderElector("c", lock2, P["LE"](**_LE), clk)
        d = P["le"].LeaderElector("d", lock2, P["LE"](**_LE), clk)
        out += [c.tick(), d.tick()]
        clk.advance(16)
        out += [d.tick(), c._leading, c.release(),
                lock2.get().holder_identity, c.is_leader()]
        clk.advance(1)
        out.append(d.tick())
        return out

    assert _both(script) == [True, False, True, False, False, True, True,
                             False, True, False, True, True, False, "d",
                             False, True]


# ---------------------------------------------------------------------------
# fenced binds and the stopped-leading drain
# ---------------------------------------------------------------------------


def _fenced_cycle(P, fenced_binds=True):
    clk = FakeClock()
    binder = P["B"]()
    s = _sched(P, clk, binder=binder,
               recovery=P["R"](fenced_binds=fenced_binds))
    el = P["le"].LeaderElector("me", P["le"].InMemoryLock(),
                               P["LE"](**_LE), clk)
    s.attach_elector(el)
    out = [el.tick()]
    s.on_node_add(P["conv"](make_node("n0")))
    s.on_pod_add(P["conv"](make_pod("p0")))
    clk.advance(11)  # the lease goes stale: no renew within the deadline
    res = s.schedule_cycle()
    out += [list(binder.bindings), res.scheduled, res.unschedulable,
            res.failure_reasons, s.metrics.recovery_fenced_binds.value(),
            s.cache.is_assumed("default/p0"),
            s.queue.pod("default/p0") is not None]
    clk.advance(60)
    out.append(el.tick())
    s.queue.move_all_to_active()
    s.queue.tick()
    res2 = s.schedule_cycle()
    out += [res2.scheduled, list(binder.bindings)]
    return out, s


def test_fenced_bind_aborts_a_deposed_leader():
    got = _both(lambda P: _fenced_cycle(P)[0])
    assert got[1] == [] and got[4] == {"default/p0":
                                       ("FencedBind:lease lost",)}
    assert got[5] == 1 and got[-2] == 1
    # the port's flight record carries the fence's count
    _, s = _fenced_cycle(PKGS["port"])
    fenced = [r for r in s.obs.recorder.records() if r.fenced_binds]
    assert len(fenced) == 1 and fenced[0].fenced_binds == 1


def test_fence_disabled_by_config():
    got = _both(lambda P: _fenced_cycle(P, fenced_binds=False)[0])
    assert got[2] == 1 and got[5] == 0


def test_stopped_leading_drains_in_flight_state():
    def script(P):
        fw = P["fw"]

        class Gate(fw.Plugin):
            def permit(self, state, pod, node_name):
                return fw.Status(fw.WAIT, ""), 100.0

        clk = FakeClock()
        s = _sched(P, clk, framework=fw.Framework(plugins=[Gate()],
                                                  clock=clk))
        lock = P["le"].InMemoryLock()
        el = P["le"].LeaderElector("me", lock, P["LE"](**_LE), clk)
        s.attach_elector(el)
        out = [el.tick()]
        s.on_node_add(P["conv"](make_node("n0")))
        s.on_pod_add(P["conv"](make_pod("parked")))
        s.on_pod_add(P["conv"](make_pod("plain", cpu_milli=10)))
        res = s.schedule_cycle()
        out += [res.waiting, sorted(s.cache.assumed_keys())]
        rival = P["le"].LeaderElector("rival", lock, P["LE"](**_LE), clk)
        out.append(rival.tick())
        clk.advance(16)
        out += [rival.tick(), el.tick(),
                s.framework.waiting.get("default/parked") is None,
                s.cache.assumed_keys(),
                sorted(k for q in s.queue.pending_pods().values()
                       for k in (p.key() for p in q)),
                s.metrics.recovery_drained.value()]
        return out

    got = _both(script)
    assert got[1] == 2 and got[-3] == [] and got[-1] == 2


# ---------------------------------------------------------------------------
# takeover reconciliation
# ---------------------------------------------------------------------------


def _counts(s):
    m = s.metrics
    return [m.recovery_takeovers.value(), m.recovery_adopted.value(),
            m.recovery_forgotten.value(), m.recovery_requeued.value()]


@pytest.mark.parametrize("truth_node", ["", "n0", "n1"])
def test_reconcile_settles_an_assumption_against_the_truth(truth_node):
    """Truth unbound: forget and requeue; truth agreeing: adopt; truth
    bound elsewhere: forget the assumption, adopt the truth."""
    def script(P):
        clk = FakeClock()
        s = _sched(P, clk)
        s.on_node_add(P["conv"](make_node("n0")))
        s.on_node_add(P["conv"](make_node("n1")))
        p = P["conv"](make_pod("p0", cpu_milli=100, uid="u1"))
        s.cache.assume_pod(p, "n0")
        s.cache.finish_binding(p.key())
        out = s.reconcile([dataclasses.replace(p, node_name=truth_node)])
        cached = s.cache.pod("default/p0")
        return [out, _counts(s), s.cache.is_assumed("default/p0"),
                None if cached is None else cached.node_name,
                s.queue.pod("default/p0") is not None]

    got = _both(script)
    assert got[2] is False


def test_reconcile_drops_deleted_pods_and_replaces_recreated_ones():
    def script(P):
        s = _sched(P, FakeClock())
        s.on_node_add(P["conv"](make_node("n0")))
        s.on_pod_add(P["conv"](make_pod("ghost")))
        s.on_pod_add(P["conv"](make_pod("reborn", uid="old")))
        out = s.reconcile([P["conv"](make_pod("reborn", uid="new")),
                           P["conv"](make_pod("other", node_name="n0",
                                              uid="o"))])
        return [out, _counts(s), s.queue.pod("default/ghost") is None,
                s.queue.pod("default/reborn").uid,
                s.cache.pod("default/other").node_name]

    assert _both(script)[2:] == [True, "new", "n0"]


def test_reconcile_rebuilds_the_device_snapshot_and_flags_the_trace():
    def script(P):
        clk = FakeClock()
        s = _sched(P, clk)
        el = P["le"].LeaderElector("me", P["le"].InMemoryLock(),
                                   P["LE"](**_LE), clk)
        s.attach_elector(el)
        s.on_node_add(P["conv"](make_node("n0")))
        s.on_pod_add(P["conv"](make_pod("warm")))
        r0 = s.schedule_cycle()
        s.on_pod_add(P["conv"](make_pod("p0")))
        out = [r0.snapshot_mode, el.tick(), el.epoch]
        res = s.schedule_cycle()
        return out + [res.scheduled, res.snapshot_mode, _counts(s)]

    got = _both(script)
    assert got[4] == "full"
    s = _sched(PKGS["port"], FakeClock())
    s.on_node_add(to_port(make_node("n0")))
    s.cache.device_snapshot()
    assert s.cache.has_device_snapshot()
    s.reconcile()
    assert not s.cache.has_device_snapshot()
    s.on_pod_add(to_port(make_pod("p")))
    r = s.schedule_cycle()
    assert r.snapshot_mode == "full" and s.cache.has_device_snapshot()
    assert s.obs.recorder.records()[-1].takeover == 1
    assert s._ambiguous_binds == {}


# ---------------------------------------------------------------------------
# the hub's CAS: stale views, two replicas failing over
# ---------------------------------------------------------------------------


def _stale_view(P, hub):
    """A scheduler binding through the hub but fed by hand: hub
    mutations do not reach it (the delayed-informer race)."""
    s = _sched(P, hub.clock, binder=hub.binder)
    for n in hub.truth_nodes.values():
        s.on_node_add(n)
    return s


@pytest.mark.parametrize("race", ["deleted", "recreated", "bound-elsewhere"])
def test_stale_view_binds_take_the_reject_path(race):
    def script(P):
        hub = MiniHub()
        hub.add_node(P["conv"](make_node("n0", cpu_milli=4000)))
        hub.add_node(P["conv"](make_node("n1", cpu_milli=4000)))
        s = _stale_view(P, hub)
        hub.create_pod(P["conv"](make_pod("x", cpu_milli=100)))
        s.on_pod_add(dataclasses.replace(hub.truth_pods["default/x"]))
        if race == "deleted":
            hub.delete_pod("default/x")
        elif race == "recreated":
            hub.delete_pod("default/x")
            hub.create_pod(P["conv"](make_pod("x", cpu_milli=100)))
        else:
            hub.confirm_binding(hub.truth_pods["default/x"], "n1")
        res = s.schedule_cycle()
        out = [res.bind_errors, res.scheduled, hub.binder.conflicts,
               s.cache.is_assumed("default/x"), hub.bound_total]
        rec = s.reconcile(list(hub.truth_pods.values()))
        hub.clock.advance(60)
        s.queue.tick()
        res2 = s.schedule_cycle()
        tp = hub.truth_pods.get("default/x")
        return out + [rec, res2.scheduled, hub.bound_total,
                      None if tp is None else tp.node_name]

    got = _both(script)
    assert got[0] == 1 and got[2] == 1


def test_failover_two_replicas_on_one_lock():
    """Two replicas share an InMemoryLock and a hub; the leader dies
    without releasing mid-churn. The standby takes over after the lease
    decays, reconciles against the relisted truth and finishes the
    queue: zero double binds, zero leaks, everything bound once."""
    def script(P):
        hub = MiniHub()
        for i in range(4):
            hub.add_node(P["conv"](make_node(f"n{i}", cpu_milli=4000)))
        lock = P["le"].InMemoryLock()
        reps = []
        for name in ("a", "b"):
            s = _sched(P, hub.clock, binder=hub.binder)
            for n in hub.truth_nodes.values():
                s.on_node_add(n)
            el = P["le"].LeaderElector(name, lock, P["LE"](**_LE),
                                       hub.clock)
            s.attach_elector(el, lister=lambda: list(hub.truth_pods.values()))
            hub.subscribers.append(s)
            reps.append((s, el))

        def tick(rep):
            s, el = rep
            if el.tick():
                s.schedule_cycle()

        for i in range(6):
            hub.create_pod(P["conv"](make_pod(f"pre{i}", cpu_milli=500)))
        for _ in range(3):
            for r in reps:
                tick(r)
            hub.clock.advance(2)
        a, b = reps
        out = [a[1].is_leader(), b[1].is_leader(), hub.bound_total]
        for i in range(6):
            hub.create_pod(P["conv"](make_pod(f"mid{i}", cpu_milli=500)))
        hub.subscribers.remove(a[0])  # killed: no release, no more events
        for _ in range(14):
            tick(b)
            hub.clock.advance(2)
        return out + [b[1].is_leader(), _counts(b[0]), hub.bound_total,
                      hub.binder.conflicts, b[0].cache.assumed_keys(),
                      sorted((k, p.node_name)
                             for k, p in hub.truth_pods.items())]

    got = _both(script)
    assert got[:3] == [True, False, 6]
    assert got[3] is True and got[5] == 12 and got[6] == 0
    assert all(node for _, node in got[-1])


# ---------------------------------------------------------------------------
# CrashLoop: kill/restart at seeded crash points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_crashloop_invariant_triple_matches_reference(seed):
    """The reference's CrashLoop on its simulated cluster and the port's
    on the same cluster slice, at the reference's seeds: the same kills
    at the same sites, every pod bound exactly once on the same node, no
    conflict, no leaked assumption."""
    from kubernetes_tpu.chaos import CrashLoop as JLoop
    from kubernetes_tpu.sim import HollowCluster
    from kubernetes_tpu_torch.chaos import CrashLoop as TLoop

    want = JLoop(HollowCluster(seed=seed), seed=seed, kill_rate=0.25,
                 max_kills=5).run(n_pods=24, n_nodes=5)
    got = TLoop(MiniHub(), seed=seed, kill_rate=0.25, max_kills=5,
                scheduler_kw={"device": "cpu"}).run(n_pods=24, n_nodes=5)
    assert got == want
    assert got["kills"] == 5 and got["incarnations"] == 6
    assert got["all_bound"] and got["bound_total"] == got["n_pods"]
    assert got["conflicts"] == 0 and got["leaked_assumptions"] == []


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_crashloop_on_the_ports_hollow_cluster_matches_reference(seed):
    """The port's CrashLoop on the port's own simulated cluster
    (``sim.HollowCluster``, CAS binder and watch feed as the reference's)
    beside the reference's CrashLoop on its own: the same report, the
    invariant triple included."""
    from kubernetes_tpu.chaos import CrashLoop as JLoop
    from kubernetes_tpu.sim import HollowCluster as JHub
    from kubernetes_tpu_torch.chaos import CrashLoop as TLoop
    from kubernetes_tpu_torch.sim import HollowCluster as THub

    want = JLoop(JHub(seed=seed), seed=seed, kill_rate=0.25,
                 max_kills=5).run(n_pods=24, n_nodes=5)
    hub = THub(seed=seed, scheduler_kw={"device": "cpu"})
    got = TLoop(hub, seed=seed, kill_rate=0.25, max_kills=5,
                scheduler_kw={"device": "cpu"}).run(n_pods=24, n_nodes=5)
    assert got == want
    assert got["all_bound"] and got["bound_total"] == got["n_pods"]
    assert got["conflicts"] == 0 and got["leaked_assumptions"] == []
    hub.check_consistency()


def test_crashloop_restart_adopts_a_committed_bind():
    """Killed after the hub committed but before finish_binding: the next
    incarnation adopts the bind from the relist and never re-binds."""
    from kubernetes_tpu_torch.chaos import CrashLoop, SchedulerKilled

    hub = MiniHub()
    loop = CrashLoop(hub, seed=7, kill_rate=0.0, max_kills=1,
                     scheduler_kw={"device": "cpu"})
    loop.plan.kill_rate = 1.0
    loop.plan.sites = {"bind:post"}
    for i in range(3):
        hub.add_node(to_port(make_node(f"n{i}", cpu_milli=4000)))
    sched = loop.new_incarnation()
    hub.create_pod(to_port(make_pod("victim", cpu_milli=500)))
    with pytest.raises(SchedulerKilled):
        sched.schedule_cycle()
    assert hub.truth_pods["default/victim"].node_name
    assert hub.bound_total == 1
    sched2 = loop.new_incarnation()
    assert sched2.cache.pod("default/victim") is not None
    assert not sched2.cache.is_assumed("default/victim")
    assert sched2.queue.pod("default/victim") is None
    assert sched2.metrics.recovery_adopted.value() >= 1
    r = sched2.schedule_cycle()
    assert r.attempted == 0 and hub.bound_total == 1
    assert hub.binder.conflicts == 0


def test_crash_plan_matches_reference():
    from kubernetes_tpu.chaos import CrashPlan as JPlan
    from kubernetes_tpu_torch.chaos import CrashPlan as TPlan

    def fires(Plan):
        plan = Plan(seed=4, kill_rate=0.3, max_kills=6)
        out = [plan.fire(s) for _ in range(40)
               for s in ("bind:pre", "bind:post", "solve:mid", "cycle:pre",
                         "elsewhere")]
        return out, plan.kills, plan.fired

    assert fires(TPlan) == fires(JPlan)
