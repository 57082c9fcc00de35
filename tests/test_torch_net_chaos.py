"""The port's network-fault recovery (``kubernetes_tpu_torch/chaos.py``'s
network harnesses, the scheduler's ambiguous-bind protocol, the Reflector
under a fuzzed watch, and ``obs/audit.py``) held against the JAX package.

Each case runs one script through both packages (the port on CPU
tensors), on the same seeds, and compares what the script returns field
by field: resolutions, metric counts, commits, double-bind attempts,
assumptions, events, the Reflectors' counters and ``NetChaos.run``'s
report. These are integers and keys: no tolerance."""

import dataclasses
import random
import types

import pytest

import kubernetes_tpu.chaos as jchaos
import kubernetes_tpu.config as jconfig
import kubernetes_tpu.debugger as jdebugger
import kubernetes_tpu.faults as jfaults
import kubernetes_tpu.obs.audit as jaudit
import kubernetes_tpu.scheduler as jscheduler
import kubernetes_tpu.serving as jserving
import kubernetes_tpu.sim as jsim
import kubernetes_tpu.testing as jtesting
import kubernetes_tpu_torch.chaos as tchaos
import kubernetes_tpu_torch.config as tconfig
import kubernetes_tpu_torch.debugger as tdebugger
import kubernetes_tpu_torch.faults as tfaults
import kubernetes_tpu_torch.obs.audit as taudit
import kubernetes_tpu_torch.scheduler as tscheduler
import kubernetes_tpu_torch.serving as tserving
import kubernetes_tpu_torch.sim as tsim
import kubernetes_tpu_torch.testing as ttesting

REF = types.SimpleNamespace(
    name="jax", chaos=jchaos, config=jconfig, debugger=jdebugger,
    faults=jfaults, audit=jaudit, scheduler=jscheduler, serving=jserving,
    sim=jsim, testing=jtesting, kw={})
PORT = types.SimpleNamespace(
    name="port", chaos=tchaos, config=tconfig, debugger=tdebugger,
    faults=tfaults, audit=taudit, scheduler=tscheduler, serving=tserving,
    sim=tsim, testing=ttesting, kw={"device": "cpu"})


def both(script):
    """Run ``script(pkg)`` on each package; the port must return exactly
    what the reference returns. Returns the port's result."""
    want, got = script(REF), script(PORT)
    assert got == want, (got, want)
    return got


class Clock:
    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class Truth:
    """Minimal CAS'd hub truth for the protocol cases: a binder that can
    commit and then time out (the ambiguous class), and a reader the
    scheduler verifies against; raising its package's fault types."""

    def __init__(self, faults) -> None:
        self.faults = faults
        self.bound: dict = {}
        self.uids: dict = {}
        self.double_bind_attempts = 0
        self.commits = 0
        #: the next bind calls: "ok", "timeout_committed", "timeout_lost",
        #: "error" (consumed left to right; empty = ok)
        self.script: list = []
        #: every reader GET raises RPCTimeout while True
        self.reader_down = False

    def _commit(self, pod, node_name: str) -> None:
        if pod.key() in self.bound:
            self.double_bind_attempts += 1
            raise RuntimeError(f"{pod.key()} already bound")
        self.bound[pod.key()] = node_name
        self.commits += 1

    def bind(self, pod, node_name: str) -> None:
        self.uids[pod.key()] = pod.uid
        action = self.script.pop(0) if self.script else "ok"
        if action == "error":
            raise self.faults.RPCError("injected: definitely not committed")
        if action == "timeout_committed":
            self._commit(pod, node_name)
            raise self.faults.RPCTimeout("injected: committed, answer lost")
        if action == "timeout_lost":
            raise self.faults.RPCTimeout("injected: not committed")
        self._commit(pod, node_name)

    def read(self, key: str):
        if self.reader_down:
            raise self.faults.RPCTimeout("injected: GET unreachable")
        if key not in self.uids:
            return None
        return types.SimpleNamespace(uid=self.uids[key],
                                     node_name=self.bound.get(key, ""))


def sched_of(pkg, truth, clock=None, reader=True, **kw):
    clock = clock or Clock()
    s = pkg.scheduler.Scheduler(
        binder=truth, clock=clock, enable_preemption=False,
        retry_sleep=lambda _s: None, jitter_seed=1,
        pod_reader=truth.read if reader else None, **pkg.kw, **kw)
    s.on_node_add(pkg.testing.make_node("n0", cpu_milli=8000))
    s.on_node_add(pkg.testing.make_node("n1", cpu_milli=8000))
    return s, clock


def ambiguous(s) -> dict:
    return dict(s.metrics.bind_ambiguous._values)


def pod0(pkg, name="p0"):
    return pkg.testing.make_pod(name, cpu_milli=100)


# ---------------------------------------------------------------------------
# the repair: an ambiguous timeout is never bound a second time
# ---------------------------------------------------------------------------


def _repair_script(with_reader):
    def script(pkg):
        hub = pkg.sim.HollowCluster(seed=3, scheduler_kw=dict(pkg.kw))
        for i in range(4):
            hub.add_node(pkg.testing.make_node(f"n{i}", cpu_milli=4000))
        for i in range(6):
            hub.create_pod(pkg.testing.make_pod(f"p{i}", cpu_milli=500))
        inj = pkg.faults.FaultInjector(seed=3)
        inj.arm("rpc:bind", "rpc_timeout", rate=1.0, count=1,
                commit_rate=1.0)
        binder = pkg.chaos.AmbiguousBinder(hub, inj)
        kw = dict(pkg.kw)
        if with_reader:
            kw["pod_reader"] = lambda k: hub.truth_pods.get(k)
        # fed by hand: the hub's watch reaches only its own scheduler, so
        # this one never hears the committed bind's MODIFIED event
        s = pkg.scheduler.Scheduler(
            binder=binder, clock=hub.clock, enable_preemption=False,
            retry_sleep=lambda _s: None, jitter_seed=3, **kw)
        for nd in hub.truth_nodes.values():
            s.on_node_add(nd)
        for p in hub.truth_pods.values():
            s.on_pod_add(p)
        first = s.schedule_cycle()
        timed_out = [k for k, p in hub.truth_pods.items()
                     if p.node_name and k not in first.assignments]
        # a node event sweeps the unschedulable queue: a pod rejected and
        # requeued would be bound again by the next cycles
        hub.clock.advance(2.0)
        s.on_node_add(pkg.testing.make_node("spare", cpu_milli=4000))
        for _ in range(3):
            s.schedule_cycle()
            hub.clock.advance(2.0)
        return {"first": dict(first.assignments), "timed_out": timed_out,
                "assumed": sorted(s.cache.assumed_keys()),
                "queued": sorted(p.key() for q in
                                 s.queue.pending_pods().values() for p in q),
                "double": binder.double_bind_attempts,
                "commits": binder.commits,
                "timeouts": binder.timeouts_committed,
                "ambiguous": ambiguous(s),
                "bound": {k: p.node_name
                          for k, p in hub.truth_pods.items()}}
    return script


@pytest.mark.parametrize("with_reader", [False, True])
def test_ambiguous_timeout_is_never_rebound_like_the_reference(with_reader):
    """A bind that committed at the hub and then timed out: without a
    reader the pod stays assumed until its TTL and no second bind is sent;
    with one the read-your-write GET adopts it. Either way the hub never
    sees a second bind RPC for the pod, as in the reference."""
    got = both(_repair_script(with_reader))
    assert got["double"] == 0 and got["timeouts"] == 1
    assert got["commits"] == 6 and all(got["bound"].values())
    key = got["timed_out"]
    if with_reader:
        assert key == [] and len(got["first"]) == 6
        assert got["ambiguous"] == {("adopted",): 1.0}
    else:
        assert len(key) == 1 and key[0] in got["assumed"]
        assert key[0] not in got["queued"]
        assert got["ambiguous"] == {("ttl-parked",): 1.0}


# ---------------------------------------------------------------------------
# fault primitives: the RPC hook's commit coin, the per-replica jitter
# ---------------------------------------------------------------------------


def test_rpc_hook_ambiguous_commit_coin():
    def script(pkg):
        F = pkg.faults.FaultInjector
        a = F(seed=3).arm("rpc:bind", "rpc_timeout", rate=1.0,
                          commit_rate=1.0).rpc_hook("rpc:bind")
        b = F(seed=3).arm("rpc:bind", "rpc_timeout", rate=1.0,
                          commit_rate=0.0).rpc_hook("rpc:bind")
        c = F(seed=9).arm("x", "rpc_timeout", commit_rate=0.5)
        return [a[0], a[2], b[0], b[2], [c.rpc_hook("x")[2]
                                         for _ in range(16)]]

    got = both(script)
    assert got[:4] == ["rpc_timeout", True, "rpc_timeout", False]


def test_rpc_hook_error_never_commits():
    def script(pkg):
        inj = pkg.faults.FaultInjector(seed=1)
        inj.arm("rpc:bind", "rpc_error", rate=1.0)
        kind, _rule, committed = inj.rpc_hook("rpc:bind")
        return kind, committed

    assert both(script) == ("rpc_error", False)


def test_per_replica_jitter_streams_match_the_reference():
    """Unpinned schedulers draw distinct jitter seeds; a pinned seed gives
    the reference's streams, the verification GET's offset from the
    transport's."""
    def script(pkg):
        t = Truth(pkg.faults)
        mk = lambda **kw: pkg.scheduler.Scheduler(  # noqa: E731
            binder=t, enable_preemption=False, retry_sleep=lambda _s: None,
            **pkg.kw, **kw)
        a, b = mk(), mk()
        c = mk(jitter_seed=7)
        return (a._jitter_seed != b._jitter_seed,
                [c._transport_retry.backoff_s(i) for i in range(6)],
                [c._bind_verify_retry.backoff_s(i) for i in range(4)])

    distinct, transport, verify = both(script)
    assert distinct and verify != transport[:4]


# ---------------------------------------------------------------------------
# the ambiguous-outcome bind protocol
# ---------------------------------------------------------------------------


def test_ambiguous_bind_adopted_never_rebinds():
    def script(pkg):
        t = Truth(pkg.faults)
        t.script = ["timeout_committed"]
        s, _ = sched_of(pkg, t)
        s.on_pod_add(pod0(pkg))
        res = s.schedule_cycle()
        return (res.scheduled, dict(res.assignments), t.commits,
                t.double_bind_attempts, ambiguous(s))

    got = both(script)
    assert got[0] == 1 and got[2:4] == (1, 0)
    assert got[4] == {("adopted",): 1.0}


def test_ambiguous_bind_requeued_when_verified_uncommitted():
    def script(pkg):
        t = Truth(pkg.faults)
        t.script = ["timeout_lost"]
        s, clock = sched_of(pkg, t)
        s.on_pod_add(pod0(pkg))
        res = s.schedule_cycle()
        first = (res.scheduled, res.bind_errors, t.commits, ambiguous(s))
        for _ in range(30):
            clock.advance(10.0)
            if s.schedule_cycle().scheduled:
                break
        return first, dict(t.bound), t.commits, t.double_bind_attempts, \
            clock.t

    first, bound, commits, double, _ = both(script)
    assert first == (0, 1, 0, {("requeued",): 1.0})
    assert bound.get("default/p0") and commits == 1 and double == 0


def test_ambiguous_bind_parked_until_hub_answers():
    def script(pkg):
        t = Truth(pkg.faults)
        t.script = ["timeout_committed"]
        t.reader_down = True
        s, clock = sched_of(pkg, t)
        s.on_pod_add(pod0(pkg))
        res = s.schedule_cycle()
        out = [res.scheduled, sorted(s._ambiguous_binds),
               s.cache.is_assumed("default/p0"), ambiguous(s)]
        clock.advance(s.cache.ttl_s + 5)
        s.idle_tick()
        out += [sorted(s._ambiguous_binds), t.commits]
        t.reader_down = False
        s.idle_tick()
        out += [sorted(s._ambiguous_binds),
                s.cache.is_assumed("default/p0"),
                s.cache.pod("default/p0") is not None, t.commits,
                t.double_bind_attempts, ambiguous(s)]
        return out

    got = both(script)
    assert got[:4] == [0, ["default/p0"], True, {("deferred",): 1.0}]
    assert got[4:6] == [["default/p0"], 1]
    assert got[6:11] == [[], False, True, 1, 0]
    assert got[11][("adopted",)] == 1.0


def test_ambiguous_bind_gone_and_conflict():
    def script(pkg):
        t = Truth(pkg.faults)
        s, _ = sched_of(pkg, t)
        s.on_pod_add(pod0(pkg))

        def lost(pod, node):
            raise pkg.faults.RPCTimeout("lost")

        t.bind = lost  # never commits, never registers: reads as gone
        s.schedule_cycle()
        gone = ambiguous(s)
        s.queue.delete("default/p0")
        s.on_pod_add(pod0(pkg))
        t.uids["default/p0"] = "someone-else"
        t.bound["default/p0"] = "n1"
        s.schedule_cycle()
        return gone, ambiguous(s), s.cache.is_assumed("default/p0")

    gone, both_counts, assumed = both(script)
    assert gone == {("gone",): 1.0}
    assert both_counts[("conflict",)] == 1.0 and not assumed


def test_ambiguous_bind_without_reader_falls_back_to_ttl():
    def script(pkg):
        t = Truth(pkg.faults)
        t.script = ["timeout_committed"]
        s, _ = sched_of(pkg, t, reader=False)
        s.on_pod_add(pod0(pkg))
        s.schedule_cycle()
        return (s.cache.is_assumed("default/p0"), dict(s._ambiguous_binds),
                ambiguous(s))

    assert both(script) == (True, {}, {("ttl-parked",): 1.0})


def test_expired_assumption_adopts_instead_of_blind_requeue():
    def script(pkg):
        t = Truth(pkg.faults)
        s, clock = sched_of(pkg, t)
        s.on_pod_add(pod0(pkg))
        s.schedule_cycle()
        clock.advance(s.cache.ttl_s + 1)
        s.idle_tick()
        out = [ambiguous(s), s.cache.is_assumed("default/p0"),
               s.cache.pod("default/p0") is not None,
               s.queue.pod("default/p0") is None]
        for _ in range(5):
            clock.advance(10.0)
            s.schedule_cycle()
        return out + [t.commits, t.double_bind_attempts]

    assert both(script) == [{("expired-adopted",): 1.0}, False, True, True,
                            1, 0]


def test_expired_assumption_requeues_only_when_verified_unbound():
    def script(pkg):
        t = Truth(pkg.faults)
        s, clock = sched_of(pkg, t)
        s.on_pod_add(pod0(pkg))
        s.schedule_cycle()
        del t.bound["default/p0"]  # the hub lost the binding
        clock.advance(s.cache.ttl_s + 1)
        s.idle_tick()
        return (ambiguous(s), s.queue.pod("default/p0") is not None,
                s.cache.is_assumed("default/p0"))

    assert both(script) == ({("expired-requeued",): 1.0}, True, False)


def test_expired_assumption_parks_during_hub_outage():
    def script(pkg):
        t = Truth(pkg.faults)
        events = []
        s, clock = sched_of(pkg, t)
        s.event_sink = lambda reason, obj, msg="": events.append(reason)
        s.on_pod_add(pod0(pkg))
        s.schedule_cycle()
        t.reader_down = True
        clock.advance(s.cache.ttl_s + 1)
        s.idle_tick()
        out = [sorted(s._ambiguous_binds), s.cache.is_assumed("default/p0")]
        t.reader_down = False
        s.idle_tick()
        return out + [sorted(s._ambiguous_binds),
                      s.cache.pod("default/p0") is not None, t.commits,
                      t.double_bind_attempts, events, ambiguous(s)]

    got = both(script)
    assert got[:6] == [["default/p0"], True, [], True, 1, 0]
    assert got[6].count("Scheduled") == 1


def test_watch_settled_park_still_runs_success_tail():
    def script(pkg):
        t = Truth(pkg.faults)
        events = []
        t.script = ["timeout_committed"]
        t.reader_down = True
        s, _ = sched_of(pkg, t)
        s.event_sink = lambda reason, obj, msg="": events.append(reason)
        p = pod0(pkg)
        s.on_pod_add(p)
        s.schedule_cycle()
        out = [sorted(s._ambiguous_binds), events.count("Scheduled")]
        s.on_pod_update(p, dataclasses.replace(p, node_name="n0"))
        s.idle_tick()
        return out + [sorted(s._ambiguous_binds), events.count("Scheduled"),
                      ambiguous(s), t.commits, t.double_bind_attempts]

    got = both(script)
    assert got[:4] == [["default/p0"], 0, [], 1]
    assert got[4][("adopted",)] == 1.0 and got[5:] == [1, 0]


def test_deleted_parked_pod_releases_assumption():
    def script(pkg):
        t = Truth(pkg.faults)
        t.script = ["timeout_committed"]
        t.reader_down = True
        s, _ = sched_of(pkg, t)
        p = pod0(pkg)
        s.on_pod_add(p)
        s.schedule_cycle()
        before = s.cache.is_assumed("default/p0")
        s.on_pod_delete(p)
        return (before, dict(s._ambiguous_binds),
                s.cache.is_assumed("default/p0"),
                s.cache.pod("default/p0") is None)

    assert both(script) == (True, {}, False, True)


def test_reap_origin_park_resolutions_keep_expired_labels():
    def script(pkg):
        t = Truth(pkg.faults)
        s, clock = sched_of(pkg, t)
        s.on_pod_add(pod0(pkg))
        s.schedule_cycle()
        t.reader_down = True
        clock.advance(s.cache.ttl_s + 1)
        s.idle_tick()
        parked = ambiguous(s)
        t.reader_down = False
        s.idle_tick()
        return parked, ambiguous(s)

    parked, final = both(script)
    assert parked == {("expired-deferred",): 1.0}
    assert final[("expired-adopted",)] == 1.0 and ("adopted",) not in final


def test_idle_path_verification_retries_despite_stale_cycle_deadline():
    def script(pkg):
        t = Truth(pkg.faults)
        calls = {"n": 0}

        def flaky_read(key):
            calls["n"] += 1
            if calls["n"] == 1:
                raise pkg.faults.RPCTimeout("transient")
            return t.read(key)

        clock = Clock()
        s = pkg.scheduler.Scheduler(
            binder=t, clock=clock, enable_preemption=False,
            retry_sleep=lambda _s: None, jitter_seed=1,
            pod_reader=flaky_read,
            robustness=pkg.config.RobustnessConfig(cycle_deadline_s=5.0),
            **pkg.kw)
        s.on_node_add(pkg.testing.make_node("n0", cpu_milli=8000))
        s.on_pod_add(pod0(pkg))
        s.schedule_cycle()
        clock.advance(s.cache.ttl_s + 1)
        s.idle_tick()
        return ambiguous(s), calls["n"]

    counts, n = both(script)
    assert counts == {("expired-adopted",): 1.0} and n >= 2


# ---------------------------------------------------------------------------
# the Reflector under a fuzzed watch (chaos.FuzzedCursor)
# ---------------------------------------------------------------------------


def _churn_tape(pkg, hub, rng, steps, on_step):
    n = 0
    for step in range(steps):
        for _ in range(rng.randrange(1, 4)):
            hub.create_pod(pkg.testing.make_pod(f"t{n}", cpu_milli=100))
            n += 1
        if step % 3 == 1:
            hub.sched.schedule_cycle()
        if step % 4 == 3:
            bound = [k for k, p in hub.truth_pods.items() if p.node_name]
            if bound:
                hub.delete_pod(rng.choice(bound))
        on_step(step)
        hub.clock.advance(0.25)


def _mirror(pkg, hub):
    return pkg.scheduler.Scheduler(clock=hub.clock, enable_preemption=False,
                                   **pkg.kw)


def _synced(pkg, sched, hub):
    truth = {k: p.node_name for k, p in hub.truth_pods.items()}
    return pkg.debugger.compare(sched, truth, list(hub.truth_nodes))


def _fuzz_hub(pkg, seed):
    hub = pkg.sim.HollowCluster(
        seed=seed, scheduler_kw={"enable_preemption": False, **pkg.kw})
    for i in range(4):
        hub.add_node(pkg.testing.make_node(f"n{i}", cpu_milli=16000))
    return hub


@pytest.mark.parametrize("seed", (1, 2, 3))
def test_reflector_fuzz_dup_reorder_converges_without_relist(seed):
    def script(pkg):
        hub = _fuzz_hub(pkg, seed)
        inj = pkg.faults.FaultInjector(seed=seed)
        inj.arm("watch:event", "duplicate", rate=0.35)
        inj.arm("watch:batch", "reorder", rate=0.6)
        clean, fuzzed = _mirror(pkg, hub), _mirror(pkg, hub)
        rc = pkg.sim.Reflector(hub, clean)
        rf = pkg.sim.Reflector(
            hub, fuzzed,
            cursor_wrap=lambda c: pkg.chaos.FuzzedCursor(c, inj, seed=seed))
        rc.list_and_watch()
        rf.list_and_watch()
        _churn_tape(pkg, hub, random.Random(seed), 16,
                    lambda _s: (rc.pump(), rf.pump()))
        rc.pump()
        rf.pump()
        cur = rf._cursor
        return {"deduped": rf.deduped, "relists": rf.relists,
                "cursor": (cur.dropped, cur.duplicated, cur.reordered),
                "clean": _synced(pkg, clean, hub),
                "fuzzed": _synced(pkg, fuzzed, hub),
                "pods": {k: p.node_name for k, p in rf.pods.items()},
                "same": ({k: p.node_name for k, p in rf.pods.items()}
                         == {k: p.node_name for k, p in rc.pods.items()})}

    got = both(script)
    assert got["deduped"] > 0 and got["relists"] == 0
    assert got["clean"] == ([], []) and got["fuzzed"] == ([], [])
    assert got["same"]


@pytest.mark.parametrize("seed", (1, 2, 3))
def test_reflector_fuzz_with_drops_converges_via_relist(seed):
    def script(pkg):
        hub = _fuzz_hub(pkg, seed)
        inj = pkg.faults.FaultInjector(seed=seed)
        inj.arm("watch:event", "drop", rate=0.25)
        inj.arm("watch:event", "duplicate", rate=0.2)
        inj.arm("watch:batch", "reorder", rate=0.4)
        clean, fuzzed = _mirror(pkg, hub), _mirror(pkg, hub)
        rc = pkg.sim.Reflector(hub, clean)
        rf = pkg.sim.Reflector(
            hub, fuzzed, clock=hub.clock, progress_deadline_s=2.0,
            relist_backoff=pkg.faults.RetryPolicy(base_s=0.1, max_s=0.5,
                                                  jitter=0.5, seed=seed),
            cursor_wrap=lambda c: pkg.chaos.FuzzedCursor(c, inj, seed=seed))
        rc.list_and_watch()
        rf.list_and_watch()

        def step(i):
            rc.pump()
            rf.pump()
            if i % 5 == 4:
                rf.list_and_watch()

        _churn_tape(pkg, hub, random.Random(seed), 20, step)
        rc.pump()
        rf.list_and_watch()
        cur = rf._cursor
        return {"deduped": rf.deduped, "relists": rf.relists,
                "stalled": rf.stalled_relists,
                "cursor": (cur.dropped, cur.duplicated, cur.reordered),
                "clean": _synced(pkg, clean, hub),
                "fuzzed": _synced(pkg, fuzzed, hub)}

    got = both(script)
    assert got["cursor"][0] > 0 or got["deduped"] > 0
    assert got["clean"] == ([], []) and got["fuzzed"] == ([], [])


# ---------------------------------------------------------------------------
# the state-conservation auditor
# ---------------------------------------------------------------------------


def _invariants(vs):
    return [(v.invariant, v.subject) for v in vs]


def test_auditor_clean_scheduler_is_clean():
    def script(pkg):
        s, _ = sched_of(pkg, Truth(pkg.faults))
        aud = s.attach_auditor(pkg.audit.StateAuditor())
        s.on_pod_add(pod0(pkg))
        first = _invariants(aud.audit(s))
        s.schedule_cycle()
        return first, _invariants(aud.audit(s)), aud.audits, \
            aud.violations_total

    assert both(script) == ([], [], 2, 0)


def test_auditor_multi_state_and_capacity():
    def script(pkg):
        s, _ = sched_of(pkg, Truth(pkg.faults))
        aud = s.attach_auditor(pkg.audit.StateAuditor())
        s.on_pod_add(pod0(pkg))
        s.schedule_cycle()
        s.queue.add_if_not_present(pod0(pkg))
        multi = _invariants(aud.audit(s))
        s.queue.delete("default/p0")
        s.cache.add_pod(pkg.testing.make_pod("huge", cpu_milli=999000,
                                             node_name="n0"))
        cap = [(v.invariant, v.subject, v.detail) for v in aud.audit(s)]
        return multi, cap, aud.violations_total, aud.report()

    multi, cap, total, _ = both(script)
    assert multi == [("multi-state", "default/p0")]
    assert "capacity" in [c[0] for c in cap] and total >= 2
    assert set(taudit.INVARIANTS) == set(jaudit.INVARIANTS)


def test_auditor_conservation_needs_explained_exits():
    def script(pkg):
        s, _ = sched_of(pkg, Truth(pkg.faults))
        aud = s.attach_auditor(pkg.audit.StateAuditor())
        s.on_pod_add(pod0(pkg))
        aud.audit(s)
        s.queue.delete("default/p0")
        lost = _invariants(aud.audit(s))
        p1 = pod0(pkg, "p1")
        s.on_pod_add(p1)
        aud.audit(s)
        s.on_pod_delete(p1)
        return lost, _invariants(aud.audit(s))

    assert both(script) == ([("lost-pod", "default/p0")], [])


def test_auditor_truth_mode_two_strike():
    def script(pkg):
        out = []
        for heal in (False, True):
            s, _ = sched_of(pkg, Truth(pkg.faults))
            aud = s.attach_auditor(pkg.audit.StateAuditor())
            p = pod0(pkg)
            s.on_pod_add(p)
            truth = [dataclasses.replace(p, node_name="n1")]
            out.append(_invariants(aud.audit(s, truth_pods=truth)))
            if heal:  # the lagging watch catches up before the 2nd audit
                s.on_pod_update(p, truth[0])
            out.append(_invariants(aud.audit(s, truth_pods=truth)))
            out.append(aud.violations_total)
        return out

    assert both(script) == [[], [("double-bind-risk", "default/p0")], 1,
                            [], [], 0]


def test_auditor_truth_strikes_survive_truthless_sweeps():
    def script(pkg):
        s, _ = sched_of(pkg, Truth(pkg.faults))
        aud = s.attach_auditor(pkg.audit.StateAuditor())
        p = pod0(pkg)
        s.on_pod_add(p)
        truth = [dataclasses.replace(p, node_name="n1")]
        return [_invariants(aud.audit(s, truth_pods=truth)),
                _invariants(aud.audit(s)),
                _invariants(aud.audit(s, truth_pods=truth))]

    assert both(script) == [[], [], [("double-bind-risk", "default/p0")]]


def test_auditor_publishes_metric_event_and_trace_flag():
    """The port publishes like the reference: the metric, the event and
    the obs note (parked for the next cycle's trace when the audit ran
    between cycles, where the reference flags its next flight record)."""
    def script(pkg):
        s, _ = sched_of(pkg, Truth(pkg.faults))
        events = []
        aud = pkg.audit.StateAuditor(
            metrics=s.metrics,
            event_sink=lambda r, o, m: events.append((r, m)), obs=s.obs)
        s.attach_auditor(aud)
        s.on_pod_add(pod0(pkg))
        aud.audit(s)
        s.queue.delete("default/p0")
        aud.audit(s)
        return (s.metrics.invariant_violations.value(invariant="lost-pod"),
                events, s.obs._pending_invariants)

    metric, events, pending = both(script)
    assert metric == 1 and events[0][0] == "InvariantViolation"
    assert pending == 1
    # the parked count lands on the port's next flight record, as the
    # reference's does
    s, _ = sched_of(PORT, Truth(tfaults))
    s.obs.note_invariant_violations(2)
    s.on_pod_add(pod0(PORT))
    s.schedule_cycle()
    assert s.obs.recorder.records()[-1].invariant_violations == 2


def test_serving_runtime_runs_low_frequency_audit():
    def script(pkg):
        t = Truth(pkg.faults)
        clock = Clock()
        s = pkg.scheduler.Scheduler(
            binder=t, clock=clock, enable_preemption=False,
            observability=pkg.config.ObservabilityConfig(
                audit_interval_s=1.0), **pkg.kw)
        s.on_node_add(pkg.testing.make_node("n0", cpu_milli=8000))
        rt = pkg.serving.ServingRuntime(s, clock=clock)
        out = [rt.auditor is not None and s.auditor is rt.auditor,
               rt.loop.maintenance is not None]
        rt.loop.maintenance()
        out.append(rt.auditor.audits)
        rt.loop.maintenance()
        out.append(rt.auditor.audits)
        seen = []
        rt.add_maintenance(lambda: seen.append(True))
        clock.advance(1.5)
        rt.loop.maintenance()
        out += [rt.auditor.audits, seen]
        s2 = pkg.scheduler.Scheduler(binder=t, enable_preemption=False,
                                     **pkg.kw)
        s2.on_node_add(pkg.testing.make_node("n0", cpu_milli=8000))
        rt2 = pkg.serving.ServingRuntime(s2)
        return out + [rt2.auditor, rt2.loop.maintenance, rt2.maybe_audit()]

    assert both(script) == [True, True, 1, 1, 2, [True], None, None, 0]


# ---------------------------------------------------------------------------
# the composed NetChaos harness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_net_chaos_converges_with_zero_double_binds(seed):
    """Ambiguous binds, a fuzzed watch and a relist storm at once: the
    port's report equals the reference's field by field, and keeps the
    invariants (every pod bound, no double-bind attempt, no violation,
    nothing leaked or parked)."""
    def script(pkg):
        hub = pkg.sim.HollowCluster(
            seed=seed, scheduler_kw={"enable_preemption": False, **pkg.kw})
        return pkg.chaos.NetChaos(hub, seed=seed,
                                  scheduler_kw=dict(pkg.kw)).run(
            n_pods=32, n_nodes=6)

    rep = both(script)
    assert rep["converged"] and rep["all_bound"], rep
    assert rep["double_bind_attempts"] == 0, rep
    assert rep["invariant_violations"] == 0, rep["violations"]
    assert rep["leaked_assumptions"] == [] and rep["parked_ambiguous"] == []
    assert rep["ambiguous_timeouts"] > 0 and rep["watch_deduped"] > 0
    assert rep["relists"] >= 1


def test_net_chaos_ambiguous_binder_counts_double_attempts():
    def script(pkg):
        hub = pkg.sim.HollowCluster(
            seed=4, scheduler_kw={"enable_preemption": False, **pkg.kw})
        hub.add_node(pkg.testing.make_node("m0", cpu_milli=4000))
        b = pkg.chaos.AmbiguousBinder(hub, pkg.faults.FaultInjector(seed=4))
        p = pkg.testing.make_pod("dbl", cpu_milli=100)
        hub.create_pod(p)
        b.bind(p, "m0")
        first = b.double_bind_attempts
        with pytest.raises(pkg.sim.Conflict):
            b.bind(p, "m0")
        return first, b.double_bind_attempts, b.commits, b.binds_attempted

    assert both(script) == (0, 1, 1, 2)


def test_net_fault_load_arms_and_disarms_like_the_reference():
    def script(pkg):
        inj = pkg.faults.FaultInjector(seed=5)
        inj.arm("snapshot:device", "device_lost", count=1)
        armed = pkg.chaos.arm_net_fault_load(inj, drop_rate=0.0)
        sites = sorted((r.site, r.kind) for r in inj.rules)
        removed = pkg.chaos.disarm_net_fault_load(inj)
        return (armed, sites, removed,
                [(r.site, r.kind) for r in inj.rules],
                pkg.chaos.NET_FAULT_SITES)

    got = both(script)
    assert got[0] == 5 and got[2] == 5
    assert got[3] == [("snapshot:device", "device_lost")]
