"""The port's soak harness (``soak.py``: ``SoakSentinels``, ``SoakPhase``,
``SoakEngine``, ``standard_counters``) and ``Scheduler.state_sizes`` held
against the JAX package: the sentinel and engine cases of
tests/test_soak.py, each run through both packages on a fake clock and
compared on what it returns.

Left out: the consolidation re-pack cases and the scenario pack of the
reference's ``MiniSoak`` (ROADMAP A.15: scenario packs), and the
``slo_burns`` and ``incidents`` counters and the ``mem.*`` /
``incident.*`` sentinels of the perf ledger, the memory ledger and the
incident recorder (ROADMAP A.13 slice 2): the fake-clock soak here runs
both packages without the pack and compares everything else."""

import dataclasses
import random
from types import SimpleNamespace

import pytest

import kubernetes_tpu.config as jconfig
import kubernetes_tpu.faults as jfaults
import kubernetes_tpu.metrics as jmetrics
import kubernetes_tpu.obs.audit as jaudit
import kubernetes_tpu.scheduler as jscheduler
import kubernetes_tpu.sim as jsim
import kubernetes_tpu.soak as jsoak
import kubernetes_tpu.testing as jtesting
import kubernetes_tpu_torch.config as tconfig
import kubernetes_tpu_torch.faults as tfaults
import kubernetes_tpu_torch.metrics as tmetrics
import kubernetes_tpu_torch.obs.audit as taudit
import kubernetes_tpu_torch.scheduler as tscheduler
import kubernetes_tpu_torch.sim as tsim
import kubernetes_tpu_torch.soak as tsoak
import kubernetes_tpu_torch.testing as ttesting
from torch_parity import FakeClock

REF = SimpleNamespace(config=jconfig, faults=jfaults, metrics=jmetrics,
                      audit=jaudit, scheduler=jscheduler, sim=jsim,
                      soak=jsoak, testing=jtesting, kw={})
PORT = SimpleNamespace(config=tconfig, faults=tfaults, metrics=tmetrics,
                       audit=taudit, scheduler=tscheduler, sim=tsim,
                       soak=tsoak, testing=ttesting, kw={"device": "cpu"})

#: what the reference's soak carries for its A.13 slice 2 backends
PR12_KEYS = ("slo_burns", "incidents")
PR12_PREFIXES = ("mem.", "incident.", "sched.mem_", "sched.incident_", "mem_",
                 "incident_")


def both(script):
    """``script(pkg)`` on each package; the port returns what the
    reference returns. Returns the port's result."""
    want, got = script(REF), script(PORT)
    assert got == want, (got, want)
    return got


def _ported(d: dict) -> dict:
    """``d`` without the keys of the reference's A.13 slice 2 backends."""
    return {k: v for k, v in d.items()
            if k not in PR12_KEYS and not k.startswith(PR12_PREFIXES)}


class Truth:
    """Minimal CAS'd hub truth with the spec registry the auditor's truth
    view needs: binding an already-bound key is counted and refused."""

    def __init__(self, faults) -> None:
        self.faults = faults
        self.bound: dict = {}
        self.spec: dict = {}
        self.double_bind_attempts = 0
        self.script: list = []

    def register(self, pod) -> None:
        self.spec[pod.key()] = pod

    def delete(self, key: str) -> None:
        self.spec.pop(key, None)
        self.bound.pop(key, None)

    def bind(self, pod, node_name: str) -> None:
        self.spec.setdefault(pod.key(), pod)
        action = self.script.pop(0) if self.script else "ok"
        if action == "error":
            raise self.faults.RPCError("injected: definitely not committed")
        if pod.key() in self.bound:
            self.double_bind_attempts += 1
            raise RuntimeError(f"{pod.key()} already bound")
        self.bound[pod.key()] = node_name

    def read(self, key: str):
        spec = self.spec.get(key)
        if spec is None:
            return None
        return SimpleNamespace(uid=spec.uid,
                               node_name=self.bound.get(key, ""))

    def list_pods(self):
        return [dataclasses.replace(p, node_name=self.bound.get(k, ""),
                                    deletion_timestamp=0.0)
                for k, p in self.spec.items()]


def _sched(pkg, truth, clock=None, **kw):
    clock = clock or FakeClock()
    kw.setdefault("enable_preemption", False)
    s = pkg.scheduler.Scheduler(binder=truth, clock=clock,
                                retry_sleep=lambda _s: None, jitter_seed=1,
                                pod_reader=truth.read, **pkg.kw, **kw)
    return s, clock


def _confirm(s, res) -> None:
    """Relay the bind confirmations a watch stream would deliver."""
    for key, node in dict(res.assignments).items():
        cached = s.cache.pod(key)
        if cached is not None:
            s.on_pod_update(cached, dataclasses.replace(cached,
                                                        node_name=node))


def _stub_sched(sizes: dict):
    return SimpleNamespace(state_sizes=lambda: dict(sizes))


# ---------------------------------------------------------------------------
# sentinel mechanics
# ---------------------------------------------------------------------------


def test_growth_verdict_flags_monotonic_ratchet():
    def script(pkg):
        out = []
        for series in ((10, 13, 17), (10, 17, 11), (10, 10, 10)):
            sizes = {"why_pending": 10}
            sent = pkg.soak.SoakSentinels(sched=_stub_sched(sizes),
                                          rss_reader=lambda: 0)
            for v in series:
                sizes["why_pending"] = v
                sent.sample(tag="phase-end", clean=True)
            out.append((sent.leaking(),
                        sent.growth_report()["sched.why_pending"]))
        return out

    (ratchet, rep), (saw, _), (flat, _) = both(script)
    assert ratchet == ["sched.why_pending"] and rep["growth"] == 7
    assert saw == [] and flat == []


def test_growth_verdict_needs_three_clean_samples():
    def script(pkg):
        sizes = {"why_pending": 0}
        sent = pkg.soak.SoakSentinels(sched=_stub_sched(sizes),
                                      rss_reader=lambda: 0)
        for v in (0, 50):
            sizes["why_pending"] = v
            sent.sample(tag="phase-end", clean=True)
        return sent.leaking(), sent.growth_report()["sched.why_pending"]

    leaking, rep = both(script)
    assert leaking == [] and not rep["judged"]


def test_tolerance_prefix_matching_and_override():
    def script(pkg):
        sizes = {"interned_items": 0}
        sent = pkg.soak.SoakSentinels(sched=_stub_sched(sizes),
                                      rss_reader=lambda: 0,
                                      tolerance={"rss_kb": 999999.0})
        for v in (0, 100, 200):
            sizes["interned_items"] = v
            sent.sample(tag="phase-end", clean=True)
        out = [sent.leaking(), sent.tolerance["rss_kb"],
               sent.tolerance["sched.interned_items"]]
        sizes["interned_items"] = 10 ** 6
        sent.sample(tag="cadence", clean=False)
        return out + [sent.leaking(),
                      pkg.soak._tolerance("reflector.3.tombstones",
                                          sent.tolerance)]

    assert both(script) == [[], 999999.0, 256, [], 8192]
    assert _ported(tsoak.DEFAULT_TOLERANCE) == _ported(jsoak.DEFAULT_TOLERANCE)


def test_gauge_freshness_counts_writes_not_value_changes():
    def script(pkg):
        reg = pkg.metrics.Registry()
        maintained = reg.register(pkg.metrics.Gauge("maintained", ""))
        abandoned = reg.register(pkg.metrics.Gauge("abandoned", ""))
        maintained.set(0.0)
        abandoned.set(3.0)
        sent = pkg.soak.SoakSentinels(
            registry=reg, fresh_gauges=["maintained", "abandoned"],
            rss_reader=lambda: 0)
        sent.sample()
        maintained.set(0.0)
        sent.sample()
        maintained.set(0.0)
        sent.sample()
        return sent.stale_since(1), sent.gauge_ages()

    stale, _ = both(script)
    assert stale == ["abandoned"]


# ---------------------------------------------------------------------------
# the structures and livelocks the soak watches
# ---------------------------------------------------------------------------


def test_reflector_tombstone_lru_bounded():
    def script(pkg):
        hub = pkg.sim.HollowCluster(
            seed=3, scheduler_kw={"enable_preemption": False, **pkg.kw})
        hub.add_node(pkg.testing.make_node("n0", cpu_milli=64000))
        sink = pkg.scheduler.Scheduler(clock=hub.clock,
                                       enable_preemption=False, **pkg.kw)
        r = pkg.sim.Reflector(hub, sink)
        r.tombstone_capacity = 8
        r.list_and_watch()
        for i in range(50):
            hub.create_pod(pkg.testing.make_pod(f"t{i}", cpu_milli=10))
            hub.delete_pod(f"default/t{i}")
            r.pump()
        sample = pkg.soak.SoakSentinels(reflectors=[r],
                                        rss_reader=lambda: 0).collect()
        return (len(r._gone_rev),
                sorted(k for k in r._obj_rev if k.startswith("pods/")),
                sample)

    gone, live_pods, sample = both(script)
    assert gone <= 8 and live_pods == []
    assert sample["reflector.0.tombstones"] == gone


def test_pod_side_state_returns_to_baseline_on_exit():
    def script(pkg):
        t = Truth(pkg.faults)
        s, clock = _sched(pkg, t)
        s.on_node_add(pkg.testing.make_node("n0", cpu_milli=8000))
        for i in range(4):
            p = pkg.testing.make_pod(f"p{i}", cpu_milli=100)
            t.register(p)
            s.on_pod_add(p)
        res = s.schedule_cycle()
        _confirm(s, res)
        for i in range(4):
            key = f"default/p{i}"
            pod = s.cache.pod(key)
            t.delete(key)
            s.on_pod_delete(pod)
        clock.advance(120.0)
        s.schedule_cycle()
        return res.scheduled, _ported(s.state_sizes())

    scheduled, sizes = both(script)
    assert scheduled == 4
    for key in ("why_pending", "ambiguous_binds", "cycle_states",
                "waiting_pods", "queue_pending", "cache_assumed",
                "cache_pods", "packer_pod_refs", "journey_pending"):
        assert sizes[key] == 0, (key, sizes)


def test_gang_member_rebind_is_not_livelocked():
    def script(pkg):
        t = Truth(pkg.faults)
        s, clock = _sched(pkg, t)
        s.on_node_add(pkg.testing.make_node("n0", cpu_milli=8000))
        s.on_node_add(pkg.testing.make_node("n1", cpu_milli=8000))
        gang = [pkg.testing.make_pod(f"g{i}", cpu_milli=100,
                                     pod_group="job",
                                     pod_group_min_available=3)
                for i in range(3)]
        t.script = ["ok", "ok", "error"]
        for p in gang:
            t.register(p)
            s.on_pod_add(p)
        res = s.schedule_cycle()
        out = [len(t.bound), res.bind_errors, s.cache.group_members("job")]
        for _ in range(30):
            clock.advance(10.0)
            if s.schedule_cycle().scheduled:
                break
        return out + [len(t.bound), t.double_bind_attempts]

    assert both(script) == [2, 1, 2, 3, 0]


def test_warmup_registers_nominated_solve_variant():
    """With preemption on, the warmup registers the masked (nominated
    pods) solve signature beside the plain one, so the first cycle after
    a preemption is no new capture; without it, only the plain one."""
    def script(pkg):
        out = []
        for preempt in (True, False):
            captured = []
            t = Truth(pkg.faults)
            s, _ = _sched(pkg, t, enable_preemption=preempt,
                          warmup=pkg.config.WarmupConfig(
                              enabled=True, pod_buckets=(4,),
                              include_filter=False))
            s.on_node_add(pkg.testing.make_node("n0", cpu_milli=8000))
            orig = s.obs.jax.record_call

            def spy(site, *trees, static=None, warmup=False,
                    orig=orig, captured=captured):
                if site == "solve" and warmup and static is not None:
                    captured.append(static[8])
                return orig(site, *trees, static=static, warmup=warmup)

            s.obs.jax.record_call = spy
            warmed = s.warmup(sample_pods=[pkg.testing.make_pod(
                "w", cpu_milli=100)])
            out.append((warmed, sorted(set(captured))))
        return out

    assert both(script) == [(1, [False, True]), (1, [True])]


# ---------------------------------------------------------------------------
# the composed fake-clock soak
# ---------------------------------------------------------------------------


class MiniSoak:
    """The reference's day-in-the-life arc compressed to a fake clock,
    without its scenario pack: one scheduler, one truth, scripted
    traffic, chaos and preemption phases, the auditor and the sentinels
    armed throughout. Single-threaded, so every phase boundary is exact."""

    def __init__(self, pkg, seed: int) -> None:
        self.pkg = pkg
        self.rng = random.Random(seed)
        self.clock = FakeClock()
        self.injector = pkg.faults.FaultInjector(seed=seed)
        self.truth = Truth(pkg.faults)
        self.sched, _ = _sched(pkg, self.truth, clock=self.clock,
                               enable_preemption=True,
                               fault_injector=self.injector)
        for i in range(2):
            self.sched.on_node_add(
                pkg.testing.make_node(f"n{i}", cpu_milli=8000, pods=64))
        self.auditor = self.sched.attach_auditor(pkg.audit.StateAuditor())
        self.victims: list = []
        self.sched.victim_deleter = self.victims.append
        self.seq = 0
        self.created = 0

    def spawn(self, priority: int = 0, group: str = "",
              min_available: int = 0) -> None:
        self.seq += 1
        p = self.pkg.testing.make_pod(
            f"m{self.seq}", cpu_milli=1000, priority=priority,
            pod_group=group, pod_group_min_available=min_available)
        self.truth.register(p)
        self.sched.on_pod_add(p)
        self.created += 1

    def cycle(self) -> None:
        res = self.sched.schedule_cycle()
        for v in self.victims:
            self.truth.delete(v.key())
            self.sched.on_pod_delete(v)
        self.victims.clear()
        _confirm(self.sched, res)

    def drain(self) -> None:
        for _ in range(40):
            if sum(self.sched.queue.pending_counts().values()) == 0:
                return
            self.clock.advance(10.0)
            self.sched.queue.move_all_to_active()
            self.cycle()

    def audit(self) -> None:
        self.auditor.audit(self.sched, truth_pods=self.truth.list_pods())


def _soak(pkg, seed):
    m = MiniSoak(pkg, seed)
    sent = pkg.soak.SoakSentinels(
        sched=m.sched, registry=m.sched.metrics.registry,
        fresh_gauges=["scheduler_pending_pods"], rss_reader=lambda: 0)
    counters = pkg.soak.standard_counters(
        m.sched, auditor=m.auditor,
        extra={"double_binds": lambda: float(m.truth.double_bind_attempts),
               "preempted":
               lambda: float(m.sched.metrics.preemption_victims.value())})
    engine = pkg.soak.SoakEngine(
        phases=[], sentinels=sent, counters=counters,
        clean_zero=("slo_burns", "auditor_violations", "double_binds",
                    "retraces", "fenced_binds", "preempted"),
        clock=m.clock, sleep=m.clock.advance, step_s=1.0,
        sample_every_s=4.0)

    def prio():
        r = m.rng.random()
        return 0 if r < 0.6 else (50 if r < 0.9 else 100)

    def traffic_tick(_elapsed):
        m.spawn(priority=prio())
        m.cycle()

    gang = {"done": False}

    def gang_tick(elapsed):
        if int(elapsed) == 2 and not gang["done"]:
            gang["done"] = True
            m.spawn(group="mgang", min_available=2)
            m.spawn(group="mgang", min_available=2)
        traffic_tick(elapsed)

    def clean_tick(_elapsed):
        m.cycle()

    def chaos_arm():
        m.injector.arm("rpc:bind", "rpc_error", rate=0.3)

    def chaos_disarm():
        m.injector.rules.clear()
        m.drain()

    def cascade_tick(_elapsed):
        m.spawn(priority=100)
        m.cycle()

    def clean_probe():
        m.audit()
        return {"resident": len(m.truth.bound),
                "queue": sum(m.sched.queue.pending_counts().values())}

    P = pkg.soak.SoakPhase
    engine.phases = [
        P("traffic", 8.0, "traffic", tick=gang_tick, disarm=m.drain),
        P("clean-1", 4.0, "clean", tick=clean_tick, probe=clean_probe),
        P("rpc-chaos", 6.0, "chaos", arm=chaos_arm, tick=traffic_tick,
          disarm=chaos_disarm),
        P("clean-2", 4.0, "clean", tick=clean_tick, probe=clean_probe),
        P("cascade", 4.0, "chaos", tick=cascade_tick, disarm=m.drain),
        P("clean-3", 4.0, "clean", tick=clean_tick, probe=clean_probe),
    ]
    engine.attach(m.sched)
    record = engine.run()
    return m, record


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fake_clock_soak_sequence(seed):
    """Traffic with priority tiers and a gang, an rpc-error chaos window
    and a preemption cascade, each followed by a clean phase where the
    clean-zero counters must not move: the phase reports, the counter
    totals, the growth verdicts and the end state equal the
    reference's."""
    def script(pkg):
        m, record = _soak(pkg, seed)
        phases = [{**r, "counters_delta": _ported(r["counters_delta"])}
                  for r in record["phases"]]
        growth = _ported(record["sentinels"]["growth"])
        return (phases, _ported(record["counters_total"]), growth,
                record["verdict"], m.truth.double_bind_attempts,
                m.auditor.violations_total, len(m.truth.bound),
                len(m.truth.spec), m.created,
                m.sched.metrics.preemption_victims.value(),
                m.sched.soak.status()["phases_done"])

    (phases, totals, growth, verdict, doubles, violations, bound, spec,
     created, victims, done) = both(script)
    assert doubles == 0 and violations == 0
    assert all(r["ok"] for r in phases), phases
    assert verdict["ok"] and verdict["sentinels_flat"]
    assert bound == spec and len(done) == 6
    if created > 16:
        assert victims > 0
