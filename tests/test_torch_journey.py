"""Pod journeys in the port (``obs/journey.py``, the queue's residency
seams, the scheduler's bind-path notes and ``/debug/journeys``) held
against the JAX package: the cases of tests/test_journey.py that do not
need the incident recorder (ROADMAP A.13 slice 2).

Every case runs one script through both packages on a fake clock and
compares what it returns: timelines (phases, shares, attempt rows, raw
events), the ``/debug/journeys`` bodies, the retention sizes and the
exposition of ``scheduler_pod_journey_phase_seconds`` and
``scheduler_pod_journeys_total``. The reference's host-cost budget
(``test_journey_overhead_under_budget_on_contended_cycle``) is a timing
assertion; the port's cost is measured on the card's host by
``chip_smoke.py``'s pipeline phase instead, and not gated here."""

from types import SimpleNamespace

import pytest

import kubernetes_tpu.config as jconfig
import kubernetes_tpu.faults as jfaults
import kubernetes_tpu.obs.journey as jjourney
import kubernetes_tpu.scheduler as jscheduler
import kubernetes_tpu.server as jserver
import kubernetes_tpu.soak as jsoak
import kubernetes_tpu.testing as jtesting
import kubernetes_tpu_torch.config as tconfig
import kubernetes_tpu_torch.faults as tfaults
import kubernetes_tpu_torch.obs.journey as tjourney
import kubernetes_tpu_torch.scheduler as tscheduler
import kubernetes_tpu_torch.server as tserver
import kubernetes_tpu_torch.soak as tsoak
import kubernetes_tpu_torch.testing as ttesting
from kubernetes_tpu_torch.ops.sync import SYNCS
from torch_parity import FakeClock

REF = SimpleNamespace(config=jconfig, faults=jfaults, journey=jjourney,
                      scheduler=jscheduler, server=jserver, soak=jsoak,
                      testing=jtesting, kw={})
PORT = SimpleNamespace(config=tconfig, faults=tfaults, journey=tjourney,
                       scheduler=tscheduler, server=tserver, soak=tsoak,
                       testing=ttesting, kw={"device": "cpu"})


def both(script):
    """``script(pkg)`` on each package; the port returns what the
    reference returns. Returns the port's result."""
    want, got = script(REF), script(PORT)
    assert got == want, (got, want)
    return got


def families(s):
    """The journey families' samples."""
    m = s.metrics
    return (m.pod_journey_phase_seconds.expose()
            + m.pod_journeys_total.expose())


class Truth:
    """A scriptable hub: a binder that can commit then time out (the
    ambiguous class) and the GET the scheduler verifies against, raising
    its package's fault types."""

    def __init__(self, faults) -> None:
        self.faults = faults
        self.bound: dict = {}
        self.uids: dict = {}
        self.script: list = []
        self.reader_down = False

    def bind(self, pod, node_name: str) -> None:
        self.uids[pod.key()] = pod.uid
        action = self.script.pop(0) if self.script else "ok"
        if action == "error":
            raise self.faults.RPCError("injected: definitely not committed")
        if action == "timeout_committed":
            self.bound[pod.key()] = node_name
            raise self.faults.RPCTimeout("injected: committed, answer lost")
        if action == "timeout_lost":
            raise self.faults.RPCTimeout("injected: not committed")
        self.bound[pod.key()] = node_name

    def read(self, key: str):
        if self.reader_down:
            raise self.faults.RPCTimeout("injected: GET unreachable")
        if key not in self.uids:
            return None
        return SimpleNamespace(uid=self.uids[key],
                               node_name=self.bound.get(key, ""))


def _sched(pkg, **kw):
    truth = Truth(pkg.faults)
    clk = FakeClock()
    s = pkg.scheduler.Scheduler(
        binder=truth, clock=clk, enable_preemption=False,
        retry_sleep=lambda _s: None, jitter_seed=1,
        pod_reader=truth.read, **pkg.kw, **kw)
    s.on_node_add(pkg.testing.make_node("n0", cpu_milli=8000))
    return s, clk, truth


# ---------------------------------------------------------------------------
# the tracker itself (fake clock, driven directly)
# ---------------------------------------------------------------------------


def test_phase_decomposition_sums_to_e2e():
    def script(pkg):
        clk = FakeClock()
        jt = pkg.journey.JourneyTracker(pkg.config.JourneysConfig(),
                                        clock=clk)
        jt.note_created("d/p", "u1")
        clk.advance(2.0)
        jt.note_popped("d/p", 1)
        clk.advance(0.5)
        jt.note_bind_start("d/p")
        clk.advance(0.25)
        jt.note_bound("d/p", 1)
        return jt.timeline("d/p")

    doc = both(script)
    assert doc["outcome"] == "bound"
    assert doc["e2e_s"] == pytest.approx(2.75)
    assert sum(doc["phases_s"].values()) == pytest.approx(doc["e2e_s"])
    assert doc["phases_s"] == {"bind-rpc": 0.25, "queue-wait": 2.0,
                               "solve": 0.5}


def test_retention_slowest_k_rolling_window_and_sampling():
    def script(pkg):
        clk = FakeClock()
        jt = pkg.journey.JourneyTracker(
            pkg.config.JourneysConfig(slow_k=2, sample_every=3,
                                      window_s=100.0), clock=clk)
        for i in range(6):
            jt.note_created(f"d/p{i}", "u")
            clk.advance(float(i))
            jt.note_bound(f"d/p{i}", i)
        out = [jt.sizes(), [j["pod"] for j in jt.snapshot()["slowest"]]]
        clk.advance(200.0)
        jt.note_created("d/late", "u")
        clk.advance(1.0)
        jt.note_bound("d/late", 9)
        return out + [[j["pod"] for j in jt.snapshot()["slowest"]],
                      jt.timeline("d/late")["done"]]

    got = both(script)
    assert got[0]["journey_slowest"] == 2 and got[0]["journey_sampled"] == 2
    assert got[1:] == [["d/p5", "d/p4"], ["d/late"], True]


def test_pending_cap_counts_drops_and_gone_closes():
    def script(pkg):
        jt = pkg.journey.JourneyTracker(
            pkg.config.JourneysConfig(max_pending=2), clock=FakeClock())
        for k in ("d/a", "d/b", "d/c"):
            jt.note_created(k, "u")
        out = [jt.dropped_total, jt.sizes()["journey_pending"]]
        jt.note_gone("d/a")
        return out + [jt.gone_total, jt.sizes()["journey_pending"],
                      jt.timeline("d/a")]

    assert both(script) == [1, 2, 1, 1, None]


def test_event_ring_elides_beyond_max_events():
    def script(pkg):
        jt = pkg.journey.JourneyTracker(
            pkg.config.JourneysConfig(max_events=4), clock=FakeClock())
        jt.note_created("d/p", "u")
        for i in range(10):
            jt.note_queue("d/p", "backoff" if i % 2 else "active")
        return jt.timeline("d/p")

    doc = both(script)
    assert len(doc["events"]) == 4 and doc["events_elided"] > 0


def test_disabled_tracker_is_inert():
    def script(pkg):
        jt = pkg.journey.JourneyTracker(
            pkg.config.JourneysConfig(enabled=False), clock=FakeClock())
        jt.note_created("d/p", "u")
        jt.note_bound("d/p", 1)
        return (jt.sizes(), jt.snapshot()["enabled"], jt.created_total,
                jt.bound_total)

    assert both(script) == ({"journey_pending": 0, "journey_slowest": 0,
                             "journey_sampled": 0}, False, 0, 0)


# ---------------------------------------------------------------------------
# driven through the scheduler and /debug/journeys
# ---------------------------------------------------------------------------


def test_slow_pod_journey_explains_e2e_latency():
    """The pod fails its first bind, serves a backoff window and lands
    on retry: ``/debug/journeys?pod=`` decomposes its e2e latency into
    the phases where the seconds were spent, equal to the reference's."""
    def script(pkg):
        s, clk, truth = _sched(pkg)
        s.on_pod_add(pkg.testing.make_pod("slow", cpu_milli=100))
        clk.advance(1.0)
        truth.script = ["error"]
        r1 = s.schedule_cycle()
        clk.advance(0.5)
        s.on_node_add(pkg.testing.make_node("n1", cpu_milli=8000))
        clk.advance(3.0)
        r2 = s.schedule_cycle()
        code, doc = pkg.server.journeys_payload(
            s, "/debug/journeys?pod=default/slow")
        h = s.metrics.e2e_scheduling_duration
        return (r1.scheduled, r2.scheduled, code, doc, h.count(),
                sum(h._sum.values()), families(s))

    got = both(script)
    assert got[:3] == (0, 1, 200)
    doc = got[3]
    assert doc["outcome"] == "bound" and doc["e2e_s"] == pytest.approx(4.5)
    assert doc["phases_s"]["backoff"] == pytest.approx(3.0)
    assert doc["phases_s"]["queue-wait"] == pytest.approx(1.5)
    assert ("failed", True) in [(a["outcome"], a["tier"] != "")
                                for a in doc["attempts"]]
    assert got[4:6] == (2, pytest.approx(4.5))
    assert 'scheduler_pod_journeys_total{outcome="bound"} 1.0' in got[6]


def test_debug_journeys_bare_name_and_unknown_pod():
    def script(pkg):
        s, clk, _ = _sched(pkg)
        s.on_pod_add(pkg.testing.make_pod("web", cpu_milli=100))
        clk.advance(0.5)
        s.schedule_cycle()
        return [pkg.server.journeys_payload(s, path) for path in (
            "/debug/journeys", "/debug/journeys?pod=web",
            "/debug/journeys?pod=nope")]

    (c1, bare), (c2, one), (c3, unknown) = both(script)
    assert (c1, c2, c3) == (200, 200, 404)
    assert bare["bound"] == 1 and bare["slowest"][0]["pod"] == "default/web"
    assert one["pod"] == "default/web" and "default/web" in unknown["known"]


def test_debug_journeys_404_when_disabled():
    def script(pkg):
        s = pkg.scheduler.Scheduler(
            enable_preemption=False,
            observability=pkg.config.ObservabilityConfig(
                journeys=pkg.config.JourneysConfig(enabled=False)),
            **pkg.kw)
        return pkg.server.journeys_payload(s, "/debug/journeys")

    code, doc = both(script)
    assert code == 404 and "error" in doc


def test_state_sizes_exports_journey_occupancy():
    def script(pkg):
        s, clk, _ = _sched(pkg)
        for i in range(3):
            s.on_pod_add(pkg.testing.make_pod(f"p{i}", cpu_milli=100))
        before = {k: v for k, v in s.state_sizes().items()
                  if k.startswith("journey_")}
        clk.advance(0.2)
        s.schedule_cycle()
        after = {k: v for k, v in s.state_sizes().items()
                 if k.startswith("journey_")}
        return before, after

    before, after = both(script)
    assert before["journey_pending"] == 3 and after["journey_pending"] == 0


def test_queue_seams_and_pod_events_close_journeys_like_the_reference():
    """The queue's residency seams (add, sub-queue moves, pop), a watch
    delete and a competing writer's bind: every timeline and counter."""
    def script(pkg):
        s, clk, _ = _sched(pkg)
        mk = pkg.testing.make_pod
        pods = [mk(f"q{i}", cpu_milli=100) for i in range(4)]
        for p in pods:
            s.on_pod_add(p)
            clk.advance(0.1)
        s.on_pod_delete(pods[0])
        bound_elsewhere = mk("q1", cpu_milli=100, node_name="n0")
        s.on_pod_update(pods[1], bound_elsewhere)
        clk.advance(1.0)
        s.schedule_cycle()
        jt = s.obs.journeys
        return ({k: jt.timeline(k) for k in sorted(jt.keys())},
                jt.created_total, jt.bound_total, jt.gone_total,
                families(s))

    got = both(script)
    assert got[1:4] == (4, 2, 2)


# ---------------------------------------------------------------------------
# e2e latency provenance on the ambiguous-bind paths
# ---------------------------------------------------------------------------


def test_adopted_ambiguous_bind_observes_create_to_bind():
    def script(pkg):
        s, clk, truth = _sched(pkg)
        s.on_pod_add(pkg.testing.make_pod("amb", cpu_milli=100))
        clk.advance(3.0)
        truth.script = ["timeout_committed"]
        r = s.schedule_cycle()
        h = s.metrics.e2e_scheduling_duration
        return (r.scheduled, h.count(), sum(h._sum.values()),
                s.obs.journeys.timeline("default/amb"), families(s))

    got = both(script)
    assert got[:3] == (1, 1, pytest.approx(3.0))


def test_parked_adoption_observes_create_to_bind():
    def script(pkg):
        s, clk, truth = _sched(pkg)
        s.on_pod_add(pkg.testing.make_pod("amb", cpu_milli=100))
        clk.advance(1.0)
        truth.script = ["timeout_committed"]
        truth.reader_down = True
        r = s.schedule_cycle()
        h = s.metrics.e2e_scheduling_duration
        before = (h.count(), sum(h._sum.values()))
        clk.advance(6.0)
        truth.reader_down = False
        s.idle_tick()
        return (r.scheduled, before, h.count(), sum(h._sum.values()),
                s.obs.journeys.timeline("default/amb"), families(s))

    got = both(script)
    assert got[:4] == (0, (1, 0.0), 2, pytest.approx(7.0))
    doc = got[4]
    assert doc["outcome"] == "bound"
    assert doc["phases_s"]["ambiguous"] == pytest.approx(6.0)


def test_offcycle_requeue_emits_no_bogus_near_zero_sample():
    def script(pkg):
        s, clk, truth = _sched(pkg)
        s.on_pod_add(pkg.testing.make_pod("lost", cpu_milli=100))
        truth.script = ["timeout_lost"]
        truth.reader_down = True
        r = s.schedule_cycle()
        truth.reader_down = False
        before = s.metrics.e2e_scheduling_duration.count()
        s.idle_tick()
        return (r.scheduled, "default/lost" in s._ambiguous_binds,
                s.metrics.e2e_scheduling_duration.count() - before,
                s.obs.journeys.timeline("default/lost"))

    got = both(script)
    assert got[:3] == (0, False, 0) and not got[3]["done"]


# ---------------------------------------------------------------------------
# soak integration and the device budget
# ---------------------------------------------------------------------------


def test_soak_sentinels_and_counters_carry_the_journey_namespaces():
    def script(pkg):
        s, clk, _ = _sched(pkg)
        s.on_pod_add(pkg.testing.make_pod("p", cpu_milli=100))
        clk.advance(0.1)
        s.schedule_cycle()
        sample = pkg.soak.SoakSentinels(sched=s,
                                        rss_reader=lambda: 0).collect()
        counters = pkg.soak.standard_counters(s)
        return ({k: v for k, v in sample.items()
                 if k.startswith(("journey.", "sched.journey_"))},
                counters["journey_drops"]())

    sample, drops = both(script)
    assert sample["journey.pending"] == 0.0 and drops == 0.0
    assert tsoak.DEFAULT_TOLERANCE["journey.pending"] == 0


def test_zero_new_retraces_and_no_device_reads_with_journeys_on():
    """The tracker is host bookkeeping: with journeys on, a cycle makes
    the same counted reads and solve signatures as with them off."""
    def run(enabled):
        s, clk, _ = _sched(PORT, observability=tconfig.ObservabilityConfig(
            journeys=tconfig.JourneysConfig(enabled=enabled)))
        syncs = []
        for c in range(4):
            for i in range(8):
                s.on_pod_add(ttesting.make_pod(f"c{c}-{i}", cpu_milli=10))
            clk.advance(0.1)
            before = SYNCS.count
            s.schedule_cycle()
            syncs.append(SYNCS.count - before)
        return syncs, s.obs.jax.retrace_total()

    on, off = run(True), run(False)
    assert on == off and on[1] == 0
