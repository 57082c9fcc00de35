"""The port's serving layer (``kubernetes_tpu_torch/serving``) against the
JAX package's (``kubernetes_tpu/serving``): the doorbell, the micro-batch
window and the serving loop's decisions on a fake clock, APF flow
control, the watch hub, the composed runtime and the scheduler's serving
hooks (``attach_doorbell``, ``idle_tick``, ``backend_pressure``,
``schedule_cycle(flush_trigger, window_s)``). Each case runs the same
script through both packages (the port on CPU tensors) and compares what
they decided; the real-time pieces are bounded (a short churn through
the threaded loop, a kernel fault escaping it)."""

import threading
import time

import pytest

import kubernetes_tpu.serving as jserving
import kubernetes_tpu_torch.serving as tserving
from kubernetes_tpu.config import ServingConfig as JServingConfig
from kubernetes_tpu.config import WarmupConfig as JWarmupConfig
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.testing import make_node, make_pod
from kubernetes_tpu_torch.config import ServingConfig as TServingConfig
from kubernetes_tpu_torch.config import WarmupConfig as TWarmupConfig
from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler
from torch_parity import FakeClock, to_port

PKGS = {"jax": (jserving, JScheduler, JServingConfig, JWarmupConfig, {}),
        "port": (tserving, TScheduler, TServingConfig, TWarmupConfig,
                 {"device": "cpu"})}


def _scheduler(pkg, n_nodes=8, clock=None, **kw):
    _, S, _, _, extra = PKGS[pkg]
    kw.setdefault("enable_preemption", False)
    if clock is not None:
        kw["clock"] = clock
    s = S(**extra, **kw)
    conv = to_port if pkg == "port" else (lambda x: x)
    for i in range(n_nodes):
        s.on_node_add(conv(make_node(f"n{i}", cpu_milli=16000,
                                     memory=64 * 2**30, pods=250)))
    return s, conv


def _both(fn):
    """``fn(pkg)`` for each package; asserts they agree, returns it."""
    got = {pkg: fn(pkg) for pkg in PKGS}
    assert got["port"] == got["jax"], got
    return got["port"]


# ---------------------------------------------------------------------------
# doorbell
# ---------------------------------------------------------------------------


def test_doorbell_ring_pending_consume_matches_reference():
    def script(pkg):
        bell = PKGS[pkg][0].Doorbell()
        out = [bell.pending(), bell.consume()]
        bell.ring("queue:PodAdd")
        bell.ring("rest:create")
        out += [bell.pending(), bell.rings_total, dict(bell.rings_by_reason),
                bell.consume(), bell.pending()]
        bell.ring()
        out += [bell.wait(timeout=0), bell.wait(timeout=0)]
        return out

    assert _both(script) == [0, 0, 2, 2, {"queue:PodAdd": 1,
                                          "rest:create": 1}, 2, 0,
                             True, False]


def test_doorbell_wakes_waiter_across_threads():
    bell = tserving.Doorbell()
    out = {}

    def waiter():
        out["rung"] = bell.wait(timeout=2.0)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.02)
    bell.ring("x")
    t.join(timeout=2.0)
    assert not t.is_alive() and out["rung"] is True


def test_queue_rings_doorbell_on_work_not_on_failures():
    def script(pkg):
        s, conv = _scheduler(pkg, n_nodes=1, clock=FakeClock())
        bell = s.attach_doorbell(PKGS[pkg][0].Doorbell())
        assert s.queue.doorbell is bell
        s.queue.add(conv(make_pod("a", cpu_milli=100)))
        out = [dict(bell.rings_by_reason)]
        p = conv(make_pod("b", cpu_milli=100))
        before = bell.rings_total
        s.queue.record_failure(p)
        s.queue.add_unschedulable_if_not_present(p, 1)
        out.append(bell.rings_total - before)
        s.queue.move_all_to_active()
        out.append(dict(bell.rings_by_reason))
        out.append(s.metrics.doorbell_rings.value(reason="queue:PodAdd"))
        clk = FakeClock()
        s2, conv = _scheduler(pkg, n_nodes=1, clock=clk)
        bell2 = s2.attach_doorbell(PKGS[pkg][0].Doorbell())
        stuck = conv(make_pod("stuck", cpu_milli=100))
        s2.queue.record_failure(stuck)
        s2.queue.add_unschedulable_if_not_present(stuck, 1)
        clk.advance(30.0)
        before = bell2.rings_total
        s2.on_node_add(conv(make_node("n-new", cpu_milli=4000)))
        out.append(bell2.rings_total > before)
        return out

    got = _both(script)
    assert got[1] == 0 and got[3] == 1 and got[4] is True


# ---------------------------------------------------------------------------
# micro-batch window and serving loop (fake clock)
# ---------------------------------------------------------------------------

#: (advance seconds, depth) observations, the window's whole decision table
WINDOW_SCRIPT = (
    (0.0, 0), (0.0, 5), (0.01, 5), (0.05, 5), ("close",),
    (0.0, 3), (0.006, 13), (0.0, 16), ("close",),
    (0.0, 16), (0.006, 4), (0.0, 0),
    (0.0, 512), ("close",),
    (0.0, 7), (0.0, 0), (0.02, 9), (0.01, 9), (0.05, 9), ("close",),
)


@pytest.mark.parametrize("target,min_wait,max_wait", [
    (256, 0.005, 0.05), (1000, 0.005, 0.05), (64, 0.0, 0.05),
    (16, 0.002, 0.02)])
def test_window_decisions_match_reference(target, min_wait, max_wait):
    def script(pkg):
        clk = FakeClock()
        w = PKGS[pkg][0].MicroBatchWindow(clock=clk, min_wait_s=min_wait,
                                          max_wait_s=max_wait,
                                          target_bucket=target)
        out = [w.target_bucket]
        for step in WINDOW_SCRIPT:
            if step[0] == "close":
                out.append(("close", round(w.close(), 9), w.open))
                continue
            clk.advance(step[0])
            d = w.observe(step[1])
            out.append((d.flush, d.trigger, round(d.wait_s, 9), w.open))
        return out

    _both(script)


def test_window_rejects_inverted_waits():
    for pkg in PKGS:
        with pytest.raises(ValueError):
            PKGS[pkg][0].MicroBatchWindow(min_wait_s=0.1, max_wait_s=0.05)


def test_serving_loop_run_once_matches_reference():
    """The same event script through both packages' ServingLoop.run_once
    on a fake clock: the flush triggers, window lengths, popped batch
    sizes, bindings and per-pod create-to-bind latencies agree."""
    # (advance, pods to add this step) before each run_once
    script = ((0.0, 3), (0.01, 0), (0.05, 0), (0.0, 16), (0.0, 5),
              (0.006, 3), (0.0, 0), (0.05, 0), (0.0, 9), (0.003, 0),
              (0.06, 0), (0.0, 0))

    def run(pkg):
        mod, _, Cfg, _, _ = PKGS[pkg]
        clk = FakeClock()
        s, conv = _scheduler(pkg, n_nodes=4, clock=clk)
        bell = s.attach_doorbell(mod.Doorbell())
        loop = mod.ServingLoop(
            s, bell, Cfg(enabled=True, min_wait_s=0.005, max_wait_s=0.05,
                         target_bucket=16, idle_wait_s=0.01), clock=clk)
        out = [s.max_batch, loop.window.target_bucket]
        n = 0
        for dt, add in script:
            clk.advance(dt)
            for _ in range(add):
                loop.ingest(s.on_pod_add,
                            conv(make_pod(f"s{n}", cpu_milli=100 + n)))
                n += 1
            r = loop.run_once()
            out.append(None if r is None else (
                r.flush_trigger, round(r.window_s, 9), r.attempted,
                sorted(r.assignments.items()),
                sorted((k, round(v, 9)) for k, v in r.e2e_latency_s.items())))
        out.append((loop.cycles, s.metrics.microbatch_flushes.value(
            trigger="bucket-fill"), s.metrics.microbatch_flushes.value(
            trigger="max-wait")))
        return out

    got = _both(run)
    flushed = [g for g in got[2:-1] if g is not None]
    assert {g[0] for g in flushed} == {"bucket-fill", "max-wait"}
    assert sum(g[2] for g in flushed) == 36


def test_flush_provenance_reaches_the_result_and_trace():
    def script(pkg):
        s, conv = _scheduler(pkg, n_nodes=2, clock=FakeClock())
        s.on_pod_add(conv(make_pod("p", cpu_milli=100)))
        r = s.schedule_cycle(flush_trigger="bucket-fill", window_s=0.012)
        return r.flush_trigger, r.window_s, r.scheduled

    assert _both(script) == ("bucket-fill", 0.012, 1)
    s, conv = _scheduler("port", n_nodes=2, clock=FakeClock())
    s.on_pod_add(conv(make_pod("p", cpu_milli=100)))
    s.schedule_cycle(flush_trigger="max-wait", window_s=0.05)
    rec = s.obs.recorder.records()[-1]
    assert rec.flush_trigger == "max-wait"
    assert rec.window_s == 0.05


def test_e2e_latency_is_per_pod_create_to_bind():
    def script(pkg):
        clk = FakeClock()
        s, conv = _scheduler(pkg, n_nodes=2, clock=clk)
        s.on_pod_add(conv(make_pod("early", cpu_milli=100)))
        clk.advance(0.2)
        s.on_pod_add(conv(make_pod("late", cpu_milli=100)))
        clk.advance(0.05)
        r = s.schedule_cycle()
        return ({k: round(v, 9) for k, v in r.e2e_latency_s.items()},
                s.metrics.e2e_scheduling_duration.count())

    assert _both(script) == ({"default/early": 0.25, "default/late": 0.05},
                             2)


def test_idle_tick_mints_no_cycle_and_resurfaces_backoff():
    def script(pkg):
        clk = FakeClock()
        s, conv = _scheduler(pkg, n_nodes=1, clock=clk)
        cycle0 = s.queue.scheduling_cycle
        for _ in range(20):
            s.idle_tick()
            clk.advance(0.25)
        out = [s.queue.scheduling_cycle - cycle0,
               s.metrics.e2e_scheduling_duration.count()]
        bell = s.attach_doorbell(PKGS[pkg][0].Doorbell())
        p = conv(make_pod("parked", cpu_milli=100))
        s.queue.record_failure(p)
        s.queue.add_unschedulable_if_not_present(p, -10)
        bell.consume()
        clk.advance(30.0)
        s.idle_tick()
        out += [s.queue.pending_counts()["active"],
                bell.rings_by_reason.get("queue:BackoffComplete")]
        return out

    assert _both(script) == [0, 0, 1, 1]
    s, _ = _scheduler("port", n_nodes=1, clock=FakeClock())
    s.idle_tick()
    assert s.obs.last_trace is None and len(s.obs.traces) == 0


def test_idle_tick_times_out_a_permit_parked_pod():
    """A Permit-parked pod on an idle loop times out and requeues purely
    from idle_tick, with its outcome in the metrics."""
    import kubernetes_tpu.framework as jfw
    import kubernetes_tpu_torch.framework as tfw

    def script(pkg):
        fw = jfw if pkg == "jax" else tfw

        class Gate(fw.Plugin):
            def permit(self, state, pod, node_name):
                return fw.Status(fw.WAIT, ""), 5.0

        clk = FakeClock()
        s, conv = _scheduler(pkg, n_nodes=1, clock=clk,
                             framework=fw.Framework(plugins=[Gate()],
                                                    clock=clk))
        s.on_pod_add(conv(make_pod("parked")))
        res = s.schedule_cycle()
        out = [res.waiting, s.cache.is_assumed("default/parked")]
        before = s.metrics.schedule_attempts.value(
            result=s.metrics.UNSCHEDULABLE)
        clk.advance(6)
        s.idle_tick()
        out += [s.framework.waiting.get("default/parked") is None,
                s.cache.is_assumed("default/parked"),
                s.queue.pod("default/parked") is not None,
                s.metrics.schedule_attempts.value(
                    result=s.metrics.UNSCHEDULABLE) - before]
        return out

    assert _both(script) == [1, True, True, False, True, 1]


# ---------------------------------------------------------------------------
# APF flow control
# ---------------------------------------------------------------------------


def test_flow_controller_seats_queue_and_saturation_match_reference():
    def script(pkg):
        mod = PKGS[pkg][0]
        out = []
        ctrl = mod.FlowController(flows=[mod.FlowSchema(
            "mutating", concurrency=2, queue_length=1, queue_timeout_s=0.0)],
            retry_after_s=3.0)
        s1, s2 = ctrl.acquire("mutating"), ctrl.acquire("mutating")
        with pytest.raises(mod.RequestRejected) as ei:
            ctrl.acquire("mutating")
        out.append((ei.value.reason, ei.value.retry_after_s, str(ei.value)))
        ctrl.release(s1)
        s3 = ctrl.acquire("mutating")
        ctrl.release(s2)
        ctrl.release(s3)
        out.append(ctrl.stats())
        full = mod.FlowController(flows=[mod.FlowSchema(
            "readonly", concurrency=1, queue_length=0, queue_timeout_s=5.0)])
        seat = full.acquire("readonly")
        t0 = time.monotonic()
        with pytest.raises(mod.RequestRejected) as ei:
            full.acquire("readonly")
        out.append((ei.value.reason, time.monotonic() - t0 < 1.0))
        full.release(seat)
        depth = {"v": 0}
        sat = mod.FlowController(flows=[mod.FlowSchema(
            "mutating", concurrency=16, queue_length=16,
            queue_timeout_s=0.0)])
        sat.set_saturation("mutating", lambda: depth["v"], maximum=100)
        sat.release(sat.acquire("mutating"))
        depth["v"] = 101
        with pytest.raises(mod.RequestRejected) as ei:
            sat.acquire("mutating")
        out.append(ei.value.reason)
        depth["v"] = 10
        sat.release(sat.acquire("mutating"))
        out.append(sat.stats())
        # exempt and unknown flows admit unmetered
        out.append((sat.acquire("exempt"), sat.acquire("nope")))
        return out

    got = _both(script)
    assert got[0][0] == "timeout" and got[2] == ("queue-full", True)
    assert got[3] == "saturated"


def test_flow_controller_fifo_drain():
    ctrl = tserving.FlowController(flows=[tserving.FlowSchema(
        "mutating", concurrency=1, queue_length=8, queue_timeout_s=2.0)])
    seat = ctrl.acquire("mutating")
    order = []
    lock = threading.Lock()

    def worker(i):
        s = ctrl.acquire("mutating")
        with lock:
            order.append(i)
        ctrl.release(s)

    threads = []
    for i in range(3):
        t = threading.Thread(target=worker, args=(i,))
        t.start()
        time.sleep(0.02)  # establish FIFO arrival order
        threads.append(t)
    ctrl.release(seat)
    for t in threads:
        t.join(timeout=2.0)
    assert not any(t.is_alive() for t in threads)
    assert order == [0, 1, 2]


@pytest.mark.parametrize("verb,path", [
    ("GET", "/healthz"), ("GET", "/metrics"), ("GET", "/version"),
    ("GET", "/debug/why?pod=x"), ("GET", "/api/v1/watch/pods?rv=3"),
    ("GET", "/apis/apps/v1/watch/deployments"), ("GET", "/api/v1/pods"),
    ("POST", "/api/v1/namespaces/default/pods"), ("DELETE", "/api/v1/n/x"),
    ("GET", "/api/v1/namespaces/watch/pods"), ("POST", "/scheduler/filter"),
    ("GET", "/openapi/v2")])
def test_flow_classification_matches_reference(verb, path):
    got = tserving.FlowController.classify(verb, path)
    assert got == jserving.FlowController.classify(verb, path)


def test_default_flows_match_reference():
    def script(pkg):
        mod = PKGS[pkg][0]
        from dataclasses import asdict

        return [asdict(f) for f in mod.fairness.default_flows(
            concurrency=4, queue_length=10, watch_concurrency=2,
            queue_timeout_s=0.5)]

    _both(script)


# ---------------------------------------------------------------------------
# watch hub
# ---------------------------------------------------------------------------


def test_watch_hub_eviction_accounting_matches_reference():
    def script(pkg):
        mod = PKGS[pkg][0]
        out = []
        hub = mod.WatchHub(buffer=2)
        fast, slow = hub.register(), hub.register()
        for i in range(3):
            hub.publish(("ADDED", i))
            out.append(len(fast.poll()))
        with pytest.raises(mod.WatcherGone) as ei:
            slow.poll()
        out += [str(ei.value), slow.dropped, hub.stats()]
        with pytest.raises(mod.WatcherGone):
            slow.poll()  # sticky
        slow.close()
        w = hub.register()
        hub.publish(("ADDED", 9))
        out.append(hub.evict_all("leadership change (takeover): relist"))
        with pytest.raises(mod.WatcherGone) as ei:
            w.poll()
        out += [str(ei.value), hub.stats()]
        return out

    got = _both(script)
    assert "send buffer overflowed" in got[3] and "relist" in got[3]
    assert "leadership change (takeover)" in got[-2]


def test_runtime_relists_watchers_on_every_leadership_change():
    """ServingRuntime.attach_elector chains the scheduler's recovery
    callbacks and the hub's relist eviction: a takeover and a deposition
    each evict every live watcher with its reason, in both packages."""
    from kubernetes_tpu import leaderelection as jle
    from kubernetes_tpu.config import LeaderElectionConfig as JLE
    from kubernetes_tpu_torch import leaderelection as tle
    from kubernetes_tpu_torch.config import LeaderElectionConfig as TLE

    def script(pkg):
        mod = PKGS[pkg][0]
        le, LE = (jle, JLE) if pkg == "jax" else (tle, TLE)
        cfg = LE(lease_duration_s=15, renew_deadline_s=10, retry_period_s=2)
        clk = FakeClock()
        s, _ = _scheduler(pkg, n_nodes=2, clock=clk)
        rt = mod.ServingRuntime(s, PKGS[pkg][2](enabled=True), clock=clk)
        lock = le.InMemoryLock()
        el = rt.attach_elector(le.LeaderElector("me", lock, cfg, clk))
        w = rt.hub.register()
        out = [el.tick(), s.fence is el]
        with pytest.raises(mod.WatcherGone) as ei:
            w.poll()
        out.append(str(ei.value))
        w.close()
        w2 = rt.hub.register()
        rival = le.LeaderElector("rival", lock, cfg, clk)
        rival.tick()
        clk.advance(16)
        out += [rival.tick(), el.tick()]
        with pytest.raises(mod.WatcherGone) as ei:
            w2.poll()
        out += [str(ei.value), rt.hub.stats()["evicted"],
                s.metrics.recovery_takeovers.value()]
        return out

    got = _both(script)
    assert got[0] is True and "takeover" in got[2] and "deposed" in got[5]


# ---------------------------------------------------------------------------
# the composed runtime and backend pressure
# ---------------------------------------------------------------------------


def test_runtime_composition_matches_reference():
    def script(pkg):
        mod, _, Cfg, Wu, _ = PKGS[pkg]
        s, _ = _scheduler(pkg, n_nodes=2, clock=FakeClock())
        rt = mod.ServingRuntime(s, Cfg(enabled=True, target_bucket=100),
                                warmup=Wu(enabled=True))
        rt2 = mod.ServingRuntime(
            _scheduler(pkg, n_nodes=1)[0],
            Cfg(enabled=True, shed_queue_bound=7),
            warmup=Wu(enabled=True, pod_buckets=(16,), min_bucket=512))
        return [s.warmup_config.min_bucket, s.max_batch,
                rt.loop.window.target_bucket, rt.shed_bound(),
                rt.sched.queue.doorbell is rt.bell, rt._warmup_pending,
                rt2.shed_bound(), rt2.sched.warmup_config.min_bucket]

    assert _both(script) == [8, 64, 64, 128, True, True, 7, 512]
    # the runtime's SLO surface is the scheduler's perf ledger; the
    # auditor stays off at the default audit interval
    rt = tserving.ServingRuntime(_scheduler("port", n_nodes=1)[0])
    assert rt.ledger is rt.sched.obs.ledger and rt.auditor is None


def test_backend_pressure_inflates_while_degraded():
    """backend_pressure is the active depth, times the degraded factor
    after a cycle that fell through the ladder (last_solver_fallbacks)
    or while the configured tier's breaker is open."""
    from kubernetes_tpu.config import RobustnessConfig as JR
    from kubernetes_tpu_torch.config import RobustnessConfig as TR

    def script(pkg):
        R = JR if pkg == "jax" else TR
        clk = FakeClock()
        s, conv = _scheduler(pkg, n_nodes=2, clock=clk,
                             robustness=R(solver_retries=0))
        for i in range(3):
            s.on_pod_add(conv(make_pod(f"q{i}", cpu_milli=100)))
        out = [s.backend_pressure(), s.is_degraded()]
        s.last_solver_fallbacks = 1
        out += [s.is_degraded(), s.backend_pressure(degraded_factor=4.0),
                s.backend_pressure(degraded_factor=0.5)]
        s.last_solver_fallbacks = 0
        br = s._breaker(f"solver:{s.solver}")
        for _ in range(s.robustness.breaker_failure_threshold):
            br.record_failure()
        out += [s.is_degraded(), s.backend_pressure(degraded_factor=2.0)]
        s.schedule_cycle()
        out += [s.last_solver_tier, s.last_solver_fallbacks,
                s.backend_pressure()]
        return out

    assert _both(script)[:5] == [3.0, False, True, 12.0, 3.0]


# ---------------------------------------------------------------------------
# the threaded loop: churn end to end, and a kernel fault escaping it
# ---------------------------------------------------------------------------


#: pods the churn test creates, in bursts of 3
CHURN_PODS = 150


def test_serving_runtime_churn_binds_everything():
    """Create/delete churn through the threaded ServingRuntime (warmup on,
    buckets 8 and 16): 150 pods created in bursts of 3, 20 ms apart, the
    oldest bound pods deleted past a backlog of 40. Every created pod
    binds exactly once, every flush is bucket-fill or max-wait, and no
    cycle captures a round-loop graph after the warmup. The count is
    fixed, so a loaded host slows the run instead of shrinking it."""
    s, conv = _scheduler("port", n_nodes=8)
    results = []
    rt = tserving.ServingRuntime(
        s, TServingConfig(enabled=True, min_wait_s=0.002, max_wait_s=0.02,
                          target_bucket=16, idle_wait_s=0.05),
        warmup=TWarmupConfig(enabled=True, pod_buckets=(8, 16)),
        on_cycle=results.append)
    warmed = rt.warm_if_pending(sample_pods=[conv(make_pod(
        "w", cpu_milli=50, memory=128 * 2**20))])
    assert warmed == 2 and not rt._warmup_pending
    stop = threading.Event()
    t = threading.Thread(target=rt.run, args=(stop,))
    t.start()
    created, seen, backlog = 0, 0, []
    try:
        for _ in range(CHURN_PODS // 3):
            for _ in range(3):
                rt.loop.ingest(s.on_pod_add, conv(make_pod(
                    f"churn-{created}", cpu_milli=50, memory=128 * 2**20)))
                created += 1
            while seen < len(results):
                backlog.extend(results[seen].assignments.items())
                seen += 1
            while len(backlog) > 40:
                key, node = backlog.pop(0)
                p = conv(make_pod(key.split("/", 1)[1], cpu_milli=50,
                                  memory=128 * 2**20, node_name=node))
                rt.loop.ingest(s.on_pod_delete, p)
            time.sleep(0.02)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and len(s.queue) > 0:
            time.sleep(0.02)
    finally:
        stop.set()
        t.join(timeout=10)
    assert not t.is_alive()
    bound = [k for r in results for k in r.assignments]
    assert len(bound) == len(set(bound)) == created == CHURN_PODS
    assert all(r.flush_trigger in ("bucket-fill", "max-wait")
               for r in results)
    assert sum(r.graph_captures for r in results) == 0
    lats = [v for r in results for v in r.e2e_latency_s.values()]
    assert len(lats) == created and max(lats) < 2.0


def test_serving_loop_lets_a_kernel_fault_out():
    """A KernelError inside a serve cycle ends ServingRuntime.run on the
    caller's thread: the loop never swallows it into a log line."""
    from kubernetes_tpu_torch.kernels import KernelError

    class BrokenKernel:
        def solver_hook(self, site, assigned, usage, rounds, n_nodes):
            raise KernelError(f"injected kernel fault at {site}")

        def device_hook(self, site):
            return None

    s, conv = _scheduler("port", n_nodes=2, fault_injector=BrokenKernel())
    rt = tserving.ServingRuntime(s, TServingConfig(
        enabled=True, min_wait_s=0.0, max_wait_s=0.01, idle_wait_s=0.05))
    rt.loop.ingest(s.on_pod_add, conv(make_pod("p", cpu_milli=100)))
    stop = threading.Event()
    watchdog = threading.Timer(5.0, stop.set)
    watchdog.start()
    try:
        with pytest.raises(KernelError, match="injected kernel fault"):
            rt.run(stop)
    finally:
        watchdog.cancel()
    assert not stop.is_set()


def test_concurrent_producers_lose_no_pod():
    """Eight producer threads feed creates through the loop's ingest lock
    while the threaded loop schedules, with the interpreter switching
    threads every 10 us: every pod binds exactly once (a lost queue
    update would strand or double-bind one)."""
    import sys

    s, conv = _scheduler("port", n_nodes=8)
    results = []
    rt = tserving.ServingRuntime(
        s, TServingConfig(enabled=True, min_wait_s=0.0, max_wait_s=0.005,
                          target_bucket=64, idle_wait_s=0.02),
        on_cycle=results.append)
    stop = threading.Event()
    loop_t = threading.Thread(target=rt.run, args=(stop,))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        loop_t.start()

        def produce(w):
            for i in range(40):
                rt.loop.ingest(s.on_pod_add, conv(make_pod(
                    f"w{w}-{i}", cpu_milli=10, memory=2**20)))

        producers = [threading.Thread(target=produce, args=(w,))
                     for w in range(8)]
        for t in producers:
            t.start()
        for t in producers:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in producers)
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline and (
                len(s.queue) or sum(r.scheduled for r in results) < 320):
            time.sleep(0.01)
    finally:
        sys.setswitchinterval(old)
        stop.set()
        loop_t.join(timeout=10)
    assert not loop_t.is_alive()
    bound = [k for r in results for k in r.assignments]
    assert len(bound) == len(set(bound)) == 320
    assert s.cache.pod_count() == 320
