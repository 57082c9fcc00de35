"""The port's perf ledger (``kubernetes_tpu_torch/obs/ledger.py``) and its
copy of the analytic scale-out model (``parallel/costmodel.py``) held
against the JAX package's: the cases of tests/test_ledger.py, each run
through both packages on the same seeded inputs and a ``FakeClock``, and
compared exactly — ``phase_of``, ``RollingDist`` quantiles, the cost
model's predictions for the same signatures and anchors,
``model_efficiency`` at {1, 2, 4, 8} devices, and the SLO watchdog's burn
rates, transitions and events through a latency regression and its
recovery. The one designed difference: the port's model signatures are
the analytic work of a round (``round_work``), and a prediction made from
them carries the basis ``"analytic"`` where the reference's says
``"xla-cost"``. None of the reference's wall-clock budget assertions is
copied: the ledger's host cost is measured on the card
(``chip_smoke.py``'s ``ledger`` phase)."""

import types

import numpy as np
import pytest

import kubernetes_tpu.config as jconfig
import kubernetes_tpu.metrics as jmetrics
import kubernetes_tpu.obs.ledger as jledger
import kubernetes_tpu.obs.recorder as jrecorder
import kubernetes_tpu.parallel.costmodel as jcost
import kubernetes_tpu.scheduler as jscheduler
import kubernetes_tpu.testing as jtesting
import kubernetes_tpu_torch.config as tconfig
import kubernetes_tpu_torch.metrics as tmetrics
import kubernetes_tpu_torch.obs.ledger as tledger
import kubernetes_tpu_torch.obs.recorder as trecorder
import kubernetes_tpu_torch.parallel.costmodel as tcost
import kubernetes_tpu_torch.scheduler as tscheduler
import kubernetes_tpu_torch.testing as ttesting
from kubernetes_tpu_torch import kernels
from torch_parity import FakeClock

REF = types.SimpleNamespace(config=jconfig, metrics=jmetrics, ledger=jledger,
                            recorder=jrecorder, cost=jcost,
                            scheduler=jscheduler, testing=jtesting, kw={})
PORT = types.SimpleNamespace(config=tconfig, metrics=tmetrics, ledger=tledger,
                             recorder=trecorder, cost=tcost,
                             scheduler=tscheduler, testing=ttesting,
                             kw={"device": "cpu"})


def both(script):
    """``script(pkg)`` on each package; the port returns what the
    reference returns. Returns the port's result."""
    want, got = script(REF), script(PORT)
    assert got == want, (got, want)
    return got


# ---------------------------------------------------------------------------
# measured side: phases, distributions
# ---------------------------------------------------------------------------

SPANS = ("solve:batch", "solve:restricted", "pipeline:pack@3",
         "pipeline:dispatch@0", "pipeline:readback@reasons",
         "pipeline:bind@2", "snapshot", "validate", "bind", "preemption",
         "extender:filter", "grpc:filter", "scenario:quality",
         "Scheduling cycle", "something-new")


@pytest.mark.parametrize("name", SPANS)
def test_phase_of_matches_the_reference(name):
    assert tledger.phase_of(name) == jledger.phase_of(name)


@pytest.mark.parametrize("digest", ["P4096xN65536+topo+mesh8", "P8xN8",
                                    "", "garbage"])
def test_parse_batch_shape_matches_the_reference(digest):
    assert (tledger.parse_batch_shape(digest)
            == jledger.parse_batch_shape(digest))


@pytest.mark.parametrize("seed,window,alpha", [(0, 1, 0.05), (1, 8, 0.3),
                                               (2, 256, 0.05), (3, 37, 1.0)])
def test_rolling_dist_matches_the_reference(seed, window, alpha):
    samples = np.random.default_rng(seed).exponential(0.01, 300).tolist()

    def script(pkg):
        d = pkg.ledger.RollingDist(window=window, alpha=alpha)
        for v in samples:
            d.observe(v)
        return ([d.quantile(q) for q in (0.0, 0.5, 0.9, 0.99, 1.0)],
                d.ewma, d.n, d.to_json())

    both(script)


# ---------------------------------------------------------------------------
# modeled side: the cost model, model_efficiency, the analytic basis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("devices", [1, 2, 4, 8])
def test_model_efficiency_matches_the_reference(devices):
    for pods, nodes in ((30000, 5000), (256, 1024), (1, 1), (8192, 50000)):
        assert (tcost.model_efficiency(devices, pods, nodes)
                == jcost.model_efficiency(devices, pods, nodes))
    m = tcost.CollectiveCostModel(devices=devices, pods_per_batch=4096,
                                  nodes_padded=65536)
    j = jcost.CollectiveCostModel(devices=devices, pods_per_batch=4096,
                                  nodes_padded=65536)
    assert m.document() == j.document()


def _seeded_model(pkg, seed):
    """A cost model fed a seeded run of signatures and anchor offers; the
    signatures' work is the same numbers in both packages."""
    rng = np.random.default_rng(seed)
    m = pkg.ledger.CycleCostModel()
    installed = []
    for _ in range(12):
        P = int(2 ** rng.integers(3, 13))
        N = int(2 ** rng.integers(3, 14))
        if rng.random() < 0.5:
            m.record_signature(P, N, float(rng.integers(1, 10**9)),
                               float(rng.integers(0, 10**9)))
        scope = ("full", "restricted", "")[int(rng.integers(0, 3))]
        mesh = int((0, 2, 4, 8)[int(rng.integers(0, 4))])
        installed.append(m.record_anchor(scope, P, N, mesh,
                                         float(rng.uniform(1e-4, 1e-1)),
                                         rounds=int(rng.integers(0, 5))))
    return m, installed, rng


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_cost_model_predictions_match_the_reference(seed):
    def script(pkg):
        m, installed, rng = _seeded_model(pkg, seed)
        preds = []
        for _ in range(40):
            P = int(2 ** rng.integers(3, 13))
            N = int(2 ** rng.integers(3, 14))
            mesh = int((0, 2, 4, 8)[int(rng.integers(0, 4))])
            scope = ("full", "restricted", "")[int(rng.integers(0, 3))]
            pred, basis = m.predict(P, N, mesh, scope,
                                    rounds=int(rng.integers(1, 4)))
            # the designed difference: the basis of a work-ratio
            # prediction names where its work came from
            preds.append((pred, {"xla-cost": "work"}.get(
                basis, {"analytic": "work"}.get(basis, basis))))
        return installed, preds, m.snapshot()

    both(script)


def test_analytic_basis_names_itself():
    """The port's signatures are counted, not compiled: a prediction from
    them says ``analytic``, never the reference's ``xla-cost``."""
    for pkg, want in ((REF, "xla-cost"), (PORT, "analytic")):
        m = pkg.ledger.CycleCostModel()
        for P in (64, 128):
            w = tledger.round_work(P, 1024)
            m.record_signature(P, 1024, w["flops"], w["bytes_accessed"])
        m.record_anchor("full", 64, 1024, 0, 0.010)
        pred, basis = m.predict(128, 1024, 0, "full")
        assert basis == want and pred == pytest.approx(0.020)


@pytest.mark.parametrize("P,N,sk", [(8192, 8192, False), (8192, 8192, True),
                                    (4096, 8192, False), (64, 8, True)])
def test_round_work_is_the_kernel_tables_count(P, N, sk):
    """The ledger's analytic work and ``chip_smoke.py``'s kernel bounds,
    each counted by its own formula, agree: the fused pair's bytes and
    operations, plus the Sinkhorn passes' times the plan's iterations."""
    import chip_smoke

    pair = chip_smoke._pair_bound(P, N)
    want_b, want_o = pair["bytes"], pair["ops"]
    if sk:
        for name in ("sinkhorn_u", "sinkhorn_v"):
            b = chip_smoke._sinkhorn_bound(name, P, N)
            want_b += b["bytes"] * tledger.SINKHORN_ITERS
            want_o += b["ops"] * tledger.SINKHORN_ITERS
    got = tledger.round_work(P, N, use_sinkhorn=sk)
    assert got == {"flops": float(want_o), "bytes_accessed": float(want_b)}
    assert pair["bytes"] == P * N * 13 and pair["ops"] == P * N * 14


def test_best_rate_anchor_never_rebases_upward():
    def script(pkg):
        m = pkg.ledger.CycleCostModel()
        out = [m.record_anchor("full", 64, 64, 0, 0.010),
               m.record_anchor("full", 64, 64, 0, 0.050),
               m.record_anchor("full", 64, 64, 0, 0.004)]
        return out, m.predict(64, 64, 0, "full")

    assert both(script) == ([True, False, True], (0.004, "calibrated"))


def test_restricted_scope_scales_with_batch_not_nodes():
    def script(pkg):
        m = pkg.ledger.CycleCostModel()
        m.record_anchor("restricted", 64, 1024, 0, 0.002)
        return [m.predict(P, N, 0, "restricted")[0]
                for P, N in ((64, 1024), (64, 8192), (256, 1024))]

    small, grown_nodes, grown_pods = both(script)
    assert grown_nodes == pytest.approx(small)
    assert grown_pods == pytest.approx(small * 4)


# ---------------------------------------------------------------------------
# the ledger through the facade: entries, gauges, the watchdog
# ---------------------------------------------------------------------------


def _ledger_cfg(pkg, **kw):
    base = dict(e2e_p99_objective_s=0.05, fast_window_s=60.0,
                slow_window_s=600.0, burn_threshold=1.0)
    base.update(kw)
    return pkg.config.LedgerConfig(**base)


def _feed_cycle(pkg, s, clk, cycle, latencies, solve_s=0.001):
    """One cycle through the facade with a solve span of ``solve_s`` on
    the fake clock and the given create-to-bind latencies."""
    obs = s.obs
    obs.begin_cycle(cycle)
    obs.note_batch_shape("P8xN8")
    with obs.span("solve:batch"):
        clk.advance(solve_s)
    res = pkg.scheduler.CycleResult(
        attempted=max(len(latencies), 1), scheduled=len(latencies),
        rounds=1, solver_tier="batch",
        e2e_latency_s={f"e{cycle}-{i}": v for i, v in enumerate(latencies)})
    return obs.end_cycle(res), res


def _watched(pkg, events, **ledger_kw):
    clk = FakeClock(1000.0)
    s = pkg.scheduler.Scheduler(
        enable_preemption=False, clock=clk,
        observability=pkg.config.ObservabilityConfig(
            ledger=_ledger_cfg(pkg, **ledger_kw)),
        event_sink=lambda reason, obj, msg: events.append(
            (reason, obj.key(), msg)), **pkg.kw)
    s.on_node_add(pkg.testing.make_node("n0", cpu_milli=4000))
    s.queue.add(pkg.testing.make_pod("parked", cpu_milli=100))
    return s, clk


def _burn_rates(s):
    g = s.metrics.slo_burn_rate
    return sorted(g.expose())


def test_latency_regression_trips_and_recovers_like_the_reference():
    def script(pkg):
        events = []
        s, clk = _watched(pkg, events)
        out = [s.backend_pressure()]
        for c in range(3):
            rec, res = _feed_cycle(pkg, s, clk, c, [0.01, 0.02])
            clk.advance(1.0)
            out.append((rec.slo, res.model_efficiency, res.modeled_s,
                        rec.model_basis))
        rec, _ = _feed_cycle(pkg, s, clk, 10, [0.2, 0.3, 0.4])
        out.append((rec.slo, s.obs.ledger.watchdog.burning(),
                    s.is_degraded(), s.backend_pressure(degraded_factor=4.0),
                    "slo=e2e_p99" in s.obs.recorder.dump(), _burn_rates(s)))
        clk.advance(120.0)
        rec, _ = _feed_cycle(pkg, s, clk, 20, [0.01, 0.01])
        out.append((rec.slo, s.obs.ledger.watchdog.burning(),
                    s.is_degraded(), s.backend_pressure(), _burn_rates(s)))
        snap = s.obs.ledger.snapshot()
        return out, events, snap

    out, events, snap = both(script)
    assert out[4][:4] == ("e2e_p99", True, True, 4.0)
    assert [e[0] for e in events] == ["SchedulerSLOBurn",
                                      "SchedulerSLORecovered"]
    assert out[5][:4] == ("", False, False, 1.0)
    assert snap["slo"]["burns"] == {"e2e_p99": 1}


def test_burn_recovers_while_idle_like_the_reference():
    def script(pkg):
        events = []
        s, clk = _watched(pkg, events)
        _feed_cycle(pkg, s, clk, 1, [0.5, 0.5])
        out = [s.obs.ledger.watchdog.burning(),
               s.backend_pressure(degraded_factor=4.0)]
        clk.advance(120.0)
        s.idle_tick()
        out += [s.obs.ledger.watchdog.burning(),
                s.backend_pressure(degraded_factor=4.0)]
        _feed_cycle(pkg, s, clk, 2, [0.5, 0.5])
        out.append(s.obs.ledger.watchdog.burning())
        clk.advance(120.0)
        out += [s.backend_pressure(degraded_factor=4.0),
                s.obs.ledger.watchdog.burning()]
        return out, [e[0] for e in events]

    out, events = both(script)
    assert out == [True, 4.0, False, 1.0, True, 1.0, False]
    assert events.count("SchedulerSLORecovered") == 2


def test_burn_never_trips_on_stale_window_drainage():
    def script(pkg):
        wd = pkg.ledger.SLOWatchdog(_ledger_cfg(pkg), clock=FakeClock())
        good, bad = 0.01, 0.2
        trace = [wd.observe_cycle(0.0, [good] * 50 + [bad] * 50, 0.0,
                                  "full")]
        for t, lat in ((30.0, [good] * 200), (90.0, [good] * 200),
                       (95.0, [good, bad])):
            trace.append(wd.observe_cycle(t, lat, 0.0, "full"))
        for t in range(96, 152, 5):
            trace.append(wd.evaluate(float(t), allow_trip=False))
        trace.append(wd.observe_cycle(152.0, [], 0.0, "full"))
        trace.append(wd.evaluate(153.0))
        return trace, dict(wd.burns), wd.snapshot()

    trace, burns, _ = both(script)
    assert trace[0] == "e2e_p99" and trace[-1] == "e2e_p99"
    assert burns == {"e2e_p99": 2}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_watchdog_burn_rates_match_on_seeded_traffic(seed):
    """Both objectives over a seeded stream of cycles: every burn rate on
    the gauge, every transition and every baseline, exactly."""
    def script(pkg):
        rng = np.random.default_rng(seed)
        m = pkg.metrics.SchedulerMetrics()
        wd = pkg.ledger.SLOWatchdog(
            _ledger_cfg(pkg, cost_drift_ratio=2.0, fast_window_s=5.0,
                        slow_window_s=20.0, baseline_decay=0.1),
            clock=FakeClock(), metrics=m)
        got = []
        wd.event_sink = lambda reason, obj, msg: got.append((reason, msg))
        t = 0.0
        for _ in range(120):
            t += float(rng.uniform(0.1, 1.5))
            slow = rng.random() < 0.2
            lat = rng.exponential(0.1 if slow else 0.01,
                                  int(rng.integers(0, 6))).tolist()
            solve = float(rng.exponential(0.02 if slow else 0.002))
            got.append(wd.observe_cycle(t, lat, solve,
                                        ("full", "restricted")[slow]))
            got.append(sorted(m.slo_burn_rate.expose()))
        return got, wd.snapshot()

    both(script)


def test_cost_drift_objective_burns_on_sustained_slowdown():
    def script(pkg):
        events = []
        s, clk = _watched(pkg, events, e2e_p99_objective_s=0.0,
                          cost_drift_ratio=2.0, baseline_decay=0.01)
        for c in range(5):
            _feed_cycle(pkg, s, clk, c, [], solve_s=0.001)
            clk.advance(1.0)
        out = [s.obs.ledger.watchdog.burning()]
        for c in range(10, 16):
            rec, _ = _feed_cycle(pkg, s, clk, c, [], solve_s=0.010)
            clk.advance(1.0)
            out.append(rec.slo)
        return out, [e[0] for e in events], s.obs.ledger.snapshot()["slo"]

    out, events, _ = both(script)
    assert out[0] is False and "cost_drift" in out
    assert events[0] == "SchedulerSLOBurn"


def test_engage_pressure_false_keeps_degraded_out():
    def script(pkg):
        s, clk = _watched(pkg, [], engage_pressure=False)
        _feed_cycle(pkg, s, clk, 1, [0.5, 0.5])
        return s.obs.ledger.watchdog.burning(), s.is_degraded()

    assert both(script) == (True, False)


def test_efficiency_gauge_freshness_on_solve_free_cycle():
    def script(pkg):
        metrics = pkg.metrics.SchedulerMetrics()
        ledger = pkg.ledger.PerfLedger(pkg.config.LedgerConfig(),
                                       metrics=metrics)
        out = []
        for rec in (pkg.recorder.CycleRecord(
                        cycle=1, batch_shape="P8xN8", tier="batch",
                        elapsed_s=0.02, spans={"solve:batch": 0.01}),
                    pkg.recorder.CycleRecord(cycle=2, batch_shape="",
                                             elapsed_s=0.001, spans={})):
            e = ledger.observe_cycle(rec)
            out.append((e.to_json(), metrics.cycle_model_efficiency.value(),
                        metrics.cycle_modeled_cost.value(),
                        sorted(metrics.cycle_phase_seconds.expose())))
        return out, ledger.arm_summary()

    out, _ = both(script)
    assert out[0][1] == 1.0 and out[1][1] == -1.0


def test_self_anchored_then_calibrated_basis_like_the_reference():
    def script(pkg):
        s, clk = _watched(pkg, [])
        _feed_cycle(pkg, s, clk, 1, [0.01])
        s.obs.ledger.model.record_anchor("full", 8, 8, 0, 1e-9)
        for c in (2, 3):
            _feed_cycle(pkg, s, clk, c, [0.01], solve_s=0.002)
        return [(e["model_basis"], e["model_efficiency"])
                for e in s.obs.ledger.snapshot()["entries"]]

    got = both(script)
    assert got[0] == ("anchor", 1.0)
    assert [b for b, _ in got[1:]] == ["calibrated", "calibrated"]


def test_chrome_trace_carries_efficiency_counter_track():
    def script(pkg):
        s, clk = _watched(pkg, [])
        _feed_cycle(pkg, s, clk, 1, [0.01])
        doc = s.obs.chrome_trace()
        return [(e["name"], e.get("args")) for e in doc["traceEvents"]
                if e["ph"] == "C"]

    assert both(script) == [("model_efficiency", {"eff": 1.0})]


# ---------------------------------------------------------------------------
# warmup: the anchor replay, and what a kernel fault does there
# ---------------------------------------------------------------------------


def _warm_scheduler(pkg, **kw):
    s = pkg.scheduler.Scheduler(
        enable_preemption=False, clock=FakeClock(),
        warmup=pkg.config.WarmupConfig(enabled=True, pod_buckets=(8, 16)),
        **pkg.kw, **kw)
    for i in range(4):
        s.on_node_add(pkg.testing.make_node(f"n{i}", cpu_milli=16000))
    sample = [pkg.testing.make_pod(f"w{i}", cpu_milli=50) for i in range(16)]
    return s, s.warmup(sample_pods=sample)


def test_warmup_anchors_the_cost_model_like_the_reference():
    """The first bucket's timed replay becomes the ``full`` anchor at the
    same shape and round count as the reference's, read back through the
    declared ``ledger-anchor`` site; the signature is the analytic work of
    that shape (the reference's is XLA's count of the same program)."""
    def script(pkg):
        s, warmed = _warm_scheduler(pkg)
        snap = s.obs.ledger.model.snapshot()
        a = snap["anchors"]["full"]
        return (warmed, {k: a[k] for k in ("P", "N", "mesh", "rounds")},
                sorted(snap["signatures"]),
                "ledger-anchor:d2h" in s.obs.jax.snapshot()["transfers"])

    got = both(script)
    assert got[1] == {"P": 8, "N": 8, "mesh": 0, "rounds": 1} and got[3]
    s, _ = _warm_scheduler(PORT)
    assert s.obs.ledger.model.snapshot()["signatures"] == {
        "P8xN8": tledger.round_work(8, 8)}
    assert s.obs.ledger.model.snapshot()["anchors"]["full"]["solve_s"] > 0


def _raises_in(where, exc):
    """A fake launch raising ``exc`` in the anchor replay (the only solve
    of the warmup that leaves the route to the router) or in the bucket's
    measured solve."""
    real = tscheduler.batch_assign

    def anchor_launch(*a, **kw):
        if kw.get("route_plan", "absent") == "absent":
            raise exc
        return real(*a, **kw)

    def measured(*a, **kw):
        raise exc

    return anchor_launch if where == "anchor" else measured


@pytest.mark.parametrize("where", ["anchor", "capture"])
def test_kernel_fault_in_warmup_accounting_escapes(monkeypatch, where):
    """A ``KernelError`` raised by the launch in the anchor replay or in
    the bucket's peak capture leaves ``warmup``: it is a kernel fault,
    never logged and swallowed like a device error."""
    import kubernetes_tpu_torch.ops.assign as tassign

    fake = _raises_in(where, kernels.KernelError("fake launch failure"))
    if where == "anchor":
        monkeypatch.setattr(tscheduler, "batch_assign", fake)
    else:
        monkeypatch.setattr(tassign, "solve_memory_analysis", fake)
    with pytest.raises(kernels.KernelError, match="fake launch failure"):
        _warm_scheduler(PORT)


@pytest.mark.parametrize("where", ["anchor", "capture"])
def test_device_error_in_warmup_accounting_reaches_the_reset_handler(
        monkeypatch, where):
    """A device error there (a CUDA out-of-memory error is a
    ``RuntimeError``) is the bucket's own solve failing: it reaches
    warmup's device-loss handler, never a log line. The sweep stops
    before the bucket counts, the reset is counted, the memory ledger's
    forensic record names ``warmup:compile`` and the bucket's shape, and
    the resident table is dropped; the preflight's table stays empty and
    no anchor lands."""
    import kubernetes_tpu_torch.ops.assign as tassign

    fake = _raises_in(where, RuntimeError("CUDA out of memory (fake)"))
    if where == "anchor":
        monkeypatch.setattr(tscheduler, "batch_assign", fake)
    else:
        monkeypatch.setattr(tassign, "solve_memory_analysis", fake)
    resets0 = tscheduler.RECOVERY.device_resets
    s, warmed = _warm_scheduler(PORT)
    assert warmed == 0
    assert tscheduler.RECOVERY.device_resets == resets0 + 1
    ooms = s.obs.memledger.oom_records()
    assert [(o["site"], o["shapes"]) for o in ooms] == [
        ("warmup:compile", "P8xN8")]
    assert "CUDA out of memory (fake)" in ooms[0]["error"]
    assert ooms[0]["top_residents"][0]["name"] == "cache.node_table"
    assert "cache.node_table" not in [
        n for n, _b, _s in s.obs.memledger.ranked_residents()]
    assert s.obs.ledger.model.snapshot()["anchors"] == {}
    assert s.obs.memledger.bucket_table() == {}


def test_device_error_in_restricted_capture_is_counted(monkeypatch):
    """The restricted sweep's peak capture is its bucket's first solve:
    a device error there aborts the restricted warmup as the reference's
    does, and is counted and recorded as a device reset (site
    ``warmup:incremental``), never only a log line."""
    import kubernetes_tpu_torch.ops.assign as tassign

    def fake(pods, nodes, *a, **kw):
        if int(nodes.valid.shape[0]) < 64:   # the (P, C) frame
            raise RuntimeError("CUDA out of memory (fake)")

    monkeypatch.setattr(tassign, "solve_memory_analysis", fake)
    resets0 = tscheduler.RECOVERY.device_resets
    s = tscheduler.Scheduler(
        enable_preemption=False, clock=FakeClock(), device="cpu",
        incremental=tconfig.IncrementalConfig(enabled=True,
                                              candidate_bucket=16),
        warmup=tconfig.WarmupConfig(enabled=True, pod_buckets=(8,)))
    for i in range(40):
        s.on_node_add(PORT.testing.make_node(f"n{i}", cpu_milli=16000))
    sample = [PORT.testing.make_pod(f"w{i}", cpu_milli=50) for i in range(8)]
    assert s.warmup(sample_pods=sample) == 1
    assert tscheduler.RECOVERY.device_resets == resets0 + 1
    assert [o["site"] for o in s.obs.memledger.oom_records()] == [
        "warmup:incremental"]
    assert s._warmed_cbuckets == set()
