"""The port's incident recorder (``kubernetes_tpu_torch/obs/incidents.py``)
held against the JAX package's: the incident cases of
tests/test_journey.py, each run through both packages on a ``FakeClock``
and compared exactly — the five triggers, the per-trigger cooldown, the
ring's bound and every bundle's keys and contents, through the facade and
through both schedulers. The bundles embed the memory ledger's snapshot
and the flight window's records: their measured side (the reference's CPU
census counts the process's live JAX arrays, the port's its live CPU
tensors) is masked before the comparison, nothing else.

The profiler capture is the port's own: ``torch.profiler`` in place of
``jax.profiler``. On the CPU it records CPU activities and writes a
Chrome trace under the artifact directory when its window closes; on the
card it adds CUDA activities (``chip_smoke.py``'s ``ledger`` phase checks
that such a trace names the fused pair kernel)."""

import json
import os
import types
from types import SimpleNamespace

import pytest

import kubernetes_tpu.config as jconfig
import kubernetes_tpu.faults as jfaults
import kubernetes_tpu.obs.incidents as jinc
import kubernetes_tpu.scheduler as jscheduler
import kubernetes_tpu.server as jserver
import kubernetes_tpu.testing as jtesting
import kubernetes_tpu_torch.config as tconfig
import kubernetes_tpu_torch.faults as tfaults
import kubernetes_tpu_torch.obs.incidents as tinc
import kubernetes_tpu_torch.scheduler as tscheduler
import kubernetes_tpu_torch.server as tserver
import kubernetes_tpu_torch.testing as ttesting
from torch_parity import FakeClock

REF = types.SimpleNamespace(config=jconfig, faults=jfaults, inc=jinc,
                            scheduler=jscheduler, server=jserver,
                            testing=jtesting, kw={})
PORT = types.SimpleNamespace(config=tconfig, faults=tfaults, inc=tinc,
                             scheduler=tscheduler, server=tserver,
                             testing=ttesting, kw={"device": "cpu"})


def both(script):
    """``script(pkg)`` on each package; the port returns what the
    reference returns. Returns the port's result."""
    want, got = script(REF), script(PORT)
    assert got == want, (got, want)
    return got


def _unmeasured_record(r: dict) -> dict:
    r = {k: v for k, v in r.items() if k != "readback_bytes"}
    if "mem" in r:
        r["mem"] = {k: v for k, v in r["mem"].items()
                    if k not in ("measured_bytes", "efficiency")}
    return r


def _unmeasured_memory(doc):
    if doc is None:
        return None
    doc = {k: v for k, v in doc.items()
           if k not in ("measured_bytes", "peak_bytes", "census", "devices",
                        "model_efficiency")}
    doc["watermarks"] = [{k: v for k, v in w.items() if k != "measured"}
                         for w in doc["watermarks"]]
    doc["entries"] = [{k: v for k, v in e.items()
                       if k not in ("measured_bytes", "efficiency")}
                      for e in doc["entries"]]
    doc["oom_records"] = [
        {**{k: v for k, v in o.items() if k not in ("measured_bytes",
                                                     "error")},
         "watermarks": [{k: v for k, v in w.items() if k != "measured"}
                        for w in o["watermarks"]]}
        for o in doc["oom_records"]]
    return doc


def _bundle(b: dict) -> dict:
    """A bundle as compared across the packages (measured side masked)."""
    return {**b, "memory": _unmeasured_memory(b["memory"]),
            "flight_window": [_unmeasured_record(r)
                              for r in b["flight_window"]]}


# ---------------------------------------------------------------------------
# through the facade: the mid-phase SLO burn
# ---------------------------------------------------------------------------


def _feed_cycle(pkg, s, clk, cycle, latencies, solve_s=0.001):
    obs = s.obs
    obs.begin_cycle(cycle)
    obs.note_batch_shape("P8xN8")
    with obs.span("solve:batch"):
        clk.advance(solve_s)
    res = pkg.scheduler.CycleResult(
        attempted=max(len(latencies), 1), scheduled=len(latencies),
        rounds=1, solver_tier="batch",
        e2e_latency_s={f"e{cycle}-{i}": v for i, v in enumerate(latencies)})
    return obs.end_cycle(res)


def test_mid_phase_slo_burn_yields_one_bundle_like_the_reference():
    """A latency burn mid-phase captures exactly one bundle whose flight
    window, ledger snapshot, queue depths and in-flight journeys all
    reference the trigger cycle; sustained burning and a re-burn inside
    the cooldown add nothing; a re-burn past it adds one."""
    def script(pkg):
        clk = FakeClock(1000.0)
        s = pkg.scheduler.Scheduler(
            enable_preemption=False, clock=clk,
            observability=pkg.config.ObservabilityConfig(
                ledger=pkg.config.LedgerConfig(
                    e2e_p99_objective_s=0.05, fast_window_s=60.0,
                    slow_window_s=600.0)), **pkg.kw)
        s.on_node_add(pkg.testing.make_node("n0", cpu_milli=4000))
        s.queue.add(pkg.testing.make_pod("parked", cpu_milli=100))
        inc = s.obs.incidents
        totals = []
        for c in range(3):
            _feed_cycle(pkg, s, clk, c, [0.01, 0.02])
            clk.advance(1.0)
        totals.append(inc.total)
        _feed_cycle(pkg, s, clk, 10, [0.2, 0.3, 0.4])
        first = [_bundle(b) for b in inc.incidents()]
        for c in (11, 12):
            _feed_cycle(pkg, s, clk, c, [0.2, 0.3])
        totals.append(inc.total)
        clk.advance(120.0)
        _feed_cycle(pkg, s, clk, 20, [0.01])
        _feed_cycle(pkg, s, clk, 30, [0.3, 0.3, 0.3])
        totals.append(inc.total)
        clk.advance(120.0)
        _feed_cycle(pkg, s, clk, 90, [0.01])
        clk.advance(1.0)
        _feed_cycle(pkg, s, clk, 110, [0.3, 0.3, 0.3])
        totals.append(inc.total)
        snap = inc.snapshot()
        snap["incidents"] = [_bundle(b) for b in snap["incidents"]]
        return (first, totals, snap, inc.dump(),
                s.metrics.incidents_total.expose(), inc.sizes())

    first, totals, snap, dump, _, _ = both(script)
    assert totals == [0, 1, 1, 2]
    b = first[0]
    assert (b["trigger"], b["cycle"]) == ("slo-burn", 10)
    assert any(r["cycle"] == 10 for r in b["flight_window"])
    assert b["ledger"] is not None and b["queues"]["active"] == 1
    assert [j["pod"] for j in b["journeys"]] == ["default/parked"]
    assert set(b) == {"trigger", "detail", "cycle", "t", "top_reasons",
                      "flight_window", "ledger", "memory", "queues",
                      "journeys"}
    assert "incident ring (2 bundles, 2 total)" in dump


# ---------------------------------------------------------------------------
# the triggers, one by one
# ---------------------------------------------------------------------------


def _rec(cycle, **kw):
    base = dict(cycle=cycle, invariant_violations=0, oom_forensic="",
                fallbacks=0, top_reasons=[])
    base.update(kw)
    return SimpleNamespace(**base)


TRIGGER_CASES = {
    "invariant-violation": ({"invariant_violations": 2}, {}),
    "oom": ({"oom_forensic": "oom@snapshot:device"}, {}),
    "ladder-fallback": ({"fallbacks": 3}, {}),
    "slo-burn": ({}, {"ledger": SimpleNamespace(
        watchdog=SimpleNamespace(burns_total=lambda: 1), enabled=False)}),
    "retrace-storm": ({}, {"jaxtel": SimpleNamespace(
        storm_total=lambda: 2)}),
}


@pytest.mark.parametrize("trigger", list(TRIGGER_CASES))
def test_each_trigger_fires_like_the_reference(trigger):
    fields, sources = TRIGGER_CASES[trigger]

    def script(pkg):
        ir = pkg.inc.IncidentRecorder(pkg.config.IncidentsConfig(),
                                      clock=FakeClock(5.0), **sources)
        out = ir.observe_cycle(_rec(1, **fields))
        # sustained (no new burn, no new storm) or a repeat inside the
        # cooldown adds nothing
        again = ir.observe_cycle(_rec(2, **fields))
        return out, again, dict(ir.by_trigger), ir.snapshot()

    out, again, by, _ = both(script)
    assert [b["trigger"] for b in out] == [trigger] and again == []
    assert by[trigger] == 1 and set(by) == set(tinc.TRIGGERS)


def test_fallback_burst_threshold_zero_disables_the_trigger():
    def script(pkg):
        ir = pkg.inc.IncidentRecorder(
            pkg.config.IncidentsConfig(fallback_burst_threshold=0))
        return ir.observe_cycle(_rec(1, fallbacks=50))

    assert both(script) == []


def test_cooldown_suppression_per_trigger_and_expiry():
    def script(pkg):
        ir = pkg.inc.IncidentRecorder(
            pkg.config.IncidentsConfig(cooldown_cycles=4), clock=FakeClock())
        out = [len(ir.observe_cycle(_rec(1, invariant_violations=1))),
               len(ir.observe_cycle(_rec(3, invariant_violations=1))),
               len(ir.observe_cycle(_rec(3, oom_forensic="x"))),
               len(ir.observe_cycle(_rec(5, invariant_violations=1)))]
        return out, ir.total, ir.snapshot()

    out, total, _ = both(script)
    assert out == [1, 0, 1, 1] and total == 3


def test_ring_stays_bounded_and_disabled_recorder_is_inert():
    def script(pkg):
        ir = pkg.inc.IncidentRecorder(pkg.config.IncidentsConfig(
            capacity=2, cooldown_cycles=0), clock=FakeClock())
        for c in range(5):
            ir.observe_cycle(_rec(c * 10, invariant_violations=1))
        off = pkg.inc.IncidentRecorder(
            pkg.config.IncidentsConfig(enabled=False))
        return (len(ir), ir.total, ir.snapshot(), ir.dump(),
                off.observe_cycle(_rec(1, invariant_violations=1)),
                off.snapshot())

    got = both(script)
    assert got[:2] == (2, 5) and got[2]["capacity"] == 2
    assert got[5]["enabled"] is False


def test_device_oom_captures_an_oom_bundle_through_both_schedulers():
    """The memory ledger's forensic flag on a cycle record triggers one
    ``oom`` bundle whose memory snapshot holds the forensic record."""
    def script(pkg):
        fi = pkg.faults.FaultInjector(seed=0)
        s = pkg.scheduler.Scheduler(enable_preemption=False,
                                    clock=FakeClock(), fault_injector=fi,
                                    **pkg.kw)
        s.on_node_add(pkg.testing.make_node("n0", cpu_milli=4000))
        s.on_pod_add(pkg.testing.make_pod("a", cpu_milli=100))
        s.schedule_cycle()
        fi.arm("snapshot:device", "device_oom", count=1)
        s.on_pod_add(pkg.testing.make_pod("b", cpu_milli=100))
        s.schedule_cycle()
        return [_bundle(b) for b in s.obs.incidents.incidents()]

    got = both(script)
    assert [b["trigger"] for b in got] == ["oom"]
    assert got[0]["detail"].startswith("oom@snapshot:device top=")
    assert got[0]["memory"]["oom_records"][0]["site"] == "snapshot:device"


# ---------------------------------------------------------------------------
# the profiler capture (torch.profiler)
# ---------------------------------------------------------------------------


def test_profiler_capture_writes_a_trace_and_respects_its_budget(tmp_path):
    """A CPU ``torch.profiler`` capture: armed, active through its window,
    a Chrome trace under the artifact directory once it closes; a second
    arm while active, or past ``max_profiles``, is refused; no error is
    counted."""
    import torch

    ir = tinc.IncidentRecorder(tconfig.IncidentsConfig(
        profile_dir=str(tmp_path), max_profiles=1))
    assert ir.arm_profile(2, tag="t") is True
    assert ir.snapshot()["profile_active"]
    assert ir.arm_profile(2) is False  # already active
    torch.ones(64, 64) @ torch.ones(64, 64)
    ir._profile_tick()
    assert ir.snapshot()["profile_active"]
    ir._profile_tick()  # the window closes: the trace is written
    assert not ir.snapshot()["profile_active"]
    assert ir.arm_profile(2) is False  # max_profiles spent
    assert ir.profiles_taken == 1 and ir.profile_errors == 0
    (path,) = ir.profile_paths
    assert path.startswith(str(tmp_path / "profile-t"))
    with open(path) as f:
        doc = json.load(f)
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])
    assert os.listdir(tmp_path) == ["profile-t"]


def test_incident_arms_the_profiler_for_its_window(tmp_path):
    """``profile_cycles`` > 0: the bundle's trigger arms a capture of the
    next cycles, closed by the cycle ticks."""
    ir = tinc.IncidentRecorder(tconfig.IncidentsConfig(
        profile_dir=str(tmp_path), profile_cycles=2, max_profiles=4))
    ir.observe_cycle(_rec(7, invariant_violations=1))  # arms, ticks once
    assert ir.snapshot()["profile_active"]
    ir.observe_cycle(_rec(8))
    assert not ir.snapshot()["profile_active"]
    assert [os.path.basename(os.path.dirname(p))
            for p in ir.profile_paths] == ["profile-invariant-violation-c7"]


def test_profiler_start_failure_is_counted_not_raised(tmp_path, monkeypatch):
    import torch.profiler

    class Broken:
        def __init__(self, *a, **kw):
            raise RuntimeError("profiler busy")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    ir = tinc.IncidentRecorder(tconfig.IncidentsConfig(
        profile_dir=str(tmp_path)))
    assert ir.arm_profile(2) is False
    assert ir.profile_errors == 1 and not ir.snapshot()["profile_active"]


def test_profile_arm_denied_without_artifact_dir():
    def script(pkg):
        ir = pkg.inc.IncidentRecorder(
            pkg.config.IncidentsConfig(profile_dir=""))
        return ir.arm_profile(4), ir.profiles_taken

    assert both(script) == (False, 0)


@pytest.mark.parametrize("query", ["?cycles=abc", "?cycles=4", "", "?cycles=0"])
def test_debug_profile_payloads_match_the_reference(query):
    def script(pkg):
        s = pkg.scheduler.Scheduler(enable_preemption=False, **pkg.kw)
        return pkg.server.profile_payload(s, f"/debug/profile{query}")

    code, doc = both(script)
    assert code == (400 if query == "?cycles=abc" else 409)
