"""The port's observability facade held against the JAX package's, the
cases of tests/test_observability.py where the port has the feature: the
metrics registry and the leveled logger (the port's copies), the nested
cycle trace and its Chrome export, the transfer and capture telemetry
(``obs/jaxtel.py``: signature classes on tensor metadata, readbacks
through ``ops/sync.to_host``), the flight recorder, the facade's sampling
and note parking, and the driven scheduler.

Driven cases run one seeded script through both packages' ``Scheduler``
(the port on CPU tensors) on fake clocks, through a breaker trip, a
retry, a blown deadline, a fenced bind, an ambiguous bind and an
injected device reset, and compare ``recorder.to_json()`` record for
record, the perf ledger's, the memory ledger's and the preflight's fields
included. Left out of the comparison: the memory ledger's measured side
(``mem.measured_bytes`` and the ``mem.efficiency`` made from it: the
reference's CPU census counts the process's live JAX arrays, the port's
its live CPU tensors, a measured byte count that depends on what else the
process holds), and ``readback_bytes``, which counts each package's own
payloads (the reference reads the greedy tier's round count as an int64
host scalar; the port's payloads are int32 vectors) and is held against
``ops/sync``'s byte count instead. Under a clock that ticks on every
read (the deadline case) the times go too: each package reads its clock
a different number of times."""

import json
import logging
import types
import urllib.request

import numpy as np
import pytest
import torch

import kubernetes_tpu.config as jconfig
import kubernetes_tpu.faults as jfaults
import kubernetes_tpu.leaderelection as jle
import kubernetes_tpu.scheduler as jscheduler
import kubernetes_tpu.testing as jtesting
import kubernetes_tpu_torch.config as tconfig
import kubernetes_tpu_torch.faults as tfaults
import kubernetes_tpu_torch.leaderelection as tle
import kubernetes_tpu_torch.scheduler as tscheduler
import kubernetes_tpu_torch.testing as ttesting
from kubernetes_tpu_torch import metrics as m
from kubernetes_tpu_torch.ops.sync import SYNCS
from kubernetes_tpu_torch.utils import klog
from torch_parity import FakeClock

REF = types.SimpleNamespace(name="jax", config=jconfig, faults=jfaults,
                            le=jle, scheduler=jscheduler, testing=jtesting,
                            kw={})
PORT = types.SimpleNamespace(name="port", config=tconfig, faults=tfaults,
                             le=tle, scheduler=tscheduler, testing=ttesting,
                             kw={"device": "cpu"})

#: the memory ledger's measured fields of a record's ``mem`` block
MEASURED_MEM = ("measured_bytes", "efficiency")


def unmeasured(r: dict) -> dict:
    """A record's JSON without its measured memory fields."""
    if "mem" in r:
        r = {**r, "mem": {k: v for k, v in r["mem"].items()
                          if k not in MEASURED_MEM}}
    return r


def rows(s, times=True):
    """``s``'s flight records as compared across the packages."""
    out = []
    for r in s.obs.recorder.to_json()["records"]:
        r = unmeasured({k: v for k, v in r.items() if k != "readback_bytes"})
        if not times:
            r.pop("t"), r.pop("elapsed_s")
            r["spans"] = sorted(r["spans"])
        out.append(r)
    return out


def both(script):
    """``script(pkg)`` on each package; the port returns what the
    reference returns. Returns the port's result."""
    want, got = script(REF), script(PORT)
    assert got == want, (got, want)
    return got


# ---------------------------------------------------------------------------
# metrics (the port's copy of the registry)
# ---------------------------------------------------------------------------


def test_exponential_buckets_shape():
    b = m.exponential_buckets(0.001, 2, 15)
    assert len(b) == 15
    assert b[0] == pytest.approx(0.001)
    assert b[1] == pytest.approx(0.002)
    assert b[-1] == pytest.approx(0.001 * 2**14)


def test_counter_labels_and_exposition():
    c = m.Counter("schedule_attempts_total", "h", ("result",))
    c.inc(result="scheduled")
    c.inc(2, result="error")
    assert c.value(result="scheduled") == 1
    assert c.value(result="error") == 2
    assert c.expose() == [
        'schedule_attempts_total{result="error"} 2.0',
        'schedule_attempts_total{result="scheduled"} 1.0',
    ]


def test_gauge_set_overwrites():
    g = m.Gauge("pending_pods", "h")
    g.set(7)
    g.set(3)
    assert g.value() == 3


def test_histogram_buckets_cumulative_and_exposition():
    h = m.Histogram("lat", "h", buckets=[1.0, 2.0, 4.0])
    for v in (0.5, 1.5, 1.5, 3.0, 100.0):
        h.observe(v)
    assert h.expose() == [
        'lat_bucket{le="1.0"} 1',
        'lat_bucket{le="2.0"} 3',
        'lat_bucket{le="4.0"} 4',
        'lat_bucket{le="+Inf"} 5',
        "lat_sum 106.5",
        "lat_count 5",
    ]


def test_histogram_quantile_interpolation():
    h = m.Histogram("lat", "h", buckets=[1.0, 2.0, 4.0])
    for _ in range(50):
        h.observe(0.5)
    for _ in range(50):
        h.observe(1.5)
    assert h.quantile(0.5) == pytest.approx(1.0)
    assert h.quantile(0.75) == pytest.approx(1.0 + 0.5 * 1.0)
    h2 = m.Histogram("x", "h", buckets=[1.0])
    h2.observe(10.0)
    assert h2.quantile(0.99) == 1.0
    assert m.Histogram("e", "h", buckets=[1.0]).quantile(0.9) == 0.0


def test_summary_quantile_exact():
    s = m.Summary("dur", "h")
    for v in range(1, 101):
        s.observe(float(v))
    assert s.quantile(0.5) == pytest.approx(50.0, abs=1.0)
    assert s.quantile(0.99) == pytest.approx(99.0, abs=1.0)


def test_registry_exposes_all_kinds():
    r = m.Registry()
    c = m.Counter("a_total", "help a")
    h = m.Histogram("b_seconds", "help b", buckets=[1.0])
    r.register(c)
    r.register(h)
    c.inc()
    h.observe(0.5)
    lines = r.expose().splitlines()
    assert "a_total 1.0" in lines
    assert 'b_seconds_bucket{le="1.0"} 1' in lines
    assert "# TYPE a_total counter" in lines
    assert "# TYPE b_seconds histogram" in lines


# ---------------------------------------------------------------------------
# klog (the port's copy)
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def _reset_verbosity():
    old = klog.verbosity()
    yield
    klog.set_verbosity(old)


def test_v_gate_truthiness():
    klog.set_verbosity(2)
    assert bool(klog.V(1)) and bool(klog.V(2))
    assert not bool(klog.V(3))
    klog.set_verbosity(0)
    assert not bool(klog.V(1))


def test_v_info_respects_gate(caplog):
    klog.set_verbosity(2)
    with caplog.at_level(logging.DEBUG, logger="kubernetes_tpu_torch"):
        klog.V(2).info("visible %d", 42)
        klog.V(5).info("hidden %d", 99)
    messages = [r.getMessage() for r in caplog.records]
    assert "visible 42" in messages
    assert all("hidden" not in msg for msg in messages)


def test_plain_levels_always_emit(caplog):
    klog.set_verbosity(0)
    with caplog.at_level(logging.INFO, logger="kubernetes_tpu_torch"):
        klog.info("i %s", "x")
        klog.warning("w")
        klog.error("e")
    levels = [r.levelno for r in caplog.records]
    assert logging.INFO in levels and logging.WARNING in levels \
        and logging.ERROR in levels


def test_v_gate_guards_expensive_formatting():
    klog.set_verbosity(0)
    gate = klog.V(10)
    assert not gate
    calls = []

    class Exploding:
        def __str__(self):
            calls.append(1)
            return "boom"

    gate.info("%s", Exploding())
    assert calls == []


# ---------------------------------------------------------------------------
# obs.trace
# ---------------------------------------------------------------------------


def _nested_trace(clk):
    from kubernetes_tpu_torch.obs.trace import Trace

    tr = Trace("cycle", clock=clk, cycle=7)
    with tr.span("snapshot"):
        clk.advance(0.010)
    with tr.span("solve:batch"):
        clk.advance(0.020)
        with tr.span("validate"):
            clk.advance(0.005)
        clk.advance(0.001)
    with tr.span("bind"):
        clk.advance(0.002)
    tr.finish()
    return tr


def test_trace_nested_spans_and_durations():
    tr = _nested_trace(FakeClock(100.0))
    durs = tr.span_durations()
    assert durs["snapshot"] == pytest.approx(0.010)
    assert durs["solve:batch"] == pytest.approx(0.026)
    assert durs["validate"] == pytest.approx(0.005)
    assert durs["bind"] == pytest.approx(0.002)
    assert [c.name for c in tr.root.children] == ["snapshot", "solve:batch",
                                                  "bind"]
    assert [c.name for c in tr.root.children[1].children] == ["validate"]


def test_trace_threshold_dump_includes_spans():
    tr = _nested_trace(FakeClock(100.0))
    text = tr.log_if_long(0.010)
    assert text is not None
    assert "solve:batch" in text and "validate" in text
    assert tr.log_if_long(1.0) is None


def test_trace_span_closes_on_exception():
    from kubernetes_tpu_torch.obs.trace import Trace

    clk = FakeClock(100.0)
    tr = Trace("cycle", clock=clk)
    with pytest.raises(RuntimeError):
        with tr.span("solve:batch"):
            clk.advance(0.5)
            raise RuntimeError("solver died")
    assert tr.root.children[0].end is not None
    with tr.span("bind"):
        clk.advance(0.1)
    assert [c.name for c in tr.root.children] == ["solve:batch", "bind"]


def test_chrome_export_round_trip_consistent_ts_dur():
    from kubernetes_tpu_torch.obs.trace import chrome_trace_json

    tr = _nested_trace(FakeClock(100.0))
    doc = json.loads(json.dumps(chrome_trace_json([tr])))
    events = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"cycle", "snapshot", "solve:batch", "validate",
            "bind"} <= set(events)
    root = events["cycle"]
    for name in ("snapshot", "solve:batch", "validate", "bind"):
        e = events[name]
        assert e["ts"] >= root["ts"]
        assert e["ts"] + e["dur"] <= root["ts"] + root["dur"] + 1e-3
    v, s = events["validate"], events["solve:batch"]
    assert v["ts"] >= s["ts"] and v["ts"] + v["dur"] <= s["ts"] + s["dur"] + 1e-3
    assert events["cycle"]["args"]["cycle"] == "7"


def test_utils_trace_is_the_obs_trace():
    from kubernetes_tpu_torch.obs.trace import Trace as ObsTrace
    from kubernetes_tpu_torch.utils.trace import Trace as UtilTrace

    assert UtilTrace is ObsTrace


# ---------------------------------------------------------------------------
# obs.jaxtel: signature classes, storms, transfers
# ---------------------------------------------------------------------------


def test_retrace_counter_classification():
    from kubernetes_tpu_torch.obs.jaxtel import JaxTelemetry

    tel = JaxTelemetry()
    a = torch.zeros((8, 4), dtype=torch.float32)
    assert tel.record_call("solve", a, static=("batch",)) == "compile"
    assert tel.record_call("solve", torch.ones((8, 4)),
                           static=("batch",)) == "hit"
    assert tel.record_call("solve", torch.zeros((16, 4)),
                           static=("batch",)) == "retrace"
    assert tel.retrace_total("solve") == 1
    assert tel.record_call("solve", a, static=("greedy",)) == "retrace"
    assert tel.retrace_total("solve") == 2
    assert tel.record_call("solve", torch.zeros((8, 4), dtype=torch.int32),
                           static=("batch",)) == "retrace"
    assert tel.compiles["solve"] == 1 and tel.hits["solve"] == 1


def test_retrace_storm_fires_once_per_window_crossing():
    from kubernetes_tpu_torch.obs.jaxtel import JaxTelemetry

    tel = JaxTelemetry(storm_threshold=3, storm_window=100)
    for i in range(7):
        tel.record_call("solve", torch.zeros((8 + i,)))
    assert tel.storms["solve"] == 2 and tel.storm_total() == 2


def test_signature_set_is_bounded_lru():
    from kubernetes_tpu_torch.obs.jaxtel import JaxTelemetry

    tel = JaxTelemetry(signature_capacity=4)
    for i in range(1, 50):
        tel.record_call("solve", torch.zeros((i,)))
    assert len(tel._seen["solve"]) == 4 and tel.signature_count() == 4
    assert tel.record_call("solve", torch.zeros((49,))) == "hit"
    assert tel.record_call("solve", torch.zeros((1,))) == "retrace"


def test_digest_matches_the_references_classes_on_the_same_shapes():
    """The same call sequence classifies identically in both packages:
    the port digests tensor metadata as the reference digests arrays."""
    from kubernetes_tpu.obs.jaxtel import JaxTelemetry as J
    from kubernetes_tpu_torch.obs.jaxtel import JaxTelemetry as T

    shapes = [(8, 4), (8, 4), (16, 4), (8, 4), (16, 2), (16, 4)]
    jt, tt = J(), T()
    got = [tt.record_call("s", {"b": torch.zeros(s), "a": torch.zeros(s[0])},
                          None, static=(s[0] > 8,)) for s in shapes]
    want = [jt.record_call("s", {"b": np.zeros(s, np.float32),
                                 "a": np.zeros(s[0], np.float32)},
                           None, static=(s[0] > 8,)) for s in shapes]
    assert got == want


def test_transfer_accounting():
    from kubernetes_tpu_torch.obs.jaxtel import JaxTelemetry, tree_nbytes

    tel = JaxTelemetry()
    x = torch.zeros((4, 4), dtype=torch.float32)
    syncs, nbytes = SYNCS.count, SYNCS.d2h_bytes
    back = tel.readback("solve-result", x)
    assert np.asarray(back).shape == (4, 4)
    # one counted read through ops/sync, its bytes charged to the site
    assert (SYNCS.count - syncs, SYNCS.d2h_bytes - nbytes) == (1, 64)
    assert tel.transfers[("solve-result", "d2h")] == [1, 64]
    tel.record_upload("snapshot", {"a": x,
                                   "b": torch.zeros((2,), dtype=torch.int64)})
    assert tel.transfers[("snapshot", "h2d")] == [1, 64 + 16]
    assert tree_nbytes(None) == 0 and tel.d2h_bytes_total() == 64


# ---------------------------------------------------------------------------
# obs.recorder
# ---------------------------------------------------------------------------


def test_flight_recorder_capacity_and_eviction():
    from kubernetes_tpu_torch.obs.recorder import CycleRecord, FlightRecorder

    fr = FlightRecorder(capacity=4)
    for i in range(10):
        fr.record(CycleRecord(cycle=i, tier="batch"))
    assert len(fr) == 4
    assert [r.cycle for r in fr.records()] == [6, 7, 8, 9]
    j = fr.to_json()
    assert j["recorded"] == 10 and j["evicted"] == 6
    text = fr.dump()
    assert "cycle 9" in text and "cycle 5" not in text


def test_flight_recorder_dump_carries_incident_flags():
    from kubernetes_tpu_torch.obs.recorder import CycleRecord, FlightRecorder

    fr = FlightRecorder(capacity=8)
    fr.record(CycleRecord(
        cycle=3, tier="greedy", fallbacks=2, retries=1,
        deadline_exceeded=True,
        breaker_transitions=[("solver:batch", "closed", "open")],
        spans={"solve:batch": 0.5, "solve:greedy": 0.01},
    ))
    text = fr.dump()
    assert "DEADLINE" in text and "fallbacks=2" in text
    assert "breaker[solver:batch]:closed->open" in text
    assert "solve:greedy" in text


# ---------------------------------------------------------------------------
# obs.core: deterministic sampling, record assembly, note parking
# ---------------------------------------------------------------------------


class _Res:
    """An eventful cycle's result: one pod attempted."""

    attempted = 1
    scheduled = 1
    unschedulable = 0
    elapsed_s = 0.001
    solver_tier = "batch"
    solver_fallbacks = 0


def _facades(**cfg):
    """Both packages' facades on their own configs and fake clocks."""
    from kubernetes_tpu.obs import Observability as JObs
    from kubernetes_tpu_torch.obs import Observability as TObs

    return (JObs(jconfig.ObservabilityConfig(**cfg), clock=FakeClock(100.0)),
            TObs(tconfig.ObservabilityConfig(**cfg), clock=FakeClock(100.0)))


def test_trace_sampling_is_deterministic():
    for obs in _facades(trace_sampling=0.5):
        kept = []
        for i in range(8):
            obs.begin_cycle(i)
            obs.end_cycle(_Res())
            kept.append(len(obs.traces))
        assert kept == [0, 1, 1, 2, 2, 3, 3, 4]
        assert len(obs.recorder) == 8


def test_sampling_counts_only_eventful_cycles():
    for obs in _facades(trace_sampling=0.5):
        for i in range(40):
            obs.begin_cycle(i)
            obs.end_cycle(_Res() if i % 2 == 1 else None)
        assert len(obs.traces) == 10


def test_trace_and_flight_record_agree_on_cycle_number():
    jobs, tobs = _facades()
    docs = []
    for obs in (jobs, tobs):
        obs.begin_cycle(4)
        obs.note_cycle(5)
        rec = obs.end_cycle(_Res())
        assert rec.cycle == 5
        root = [e for e in obs.chrome_trace()["traceEvents"]
                if e["name"] == "Scheduling cycle"][0]
        assert root["args"]["cycle"] == "5"
        docs.append(obs.chrome_trace())
    assert docs[1] == docs[0]


def test_open_span_exports_honest_duration():
    from kubernetes_tpu_torch.obs.trace import Trace

    clk = FakeClock(100.0)
    tr = Trace("t", clock=clk)
    tr.begin_span("leaked")
    clk.advance(2.0)
    tr.finish()
    ev = [e for e in tr.to_chrome_events() if e["name"] == "leaked"][0]
    assert ev["dur"] == pytest.approx(2e6)


def test_idle_empty_cycles_do_not_flood_the_recorder():
    for obs in _facades(recorder_capacity=4):
        obs.begin_cycle(1)
        assert obs.end_cycle(_Res()) is not None
        for i in range(2, 100):
            obs.begin_cycle(i)
            assert obs.end_cycle(None) is None
        assert [r.cycle for r in obs.recorder.records()] == [1]
        assert len(obs.traces) == 1
        obs.begin_cycle(100)
        obs.note_breaker("solve:batch", "closed", "open")
        assert obs.end_cycle(None) is not None
        assert [r.cycle for r in obs.recorder.records()] == [1, 100]


def test_observability_disabled_keeps_logif_long_but_records_nothing():
    for obs in _facades(enabled=False):
        tr = obs.begin_cycle(1)
        obs.clock.advance(5.0)
        assert tr.log_if_long(1.0)
        obs.end_cycle(None)
        assert len(obs.recorder) == 0 and len(obs.traces) == 0


@pytest.mark.parametrize("note", ["takeover", "invariants", "oom"])
def test_between_cycles_notes_park_for_the_next_record(note):
    """A takeover, an auditor sweep and a device-loss forensic flag noted
    between cycles land on the next cycle's record (and only there)."""
    recs = []
    for obs in _facades():
        if note == "takeover":
            obs.note_takeover(3)
        elif note == "invariants":
            obs.note_invariant_violations(2)
        else:
            obs.note_oom_forensic("oom@warmup:compile")
        obs.begin_cycle(1)
        first = obs.end_cycle(None)  # eventful through the parked note
        obs.begin_cycle(2)
        second = obs.end_cycle(_Res())
        recs.append(tuple(unmeasured(r.to_json()) for r in (first, second)))
    assert recs[1] == recs[0]
    first, second = recs[1]
    key = {"takeover": "takeover", "invariants": "invariant_violations",
           "oom": "oom_forensic"}[note]
    assert key in first and key not in second


def test_sinkhorn_note_observes_host_stats_without_a_read():
    """The scheduler hands the facade host values read on the solve's
    payload: end_cycle observes them and reads nothing; the solver's
    [-1, -1] sentinel (the plan never ran) is no sample."""
    _, obs = _facades()
    obs.metrics = m.SchedulerMetrics()
    syncs = SYNCS.count
    obs.begin_cycle(1)
    obs.note_sinkhorn([3.0, 1e-4])
    rec = obs.end_cycle(_Res())
    assert rec.sinkhorn_iters == 3.0 and rec.sinkhorn_residual == 1e-4
    obs.begin_cycle(2)
    obs.note_sinkhorn([-1.0, -1.0])
    rec = obs.end_cycle(_Res())
    assert SYNCS.count == syncs and rec.sinkhorn_iters == -1.0
    assert obs.metrics.sinkhorn_iterations.count() == 1
    assert obs.jax.transfers == {}


# ---------------------------------------------------------------------------
# the driven scheduler
# ---------------------------------------------------------------------------


def _drive(pkg):
    """Three cycles: two at one batch bucket, one at a larger bucket."""
    mk_node, mk_pod = pkg.testing.make_node, pkg.testing.make_pod
    s = pkg.scheduler.Scheduler(enable_preemption=False, clock=FakeClock(),
                                **pkg.kw)
    for i in range(3):
        s.on_node_add(mk_node(f"n{i}", cpu_milli=32000))
    out = []
    for tag, n in (("a", 4), ("b", 4), ("c", 40)):
        for i in range(n):
            s.on_pod_add(mk_pod(f"{tag}{i}", cpu_milli=100))
        out.append(s.schedule_cycle())
    return s, out


@pytest.fixture(scope="module")
def driven():
    return _drive(REF), _drive(PORT)


def test_cycle_chrome_trace_has_nested_spans(driven):
    (js, _), (ts, (r1, _, _)) = driven
    assert r1.scheduled == 4 and r1.solver_tier == "batch"
    doc = json.loads(ts.obs.export_chrome_trace())
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    roots = [e for e in spans if e["name"] == "Scheduling cycle"]
    assert len(roots) == 3
    for root in roots:
        t0, t1 = root["ts"], root["ts"] + root["dur"]
        names = {e["name"] for e in spans if e is not root
                 and t0 <= e["ts"] and e["ts"] + e["dur"] <= t1 + 1e-3}
        assert {"snapshot", "solve:batch", "validate", "bind"} <= names
    # the same span names, cycle by cycle, as the reference's export
    want = json.loads(js.obs.export_chrome_trace())
    assert ([e["name"] for e in doc["traceEvents"]]
            == [e["name"] for e in want["traceEvents"]])


def test_retrace_counter_increments_exactly_once_on_shape_change(driven):
    (js, _), (ts, _) = driven
    solve = ts.obs.jax.snapshot()["sites"]["solve"]
    assert solve == js.obs.jax.snapshot()["sites"]["solve"]
    assert (solve["calls"], solve["compiles"], solve["hits"],
            solve["retraces"]) == (3, 1, 1, 1)
    assert ts.metrics.jax_retraces.value(site="solve") == 1
    # the port has no compile cache: the family stays unset
    assert ts.metrics.jax_compile_cache.expose() == []


def test_flight_recorder_captured_every_cycle(driven):
    (js, _), (ts, _) = driven
    assert rows(ts) == rows(js)
    recs = ts.obs.recorder.records()
    assert [r.cycle for r in recs] == [1, 2, 3]
    assert recs[2].batch_shape != recs[1].batch_shape
    assert recs[2].retraces == 1 and recs[1].retraces == 0
    tr = ts.obs.jax.transfers
    assert tr[("snapshot", "h2d")][0] == 3
    assert tr[("solve-result", "d2h")][0] == 3


def test_readback_bytes_are_the_bytes_to_host_moved():
    s = PORT.scheduler.Scheduler(enable_preemption=False, device="cpu")
    for i in range(3):
        s.on_node_add(ttesting.make_node(f"n{i}", cpu_milli=1000))
    for i in range(6):
        s.on_pod_add(ttesting.make_pod(f"p{i}", cpu_milli=600))
    moved = SYNCS.d2h_bytes
    r = s.schedule_cycle()
    assert r.unschedulable == 3
    rec = s.obs.recorder.records()[-1]
    assert rec.readback_bytes == SYNCS.d2h_bytes - moved > 0
    assert set(s.obs.jax.snapshot()["transfers"]) >= {
        "solve-result:d2h", "explain:d2h", "snapshot:h2d"}


def test_debugger_dump_includes_flight_recorder(driven):
    from kubernetes_tpu_torch import debugger

    _, (ts, _) = driven
    text = debugger.dump(ts)
    assert "Flight recorder" in text and "tier=batch" in text


def test_debugger_dump_is_the_reference_dump_with_its_recorder(driven):
    """``debugger.dump`` prints the cache, the queue, the flight
    recorder's ring (with the ledgers' ``eff=`` / ``mem=`` flags), the
    memory ledger and the incident ring as the reference's does (moved
    here from the hollow cluster's tests, which pinned the dump without a
    recorder). The measured byte counts are masked (see the module
    docstring)."""
    import re

    import kubernetes_tpu.debugger as jdebugger
    from kubernetes_tpu_torch import debugger

    def masked(text):
        text = re.sub(r"(mem=\d+B)/\d+B", r"\1/<m>B", text)
        return re.sub(r"(measured|peak)=-?\d+B", r"\1=<m>B", text)

    (js, _), (ts, _) = driven
    want, got = masked(jdebugger.dump(js)), masked(debugger.dump(ts))
    assert "Flight recorder: 3/256 records" in got and "tier=batch" in got
    assert "Memory ledger:" in got and "== incident ring" in got
    assert got == want


def test_debug_http_endpoints(driven):
    from kubernetes_tpu_torch.server import serve_scheduler

    _, (ts, _) = driven
    srv = serve_scheduler(ts, port=0)
    host, port = srv.server_address[:2]
    try:
        with urllib.request.urlopen(
                f"http://{host}:{port}/debug/traces", timeout=10) as r:
            doc = json.loads(r.read().decode())
        assert any(e["name"] == "Scheduling cycle"
                   for e in doc["traceEvents"])
        with urllib.request.urlopen(
                f"http://{host}:{port}/debug/flightrecorder",
                timeout=10) as r:
            fr = json.loads(r.read().decode())
        assert len(fr["flight_recorder"]["records"]) == 3
        assert "solve" in fr["jax"]["sites"]
        with urllib.request.urlopen(
                f"http://{host}:{port}/metrics", timeout=10) as r:
            body = r.read().decode()
        assert 'scheduler_jax_retrace_total{site="solve"} 1.0' in body
    finally:
        srv.shutdown()


def test_sinkhorn_convergence_telemetry_surfaces():
    def script(pkg):
        s = pkg.scheduler.Scheduler(solver="sinkhorn",
                                    enable_preemption=False, **pkg.kw)
        for i in range(3):
            s.on_node_add(pkg.testing.make_node(f"n{i}", cpu_milli=32000))
        for i in range(6):
            s.on_pod_add(pkg.testing.make_pod(f"p{i}", cpu_milli=100))
        r = s.schedule_cycle()
        rec = s.obs.recorder.records()[-1]
        return (r.scheduled, r.solver_tier, rec.sinkhorn_iters,
                rec.sinkhorn_residual,
                s.metrics.sinkhorn_iterations.count())

    got = both(script)
    assert got[:2] == (6, "sinkhorn") and got[2] >= 1 and got[-1] == 1


# ---------------------------------------------------------------------------
# incidents on the record, through both schedulers
# ---------------------------------------------------------------------------


def _ladder(pkg):
    """A transient crash retried, then a persistent one that trips both
    breakers and lands on the oracle, then recovery."""
    inj = pkg.faults.FaultInjector(seed=9)
    inj.arm("solve:batch*", "crash", count=6)
    clk = FakeClock()
    s = pkg.scheduler.Scheduler(
        clock=clk, fault_injector=inj, enable_preemption=False,
        retry_sleep=lambda _s: None,
        robustness=pkg.config.RobustnessConfig(
            solver_retries=1, breaker_failure_threshold=1,
            breaker_open_duration_s=30.0), **pkg.kw)
    for i in range(6):
        s.on_node_add(pkg.testing.make_node(f"n{i}", cpu_milli=4000))
    for c in range(4):
        for i in range(5):
            s.on_pod_add(pkg.testing.make_pod(f"p{c}-{i}", cpu_milli=300))
        s.schedule_cycle()
        clk.advance(20.0)
    return s, clk


def _deadline(pkg):
    class TickingClock(FakeClock):
        def __call__(self):
            self.t += 1.0
            return self.t

    s = pkg.scheduler.Scheduler(
        clock=TickingClock(), enable_preemption=False,
        robustness=pkg.config.RobustnessConfig(cycle_deadline_s=1e-3,
                                               solver_retries=0), **pkg.kw)
    for i in range(4):
        s.on_node_add(pkg.testing.make_node(f"n{i}", cpu_milli=4000))
    for i in range(8):
        s.on_pod_add(pkg.testing.make_pod(f"p{i}", cpu_milli=300))
    s.schedule_cycle()
    return s, None


def _fenced(pkg):
    clk = FakeClock()
    s = pkg.scheduler.Scheduler(clock=clk, enable_preemption=False,
                                **pkg.kw)
    el = pkg.le.LeaderElector(
        "me", pkg.le.InMemoryLock(),
        pkg.config.LeaderElectionConfig(lease_duration_s=15,
                                        renew_deadline_s=10,
                                        retry_period_s=2), clk)
    s.attach_elector(el)
    el.tick()
    s.on_node_add(pkg.testing.make_node("n0"))
    s.on_pod_add(pkg.testing.make_pod("p0"))
    clk.advance(11)  # the lease goes stale: the bind is fenced
    s.schedule_cycle()
    return s, clk


class _Truth:
    """A binder whose first bind commits and then times out, and the GET
    the scheduler verifies against."""

    def __init__(self, faults):
        self.faults, self.bound, self.uids, self.first = faults, {}, {}, True

    def bind(self, pod, node_name):
        self.uids[pod.key()] = pod.uid
        self.bound[pod.key()] = node_name
        if self.first:
            self.first = False
            raise self.faults.RPCTimeout("committed, answer lost")

    def read(self, key):
        if key not in self.uids:
            return None
        return types.SimpleNamespace(uid=self.uids[key],
                                     node_name=self.bound.get(key, ""))


def _ambiguous(pkg):
    truth = _Truth(pkg.faults)
    s = pkg.scheduler.Scheduler(binder=truth, pod_reader=truth.read,
                                clock=FakeClock(), enable_preemption=False,
                                retry_sleep=lambda _s: None, jitter_seed=1,
                                **pkg.kw)
    s.on_node_add(pkg.testing.make_node("n0", cpu_milli=8000))
    for i in range(3):
        s.on_pod_add(pkg.testing.make_pod(f"p{i}", cpu_milli=100))
    s.schedule_cycle()
    return s, None


def _device_reset(pkg):
    inj = pkg.faults.FaultInjector(seed=0).arm("snapshot:device",
                                               "device_lost", count=1)
    s = pkg.scheduler.Scheduler(clock=FakeClock(), enable_preemption=False,
                                fault_injector=inj, **pkg.kw)
    s.on_node_add(pkg.testing.make_node("n0"))
    s.on_pod_add(pkg.testing.make_pod("p0"))
    s.schedule_cycle()
    return s, None


#: case -> (driver, the record field it must set, compare times)
INCIDENTS = {
    "breaker-retry": (_ladder, "breaker_transitions", True),
    "deadline": (_deadline, "deadline_exceeded", False),
    "fenced-bind": (_fenced, "fenced_binds", True),
    "ambiguous-bind": (_ambiguous, "ambiguous_binds", True),
    "device-reset": (_device_reset, "device_resets", True),
}


@pytest.mark.parametrize("case", list(INCIDENTS))
def test_incident_records_match_the_reference(case):
    drive, field, times = INCIDENTS[case]

    def script(pkg):
        s, _ = drive(pkg)
        return rows(s, times)

    got = both(script)
    assert any(r.get(field) for r in got), (field, got)
    if case == "breaker-retry":
        assert any(r["retries"] for r in got)
        assert any(r["tier"] == "greedy" for r in got)


def test_state_sizes_are_the_references_without_pr12_keys(driven):
    """Every key of the reference's ``state_sizes``, the memory ledger's
    residents and the incident ring included; the census count is
    measured (see the module docstring) and only its presence is held."""
    (js, _), (ts, _) = driven
    want, got = js.state_sizes(), ts.state_sizes()
    assert got.keys() == want.keys()
    want.pop("mem_census_arrays"), got.pop("mem_census_arrays")
    assert got == want
