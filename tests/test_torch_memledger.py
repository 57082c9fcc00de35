"""The port's device-memory ledger (``kubernetes_tpu_torch/obs/memledger.py``)
held against the JAX package's: the cases of tests/test_memledger.py, each
run through both packages on the same seeded inputs and a ``FakeClock``
and compared exactly — resident accounting and its ranking, the preflight
verdicts over a seeded grid of injected bucket tables, ``record_oom``
records and ``oom_flag`` text, and, through both schedulers, a batch that
splits to the same P and places the same pods, a batch shed back to the
queue whole, a pipelined batch that sheds, and the forensic flags of the
device-loss sites.

What each package measures is its own and is not compared: the measured
bytes (the reference's CPU census walks the process's live JAX arrays, the
port's its live CPU tensors) and the warmed buckets' peaks, which the
port measures from the card's allocator only (on the CPU no bucket is
measured; the scheduler-level cases inject the same table into both).
The card's side is exercised here against stand-ins for the
``torch.cuda`` allocator calls, to pin which counters it reads; the real
readings come from ``chip_smoke.py``'s ``ledger`` phase."""

import types

import numpy as np
import pytest
import torch

import kubernetes_tpu.config as jconfig
import kubernetes_tpu.faults as jfaults
import kubernetes_tpu.metrics as jmetrics
import kubernetes_tpu.obs.memledger as jmem
import kubernetes_tpu.scheduler as jscheduler
import kubernetes_tpu.testing as jtesting
import kubernetes_tpu_torch.config as tconfig
import kubernetes_tpu_torch.faults as tfaults
import kubernetes_tpu_torch.metrics as tmetrics
import kubernetes_tpu_torch.obs.memledger as tmem
import kubernetes_tpu_torch.scheduler as tscheduler
import kubernetes_tpu_torch.testing as ttesting
from torch_parity import FakeClock

REF = types.SimpleNamespace(config=jconfig, faults=jfaults, metrics=jmetrics,
                            mem=jmem, scheduler=jscheduler, testing=jtesting,
                            kw={})
PORT = types.SimpleNamespace(config=tconfig, faults=tfaults, metrics=tmetrics,
                             mem=tmem, scheduler=tscheduler, testing=ttesting,
                             kw={"device": "cpu"})

STATS = {"argument_bytes": 0, "output_bytes": 0, "temp_bytes": 0,
         "code_bytes": 0, "alias_bytes": 0}


def both(script):
    """``script(pkg)`` on each package; the port returns what the
    reference returns. Returns the port's result."""
    want, got = script(REF), script(PORT)
    assert got == want, (got, want)
    return got


def _mlcfg(pkg, **kw):
    kw.setdefault("sample_interval_s", 0.0)
    return pkg.config.MemoryLedgerConfig(**kw)


def _unmeasured_oom(rec: dict) -> dict:
    """A forensic record without the measured side."""
    return {**{k: v for k, v in rec.items() if k != "measured_bytes"},
            "watermarks": [{k: v for k, v in w.items() if k != "measured"}
                           for w in rec["watermarks"]]}


# ---------------------------------------------------------------------------
# modeled side
# ---------------------------------------------------------------------------


def test_register_deregister_and_forensic_ranking():
    def script(pkg):
        ml = pkg.mem.MemoryLedger(_mlcfg(pkg), clock=FakeClock())
        ml.register("cache.node_table", 4096, shape="N64")
        ml.register("cache.score_summary", 1024, shape="N64")
        ml.register("scheduler.pod_batch", 8192)
        out = [ml.resident_count(), ml.resident_bytes(),
               ml.ranked_residents(), ml.ranked_residents(top=2)]
        ml.register("cache.node_table", 100)
        ml.register("scheduler.pod_batch", 0)
        out.append(ml.ranked_residents())
        ml.deregister("cache.node_table")
        out += [ml.deregister_prefix("cache."), ml.resident_count()]
        return out

    got = both(script)
    assert [n for n, _, _ in got[2]] == [
        "scheduler.pod_batch", "cache.node_table", "cache.score_summary"]
    assert got[-2:] == [1, 0]


def test_disabled_ledger_is_inert():
    def script(pkg):
        ml = pkg.mem.MemoryLedger(_mlcfg(pkg, enabled=False),
                                  clock=FakeClock())
        ml.register("x", 100)
        return (ml.resident_count(), ml.observe_cycle(), ml.preflight_on,
                ml.preflight(8, 8, 0))

    assert both(script)[:3] == (0, None, False)


def test_sample_interval_gates_on_owner_clock():
    def script(pkg):
        clk = FakeClock(1000.0)
        metrics = pkg.metrics.SchedulerMetrics()
        ml = pkg.mem.MemoryLedger(
            pkg.config.MemoryLedgerConfig(sample_interval_s=10.0),
            metrics=metrics, clock=clk)
        ml.register("r", 1000)
        out = []
        for dt in (0.0, 1.0, 10.0):
            clk.advance(dt)
            e = ml.observe_cycle()
            sampled = e["measured_bytes"] >= 0
            # a sample-free boundary publishes the -1 sentinel; a sampled
            # one divides by the measured census, each package's own
            out.append((ml.samples, e["modeled_bytes"], sampled,
                        e["preflight"],
                        None if sampled else
                        metrics.memory_model_efficiency.value(),
                        metrics.device_memory_bytes.value(
                            kind="modeled", device="all")))
        out.append(len(ml.snapshot()["watermarks"]))
        return out

    got = both(script)
    assert [r[0] for r in got[:3]] == [1, 1, 2] and got[1][2:5] == (
        False, "", -1.0)


def test_census_measures_live_cpu_tensors_within_its_bound():
    """On the CPU the measured side is a census of the live CPU tensors
    the residents were registered with (each storage once), the stand-in
    for the reference's live-array walk; ``census_limit`` bounds it. It is
    labelled ``census``, never a device."""
    keep = torch.ones((128, 128))
    view = keep[:4]
    ml = tmem.MemoryLedger(_mlcfg(PORT), clock=FakeClock())
    ml.register_tree("r", (keep, view))
    e = ml.observe_cycle()
    assert ml.census_count() == 1
    assert e["measured_bytes"] == keep.nbytes
    assert 0.0 <= e["efficiency"] <= 8.0
    snap = ml.snapshot()
    assert list(snap["devices"]) == ["census"]
    assert snap["devices"]["census"]["limit"] == 0
    assert snap["peak_bytes"] >= e["measured_bytes"]
    one = tmem.MemoryLedger(_mlcfg(PORT, census_limit=1), clock=FakeClock())
    one.register_tree("a", torch.ones(4))
    eight = torch.ones(8)
    one.register_tree("b", (keep, eight))
    e = one.observe_cycle()
    assert (one.census_count(), e["measured_bytes"]) == (1, eight.nbytes)
    del view


def test_census_cost_is_bounded_by_its_limit(monkeypatch):
    """The census holds at most ``census_limit`` weak references, the
    oldest dropped first, and counts only those: its cost does not grow
    with what else the process holds, so it runs on every sample."""
    walked = []
    real = tmem._census

    def census(refs, cap):
        refs = list(refs)
        walked.append(len(refs))
        return real(refs, cap)

    monkeypatch.setattr(tmem, "_census", census)
    ts = [torch.full((i + 1,), 1.0) for i in range(10)]
    ml = tmem.MemoryLedger(_mlcfg(PORT, census_limit=3), clock=FakeClock())
    for i, t in enumerate(ts):
        ml.register_tree(f"r{i}", t)
    measured = [ml.observe_cycle()["measured_bytes"] for _ in range(3)]
    assert walked == [3, 3, 3] and ml.samples == 3
    assert measured == [(8 + 9 + 10) * 4] * 3
    assert len(ml.snapshot()["watermarks"]) == 3


def test_census_shows_a_deregistered_tensor_still_held():
    """A resident deregistered while something still holds its tensor
    stays in the census (measured above modeled: the leak shows); once
    the tensor is collected it leaves the census."""
    t = torch.ones((64, 64))
    ml = tmem.MemoryLedger(_mlcfg(PORT), clock=FakeClock())
    ml.register_tree("scheduler.pod_batch", t)
    ml.deregister("scheduler.pod_batch")
    e = ml.observe_cycle()
    assert (e["modeled_bytes"], e["measured_bytes"]) == (0, t.nbytes)
    del t
    e = ml.observe_cycle()
    assert (ml.census_count(), e["measured_bytes"]) == (0, 0)


def test_scheduler_residents_are_the_census(monkeypatch):
    """Through the scheduler, the census counts the cache's node table
    and the cycle's pod batch: the tensors the seams registered."""
    s = _scheduler(PORT)
    _drive(PORT, s, n_pods=4, cycles=1)
    ml = s.obs.memledger
    names = {n for n, _b, _s in ml.ranked_residents()}
    assert {"cache.node_table", "scheduler.pod_batch"} <= names
    e = ml.snapshot()["entries"][-1]
    assert ml.census_count() > 0 and e["measured_bytes"] > 0


def test_card_sample_reads_the_allocator_counters(monkeypatch):
    """On a CUDA device the measured side reads the caching allocator's
    host counters (``allocated_bytes.all.current`` / ``.peak``) and the
    device's ``total_memory`` once; it walks no census and calls no
    ``mem_get_info``. Stand-ins replace the ``torch.cuda`` calls here."""
    calls = {"stats": 0, "props": 0}
    readings = iter([(5000, 9000), (6000, 7000)])

    def memory_stats(dev):
        calls["stats"] += 1
        cur, peak = next(readings)
        return {"allocated_bytes.all.current": cur,
                "allocated_bytes.all.peak": peak}

    def props(dev):
        calls["props"] += 1
        return types.SimpleNamespace(total_memory=80 * 2**30)

    def no_info(*a, **kw):
        raise AssertionError("mem_get_info is not read per cycle")

    monkeypatch.setattr(torch.cuda, "memory_stats", memory_stats)
    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    monkeypatch.setattr(torch.cuda, "mem_get_info", no_info)
    monkeypatch.setattr(tmem, "_census", no_info)
    ml = tmem.MemoryLedger(_mlcfg(PORT), clock=FakeClock())
    ml.device = torch.device("cuda", 0)
    ml.register("cache.node_table", 2500)
    e1, e2 = ml.observe_cycle(), ml.observe_cycle()
    assert (e1["measured_bytes"], e1["efficiency"]) == (5000, 0.5)
    assert e2["measured_bytes"] == 6000
    snap = ml.snapshot()
    assert snap["devices"] == {"0": {"resident": 6000, "peak": 7000,
                                     "limit": 80 * 2**30}}
    assert snap["peak_bytes"] == 9000  # the ledger's own tally ratchets
    assert ml.limit_bytes() == 80 * 2**30
    assert calls == {"stats": 2, "props": 1}


def test_capture_memory_analysis_measures_the_allocator_peak(monkeypatch):
    """The bucket capture: the allocator's peak over the solve's start is
    ``temp_bytes``; argument and output bytes are added into
    ``total_bytes``, in the reference's dict shape. None on the CPU."""
    assert tmem.capture_memory_analysis(lambda: 1 / 0, "cpu", 10) is None
    state = {"alloc": 1000, "peak": 1000}

    def solve():
        state["peak"] = 1000 + 700
        return (torch.zeros(4, dtype=torch.int32), torch.zeros(2))

    monkeypatch.setattr(torch.cuda, "synchronize", lambda dev=None: None)
    monkeypatch.setattr(torch.cuda, "memory_allocated",
                        lambda dev=None: state["alloc"])
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda dev=None: state.update(peak=state["alloc"]))
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda dev=None: state["peak"])
    got = tmem.capture_memory_analysis(solve, "cuda:0", 123)
    assert got == {"argument_bytes": 123, "output_bytes": 24,
                   "temp_bytes": 700, "code_bytes": 0, "alias_bytes": 0,
                   "total_bytes": 847}
    assert set(got) == {"argument_bytes", "output_bytes", "temp_bytes",
                        "code_bytes", "alias_bytes", "total_bytes"}


# ---------------------------------------------------------------------------
# capacity preflight: verdicts
# ---------------------------------------------------------------------------


def test_preflight_verdicts_against_bucket_table():
    def script(pkg):
        metrics = pkg.metrics.SchedulerMetrics()
        ml = pkg.mem.MemoryLedger(_mlcfg(pkg, limit_bytes=1000,
                                         headroom_frac=0.9),
                                  metrics=metrics, clock=FakeClock())
        for P, total in ((4, 500), (8, 880), (16, 2000)):
            ml.record_bucket_memory(P, 8, 0, dict(STATS, total_bytes=total))
        out = [ml.preflight(8, 8, 0), ml.preflight(16, 8, 0),
               ml.preflight(32, 64, 0)]
        ml2 = pkg.mem.MemoryLedger(_mlcfg(pkg, limit_bytes=100),
                                   clock=FakeClock())
        ml2.record_bucket_memory(4, 8, 0, dict(STATS, total_bytes=500))
        out.append(ml2.preflight(4, 8, 0))
        return (out, dict(ml.preflights),
                metrics.memory_preflight.expose(), ml.snapshot()["buckets"])

    out, counts, _, _ = both(script)
    assert [(a, s, v["basis"]) for a, s, v in out] == [
        ("ok", 8, "fits"), ("split", 8, "over-budget"),
        ("ok", 32, "unwarmed"), ("shed", 0, "over-budget-no-bucket")]
    assert counts == {"ok": 2, "split": 1, "shed": 0}


@pytest.mark.parametrize("seed", range(6))
def test_preflight_verdicts_match_on_a_seeded_grid(seed):
    """Seeded bucket tables, limits, headroom and queries: every verdict
    (action, split P, the verdict dict) equal to the reference's."""
    rng = np.random.default_rng(seed)
    tables = []
    for _ in range(4):
        rows = []
        for _ in range(int(rng.integers(0, 8))):
            rows.append((int(2 ** rng.integers(2, 12)),
                         int(2 ** rng.integers(3, 8)),
                         int((0, 0, 2)[int(rng.integers(0, 3))]),
                         int(rng.integers(1, 10**6))))
        tables.append((rows, int(rng.integers(0, 2 * 10**6)),
                       float(rng.choice([0.5, 0.9, 1.0, 1.5])),
                       bool(rng.random() < 0.85)))
    queries = [(int(2 ** rng.integers(2, 12)), int(2 ** rng.integers(3, 8)),
                int((0, 2)[int(rng.integers(0, 2))])) for _ in range(30)]

    def script(pkg):
        out = []
        for rows, limit, frac, on in tables:
            ml = pkg.mem.MemoryLedger(
                _mlcfg(pkg, limit_bytes=limit, headroom_frac=frac,
                       preflight=on), clock=FakeClock())
            for P, N, mesh, total in rows:
                ml.record_bucket_memory(P, N, mesh,
                                        dict(STATS, total_bytes=total))
            out.append([ml.preflight(*q) for q in queries])
            out.append(dict(ml.preflights))
        return out

    both(script)


def test_preflight_without_limit_never_fires():
    def script(pkg):
        ml = pkg.mem.MemoryLedger(_mlcfg(pkg), clock=FakeClock())
        ml.record_bucket_memory(8, 8, 0, {"total_bytes": 10**12})
        return ml.preflight(8, 8, 0)

    assert both(script)[2]["basis"] == "no-limit"


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------


def test_record_oom_ranked_record_and_flag():
    def script(pkg):
        ml = pkg.mem.MemoryLedger(_mlcfg(pkg, limit_bytes=10000),
                                  clock=FakeClock(1000.0))
        ml.register("cache.node_table", 5000, shape="N64")
        ml.register("cache.score_summary", 300)
        ml.observe_cycle()
        ml.preflight(8, 8, 0)
        rec = ml.record_oom("snapshot:device", error="RESOURCE_EXHAUSTED",
                            shapes="P8xN64", cycle=7)
        out = [_unmeasured_oom(rec), ml.oom_flag(rec),
               ml.oom_flag({"site": "warmup:compile"})]
        for i in range(pkg.mem.OOM_RING + 5):
            ml.record_oom("warmup:compile", cycle=i)
        out.append([_unmeasured_oom(r) for r in ml.oom_records()])
        dump = ml.dump().split("\n")
        out.append([line for line in dump if not line.startswith(
            "Memory ledger:")])
        return out

    got = both(script)
    assert got[1] == "oom@snapshot:device top=cache.node_table:5000B"
    assert got[2] == "oom@warmup:compile"
    assert len(got[3]) == tmem.OOM_RING


# ---------------------------------------------------------------------------
# through both schedulers
# ---------------------------------------------------------------------------


def _scheduler(pkg, n_nodes=4, **kw):
    kw.setdefault("observability", pkg.config.ObservabilityConfig(
        memory_ledger=_mlcfg(pkg)))
    s = pkg.scheduler.Scheduler(enable_preemption=False, clock=FakeClock(),
                                **pkg.kw, **kw)
    for i in range(n_nodes):
        s.on_node_add(pkg.testing.make_node(f"n{i}", cpu_milli=16000))
    return s


def _drive(pkg, s, n_pods=8, cycles=2, prefix="p"):
    out = []
    for c in range(cycles):
        for i in range(n_pods):
            s.on_pod_add(pkg.testing.make_pod(f"{prefix}{c}-{i}",
                                              cpu_milli=50 + 10 * i))
        out.append(s.schedule_cycle())
    return out


def _cycle_view(r):
    return (r.attempted, r.scheduled, r.unschedulable, r.assignments,
            r.solver_tier)


def test_driven_cycles_register_the_references_residents():
    def script(pkg):
        s = _scheduler(pkg)
        _drive(pkg, s)
        ml = s.obs.memledger
        out = [ml.ranked_residents(), ml.snapshot()["observed"],
               "mem=" in s.obs.recorder.dump()]
        s.cache.drop_device_snapshot()
        out.append(ml.ranked_residents())
        return out

    got = both(script)
    assert {n for n, _, _ in got[0]} == {"cache.node_table",
                                         "scheduler.pod_batch"}
    assert got[1:3] == [2, True]
    assert [n for n, _, _ in got[3]] == ["scheduler.pod_batch"]


def _inject_table(s, totals, limit):
    ml = s.obs.memledger
    n_pad = 8  # bucket_size(4 nodes)
    for P, total in totals.items():
        ml.record_bucket_memory(P, n_pad, 0, dict(STATS, total_bytes=total))
    ml.config.limit_bytes = limit


@pytest.mark.parametrize("n_pods,totals,limit", [
    (16, {8: 400, 16: 900}, 500),
    (16, {8: 400, 16: 900, 32: 2000}, 900),
    (12, {8: 400, 16: 900}, 500),
    (9, {8: 100, 16: 900}, 999),
])
def test_over_budget_batch_splits_like_the_reference(n_pods, totals, limit):
    """With the same injected bucket table and ``limitBytes``, the same
    batch splits to the same P, places the same pods, and the requeued
    tail lands next cycle — zero OOM records."""
    def script(pkg):
        s = _scheduler(pkg)
        _inject_table(s, totals, limit)
        res = _drive(pkg, s, n_pods=n_pods, cycles=1)
        res.append(s.schedule_cycle())
        ml = s.obs.memledger
        return ([_cycle_view(r) for r in res], dict(ml.preflights),
                [r.preflight for r in s.obs.recorder.records()],
                [r.batch_shape for r in s.obs.recorder.records()],
                ml.oom_records(), s.metrics.memory_preflight.expose())

    cycles, counts, flags, shapes, ooms, _ = both(script)
    assert cycles[0][0] == 8 and cycles[0][1] == 8
    assert cycles[1][1] == n_pods - 8
    assert counts["split"] == 1 and flags[0] == "split"
    assert shapes[0].startswith("P8x") and ooms == []


def test_over_budget_batch_sheds_whole_and_requeues_every_pod():
    def script(pkg):
        s = _scheduler(pkg)
        _inject_table(s, {8: 5000}, 100)
        res = _drive(pkg, s, n_pods=4, cycles=1)
        res.append(s.schedule_cycle())
        out = [[_cycle_view(r) for r in res],
               sum(s.queue.pending_counts().values()),
               dict(s.obs.memledger.preflights),
               [r.preflight for r in s.obs.recorder.records()],
               s.obs.memledger.snapshot()["preflight"]["last"]]
        s.obs.memledger.config.limit_bytes = 0
        out.append(_cycle_view(s.schedule_cycle()))
        return out

    got = both(script)
    assert got[0][0][:2] == (0, 0) and got[1] == 4
    # a shed cycle attempts nothing, so (as in the reference) it leaves
    # no flight record: the verdicts count on the ledger and the metric
    assert got[2]["shed"] == 2 and got[3] == []
    assert got[4]["basis"] == "over-budget-no-bucket"
    assert got[5][1] == 4


def test_pipelined_batch_sheds_rather_than_splits():
    """A pipelined cycle solves at its chunk shape: an over-budget chunk
    with a smaller warmed bucket still sheds the whole batch."""
    def script(pkg):
        s = _scheduler(pkg, pipeline_chunk=8)
        _inject_table(s, {4: 100, 8: 5000}, 1000)
        res = _drive(pkg, s, n_pods=20, cycles=1)
        return ([_cycle_view(r) for r in res],
                [r.pipeline_chunks for r in res],
                sum(s.queue.pending_counts().values()),
                dict(s.obs.memledger.preflights),
                s.obs.memledger.snapshot()["preflight"]["last"])

    got = both(script)
    assert got[0][0][:2] == (0, 0) and got[1] == [0] and got[2] == 20
    assert got[3] == {"ok": 0, "split": 1, "shed": 0}
    assert got[4]["P"] == 8 and got[4]["split_P"] == 4


def test_device_oom_at_snapshot_leaves_the_references_record():
    def script(pkg):
        fi = pkg.faults.FaultInjector(seed=0)
        s = _scheduler(pkg, fault_injector=fi)
        res = _drive(pkg, s, n_pods=4, cycles=1)
        fi.arm("snapshot:device", "device_oom", count=1)
        res += _drive(pkg, s, n_pods=4, cycles=1, prefix="q")
        ml = s.obs.memledger
        return ([_cycle_view(r) for r in res],
                [_unmeasured_oom({**o, "error": ""})
                 for o in ml.oom_records()],
                [r.oom_forensic for r in s.obs.recorder.records()])

    cycles, ooms, flags = both(script)
    assert sum(c[1] for c in cycles) == 8
    assert ooms[0]["site"] == "snapshot:device"
    assert flags[1].startswith("oom@snapshot:device top=cache.node_table:")


def test_warmup_oom_releases_residents_and_parks_flag():
    def script(pkg):
        fi = pkg.faults.FaultInjector(seed=0).arm(
            "warmup:compile", "device_oom", count=1)
        s = _scheduler(pkg, fault_injector=fi,
                       warmup=pkg.config.WarmupConfig(enabled=True,
                                                      pod_buckets=(4,)))
        _drive(pkg, s, n_pods=4, cycles=1)
        ml = s.obs.memledger
        out = [ml.resident_count(),
               s.warmup(sample_pods=[pkg.testing.make_pod(
                   "w", cpu_milli=50)]),
               ml.resident_count(), s._sk_warm_pot,
               [_unmeasured_oom({**o, "error": ""})
                for o in ml.oom_records()]]
        _drive(pkg, s, n_pods=2, cycles=1, prefix="after")
        out.append([r.oom_forensic for r in s.obs.recorder.records()])
        return out

    got = both(script)
    assert got[0] >= 2 and got[1:4] == [0, 0, None]
    assert got[4][-1]["site"] == "warmup:compile"
    assert got[5][-1].startswith("oom@warmup:compile top=")
