"""Day-in-the-life soak: the phase engine and the leak sentinels (a copy
of ``kubernetes_tpu/soak.py``).

Every chaos/bench arm so far is a minute-scale, single-purpose cell;
production is ONE process surviving all of it in sequence for hours.
This module is the harness for that artifact (ROADMAP item 3): a
scripted sequence of :class:`SoakPhase` s driven over one composed
``ServingRuntime`` — mixed traffic, cadence re-packing, preemption
cascades, leader kills, shard loss, network faults — separated by
CLEAN phases where the cluster must return to quiescence, plus the
instrumentation no single-purpose cell carries:

- :class:`SoakSentinels` — a sampler that snapshots, per phase
  boundary and on a fixed cadence, every unbounded-unless-maintained
  structure in the process (``Scheduler.state_sizes()``, flight
  recorder / trace-ring occupancy, jaxtel signature LRUs, reflector
  dedupe floors + tombstones, process RSS) and per-gauge freshness —
  and renders a growth verdict over the CLEAN-phase boundaries: state
  that ratchets up across windows where traffic returned to zero is a
  leak, whatever its absolute size.
- :class:`SoakEngine` — phase sequencing with arm/disarm hooks for
  the existing chaos harnesses (chaos.py fault windows open at phase
  entry and close at exit via ``injector.rules.clear()``), per-phase
  counter deltas (SLO burns, auditor violations, double binds,
  retraces), and the clean-phase criteria: on every phase of kind
  ``"clean"`` the configured counters must not move at all.

The engine attaches itself to the scheduler (``sched.soak``) so
``/debug/soak`` (server.py) can serve live progress the same
duck-typed way ``/debug/ledger`` serves the perf ledger.

Nothing here imports torch: the soak is host-side orchestration; the
device stays behind the scheduler's existing seams. The port has no perf
ledger yet (ROADMAP A.13 slice 2), so :func:`standard_counters` has no
``slo_burns`` counter.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence


def read_rss_kb() -> int:
    """Current resident set size in kB (/proc/self/status VmRSS);
    0 where /proc is unavailable — the sentinel then watches a flat
    zero line, never crashes the soak."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except (OSError, ValueError, IndexError):
        pass
    return 0


#: growth allowed across the whole clean-boundary window before a
#: monotonically-increasing series reads as a leak. Keyed by exact
#: sentinel name or by longest matching prefix; sizes without a row
#: get 0 (pod-keyed side state must RETURN to baseline when traffic
#: does). The non-zero rows are the legitimately-plateauing series:
#: vocabulary interners grow until the label/image vocabulary is
#: fully seen, signature LRUs until the shape grid is fully warmed,
#: the rings until they first fill, RSS until allocator pools settle.
DEFAULT_TOLERANCE: Dict[str, float] = {
    "rss_kb": 65536,               # 64 MB of allocator/arena settling
    "sched.interned_items": 256,
    "sched.universe_matcher_memo": 256,
    "sched.universe_owner_sets_memo": 256,
    "sched.packer_pod_table_memo": 1024,   # LRU-capped upstream
    "sched.packer_vol_table_memo": 1024,
    "sched.breakers": 8,           # lazily minted per target, bounded
    "sched.explain_reasons_seen": 32,      # label vocabulary
    # device-side flags/counters state_sizes exports for the memory
    # ledger (mirrored mem.* rows below carry the rationale)
    "sched.dev_node_table": 1,     # 0/1 flag: resident by design
    "sched.dev_score_summary": 1,  # 0/1 flag: resident by design
    "sched.mem_residents": 8,
    "sched.mem_census_arrays": 4096,
    "jax.signatures": 512,         # per-site LRU-capped upstream
    "obs.recorder_len": 4096,      # deque maxlen-capped upstream
    "obs.trace_ring_len": 4096,
    "reflector.": 8192,            # tombstone-LRU-capped upstream
    # device-memory ledger: the census plateaus once JAX's constant /
    # executable pools are fully warmed (shape grid, like jax.
    # signatures); modeled bytes plateau at the largest warmed
    # bucket's operand tables (the resident node table + score plane
    # persist across cycles BY DESIGN — that's what resident caching
    # is). mem.residents is a fixed name set (~4 structures): growth
    # past it means a drop edge leaked a registration
    "mem.residents": 8,
    "mem.census_arrays": 4096,
    "mem.modeled_bytes": 1 << 24,  # 16 MB: bucket-shape settling
    "mem.oom_records": 16,         # ring maxlen-capped upstream
    # pod-journey tracer: pending journeys are pod-keyed side state
    # and must RETURN to baseline when traffic does (tolerance 0, made
    # explicit); the completed tiers are capped upstream (slowest by
    # slow_k, sampled by its deque maxlen) and legitimately plateau as
    # the tail fills in. Mirrored sched.* rows: state_sizes() exports
    # the same numbers under its own namespace.
    "journey.pending": 0,
    "journey.slowest": 64,
    "journey.sampled": 64,
    "sched.journey_pending": 0,
    "sched.journey_slowest": 64,
    "sched.journey_sampled": 64,
    # incident ring: occupancy is deque maxlen-capped upstream and
    # plateaus once it first fills; NEW bundles during a clean window
    # are caught by the clean_zero `incidents` counter, not by ring
    # occupancy (an at-capacity ring stays the same length)
    "incident.ring": 64,
    "sched.incident_ring": 64,
}


def _tolerance(key: str, table: Dict[str, float]) -> float:
    if key in table:
        return table[key]
    best, best_len = 0.0, -1
    for prefix, tol in table.items():
        if prefix.endswith(".") and key.startswith(prefix) \
                and len(prefix) > best_len:
            best, best_len = tol, len(prefix)
    return best if best_len >= 0 else 0.0


class SoakSentinels:
    """The leak sentinel layer. ``sample()`` is cheap (dict-length
    reads + one /proc line) and thread-safe; the soak calls it from
    the serving maintenance hook (under the ingest lock) and at phase
    boundaries. Growth verdicts read ONLY clean-phase boundary
    samples: traffic phases may grow state legitimately; a clean
    window that fails to return to baseline may not.

    ``sched``: anything with ``state_sizes()`` (Scheduler).
    ``reflectors``: sim.Reflector instances (dedupe floor/tombstones).
    ``registry``: a metrics.Registry — every Gauge in it is
    fingerprinted per sample for the freshness ages.
    ``fresh_gauges``: gauge names that MUST change at least once
    within any traffic phase (checked by the engine at phase end)."""

    def __init__(self, sched=None, reflectors: Sequence = (),
                 registry=None, fresh_gauges: Sequence[str] = (),
                 rss_reader: Callable[[], int] = read_rss_kb,
                 tolerance: Optional[Dict[str, float]] = None) -> None:
        self.sched = sched
        self.reflectors = list(reflectors)
        self.registry = registry
        self.fresh_gauges = list(fresh_gauges)
        self.rss_reader = rss_reader
        self.tolerance = dict(DEFAULT_TOLERANCE)
        if tolerance:
            self.tolerance.update(tolerance)
        self.samples: List[dict] = []
        self._lock = threading.Lock()
        #: gauge name -> fingerprint of its full label/value table
        self._gauge_fp: Dict[str, int] = {}
        #: gauge name -> sample index of the last fingerprint change
        self._gauge_changed_at: Dict[str, int] = {}

    # -- collection ---------------------------------------------------------

    def collect(self) -> Dict[str, float]:
        """One flat snapshot of every watched size. Key namespaces:
        ``sched.*`` (state_sizes), ``obs.*`` (rings), ``jax.*``
        (signature LRUs), ``lock.*`` (runtime lock-sanitizer finding
        counts, when armed), ``reflector.N.*`` (dedupe floors),
        ``rss_kb``."""
        out: Dict[str, float] = {"rss_kb": float(self.rss_reader())}
        s = self.sched
        if s is not None:
            sizes = getattr(s, "state_sizes", None)
            if sizes is not None:
                for k, v in sizes().items():
                    out[f"sched.{k}"] = float(v)
            obs = getattr(s, "obs", None)
            if obs is not None:
                rec = getattr(obs, "recorder", None)
                if rec is not None:
                    # ring OCCUPANCY only — `recorded` is a cumulative
                    # counter and would read as a perpetual "leak"
                    out["obs.recorder_len"] = float(len(rec))
                traces = getattr(obs, "traces", None)
                if traces is not None:
                    out["obs.trace_ring_len"] = float(len(traces))
                jx = getattr(obs, "jax", None)
                sig = getattr(jx, "signature_count", None)
                if sig is not None:
                    out["jax.signatures"] = float(sig())
                memledger = getattr(obs, "memledger", None)
                if memledger is not None and getattr(
                        memledger, "enabled", False):
                    # device-memory sentinels: a clean window must
                    # return modeled resident bytes (and the census)
                    # to baseline — a resident surviving its drop edge
                    # is a device leak the host dicts can't see
                    out["mem.residents"] = float(
                        memledger.resident_count())
                    out["mem.modeled_bytes"] = float(
                        memledger.resident_bytes())
                    out["mem.census_arrays"] = float(
                        memledger.census_count())
                    out["mem.oom_records"] = float(
                        len(memledger.oom_records()))
                journeys = getattr(obs, "journeys", None)
                if journeys is not None and getattr(
                        journeys, "enabled", False):
                    # per-pod journey retention: pending must drain
                    # with the queues; the completed tiers are capped
                    # upstream (slow_k / deque maxlen)
                    jsz = journeys.sizes()
                    out["journey.pending"] = float(
                        jsz.get("journey_pending", 0))
                    out["journey.slowest"] = float(
                        jsz.get("journey_slowest", 0))
                    out["journey.sampled"] = float(
                        jsz.get("journey_sampled", 0))
                incidents = getattr(obs, "incidents", None)
                if incidents is not None and getattr(
                        incidents, "enabled", False):
                    # ring OCCUPANCY only — `total` is a cumulative
                    # counter and belongs to the clean_zero contract
                    out["incident.ring"] = float(len(incidents))
            san = getattr(s, "lock_sanitizer", None)
            if san is not None:
                # monotonic finding counts: the clean-window contract
                # pins order_cycles and guard_violations at zero delta —
                # a deadlock-shaped acquisition order found mid-soak is
                # a bug whatever the RSS curve says
                counts = san.counts()
                out["lock.order_cycles"] = float(
                    counts.get("order-cycle", 0))
                out["lock.held_too_long"] = float(
                    counts.get("held-too-long", 0))
                out["lock.guard_violations"] = float(
                    counts.get("guard-violation", 0))
                out["lock.total"] = float(san.total_findings())
        for i, r in enumerate(self.reflectors):
            out[f"reflector.{i}.obj_rev"] = float(
                len(getattr(r, "_obj_rev", ())))
            out[f"reflector.{i}.tombstones"] = float(
                len(getattr(r, "_gone_rev", ())))
        return out

    def _fingerprint_gauges(self, idx: int) -> None:
        reg = self.registry
        if reg is None:
            return
        from kubernetes_tpu_torch.metrics import Gauge

        for m in getattr(reg, "_metrics", ()):
            if not isinstance(m, Gauge):
                continue
            # the write counter joins the fingerprint: a gauge that is
            # maintained every cycle but always reads 0 at sample time
            # (queue depth after a drain) must still count as FRESH —
            # freshness means "someone writes this", not "the sampled
            # value moved between two arbitrary snapshots"
            fp = hash((getattr(m, "writes", 0),
                       tuple(sorted(m._values.items()))))
            if self._gauge_fp.get(m.name) != fp:
                self._gauge_fp[m.name] = fp
                self._gauge_changed_at[m.name] = idx

    def sample(self, tag: str = "cadence", phase: Optional[str] = None,
               clean: bool = False, clock: Optional[float] = None) -> dict:
        """Take one snapshot. ``clean=True`` marks it as a clean-phase
        BOUNDARY sample — the points the growth verdict draws through."""
        values = self.collect()
        with self._lock:
            idx = len(self.samples)
            self._fingerprint_gauges(idx)
            row = {"i": idx, "t": clock, "tag": tag, "phase": phase,
                   "clean": bool(clean), "values": values}
            self.samples.append(row)
            return row

    # -- verdicts -----------------------------------------------------------

    def _clean_series(self) -> Dict[str, List[float]]:
        with self._lock:
            rows = [r for r in self.samples if r["clean"]]
        series: Dict[str, List[float]] = {}
        for r in rows:
            for k, v in r["values"].items():
                series.setdefault(k, []).append(v)
        return series

    def growth_report(self) -> Dict[str, dict]:
        """Per-sentinel verdict over the clean-phase boundary samples:
        ``growing`` is True when the series NEVER decreases, strictly
        increases at least twice, and its total rise exceeds the key's
        tolerance — the monotonic-ratchet shape of a leak, as opposed
        to a plateau (bounded cache filling) or a sawtooth (state that
        drains). Needs >= 3 clean samples to judge; fewer yields
        ``growing=False, judged=False``."""
        out: Dict[str, dict] = {}
        for key, vals in self._clean_series().items():
            judged = len(vals) >= 3
            rises = sum(1 for a, b in zip(vals, vals[1:]) if b > a)
            monotone = all(b >= a for a, b in zip(vals, vals[1:]))
            growth = (vals[-1] - vals[0]) if vals else 0.0
            tol = _tolerance(key, self.tolerance)
            out[key] = {
                "first": vals[0] if vals else 0.0,
                "last": vals[-1] if vals else 0.0,
                "growth": growth,
                "tolerance": tol,
                "judged": judged,
                "growing": bool(judged and monotone and rises >= 2
                                and growth > tol),
            }
        return out

    def leaking(self) -> List[str]:
        """Sentinel names whose clean-boundary series reads as a leak."""
        return sorted(k for k, v in self.growth_report().items()
                      if v["growing"])

    def gauge_ages(self) -> Dict[str, int]:
        """Samples since each registered gauge last changed."""
        with self._lock:
            n = len(self.samples)
            return {name: n - 1 - at
                    for name, at in self._gauge_changed_at.items()}

    def stale_since(self, idx: int) -> List[str]:
        """Which ``fresh_gauges`` have NOT changed since sample
        ``idx`` — the engine calls this at the end of each traffic
        phase with the phase's first sample index."""
        with self._lock:
            return sorted(
                name for name in self.fresh_gauges
                if self._gauge_changed_at.get(name, -1) < idx)

    def snapshot(self) -> dict:
        """JSON-shaped live view (/debug/soak)."""
        with self._lock:
            last = self.samples[-1] if self.samples else None
            n = len(self.samples)
        return {"samples": n, "last": last,
                "leaking": self.leaking(),
                "gauge_ages": self.gauge_ages()}


@dataclass
class SoakPhase:
    """One scripted phase. ``kind``:

    - ``"traffic"`` — load flows; sentinels may grow; the freshness
      rule applies (``fresh_gauges`` must move);
    - ``"chaos"`` — traffic plus an armed fault harness;
    - ``"clean"`` — recovery window: the ``clean_zero`` counters must
      not move and the boundary sample joins the growth series.

    ``arm``/``disarm`` bracket the phase (arm fault rules, start
    producers / clear rules, stop producers). ``tick(elapsed_s)`` runs
    every engine step inside the phase — drive fake-clock advances,
    kill leaders on a schedule, etc. ``probe()`` runs at phase end;
    its dict lands in the phase report (p99s, bound counts...)."""

    name: str
    duration_s: float
    kind: str = "traffic"
    arm: Optional[Callable[[], None]] = None
    disarm: Optional[Callable[[], None]] = None
    tick: Optional[Callable[[float], None]] = None
    probe: Optional[Callable[[], dict]] = None


class SoakEngine:
    """Phase sequencing + verdicts over one composed runtime.

    ``counters``: name -> zero-arg reader of a MONOTONIC total
    (watchdog burns, auditor violations, double binds, retraces...);
    read at every phase boundary, reported as per-phase deltas.
    ``clean_zero``: the counter names whose delta must be 0 on every
    clean phase. ``step_s``: engine granularity — ticks and cadence
    samples happen on this grid; ``sleep`` is injectable so the
    fake-clock test compresses hours into no wall time at all."""

    def __init__(self, phases: Sequence[SoakPhase],
                 sentinels: SoakSentinels,
                 counters: Optional[Dict[str, Callable[[], float]]] = None,
                 clean_zero: Sequence[str] = (),
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 step_s: float = 1.0,
                 sample_every_s: float = 10.0,
                 p99_drift_bound: float = 0.5,
                 log: Callable[[str], None] = lambda _m: None) -> None:
        self.phases = list(phases)
        self.sentinels = sentinels
        self.counters = dict(counters or {})
        self.clean_zero = [c for c in clean_zero if c in self.counters]
        self.clock = clock
        self.sleep = sleep
        self.step_s = max(float(step_s), 1e-6)
        self.sample_every_s = max(float(sample_every_s), self.step_s)
        self.p99_drift_bound = float(p99_drift_bound)
        self.log = log
        self.reports: List[dict] = []
        self.current: Optional[str] = None
        self._lock = threading.Lock()

    # -- one phase ----------------------------------------------------------

    def _read_counters(self) -> Dict[str, float]:
        return {name: float(read()) for name, read in self.counters.items()}

    def run_phase(self, ph: SoakPhase) -> dict:
        with self._lock:
            self.current = ph.name
        self.log(f"soak phase {ph.name} ({ph.kind}, {ph.duration_s:g}s)")
        start_sample = self.sentinels.sample(
            tag="phase-start", phase=ph.name, clock=self.clock())
        before = self._read_counters()
        t0 = self.clock()
        if ph.arm is not None:
            ph.arm()
        try:
            next_sample = t0 + self.sample_every_s
            while True:
                elapsed = self.clock() - t0
                if elapsed >= ph.duration_s:
                    break
                if ph.tick is not None:
                    ph.tick(elapsed)
                self.sleep(min(self.step_s, ph.duration_s - elapsed))
                if self.clock() >= next_sample:
                    self.sentinels.sample(
                        tag="cadence", phase=ph.name, clock=self.clock())
                    next_sample = self.clock() + self.sample_every_s
        finally:
            if ph.disarm is not None:
                ph.disarm()
        after = self._read_counters()
        delta = {k: after[k] - before.get(k, 0.0) for k in after}
        # the boundary sample is taken AFTER disarm: a clean phase's
        # point must reflect the recovered steady state, and a chaos
        # phase's point must not carry a still-armed fault window
        self.sentinels.sample(
            tag="phase-end", phase=ph.name, clean=(ph.kind == "clean"),
            clock=self.clock())
        violations: List[str] = []
        if ph.kind == "clean":
            for name in self.clean_zero:
                if delta.get(name, 0.0) != 0.0:
                    violations.append(
                        f"{name} moved by {delta[name]:g} in clean "
                        f"phase {ph.name}")
        stale: List[str] = []
        if ph.kind in ("traffic", "chaos"):
            stale = self.sentinels.stale_since(start_sample["i"])
            for name in stale:
                violations.append(
                    f"gauge {name} never changed during {ph.name}")
        report = {
            "name": ph.name, "kind": ph.kind,
            "duration_s": ph.duration_s,
            "wall_s": round(self.clock() - t0, 3),
            "counters_delta": delta,
            "stale_gauges": stale,
            "violations": violations,
            "ok": not violations,
        }
        if ph.probe is not None:
            report["probe"] = ph.probe()
        self.reports.append(report)
        return report

    # -- the full soak ------------------------------------------------------

    def run(self) -> dict:
        t0 = self.clock()
        totals0 = self._read_counters()
        for ph in self.phases:
            self.run_phase(ph)
        with self._lock:
            self.current = None
        totals = self._read_counters()
        growth = self.sentinels.growth_report()
        leaking = sorted(k for k, v in growth.items() if v["growing"])
        phase_violations = [v for r in self.reports for v in r["violations"]]
        # p99 drift: first vs last traffic-phase probe that reported one
        p99s = [(r["name"], r["probe"]["p99_s"]) for r in self.reports
                if r.get("probe") and "p99_s" in r["probe"]
                and r["probe"]["p99_s"] is not None]
        drift = None
        if len(p99s) >= 2 and p99s[0][1] > 0:
            drift = (p99s[-1][1] - p99s[0][1]) / p99s[0][1]
        drift_ok = drift is None or drift <= self.p99_drift_bound
        verdict = {
            "phases_ok": not phase_violations,
            "sentinels_flat": not leaking,
            "leaking": leaking,
            "p99_drift": drift,
            "p99_drift_ok": drift_ok,
            "ok": not phase_violations and not leaking and drift_ok,
        }
        return {
            "wall_s": round(self.clock() - t0, 3),
            "phases": self.reports,
            "counters_total": {
                k: totals[k] - totals0.get(k, 0.0) for k in totals},
            "sentinels": {
                "samples": len(self.sentinels.samples),
                "growth": growth,
            },
            "verdict": verdict,
        }

    def attach(self, sched) -> "SoakEngine":
        """Expose this engine on the scheduler for /debug/soak (the
        duck-typed pattern /debug/ledger uses)."""
        sched.soak = self
        return self

    def status(self) -> dict:
        """Live JSON view: current phase, completed reports, sentinel
        snapshot (served by /debug/soak while the soak runs)."""
        with self._lock:
            current = self.current
            done = list(self.reports)
        return {
            "current_phase": current,
            "phases_done": [
                {"name": r["name"], "kind": r["kind"], "ok": r["ok"]}
                for r in done],
            "sentinels": self.sentinels.snapshot(),
        }


def standard_counters(sched, auditor=None, extra=None
                      ) -> Dict[str, Callable[[], float]]:
    """The counter set every soak watches, wired from one scheduler:
    SLO burns (ledger watchdog), auditor violations, solve retraces,
    fenced binds, recovery drains. ``extra`` merges driver-specific
    readers (double-bind attempts from a chaos binder, ...)."""
    obs = sched.obs
    counters: Dict[str, Callable[[], float]] = {
        "retraces": lambda: float(obs.jax.retrace_total()),
        "fenced_binds": lambda: float(
            sched.metrics.recovery_fenced_binds.value()),
    }
    incidents = getattr(obs, "incidents", None)
    if incidents is not None and getattr(incidents, "enabled", False):
        # captured incident bundles: monotonic, joins the clean-window
        # zero contract — a clean phase that trips ANY incident trigger
        # is not clean, whatever the sentinel occupancies say
        counters["incidents"] = lambda: float(incidents.total)
    journeys = getattr(obs, "journeys", None)
    if journeys is not None and getattr(journeys, "enabled", False):
        # journeys dropped at the max_pending cap: monotonic; movement
        # means the backlog outran the tracer's bounded pending table
        counters["journey_drops"] = lambda: float(journeys.dropped_total)
    if auditor is not None:
        counters["auditor_violations"] = (
            lambda: float(auditor.violations_total))
    if extra:
        counters.update(extra)
    return counters
