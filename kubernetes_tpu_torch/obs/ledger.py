"""Perf ledger — per-cycle cost-model accounting and the online SLO
watchdog (the port of ``kubernetes_tpu/obs/ledger.py``).

Three pieces, one :class:`PerfLedger` facade the scheduler's
:class:`~kubernetes_tpu_torch.obs.core.Observability` owns:

- **Measured side** — every eventful cycle's flight record
  (``CycleRecord.spans``: snapshot / solve:{tier} / validate / bind,
  the pipeline's pack / dispatch / readback / bind chunks, the
  restricted-vs-cold ``solve_scope``) is grouped into canonical PHASES
  and folded into rolling per-phase x per-solve-scope x per-mesh-size
  distributions (p50/p99 over a bounded sample window, plus an EWMA).
  The ledger consumes ``end_cycle`` output on the host: it adds no
  device sync and reads no tensor.
- **Modeled side** (:class:`CycleCostModel`) — at warmup the scheduler
  records the analytic work of one round at each anchored (P, N) solve
  shape (:func:`round_work`) plus one *timed warm replay* as the rate
  anchor; live cycles without a warmup self-anchor on their first
  measured solve. A cycle's predicted solve cost scales the anchor by
  the work ratio (the recorded operations when BOTH shapes carry one,
  else the dense ``P*N`` plane; restricted solves scale with ``P`` alone
  — the candidate bucket is one fixed shape) divided across the mesh and
  discounted by :func:`~kubernetes_tpu_torch.parallel.costmodel.
  model_efficiency`. ``modeled/measured`` lands on the CycleResult, the
  flight record (``eff=0.87`` flag), ``scheduler_cycle_model_efficiency``
  and a Chrome-trace counter track.
- **SLO watchdog** (:class:`SLOWatchdog`) — multi-window burn-rate
  evaluation (page only when the FAST and the SLOW window both burn)
  over two objectives: create-to-bind p99 (``e2e_p99_objective_s``;
  error budget: 1% of pods may exceed the target) and cycle-cost drift
  against a rolling EWMA baseline (``cost_drift_ratio``; budget: 10% of
  cycles may exceed ratio x baseline). Transitions emit
  ``SchedulerSLOBurn`` / ``SchedulerSLORecovered`` events, export
  ``scheduler_slo_burn_rate{objective,window}`` and, while burning,
  engage :meth:`Scheduler.is_degraded` so APF admission sheds earlier at
  the same queue depth (``engage_pressure``).

Where the port differs from the reference: the reference's model side
reads XLA's ``cost_analysis()`` of the compiled solve (basis
``xla-cost``). The port has no compiler to ask; its signatures are the
bytes and operations one round of the hand kernels moves at the padded
(P, N), counted from the shapes by :func:`round_work` — the same count
``chip_smoke.py`` gives each kernel's bound — and a prediction made
from them carries the basis ``"analytic"``.

Everything runs on the owner's injected clock (deterministic under fake
clocks) and is thread-safe: the scheduler thread observes while the
``/debug/ledger`` handler thread snapshots.
"""

from __future__ import annotations

import math
import re
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.sanitize import make_lock

#: span name -> canonical phase. Pipeline spans carry their chunk index
#: (``pipeline:pack@3``) — the phase is the stage name; ladder spans
#: carry their tier (``solve:batch``) — the phase is "solve" so the
#: restricted/cold split rides the SCOPE axis, not the phase axis.
_PHASE_NAMES = ("snapshot", "validate", "bind", "preemption")

#: objectives' error budgets: a p99 target tolerates 1% of samples over
#: it by definition; the drift objective tolerates 10% of cycles over
#: ratio x baseline before burn = 1 (transient spikes are not incidents)
E2E_ERROR_BUDGET = 0.01
DRIFT_ERROR_BUDGET = 0.10

#: min clock seconds between pressure-probe window re-evaluations
#: (PerfLedger.pressure_engaged) — bounds burn-recovery staleness as
#: seen by request threads without an evaluate per mutating call
PRESSURE_EVAL_INTERVAL_S = 1.0

_SHAPE_RE = re.compile(r"^P(\d+)xN(\d+)")


def phase_of(span_name: str) -> str:
    """Canonical phase of one span name ('' = not a phase: the cycle
    root)."""
    if span_name.startswith("pipeline:"):
        # pipeline:pack@3 -> pack; pipeline:readback@reasons -> readback
        return span_name.split(":", 1)[1].split("@", 1)[0]
    if span_name.startswith("solve:"):
        return "solve"
    if span_name.startswith(("extender", "grpc")):
        return "extenders"
    if span_name.startswith("scenario"):
        return "scenario"
    if span_name in _PHASE_NAMES:
        return span_name
    if span_name == "Scheduling cycle":
        return ""  # the root frame is the total, not a phase
    return "other"


def parse_batch_shape(digest: str) -> Tuple[int, int]:
    """(padded P, padded N) from the flight record's batch-shape digest
    (``P4096xN65536+topo+mesh8``); (0, 0) when the cycle never packed."""
    m = _SHAPE_RE.match(digest or "")
    return (int(m.group(1)), int(m.group(2))) if m else (0, 0)


def _quantile(sorted_vals, q: float) -> float:
    """Nearest-rank quantile over an already-sorted sequence — THE one
    implementation both the rolling distributions (/debug/ledger) and
    the bench arm summaries use, so the percentiles the ``ledger``
    gate enforces can never diverge from the live ones."""
    n = len(sorted_vals)
    return sorted_vals[min(n - 1, max(0, math.ceil(q * n) - 1))]


class RollingDist:
    """Bounded sample window + EWMA for one (phase, scope, mesh) cell.
    p50/p99 come from the retained window (newest ``window`` samples);
    the EWMA is the cheap always-on trend the drift baseline rides."""

    __slots__ = ("samples", "ewma", "n", "alpha")

    def __init__(self, window: int = 256, alpha: float = 0.05) -> None:
        self.samples: deque = deque(maxlen=max(1, int(window)))
        self.ewma = 0.0
        self.n = 0
        self.alpha = min(max(float(alpha), 1e-6), 1.0)

    def observe(self, v: float) -> None:
        v = float(v)
        self.samples.append(v)
        self.ewma = v if self.n == 0 else (
            self.alpha * v + (1.0 - self.alpha) * self.ewma)
        self.n += 1

    def quantile(self, q: float) -> float:
        if not self.samples:
            return 0.0
        return _quantile(sorted(self.samples), q)

    def to_json(self) -> dict:
        return {"n": self.n, "p50_s": round(self.quantile(0.5), 6),
                "p99_s": round(self.quantile(0.99), 6),
                "ewma_s": round(self.ewma, 6)}


@dataclass
class LedgerEntry:
    """One cycle's ledger row: the measured phase costs, the model's
    prediction for the same shape, and the gap."""

    cycle: int = 0
    t: float = 0.0
    batch_shape: str = ""
    scope: str = ""          # restricted | full | "" (no solve)
    mesh: int = 0            # devices the cycle ran on (0 = single)
    phases: Dict[str, float] = field(default_factory=dict)
    measured_s: float = 0.0  # cycle wall (CycleRecord.elapsed_s)
    solve_s: float = 0.0     # measured solve(+dispatch) phase total
    modeled_s: float = -1.0  # predicted solve cost (-1 = no prediction)
    efficiency: float = -1.0  # modeled/measured solve (-1 = unpopulated)
    model_basis: str = ""    # analytic | calibrated | anchor | ""
    slo: str = ""            # comma-joined burning objectives ("" = ok)

    def to_json(self) -> dict:
        return {
            "cycle": self.cycle,
            "t": round(self.t, 6),
            "batch_shape": self.batch_shape,
            "scope": self.scope,
            "mesh": self.mesh,
            "phases": {k: round(v, 6) for k, v in sorted(
                self.phases.items())},
            "measured_s": round(self.measured_s, 6),
            "solve_s": round(self.solve_s, 6),
            **({"modeled_s": round(self.modeled_s, 6),
                "model_efficiency": round(self.efficiency, 4),
                "model_basis": self.model_basis}
               if self.efficiency >= 0 else {}),
            **({"slo": self.slo} if self.slo else {}),
        }


class CycleCostModel:
    """The modeled side: per-signature analytic work + rate anchors.

    ``record_signature`` lands warmup's :func:`round_work` count
    (operations as ``flops``, and bytes, per (P, N) solve shape);
    ``record_anchor`` offers a measured warm solve (warmup's timed
    replay, and every live cycle) — the best seconds-per-work rate
    wins, so a compile-swallowing cold cycle never becomes the
    reference. ``predict`` scales the anchor by the analytic work ratio — captured
    work when BOTH shapes carry one (basis ``analytic``), else the
    dense ``P·N`` plane (restricted solves: ``P`` — the candidate
    bucket is one static shape) — normalized to single-device work via
    ``/devices/model_efficiency(...)`` so one anchor predicts every
    mesh width with parallel/costmodel.py's collective model folded
    in."""

    def __init__(self, lock_factory=None) -> None:
        self._lock = make_lock(lock_factory, "obs.costmodel")
        #: (P, N) -> {"flops": float, "bytes_accessed": float}
        self._sig: Dict[Tuple[int, int], Dict[str, float]] = {}
        #: scope -> (P, N, mesh, solve_s, rounds) — the BEST observed
        #: rate wins (lowest seconds per work unit): the anchor is the
        #: speed-of-light reference, so a cold cycle whose solve span
        #: swallowed a graph capture can never become the baseline, and
        #: drift reads as efficiency < 1 against the best the hardware
        #: has demonstrably done (never a silent re-base upward)
        self._anchor: Dict[str, Tuple[int, int, int, float, int]] = {}

    def record_signature(self, P: int, N: int, flops: float,
                         bytes_accessed: float = 0.0) -> None:
        if flops and flops > 0:
            with self._lock:
                self._sig[(int(P), int(N))] = {
                    "flops": float(flops),
                    "bytes_accessed": float(bytes_accessed or 0.0)}

    def record_anchor(self, scope: str, P: int, N: int, mesh: int,
                      solve_s: float, rounds: int = 1) -> bool:
        """Offer a measured solve as the scope's rate anchor; installs
        it only when its seconds-per-work-unit beat the current anchor
        (or none exists). Returns True when installed."""
        if solve_s <= 0 or P <= 0:
            return False
        scope = scope or "full"
        work = self._work(P, N, mesh, scope, None, rounds)
        if work <= 0:
            return False
        rate = float(solve_s) / work
        with self._lock:
            cur = self._anchor.get(scope)
            if cur is not None:
                cP, cN, cMesh, cS, cR = cur
                cur_work = self._work(cP, cN, cMesh, scope, None, cR)
                if cur_work > 0 and rate >= cS / cur_work:
                    return False
            self._anchor[scope] = (int(P), int(N), int(mesh),
                                   float(solve_s), max(int(rounds), 1))
            return True

    def _work(self, P: int, N: int, mesh: int, scope: str,
              flops: Optional[float], rounds: int) -> float:
        """Single-device-equivalent work units for one solve: the
        per-round plane cost (captured ``flops``, read out of ``_sig``
        under the caller's lock — this helper runs locked AND unlocked,
        so it must not touch shared state itself — or the analytic P·N)
        times the round count, divided across the mesh and discounted
        by the collective model."""
        from kubernetes_tpu_torch.parallel.costmodel import model_efficiency

        if flops is not None:
            base = flops
        elif scope == "restricted":
            # the restricted solve gathers a FIXED candidate bucket:
            # cost scales with the batch, not the node axis
            base = float(max(P, 1))
        else:
            base = float(max(P, 1)) * float(max(N, 1))
        d = max(int(mesh), 1)
        return (base * max(int(rounds), 1)
                / d / model_efficiency(d, P, max(N, 1)))

    def predict(self, P: int, N: int, mesh: int, scope: str,
                rounds: int = 1) -> Tuple[Optional[float], str]:
        """(modeled solve seconds, basis) — (None, "") when no anchor
        exists yet for this scope (the caller self-anchors). No
        cross-scope fallback: restricted work units (P) and full work
        units (P·N) are incommensurable, so scaling a full anchor for a
        restricted query would produce a confidently wrong verdict."""
        scope = scope or "full"
        with self._lock:
            anchor = self._anchor.get(scope)
            if anchor is None:
                return None, ""
            aP, aN, aMesh, aS, aRounds = anchor
            use_flops = (scope != "restricted"
                         and (P, N) in self._sig
                         and (aP, aN) in self._sig)
            # snapshot the flops while still under the lock: _work runs
            # unlocked and a concurrent record_signature replaces entries
            q_flops = self._sig[(P, N)]["flops"] if use_flops else None
            a_flops = self._sig[(aP, aN)]["flops"] if use_flops else None
        work = self._work(P, N, mesh, scope, q_flops, rounds)
        anchor_work = self._work(aP, aN, aMesh, scope, a_flops, aRounds)
        if anchor_work <= 0:
            return None, ""
        basis = "analytic" if use_flops else "calibrated"
        return aS * work / anchor_work, basis

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "signatures": {
                    f"P{p}xN{n}": dict(v)
                    for (p, n), v in sorted(self._sig.items())},
                "anchors": {
                    scope: {"P": a[0], "N": a[1], "mesh": a[2],
                            "solve_s": round(a[3], 6), "rounds": a[4]}
                    for scope, a in sorted(self._anchor.items())},
            }


#: bytes and operations per (P, N) element of each hand kernel, one
#: call: the fused pair reads rf, rr (f32), the mask (u8) and writes the
#: score (f32), 14 operations an element (2 masked maxima, 2 x (mul,
#: div, add, floor), the combine); a Sinkhorn pass reads logk (f32) and
#: does add, max, sub, exp and sum. ``chip_smoke.py`` counts each
#: kernel's bound on its own by the same rule;
#: ``tests/test_torch_ledger.py`` holds the two counts equal.
_PLANE_BYTES = {"fused_pair_normalize": 4 + 4 + 1 + 4,
                "sinkhorn_u": 4, "sinkhorn_v": 4}
_PLANE_OPS = {"fused_pair_normalize": 14, "sinkhorn_u": 5, "sinkhorn_v": 5}

#: the fixed-iteration Sinkhorn scan's iterations a round
#: (``ops/sinkhorn.sinkhorn_plan``'s default)
SINKHORN_ITERS = 25


def kernel_work(name: str, P: int, N: int) -> Tuple[int, int]:
    """(bytes, operations) one call of hand kernel ``name`` needs at
    (P, N): each input read once, each output written once."""
    P, N = int(P), int(N)
    nbytes = P * N * _PLANE_BYTES[name]
    if name == "sinkhorn_u":
        nbytes += (2 * P + N) * 4    # v, log_r in; u out
    elif name == "sinkhorn_v":
        nbytes += (P + 2 * N) * 4    # u, log_c in; v out
    return nbytes, P * N * _PLANE_OPS[name]


def round_work(P: int, N: int, use_sinkhorn: bool = False,
               sinkhorn_iters: int = SINKHORN_ITERS) -> dict:
    """The analytic work of one general round at the padded (P, N): the
    fused pair once, and the plan's u and v passes ``sinkhorn_iters``
    times each when the round plans. Returns the reference's
    ``cost_analysis`` keys: ``{"flops": operations, "bytes_accessed":
    bytes}`` (the port's counterpart of XLA's cost capture)."""
    nbytes, ops = kernel_work("fused_pair_normalize", P, N)
    if use_sinkhorn:
        for name in ("sinkhorn_u", "sinkhorn_v"):
            b, o = kernel_work(name, P, N)
            nbytes += b * int(sinkhorn_iters)
            ops += o * int(sinkhorn_iters)
    return {"flops": float(ops), "bytes_accessed": float(nbytes)}


class _BurnWindow:
    """One objective × one window: a sample deque with rolling
    bad/total sums so the burn rate is O(1) per read.
    ``pressure_engaged`` probes the watchdog from request threads on
    every mutating call while burning — re-scanning a slow-window-sized
    deque per request would cost the most exactly when the system is
    already degraded."""

    __slots__ = ("window_s", "dq", "bad", "total")

    def __init__(self, window_s: float) -> None:
        self.window_s = float(window_s)
        self.dq: deque = deque()
        self.bad = 0
        self.total = 0

    def add(self, t: float, bad: int, total: int) -> None:
        self.dq.append((t, bad, total))
        self.bad += bad
        self.total += total
        self.prune(t)

    def prune(self, now: float) -> None:
        lo = now - self.window_s
        dq = self.dq
        while dq and dq[0][0] < lo:
            _, b, n = dq.popleft()
            self.bad -= b
            self.total -= n

    def rate(self, budget: float, now: float) -> float:
        self.prune(now)
        if self.total <= 0:
            return 0.0
        return (self.bad / self.total) / max(budget, 1e-9)


class SLOWatchdog:
    """Multi-window burn-rate evaluation over the ledger's objectives.

    Per objective: a (fast, slow) ``_BurnWindow`` pair with rolling
    sums; ``burn(window) = violating_fraction / error_budget``.
    The state machine trips to *burning* when BOTH windows' burn rates
    reach ``burn_threshold`` (fast alone is a blip, slow alone is old
    news — the SRE multi-window rule) and recovers when the FAST window
    drops back under. An EMPTY fast window reads burn rate 0 and so
    RECOVERS a standing burn — the SRE no-traffic convention (no
    samples = no error budget spent), chosen deliberately: holding a
    burn on silence would let one permanently-unschedulable pod pin
    degraded shedding forever, and during a true total stall the APF
    probe still sheds on raw queue depth (``backend_pressure``'s base
    term) even after the degraded multiplier drops. Transitions emit
    events through the installed sink and count in ``burns`` so the
    benches can assert clean arms stayed at zero.

    Trips require FRESH evidence: only an evaluation riding an
    ``_observe`` (a cycle just folded samples in) may flip an
    objective to burning; the clock-driven re-evaluations (idle tick,
    pressure probe) pass ``allow_trip=False`` and may only recover.
    Without this, a quiet period after a loud one can page on stale
    samples: as the fast window drains oldest-first, the violating
    FRACTION of what remains can rise and cross the threshold with no
    new traffic at all (the soak's clean window after the
    network-fault phase caught exactly this flap)."""

    def __init__(self, config, clock: Callable[[], float] = time.monotonic,
                 metrics=None, lock_factory=None) -> None:
        self.config = config
        self.clock = clock
        self.metrics = metrics
        #: event sink: (reason, involved ObjectRef, message) -> None;
        #: the Scheduler wires its own event_sink here
        self.event_sink: Optional[Callable] = None
        #: guards every state dict below: the scheduler thread observes
        #: while /debug/ledger snapshots AND request threads re-evaluate
        #: through pressure_engaged — an unlocked dict iteration there
        #: can raise "dictionary changed size during iteration"
        self._lock = make_lock(lock_factory, "obs.watchdog")
        #: objective name -> (fast, slow) _BurnWindow pair
        self._samples: Dict[str, Tuple[_BurnWindow, _BurnWindow]] = {}
        #: objective name -> burning?
        self._burning: Dict[str, bool] = {}
        #: burn transitions per objective (monotone; bench gate input)
        self.burns: Dict[str, int] = {}
        #: rolling cost baseline per solve scope (EWMA seconds)
        self._baseline: Dict[str, float] = {}

    # -- objectives ---------------------------------------------------------

    def objectives(self) -> List[Tuple[str, float]]:
        out = []
        if self.config.e2e_p99_objective_s > 0:
            out.append(("e2e_p99", E2E_ERROR_BUDGET))
        if self.config.cost_drift_ratio > 0:
            out.append(("cost_drift", DRIFT_ERROR_BUDGET))
        return out

    def _observe(self, objective: str, t: float, bad: int,
                 total: int) -> None:
        # caller holds self._lock
        wins = self._samples.get(objective)
        if wins is None:
            wins = self._samples[objective] = (
                _BurnWindow(self.config.fast_window_s),
                _BurnWindow(self.config.slow_window_s))
        for w in wins:
            w.add(t, int(bad), int(total))

    def burn_rate(self, objective: str, window_s: float,
                  budget: float, now: float) -> float:
        # caller holds self._lock (the windows must not grow mid-read)
        wins = self._samples.get(objective)
        if wins is None:
            return 0.0
        for w in wins:
            if w.window_s == window_s:
                return w.rate(budget, now)
        # only the configured fast/slow windows are maintained
        return 0.0

    def observe_cycle(self, t: float, e2e_latencies, solve_s: float,
                      scope: str) -> str:
        """Fold one cycle's evidence in, run the state machine, return
        the comma-joined burning-objective string for the records."""
        observed = False
        with self._lock:
            if self.config.e2e_p99_objective_s > 0 and e2e_latencies:
                target = self.config.e2e_p99_objective_s
                bad = sum(1 for v in e2e_latencies if v > target)
                self._observe("e2e_p99", t, bad, len(e2e_latencies))
                observed = True
            if self.config.cost_drift_ratio > 0 and solve_s > 0:
                scope = scope or "full"
                base = self._baseline.get(scope)
                violated = False
                if base is not None and base > 0:
                    violated = solve_s > self.config.cost_drift_ratio * base
                    self._observe("cost_drift", t, int(violated), 1)
                    observed = True
                a = min(max(self.config.baseline_decay, 1e-6), 1.0)
                if violated:
                    # slow the re-base 10x while violating: a step
                    # regression must fill the burn windows and TRIP
                    # before the baseline absorbs it (at full decay the
                    # violation count is bounded by ~ln(r/(r-1))/decay
                    # regardless of magnitude — the silent upward
                    # re-base this watchdog exists to prevent). A
                    # persistent new normal still re-bases eventually,
                    # so the burn recovers instead of pinning degraded.
                    a *= 0.1
                self._baseline[scope] = (solve_s if base is None
                                         else a * solve_s + (1 - a) * base)
        # an eventful cycle that folded NOTHING in (no latencies, no
        # solve) is clock, not evidence — recovery-only, like the ticks
        return self.evaluate(t, allow_trip=observed)

    def evaluate(self, now: float, allow_trip: bool = True) -> str:
        """Run the state machine over both windows. Safe from ANY
        thread (locked); events emit after the lock drops so a sink
        calling back into the ledger cannot deadlock.
        ``allow_trip=False`` (the clock-driven callers) restricts the
        machine to recovery — a burn never STARTS on window expiry."""
        burning: List[str] = []
        emissions: List[Tuple[str, str, str]] = []
        gauges: List[Tuple[float, str, str]] = []
        with self._lock:
            for objective, budget in self.objectives():
                fast = self.burn_rate(objective,
                                      self.config.fast_window_s,
                                      budget, now)
                slow = self.burn_rate(objective,
                                      self.config.slow_window_s,
                                      budget, now)
                gauges.append((round(fast, 4), objective, "fast"))
                gauges.append((round(slow, 4), objective, "slow"))
                was = self._burning.get(objective, False)
                thr = self.config.burn_threshold
                if not was and allow_trip and fast >= thr and slow >= thr:
                    self._burning[objective] = True
                    self.burns[objective] = (
                        self.burns.get(objective, 0) + 1)
                    emissions.append((
                        "SchedulerSLOBurn", objective,
                        f"SLO {objective} burning: fast-window burn "
                        f"rate {fast:.1f}, slow {slow:.1f} "
                        f"(threshold {thr:g})"))
                elif was and fast < thr:
                    self._burning[objective] = False
                    emissions.append((
                        "SchedulerSLORecovered", objective,
                        f"SLO {objective} recovered: fast-window "
                        f"burn rate {fast:.1f} < {thr:g}"))
                if self._burning.get(objective, False):
                    burning.append(objective)
        g = getattr(self.metrics, "slo_burn_rate", None)
        if g is not None:  # duck-typed: metrics fakes stay valid
            for val, objective, window in gauges:
                g.set(val, objective=objective, window=window)
        for reason, objective, message in emissions:
            self._emit(reason, objective, message)
        return ",".join(burning)

    def _emit(self, reason: str, objective: str, message: str) -> None:
        if self.event_sink is None:
            return
        from kubernetes_tpu_torch.events import ObjectRef

        ref = ObjectRef(name=f"slo-{objective}",
                        involved_kind="Scheduler")
        try:
            self.event_sink(reason, ref, message)
        except Exception:
            pass  # a broken sink must never take the cycle down

    def burning(self) -> bool:
        with self._lock:
            return any(self._burning.values())

    def burns_total(self) -> int:
        with self._lock:
            return sum(self.burns.values())

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "objectives": [o for o, _ in self.objectives()],
                "burning": sorted(o for o, b in self._burning.items()
                                  if b),
                "burns": dict(self.burns),
                "cost_baseline_s": {
                    k: round(v, 6)
                    for k, v in sorted(self._baseline.items())},
            }


class PerfLedger:
    """The facade: measured distributions + cost model + watchdog, one
    ``observe_cycle`` call from ``Observability.end_cycle`` per eventful
    cycle (zero device syncs), one thread-safe ``snapshot`` for
    ``/debug/ledger``."""

    def __init__(self, config=None, metrics=None,
                 clock: Callable[[], float] = time.monotonic,
                 lock_factory=None) -> None:
        if config is None:
            from kubernetes_tpu_torch.config import LedgerConfig

            config = LedgerConfig()
        self.config = config
        self.metrics = metrics
        self.clock = clock
        self.model = CycleCostModel(lock_factory=lock_factory)
        self.watchdog = SLOWatchdog(config, clock=clock, metrics=metrics,
                                    lock_factory=lock_factory)
        self._lock = make_lock(lock_factory, "obs.ledger")
        self.entries: deque = deque(maxlen=max(1, int(config.history)))
        #: (phase, scope, mesh) -> RollingDist
        self._dists: Dict[Tuple[str, str, int], RollingDist] = {}
        #: phase labels ever exported on the attribution gauge — the
        #: explain-gauge freshness rule: phases that stop firing zero
        self._phases_seen: set = set()
        #: lifetime observed cycles (eviction observable like the
        #: flight recorder's recorded - len)
        self.observed = 0
        #: clock stamp of the last pressure-probe re-evaluation:
        #: request threads only need burn RECOVERY to land within
        #: ~a second, not a full state-machine pass per mutating call
        self._last_probe_eval = float("-inf")

    @property
    def enabled(self) -> bool:
        return bool(getattr(self.config, "enabled", True))

    @property
    def event_sink(self):
        return self.watchdog.event_sink

    @event_sink.setter
    def event_sink(self, sink) -> None:
        self.watchdog.event_sink = sink

    def pressure_engaged(self) -> bool:
        """True while a sustained burn should inflate
        ``Scheduler.backend_pressure`` (APF sheds earlier). While
        burning, the windows re-evaluate HERE too: observe_cycle only
        runs on eventful cycles, so a queue that drains after a burn
        would otherwise freeze the degraded state (and the recovery
        event) until the next eventful cycle — possibly never."""
        if not (self.enabled
                and bool(getattr(self.config, "engage_pressure", True))):
            return False
        if not self.watchdog.objectives():
            # lock-free config read: with both objectives off (the
            # shipped default) the watchdog can never burn — keep the
            # per-mutating-request probe contention-free
            return False
        if self.watchdog.burning():
            # throttled: the probe rides the request path on every
            # mutating call while degraded — bounded-staleness (1 s)
            # recovery beats an evaluate per request (races on the
            # stamp are benign: worst case one extra evaluate)
            now = self.clock()
            if now - self._last_probe_eval >= PRESSURE_EVAL_INTERVAL_S:
                self._last_probe_eval = now
                self.watchdog.evaluate(now, allow_trip=False)
        return self.watchdog.burning()

    def tick(self) -> None:
        """Idle-path evaluation (Scheduler.idle_tick): keep the
        burn-rate windows — and the recovery transition — live while no
        eventful cycle arrives to run observe_cycle. Recovery only
        (``allow_trip=False``): idle window drainage must never START
        a burn on stale samples."""
        if self.enabled and self.watchdog.objectives():
            self.watchdog.evaluate(self.clock(), allow_trip=False)

    # -- per-cycle accounting ----------------------------------------------

    def observe_cycle(self, rec, res=None,
                      spans=None) -> Optional[LedgerEntry]:
        """Fold one finished cycle in; returns the LedgerEntry (None
        when disabled). ``rec`` is the CycleRecord ``end_cycle`` just
        built; ``res`` the CycleResult (e2e latency source); ``spans``
        the trace's CHILD-EXCLUSIVE durations (Trace.self_durations) so
        phases are disjoint — a nested validate must not count under
        both 'solve' and 'validate'. Falls back to the record's
        inclusive spans for callers without a trace (replays, tests)."""
        if not self.enabled:
            return None
        if spans is None:
            spans = rec.spans
        phases: Dict[str, float] = {}
        for name, dur in (spans or {}).items():
            ph = phase_of(name)
            if ph:
                phases[ph] = phases.get(ph, 0.0) + float(dur)
        P, N = parse_batch_shape(rec.batch_shape)
        scope = rec.solve_scope or ("full" if rec.tier else "")
        solve_s = phases.get("solve", 0.0) + phases.get("dispatch", 0.0)
        rounds = max(int(getattr(res, "rounds", 0) or 0), 1)
        modeled, basis, eff = -1.0, "", -1.0
        if solve_s > 0 and P > 0:
            # offer this cycle as the rate anchor FIRST (best rate
            # wins): without a warmup anchor the first cycles
            # self-calibrate, and a faster-than-ever cycle re-bases the
            # speed-of-light reference before being judged against it
            self_anchored = self.model.record_anchor(
                scope, P, N, rec.mesh, solve_s, rounds=rounds)
            pred, basis = self.model.predict(P, N, rec.mesh, scope,
                                             rounds=rounds)
            if pred is None:
                pred, basis = solve_s, "anchor"
            elif self_anchored:
                # THIS cycle is the reference it was judged against —
                # efficiency 1.0 by construction, labeled so operators
                # can tell a degenerate self-comparison from a real
                # calibrated prediction
                basis = "anchor"
            modeled = float(pred)
            # clipped: a pathological model must not mint absurd gauges
            eff = min(max(modeled / solve_s, 0.0), 8.0)
        e2e = list(res.e2e_latency_s.values()) if (
            res is not None and getattr(res, "e2e_latency_s", None)) else []
        slo = self.watchdog.observe_cycle(rec.t, e2e, solve_s, scope)
        entry = LedgerEntry(
            cycle=rec.cycle, t=rec.t, batch_shape=rec.batch_shape,
            scope=scope, mesh=rec.mesh, phases=phases,
            measured_s=rec.elapsed_s, solve_s=solve_s, modeled_s=modeled,
            efficiency=eff, model_basis=basis, slo=slo,
        )
        with self._lock:
            self.entries.append(entry)
            self.observed += 1
            for ph, dur in phases.items():
                cell = self._dists.get((ph, scope, rec.mesh))
                if cell is None:
                    cell = self._dists[(ph, scope, rec.mesh)] = RollingDist(
                        window=self.config.dist_window,
                        alpha=self.config.baseline_decay)
                cell.observe(dur)
        self._publish(entry, phases)
        return entry

    def _publish(self, entry: LedgerEntry, phases: Dict[str, float]) -> None:
        m = self.metrics
        if m is None:
            return
        # duck-typed like every metrics attach: partial fakes stay
        # valid. Freshness: a solve-free cycle writes the -1 sentinel
        # instead of leaving a stale older cycle's verdict on the wire
        # (the same rule the phase gauge follows below).
        g_eff = getattr(m, "cycle_model_efficiency", None)
        if g_eff is not None:
            g_eff.set(round(entry.efficiency, 4)
                      if entry.efficiency >= 0 else -1.0)
        g_mod = getattr(m, "cycle_modeled_cost", None)
        if g_mod is not None:
            g_mod.set(round(entry.modeled_s, 6)
                      if entry.modeled_s >= 0 else -1.0)
        g_ph = getattr(m, "cycle_phase_seconds", None)
        if g_ph is not None:
            for ph, dur in phases.items():
                g_ph.set(round(dur, 6), phase=ph)
            # freshness: a phase the cycle did not run reads 0, not the
            # last cycle that happened to run it (explain-gauge rule)
            for ph in self._phases_seen - set(phases):
                g_ph.set(0.0, phase=ph)
            self._phases_seen |= set(phases)

    # -- export -------------------------------------------------------------

    def snapshot(self) -> dict:
        """The /debug/ledger body (thread-safe, like /debug/why)."""
        with self._lock:
            entries = list(self.entries)
            dists = {
                f"{ph}|{scope or '-'}|mesh{mesh}": d.to_json()
                for (ph, scope, mesh), d in sorted(self._dists.items())}
            observed = self.observed
        effs = [e.efficiency for e in entries if e.efficiency >= 0]
        return {
            "observed": observed,
            "retained": len(entries),
            "model": self.model.snapshot(),
            "slo": self.watchdog.snapshot(),
            "model_efficiency": _dist_summary(effs),
            "distributions": dists,
            "entries": [e.to_json() for e in entries],
        }

    def arm_summary(self) -> dict:
        """The bench-record shape (scripts/bench_churn.py per-arm
        ``ledger`` block; scripts/bench_compare.py's ``ledger`` gate
        family reads exactly this): measured-vs-modeled efficiency,
        burn counts, and per-phase attribution shares."""
        with self._lock:
            entries = list(self.entries)
        effs = [e.efficiency for e in entries if e.efficiency >= 0]
        total = sum(e.measured_s for e in entries)
        phases: Dict[str, float] = {}
        for e in entries:
            for ph, dur in e.phases.items():
                phases[ph] = phases.get(ph, 0.0) + dur
        return {
            "cycles": len(entries),
            "model_efficiency": _dist_summary(effs),
            "phase_share": {
                ph: round(v / total, 4) if total > 0 else 0.0
                for ph, v in sorted(phases.items())},
            "slo": {"burns": self.watchdog.burns_total(),
                    "burning": self.watchdog.burning()},
        }


def _dist_summary(vals: List[float]) -> dict:
    if not vals:
        return {"n": 0}
    s = sorted(vals)
    return {"n": len(s), "mean": round(sum(s) / len(s), 4),
            "p50": round(_quantile(s, 0.5), 4),
            "p99": round(_quantile(s, 0.99), 4),
            "min": round(s[0], 4)}
