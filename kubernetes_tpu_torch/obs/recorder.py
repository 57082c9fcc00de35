"""Flight recorder — a bounded ring buffer of recent scheduling-cycle
records, the black box read AFTER something went wrong (a copy of
``kubernetes_tpu/obs/recorder.py``).

Metrics aggregate away the shape of an incident; the recorder keeps the
last N cycles verbatim: batch shape digest, which ladder tier actually
produced the placements, every fallback/retry/breaker transition taken,
and the cycle's span timings. Dump paths: ``debugger.dump`` (SIGUSR2),
the ``/debug/flightrecorder`` endpoint on server.py, or
:meth:`FlightRecorder.dump` directly in a postmortem shell.

Capacity is hard-bounded (``collections.deque(maxlen=...)``) so an
incident that lasts hours cannot grow memory — the newest record evicts
the oldest. Timestamps ride the owner's injected clock (monotonic by
default): deterministic under fake clocks."""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from kubernetes_tpu_torch.sanitize import make_lock


@dataclass
class CycleRecord:
    """One cycle's black-box row."""

    cycle: int = 0
    t: float = 0.0  # cycle start, owner clock
    batch_shape: str = ""  # e.g. "P8xN2+topo" (padded pods x nodes)
    tier: str = ""  # ladder tier that produced the placements
    fallbacks: int = 0
    retries: int = 0
    deadline_exceeded: bool = False
    #: (target, old_state, new_state) breaker flips observed this cycle
    breaker_transitions: List[Tuple[str, str, str]] = field(
        default_factory=list)
    attempted: int = 0
    scheduled: int = 0
    unschedulable: int = 0
    elapsed_s: float = 0.0
    #: span name -> seconds (Trace.span_durations of the cycle trace)
    spans: Dict[str, float] = field(default_factory=dict)
    #: device telemetry deltas worth keeping per cycle (obs/jaxtel.py)
    retraces: int = 0
    #: d2h bytes this cycle read back across ALL declared sites — the
    #: per-cycle readback budget (docs/perf.md): a healthy steady-state
    #: cycle moves ~KBs (solve-result vector + scalars); a regression to
    #: MB-scale means a full-matrix readback snuck back in
    readback_bytes: int = 0
    sinkhorn_iters: float = -1.0  # -1 = sinkhorn not engaged
    sinkhorn_residual: float = -1.0
    #: top-K unschedulability reasons this cycle — (predicate name,
    #: blocked-pod count) from the explain reduction (obs/explain.py);
    #: empty when nothing failed or the explainer is off
    top_reasons: List[Tuple[str, int]] = field(default_factory=list)
    #: how the cycle's snapshot was produced (full | delta | clean on
    #: the device-resident path, "host" = legacy full pack + upload;
    #: "" = the cycle never reached the snapshot) and how many node
    #: rows were re-packed for it
    snapshot_mode: str = ""
    snapshot_rows: int = 0
    #: which solve the cycle ran ("restricted" = the incremental
    #: candidate-column solve over the cached score plane, "full" =
    #: the cold dense solve; "" = no solve) and what fraction of the
    #: score plane's node columns the cycle REUSED from the cache
    solve_scope: str = ""
    reuse_frac: float = 0.0
    #: sub-batches the pipelined executor ran (0 = monolithic cycle)
    pipeline_chunks: int = 0
    #: what flushed the serving loop's micro-batch window into this
    #: cycle ("bucket-fill" | "max-wait"; "" = not a serving cycle) and
    #: how long the window accumulated before flushing
    flush_trigger: str = ""
    window_s: float = 0.0
    #: recovery provenance: this is the first cycle after a takeover /
    #: cold-start reconciliation (elector epoch when known, else 1)
    takeover: int = 0
    #: resident device snapshot drops + rebuilds this cycle (device
    #: lost / OOM recovery)
    device_resets: int = 0
    #: binds aborted by the lease fence this cycle (deposed leader)
    fenced_binds: int = 0
    #: state-conservation auditor violations stamped onto this cycle
    #: (obs/audit.py; nonzero is a correctness bug, never noise)
    invariant_violations: int = 0
    #: bind RPCs that timed out ambiguously this cycle and went through
    #: the read-your-write resolution protocol
    ambiguous_binds: int = 0
    #: lock-sanitizer findings (order cycles / held-too-long / guard
    #: violations, kubernetes_tpu_torch/sanitize.py) first observed during
    #: this cycle — nonzero marks the cycle eventful: a latent deadlock
    #: hazard is black-box material even if nothing else happened
    lock_findings: int = 0
    #: sharded-backend provenance: node-axis mesh device count the
    #: scheduler ran this cycle under (0 = single-device mode)
    mesh: int = 0
    #: scenario-pack placement-quality scores for this cycle (empty =
    #: scenario mode off / quality gated off)
    scenario: Dict[str, float] = field(default_factory=dict)
    #: perf-ledger verdict (obs/ledger.py): the cost model's predicted
    #: solve seconds for this cycle's shape, modeled/measured efficiency
    #: (-1 = model not populated — no solve, or ledger off), and which
    #: model basis produced the prediction (xla-cost | calibrated |
    #: anchor)
    modeled_s: float = -1.0
    model_efficiency: float = -1.0
    model_basis: str = ""
    #: comma-joined SLO objectives burning as of this cycle ("" = ok) —
    #: SIGUSR2 dumps and /debug/flightrecorder show efficiency + SLO
    #: history without scraping metrics
    slo: str = ""
    #: memory-ledger verdict (obs/memledger.py): modeled resident bytes
    #: at this cycle's boundary, the measured-side sample (-1 = the
    #: boundary fell inside the sample interval — no sample), and the
    #: modeled/measured confrontation (-1 = no verdict, same sentinel
    #: rule as model_efficiency above)
    mem_modeled_bytes: int = -1
    mem_measured_bytes: int = -1
    mem_efficiency: float = -1.0
    #: memory preflight verdict for this cycle's shape ("" = preflight
    #: never ran; ok | split | shed)
    preflight: str = ""
    #: OOM forensic flag (memledger.record_oom ran this cycle — the
    #: ``mem=`` dump flag routes the postmortem to /debug/memory)
    oom_forensic: str = ""

    def to_json(self) -> dict:
        return {
            "cycle": self.cycle,
            "t": round(self.t, 6),
            "batch_shape": self.batch_shape,
            "tier": self.tier,
            "fallbacks": self.fallbacks,
            "retries": self.retries,
            "deadline_exceeded": self.deadline_exceeded,
            "breaker_transitions": [list(x) for x in self.breaker_transitions],
            "attempted": self.attempted,
            "scheduled": self.scheduled,
            "unschedulable": self.unschedulable,
            "elapsed_s": round(self.elapsed_s, 6),
            "spans": {k: round(v, 6) for k, v in self.spans.items()},
            "retraces": self.retraces,
            "readback_bytes": self.readback_bytes,
            **({"sinkhorn_iters": self.sinkhorn_iters,
                "sinkhorn_residual": self.sinkhorn_residual}
               if self.sinkhorn_iters >= 0 else {}),
            **({"top_reasons": [list(x) for x in self.top_reasons]}
               if self.top_reasons else {}),
            **({"snapshot": {"mode": self.snapshot_mode,
                             "rows": self.snapshot_rows}}
               if self.snapshot_mode else {}),
            **({"solve_scope": self.solve_scope,
                "reuse_frac": round(self.reuse_frac, 4)}
               if self.solve_scope else {}),
            **({"pipeline_chunks": self.pipeline_chunks}
               if self.pipeline_chunks else {}),
            **({"microbatch": {"trigger": self.flush_trigger,
                               "window_s": round(self.window_s, 6)}}
               if self.flush_trigger else {}),
            **({"takeover": self.takeover} if self.takeover else {}),
            **({"device_resets": self.device_resets}
               if self.device_resets else {}),
            **({"fenced_binds": self.fenced_binds}
               if self.fenced_binds else {}),
            **({"invariant_violations": self.invariant_violations}
               if self.invariant_violations else {}),
            **({"ambiguous_binds": self.ambiguous_binds}
               if self.ambiguous_binds else {}),
            **({"lock_findings": self.lock_findings}
               if self.lock_findings else {}),
            **({"mesh": self.mesh} if self.mesh else {}),
            **({"scenario": dict(self.scenario)} if self.scenario else {}),
            **({"modeled_s": round(self.modeled_s, 6),
                "model_efficiency": round(self.model_efficiency, 4),
                "model_basis": self.model_basis}
               if self.model_efficiency >= 0 else {}),
            **({"slo": self.slo} if self.slo else {}),
            **({"mem": {"modeled_bytes": self.mem_modeled_bytes,
                        "measured_bytes": self.mem_measured_bytes,
                        "efficiency": round(self.mem_efficiency, 4)}}
               if self.mem_modeled_bytes >= 0 else {}),
            **({"preflight": self.preflight} if self.preflight else {}),
            **({"oom_forensic": self.oom_forensic}
               if self.oom_forensic else {}),
        }


class FlightRecorder:
    """Bounded ring of :class:`CycleRecord`."""

    def __init__(self, capacity: int = 256, lock_factory=None) -> None:
        self.capacity = max(1, int(capacity))
        self._buf: deque = deque(maxlen=self.capacity)
        #: serializes the scheduler thread's appends against snapshot
        #: reads from the /debug handler thread and the SIGUSR2 dump —
        #: iterating a deque mid-append raises RuntimeError
        self._lock = make_lock(lock_factory, "obs.recorder")
        #: lifetime count (so eviction is observable: recorded - len)
        self.recorded = 0

    def record(self, rec: CycleRecord) -> None:
        with self._lock:
            self._buf.append(rec)
            self.recorded += 1

    def records(self) -> List[CycleRecord]:
        with self._lock:
            return list(self._buf)

    def __len__(self) -> int:
        with self._lock:
            return len(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()

    def to_json(self) -> dict:
        with self._lock:
            recs = list(self._buf)
            recorded = self.recorded
        return {
            "capacity": self.capacity,
            "recorded": recorded,
            "evicted": max(0, recorded - len(recs)),
            "records": [r.to_json() for r in recs],
        }

    def dump(self) -> str:
        """Readable postmortem text (the SIGUSR2 / debugger.dump shape)."""
        with self._lock:
            recs = list(self._buf)
            recorded = self.recorded
        lines = [
            f"Flight recorder: {len(recs)}/{self.capacity} records "
            f"({max(0, recorded - len(recs))} evicted)"
        ]
        for r in recs:
            flags = []
            if r.deadline_exceeded:
                flags.append("DEADLINE")
            if r.fallbacks:
                flags.append(f"fallbacks={r.fallbacks}")
            if r.retries:
                flags.append(f"retries={r.retries}")
            for tgt, old, new in r.breaker_transitions:
                flags.append(f"breaker[{tgt}]:{old}->{new}")
            if r.top_reasons:
                flags.append("why=" + ",".join(
                    f"{name}:{n}" for name, n in r.top_reasons))
            if r.readback_bytes:
                flags.append(f"d2h={r.readback_bytes}B")
            if r.snapshot_mode:
                flags.append(f"snap={r.snapshot_mode}:{r.snapshot_rows}")
            if r.solve_scope:
                flags.append(
                    f"scope={r.solve_scope}:{r.reuse_frac:.0%}")
            if r.pipeline_chunks:
                flags.append(f"chunks={r.pipeline_chunks}")
            if r.flush_trigger:
                flags.append(
                    f"win={r.flush_trigger}:{r.window_s*1000:.1f}ms")
            if r.takeover:
                flags.append(f"takeover=epoch{r.takeover}")
            if r.device_resets:
                flags.append(f"device_reset={r.device_resets}")
            if r.fenced_binds:
                flags.append(f"fenced={r.fenced_binds}")
            if r.invariant_violations:
                flags.append(f"invariants={r.invariant_violations}")
            if r.ambiguous_binds:
                flags.append(f"ambig={r.ambiguous_binds}")
            if r.lock_findings:
                flags.append(f"lockfind={r.lock_findings}")
            if r.model_efficiency >= 0:
                flags.append(f"eff={r.model_efficiency:.2f}")
            if r.slo:
                flags.append(f"slo={r.slo}")
            if r.oom_forensic:
                flags.append(f"mem={r.oom_forensic}")
            elif r.mem_modeled_bytes >= 0:
                flags.append(
                    f"mem={r.mem_modeled_bytes}B"
                    + (f"/{r.mem_measured_bytes}B"
                       if r.mem_measured_bytes >= 0 else ""))
            if r.preflight and r.preflight != "ok":
                flags.append(f"preflight={r.preflight}")
            spans = " ".join(
                f"{k}={v*1000:.1f}ms" for k, v in sorted(r.spans.items()))
            lines.append(
                f"  cycle {r.cycle} t={r.t:.3f} {r.batch_shape or '-'} "
                f"tier={r.tier or '-'} "
                f"attempted={r.attempted} scheduled={r.scheduled} "
                f"unsched={r.unschedulable} {r.elapsed_s*1000:.1f}ms"
                + (f" [{' '.join(flags)}]" if flags else "")
            )
            if spans:
                lines.append(f"    {spans}")
        return "\n".join(lines)
