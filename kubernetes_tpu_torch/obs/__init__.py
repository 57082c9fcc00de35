"""Observability for the batched solve path (the port of
``kubernetes_tpu/obs``), all host-side:

- :mod:`kubernetes_tpu_torch.obs.trace` — nested cycle spans, the
  threshold-gated slow-cycle log and the Chrome trace-event exporter.
- :mod:`kubernetes_tpu_torch.obs.jaxtel` — transfer and capture
  telemetry: per-site readback and upload bytes at the declared host
  boundaries, and solve-site signature classes (a new signature is a new
  round-loop graph).
- :mod:`kubernetes_tpu_torch.obs.recorder` — the bounded flight recorder
  of recent cycle records (``/debug/flightrecorder``, ``debugger.dump``).
- :mod:`kubernetes_tpu_torch.obs.journey` — per-pod journeys: each bound
  pod's create-to-bind seconds split into phases (``/debug/journeys``).
- :mod:`kubernetes_tpu_torch.obs.explain` — the batched schedulability
  explainer (``/debug/why``, the record's top reasons, the
  ``scheduler_unschedulable_*`` metrics).
- :mod:`kubernetes_tpu_torch.obs.ledger` — the perf ledger: per-cycle
  phase-cost distributions against the cost model
  (``scheduler_cycle_model_efficiency``) and the multi-window SLO
  burn-rate watchdog (``/debug/ledger``).
- :mod:`kubernetes_tpu_torch.obs.memledger` — the device-memory ledger:
  modeled residents against the allocator's counters, the capacity
  preflight and the OOM forensics (``/debug/memory``).
- :mod:`kubernetes_tpu_torch.obs.incidents` — incident bundles and the
  ``torch.profiler`` capture (``/debug/incidents``, ``/debug/profile``).
- :mod:`kubernetes_tpu_torch.obs.audit` — the state-conservation auditor.

:class:`kubernetes_tpu_torch.obs.core.Observability` is the facade the
scheduler owns.
"""

from kubernetes_tpu_torch.obs.audit import INVARIANTS, StateAuditor, Violation
from kubernetes_tpu_torch.obs.core import Observability
from kubernetes_tpu_torch.obs.explain import (
    ExplainResult,
    PodExplanation,
    UnschedulableReport,
    build_report,
    explain_reduce,
)
from kubernetes_tpu_torch.obs.jaxtel import (
    JaxTelemetry,
    abstract_digest,
    tree_nbytes,
)
from kubernetes_tpu_torch.obs.journey import Journey, JourneyTracker
from kubernetes_tpu_torch.obs.ledger import (
    CycleCostModel,
    LedgerEntry,
    PerfLedger,
    SLOWatchdog,
)
from kubernetes_tpu_torch.obs.recorder import CycleRecord, FlightRecorder
from kubernetes_tpu_torch.obs.trace import (
    DEFAULT_THRESHOLD_S,
    Span,
    Trace,
    chrome_trace_json,
)

__all__ = [
    "INVARIANTS",
    "StateAuditor",
    "Violation",
    "Observability",
    "ExplainResult",
    "PodExplanation",
    "UnschedulableReport",
    "build_report",
    "explain_reduce",
    "JaxTelemetry",
    "abstract_digest",
    "tree_nbytes",
    "Journey",
    "JourneyTracker",
    "CycleCostModel",
    "LedgerEntry",
    "PerfLedger",
    "SLOWatchdog",
    "CycleRecord",
    "FlightRecorder",
    "Span",
    "Trace",
    "DEFAULT_THRESHOLD_S",
    "chrome_trace_json",
]
