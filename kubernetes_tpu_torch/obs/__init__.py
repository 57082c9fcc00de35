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
- :mod:`kubernetes_tpu_torch.obs.audit` — the state-conservation auditor.

:class:`kubernetes_tpu_torch.obs.core.Observability` is the facade the
scheduler owns. The perf ledger, the device-memory ledger and the
incident recorder are ROADMAP A.13 slice 2.
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
    "CycleRecord",
    "FlightRecorder",
    "Span",
    "Trace",
    "DEFAULT_THRESHOLD_S",
    "chrome_trace_json",
]
