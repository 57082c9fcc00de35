"""Streaming serving mode — the event-driven layer between the queue and
the batched solver (the port of ``kubernetes_tpu/serving``).

Four pieces, each usable standalone:

- :mod:`kubernetes_tpu_torch.serving.doorbell` — a condition-variable
  doorbell the SchedulingQueue and the HTTP handlers ring on activity;
  replaces the fixed-interval sleep in ``cli.run`` with wake-on-event.
- :mod:`kubernetes_tpu_torch.serving.microbatch` — the adaptive
  accumulation window (min/max wait, flush targets snapped to the
  warmup's pod buckets so steady-state churn never captures a
  round-loop graph) and the :class:`ServingLoop` that drives
  ``Scheduler`` cycles from it.
- :mod:`kubernetes_tpu_torch.serving.fairness` — API-priority-and-
  fairness-style load shedding (per-flow-schema concurrency limits,
  bounded FIFO queues, 429 + Retry-After on overload) and the
  bounded-buffer watch fan-out hub (a slow watcher is disconnected with
  410 Gone instead of stalling the publisher).
- :mod:`kubernetes_tpu_torch.serving.compose` — :class:`ServingRuntime`,
  the composed posture on one card: the serving loop with the
  crash/failover protocol, APF shedding wired to the scheduler's real
  backend pressure, and takeover-relisted watch fan-out — one
  constructor shared by ``cli.run`` and ``chip_smoke.py``.
"""

from kubernetes_tpu_torch.serving.compose import ServingRuntime
from kubernetes_tpu_torch.serving.doorbell import Doorbell
from kubernetes_tpu_torch.serving.fairness import (
    FlowController,
    FlowSchema,
    RequestRejected,
    WatcherGone,
    WatchHub,
)
from kubernetes_tpu_torch.serving.microbatch import (
    MicroBatchWindow,
    ServingLoop,
    WindowDecision,
)

__all__ = [
    "Doorbell",
    "FlowController",
    "FlowSchema",
    "MicroBatchWindow",
    "RequestRejected",
    "ServingLoop",
    "ServingRuntime",
    "WatcherGone",
    "WatchHub",
    "WindowDecision",
]
