"""Operation tracing — the ``k8s.io/utils/trace`` analog (the port of
``kubernetes_tpu/utils/trace.py``).

The implementation lives in :mod:`kubernetes_tpu_torch.obs.trace` (nested
spans and the Chrome trace-event exporter); this module stays the stable
import path for the flat utiltrace surface (``Trace(name, clock=...)`` +
``step`` + ``log_if_long``) so callers get the SAME class — two trace
implementations drifting apart would be an observability bug factory.
"""

from kubernetes_tpu_torch.obs.trace import (  # noqa: F401
    DEFAULT_THRESHOLD_S,
    Span,
    Trace,
    logger,
)

__all__ = ["Trace", "Span", "DEFAULT_THRESHOLD_S", "logger"]
