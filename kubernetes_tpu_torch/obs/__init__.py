"""Observability for the batched solve path (the port of
``kubernetes_tpu/obs``). Ported so far:
:mod:`kubernetes_tpu_torch.obs.explain`, the batched schedulability
explainer; :mod:`kubernetes_tpu_torch.obs.trace`, the cycle trace with
nested spans; the tracer seam of the facade,
:mod:`kubernetes_tpu_torch.obs.core`; and the state-conservation auditor,
:mod:`kubernetes_tpu_torch.obs.audit`."""
