from kubernetes_tpu_torch.api import types  # noqa: F401
