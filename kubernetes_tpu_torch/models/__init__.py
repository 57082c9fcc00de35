from kubernetes_tpu_torch.models import cluster  # noqa: F401
