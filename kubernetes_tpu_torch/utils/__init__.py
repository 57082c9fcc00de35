from kubernetes_tpu_torch.utils.interner import Interner  # noqa: F401
