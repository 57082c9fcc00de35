"""kubernetes_tpu_torch — the batched scheduler on PyTorch and CUDA.

The same scheduling framework as ``kubernetes_tpu`` (columnar snapshot,
fused (pods x nodes) filter and score, whole-queue assignment rounds),
written against PyTorch tensors instead of JAX arrays, with the four
Pallas TPU kernels replaced by hand-written CUDA C++ for Hopper
(``csrc/``, built at first use by :mod:`kubernetes_tpu_torch.kernels`).
The host modules (API types, snapshot packer, queue, framework) are
copies, so the two packages share no import.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); asking for ``cuda`` without a card raises.
"""

import torch

# The set-membership predicates are f32 multihot matmuls whose counts
# must stay exact, and _idiv floors f32 quotients: TF32 (about three
# decimal digits) would break both. Pin full f32 everywhere.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"


def version_info() -> dict:
    """pkg/version analog (version/base.go Get()): the version document
    ``--version`` prints."""
    import platform as _platform

    return {
        "gitVersion": f"v{__version__}",
        "compatibleReference": "kubernetes v1.16 (scheduler capability set)",
        "platform": f"{_platform.system().lower()}/{_platform.machine()}",
        "pythonVersion": _platform.python_version(),
    }


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    asks for the CPU. Raises when CUDA is asked for and no card is
    visible — the port never carries on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "kubernetes_tpu_torch: device 'cuda' requested but "
            "torch.cuda.is_available() is False (pass device='cpu' to "
            "run the plain PyTorch path)")
    return dev
