"""Device-to-host synchronisation accounting.

The reference package keeps its round loops on the device
(``jax.lax.while_loop``) and reads back once per solve. So does the port
(:mod:`.device_loop`): the reads that remain are the solve's one readback,
the auto-router's round-0 decision, the explain and preemption readbacks
and the tolerance-gated Sinkhorn's exit tests. All of them go through
:func:`to_host`, which counts them: ``SYNCS.count`` is what a cycle's
report subtracts.

:func:`to_host` is the one sanctioned read (with :func:`to_cpu`, the
whole-table copy of the ladder's ``batch-cpu`` tier): it lifts PyTorch's
sync debug mode (``torch.cuda.set_sync_debug_mode``) for its own copy, so
a caller that runs a path under ``"error"`` catches every sync that is NOT
counted here."""

from __future__ import annotations


class SyncCounter:
    """A running count of device-to-host reads made through to_host and
    to_cpu, the bytes to_host read back and the bytes to_cpu moved."""

    def __init__(self) -> None:
        self.count = 0
        self.d2h_bytes = 0
        self.cpu_bytes = 0


SYNCS = SyncCounter()


def to_host(t):
    """Read a tensor back to the host (Python scalars or nested lists),
    counting one sync and its bytes."""
    SYNCS.count += 1
    SYNCS.d2h_bytes += t.numel() * t.element_size()
    if t.device.type != "cuda":
        return t.tolist()
    import torch

    mode = torch.cuda.get_sync_debug_mode()
    if not mode:
        return t.tolist()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return t.tolist()
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _tree_map(fn, x):
    """``x`` with ``fn`` applied to every tensor in it (NamedTuples,
    tuples, lists and None nest)."""
    import torch

    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*[_tree_map(fn, v) for v in x])
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, v) for v in x)
    return x


def to_cpu(tree):
    """Copy every tensor of ``tree`` to CPU tensors, counting one sync
    and the bytes moved (the ``batch-cpu`` tier re-runs a solve on the
    host's copies)."""
    import torch

    def copy(t):
        SYNCS.cpu_bytes += t.numel() * t.element_size()
        return t.detach().to("cpu", copy=True)

    SYNCS.count += 1
    mode = torch.cuda.get_sync_debug_mode() if torch.cuda.is_available() \
        else 0
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    try:
        return _tree_map(copy, tree)
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)

