"""Device-to-host synchronisation accounting.

The reference package keeps its round loops on the device
(``jax.lax.while_loop``) and reads back once per solve. So does the port
(:mod:`.device_loop`): the reads that remain are the solve's one readback,
the auto-router's round-0 decision, the explain and preemption readbacks
and the tolerance-gated Sinkhorn's exit tests. All of them go through
:func:`to_host`, which counts them: ``SYNCS.count`` is what a cycle's
report subtracts.

:func:`to_host` is the one sanctioned read: it lifts PyTorch's sync debug
mode (``torch.cuda.set_sync_debug_mode``) for its own copy, so a caller
that runs a path under ``"error"`` catches every sync that is NOT counted
here."""

from __future__ import annotations


class SyncCounter:
    """A running count of device-to-host reads made through to_host."""

    def __init__(self) -> None:
        self.count = 0


SYNCS = SyncCounter()


def to_host(t):
    """Read a tensor back to the host (Python scalars or nested lists),
    counting one sync."""
    SYNCS.count += 1
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
