"""Device-to-host synchronisation accounting.

The reference package keeps its round loops on the device
(``jax.lax.while_loop``) and reads back once per cycle. The port runs
those loops in Python, so every loop condition it reads is a
device-to-host sync. All of them go through :func:`to_host`, which counts
them: ``SYNCS.count`` is what a cycle's report subtracts."""

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
    return t.tolist()
