"""Solve layer (``ops/sync.py``): device-to-host reads a cycle
(``CycleResult.host_syncs``), summed over the window's cycles and
divided by their count."""


def read(record):
    if not record.cycles:
        return None
    return sum(c.host_syncs for c in record.cycles) / len(record.cycles)
