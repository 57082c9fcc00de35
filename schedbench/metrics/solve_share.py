"""Solve layer (``ops/assign.py``, ``ops/device_loop.py``, the ladder):
``solve:{tier}``, ``validate`` and each pipelined chunk's
``pipeline:dispatch@k`` and ``pipeline:readback@k``, as a share of the
window (``validate`` inside a readback counted once)."""

from schedbench.core.spans import share


def _solve(n: str) -> bool:
    return (n.startswith(("solve:", "pipeline:dispatch@",
                          "pipeline:readback@")) or n == "validate")


def read(record):
    return share(record, _solve)
