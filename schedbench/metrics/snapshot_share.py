"""Cache and snapshot layer (``cache.py``, ``snapshot.py``): the
cycle's ``snapshot`` span and each pipelined chunk's
``pipeline:pack@k``, as a share of the window."""

from schedbench.core.spans import share


def read(record):
    return share(record, lambda n: n == "snapshot"
                 or n.startswith("pipeline:pack@"))
