"""Scheduler layer (``scheduler.py``: assume, the bind fence, the
binder): the ``bind`` span of a monolithic cycle and each pipelined
chunk's ``pipeline:bind@k``, as a share of the window."""

from schedbench.core.spans import share


def read(record):
    return share(record, lambda n: n == "bind"
                 or n.startswith("pipeline:bind@"))
