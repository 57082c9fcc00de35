"""Informer handlers (``Scheduler.on_pod_update`` confirming each bind,
``on_pod_add`` for each new pending pod, and what they reach in
``cache.py``, ``queue.py`` and ``snapshot.py``): the
seconds the window spends in those calls, timed by the benchmark
around them, as a share of the window."""


def read(record):
    if not record.harness_spans:
        return None
    s = sum(b - a for name, a, b, _ in record.harness_spans
            if name.startswith("informer:"))
    return 100.0 * s / record.window_s
