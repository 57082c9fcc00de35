"""Scheduler layer (``Scheduler.schedule_cycle``'s own work: the queue
pop, PreFilter, the executor's bookkeeping, the result): the seconds
inside each cycle's trace that none of its named spans covers, as a
share of the window."""


def read(record):
    if not any(c.cycle_span for c in record.cycles):
        return None
    rest = 0.0
    for c in record.cycles:
        if c.cycle_span:
            top = sum(b - a for _, a, b, anc in c.spans if not anc)
            rest += (c.cycle_span[1] - c.cycle_span[0]) - top
    return 100.0 * rest / record.window_s
