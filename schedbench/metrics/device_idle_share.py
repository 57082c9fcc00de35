"""Device layer: the share of the traced cycles' wall time in which no
kernel, copy or fill ran on the card (1 minus the union of their
intervals), in percent."""

from schedbench.core.profile import busy_seconds


def read(record):
    if not record.device_events or record.traced_s <= 0:
        return None
    busy = busy_seconds(record.device_events, record.traced_lo_us,
                        record.traced_hi_us)
    return 100.0 * (1.0 - busy / record.traced_s)
