"""Kernels layer, wide route (rows past the staged limit): the pair's
least time at 3.35 TB/s over the device time of ``fused_pair_kernel``
(launched by ``fused_pair_normalize_wide``) in the traced cycles. Only
the 50,000-node configuration (``configs/cluster-50k.json``) launches
it."""

from schedbench.core.roofline import pair_share


def read(record):
    return pair_share(record, "fused_pair_kernel",
                      record.launch_shapes.get("fused_pair_normalize_wide",
                                               {}))
