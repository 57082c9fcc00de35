"""Kernels layer (``kernels.py``, ``csrc/fused_pair.cu``), staged route:
the pair's least time at 3.35 TB/s over the device time of
``fused_pair_staged_kernel`` in the traced cycles. The staged launches
are ``fused_pair_normalize``'s less the wide route's share."""

from schedbench.core.roofline import pair_share


def read(record):
    shapes = dict(record.launch_shapes.get("fused_pair_normalize", {}))
    for s, c in record.launch_shapes.get("fused_pair_normalize_wide",
                                         {}).items():
        shapes[s] = shapes.get(s, 0) - c
    shapes = {s: c for s, c in shapes.items() if c > 0}
    return pair_share(record, "fused_pair_staged_kernel", shapes)
