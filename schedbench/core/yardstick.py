"""The yardstick: the card's published peaks and each kernel's least
bytes and operations, frozen here so that a change to a kernel cannot
move what it is measured against.

Peaks: NVIDIA's H100 SXM data sheet, dense rates: HBM3 at 3.35 TB/s and
67 TFLOP/s of float32 outside the tensor cores (the kernels below are
float32 elementwise and reduction work).

Bytes count each input read once and each output written once.
"""

from __future__ import annotations

from typing import Dict, Tuple

HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12


def pair_bytes(P: int, N: int) -> int:
    """The fused NodeAffinity + TaintToleration normalize pair on a
    (P, N) plane: two float32 raw planes and the bool mask in, the
    float32 weighted score out."""
    return P * N * (4 + 4 + 1 + 4)


def pair_ops(P: int, N: int) -> int:
    """Two masked row maxima, then per element two of (mul, div, add,
    floor) and the combine."""
    return P * N * 14


def least_seconds(nbytes: float, ops: float) -> float:
    """The least time the card could take: the larger of the bytes at
    the HBM rate and the operations at the float32 peak."""
    return max(nbytes / HBM_BYTES_S, ops / F32_OPS_S)


def pair_least_seconds(shapes: Dict[Tuple[int, ...], int]) -> float:
    """Least seconds of the pair's launches, ``{(P, N): launches}``."""
    return sum(least_seconds(pair_bytes(*s), pair_ops(*s)) * c
               for s, c in shapes.items())
