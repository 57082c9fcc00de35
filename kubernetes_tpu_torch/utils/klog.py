"""Leveled logging — the klog analog (vendor/k8s.io/klog; component-base
logs plumbing). The reference guards expensive log paths with verbosity
checks (``klog.V(10)`` around per-node score dumps,
``generic_scheduler.go:831``); this module gives the same shape over the
stdlib ``logging`` backend:

    from kubernetes_tpu_torch.utils.klog import V, set_verbosity, info, warning

    set_verbosity(4)            # --v=4 (cli flag / KTPU_V env)
    if V(10):                   # guard the expensive formatting
        info("scores: %s", big_tensor_dump())

Verbosity conventions follow the reference's usage: 0-2 operator-facing,
3-5 steady-state debugging, 6+ per-object trace, 10 per-(pod,node) dumps.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional

logger = logging.getLogger("kubernetes_tpu_torch")

_verbosity = 0


def set_verbosity(v: int) -> None:
    """--v flag analog (klog.InitFlags); higher = chattier."""
    global _verbosity
    _verbosity = int(v)
    if v > 0 and not logger.handlers and not logging.root.handlers:
        # klog defaults to stderr with no configuration required
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(levelname).1s%(asctime)s.%(msecs)03d %(name)s] %(message)s",
            datefmt="%m%d %H:%M:%S",
        ))
        logger.addHandler(h)
    logger.setLevel(logging.DEBUG if v > 0 else logging.INFO)


def verbosity() -> int:
    return _verbosity


# KTPU_V env activates output immediately (the module docstring and the
# --v help advertise it; a gate that silently drops is worse than none)
if os.environ.get("KTPU_V"):
    set_verbosity(int(os.environ["KTPU_V"]))


class _Verbose:
    """klog.Verbose: truthy gate + logging methods at that level."""

    def __init__(self, enabled: bool) -> None:
        self.enabled = enabled

    def __bool__(self) -> bool:
        return self.enabled

    def info(self, msg: str, *args) -> None:
        if self.enabled:
            logger.debug(msg, *args)


def V(level: int) -> _Verbose:
    """klog.V(n): gate expensive logging on verbosity."""
    return _Verbose(_verbosity >= level)


def info(msg: str, *args) -> None:
    logger.info(msg, *args)


def warning(msg: str, *args) -> None:
    logger.warning(msg, *args)


def error(msg: str, *args) -> None:
    logger.error(msg, *args)
