"""resource.Quantity parsing/formatting — the apimachinery slice the
framework's seams need (SURVEY §2.2 "apimachinery: ...unstructured,
field/label selectors..."; reference
``staging/src/k8s.io/apimachinery/pkg/api/resource/quantity.go`` —
``ParseQuantity`` and the suffixer tables in ``suffix.go``).

Quantities appear wherever Kubernetes JSON crosses our wire seams:
``resources.requests.cpu: "250m"``, ``memory: "1Gi"``. Internally the
framework is float milli-CPU / float bytes (the columnar tensors), so
this module only converts at the boundary; it is NOT the reference's
infinite-precision decimal — inputs beyond float64 precision are out of
scope for a scheduler (the reference itself caps at 2^63-1).

``parse_cpu`` returns milli-CPU (the scheduler's unit,
``MilliValue`` in the reference); ``parse_memory`` returns bytes.
"""

from __future__ import annotations

import re
from typing import Union

#: binary suffixes (suffix.go binSuffixes): 1024-based
_BINARY = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40,
           "Pi": 2**50, "Ei": 2**60}
#: decimal SI suffixes (decSuffixes): 1000-based; "m" = milli, "" = 1
_DECIMAL = {"n": 1e-9, "u": 1e-6, "m": 1e-3, "": 1.0, "k": 1e3,
            "M": 1e6, "G": 1e9, "T": 1e12, "P": 1e15, "E": 1e18}

_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>\d+(?:\.\d*)?|\.\d+)"
    r"(?:(?P<exp>[eE][+-]?\d+)|(?P<suffix>[KMGTPE]i|[numkMGTPE]?))$"
)


def parse_quantity(s: Union[str, int, float]) -> float:
    """ParseQuantity analog: "250m" → 0.25, "1Gi" → 1073741824,
    "1e3" → 1000.0, bare numbers pass through. Raises ValueError on
    malformed input (quantity.go ErrFormatWrong)."""
    if isinstance(s, (int, float)):
        return float(s)
    m = _QUANTITY_RE.match(s.strip())
    if m is None:
        raise ValueError(
            f"quantities must match the regular expression "
            f"'^([+-]?[0-9.]+)([eEinumkKMGTP]*[-+]?[0-9]*)$': {s!r}"
        )
    val = float(m.group("num"))
    if m.group("exp"):
        val = float(m.group("num") + m.group("exp"))
    else:
        suffix = m.group("suffix") or ""
        if suffix in _BINARY:
            val *= _BINARY[suffix]
        else:
            val *= _DECIMAL[suffix]
    return -val if m.group("sign") == "-" else val


def parse_cpu(s: Union[str, int, float]) -> float:
    """CPU quantity → milli-CPU (Quantity.MilliValue): "250m" → 250,
    "2" → 2000, 1.5 → 1500."""
    return parse_quantity(s) * 1000.0


def parse_memory(s: Union[str, int, float]) -> float:
    """Memory quantity → bytes: "1Gi" → 2**30, "500M" → 5e8."""
    return parse_quantity(s)


def format_cpu(milli: float) -> str:
    """Milli-CPU → canonical string ("250m", "2"). Whole cores render
    bare (CanonicalizeBytes picks the largest exact suffix)."""
    if milli == int(milli) and int(milli) % 1000 == 0:
        return str(int(milli) // 1000)
    if milli == int(milli):
        return f"{int(milli)}m"
    return f"{milli:g}m"


def format_memory(b: float) -> str:
    """Bytes → canonical binary-suffix string when exact ("1Gi"), bare
    integer otherwise."""
    for suffix in ("Ei", "Pi", "Ti", "Gi", "Mi", "Ki"):
        unit = _BINARY[suffix]
        if b >= unit and b == (b // unit) * unit:
            return f"{int(b // unit)}{suffix}"
    return f"{b:g}"
