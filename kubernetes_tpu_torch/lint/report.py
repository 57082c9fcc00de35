"""graftlint output + baseline handling.

The baseline file grandfathers findings the team has decided not to fix
yet: a committed JSON map of line-number-free fingerprints (rule + file
+ normalized snippet + occurrence index), so edits elsewhere in a file
never invalidate it. New findings — anything not in the baseline — fail
the run; fixed findings simply age out the next time the baseline is
rewritten (``--write-baseline``).
"""

from __future__ import annotations

import json
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

from kubernetes_tpu_torch.lint.engine import Finding

BASELINE_VERSION = 1


def render_text(findings: Sequence[Finding], baselined: int = 0) -> str:
    out: List[str] = []
    for f in findings:
        out.append(f"{f.path}:{f.line}:{f.col + 1}: {f.rule} {f.message}")
        if f.snippet:
            out.append(f"    {f.snippet}")
    counts = Counter(f.rule for f in findings)
    if findings:
        per_rule = ", ".join(f"{r}={n}" for r, n in sorted(counts.items()))
        out.append("")
        out.append(f"graftlint: {len(findings)} finding(s) ({per_rule})"
                   + (f", {baselined} baselined" if baselined else ""))
    else:
        out.append("graftlint: clean"
                   + (f" ({baselined} baselined)" if baselined else ""))
    return "\n".join(out)


def render_json(findings: Sequence[Finding], baselined: int = 0) -> str:
    payload = {
        "version": BASELINE_VERSION,
        "findings": [f.as_dict() for f in findings],
        "counts": dict(sorted(Counter(f.rule for f in findings).items())),
        "baselined": baselined,
    }
    return json.dumps(payload, indent=2, sort_keys=True) + "\n"


def write_baseline(findings: Sequence[Finding], path: str) -> None:
    entries: Dict[str, Dict[str, object]] = {}
    for f in findings:
        entries[f.fingerprint()] = {
            "rule": f.rule,
            "path": f.path,
            "snippet": " ".join(f.snippet.split()),
            "occurrence": f.occurrence,
        }
    payload = {"version": BASELINE_VERSION, "findings": entries}
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(payload, fh, indent=2, sort_keys=True)
        fh.write("\n")


def load_baseline(path: str) -> Dict[str, Dict[str, object]]:
    with open(path, "r", encoding="utf-8") as fh:
        payload = json.load(fh)
    if payload.get("version") != BASELINE_VERSION:
        raise ValueError(
            f"baseline {path} has version {payload.get('version')!r}, "
            f"expected {BASELINE_VERSION}"
        )
    findings = payload.get("findings", {})
    if not isinstance(findings, dict):
        raise ValueError(f"baseline {path}: 'findings' must be a mapping")
    return findings


def subtract_baseline(
    findings: Sequence[Finding], baseline: Dict[str, Dict[str, object]]
) -> Tuple[List[Finding], int]:
    """Split findings into (new, n_baselined) by fingerprint.

    Fingerprints are line-free, so identical snippets in one file are
    told apart only by occurrence index — when a fresh copy of an
    already-baselined snippet appears, WHICH copy gets blamed is
    positional, not causal. Such findings carry an explicit warning so
    nobody "fixes" a pre-existing site and leaves the new one
    grandfathered."""
    fresh: List[Finding] = []
    matched = 0
    sibling_keys = Counter(
        (e.get("rule"), e.get("path"), e.get("snippet"))
        for e in baseline.values() if isinstance(e, dict)
    )
    for f in findings:
        if f.fingerprint() in baseline:
            matched += 1
            continue
        n = sibling_keys.get((f.rule, f.path, " ".join(f.snippet.split())), 0)
        if n:
            f = Finding(
                f.path, f.line, f.col, f.rule,
                f.message + f" [{n} identical baselined occurrence(s) in "
                "this file — the NEW copy may be at a different line than "
                "the one reported here]",
                f.snippet, occurrence=f.occurrence,
            )
        fresh.append(f)
    return fresh, matched


def per_rule_counts(findings: Iterable[Finding]) -> Dict[str, int]:
    return dict(sorted(Counter(f.rule for f in findings).items()))
