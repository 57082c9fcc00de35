"""graftlint CLI for the port — ``python -m kubernetes_tpu_torch.lint
[paths...]``.

With no paths it lints the port: ``kubernetes_tpu_torch/``,
``chip_smoke.py`` and ``scripts/torch_*.py``. Exit codes: 0 clean (after
suppressions + baseline), 1 findings, 2 usage error (a missing path, an
unknown ``--select`` id). The CPU suite runs the same gate
(``tests/test_torch_lint_gate.py``) against the committed
``.graftlint-torch-baseline.json``.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import List, Optional

from kubernetes_tpu_torch.lint.engine import RULE_IDS, run_lint
from kubernetes_tpu_torch.lint.report import (
    load_baseline,
    render_json,
    render_text,
    subtract_baseline,
    write_baseline,
)

#: what the port's gate lints (globs, relative to --root)
DEFAULT_PATHS = ("kubernetes_tpu_torch/", "chip_smoke.py",
                 "scripts/torch_*.py")
DEFAULT_BASELINE = ".graftlint-torch-baseline.json"


def default_paths(root: str) -> List[str]:
    """The existing files and directories :data:`DEFAULT_PATHS` names
    under ``root``."""
    out: List[str] = []
    for pattern in DEFAULT_PATHS:
        out.extend(sorted(glob.glob(os.path.join(root, pattern))))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m kubernetes_tpu_torch.lint",
        description="AST-based capture-safety / determinism / host-sync / "
                    "concurrency linter for the PyTorch port "
                    "(rules R0-R10; see the package docstring).",
    )
    parser.add_argument("paths", nargs="*", default=None,
                        help=f"files/dirs to lint (default: {' '.join(DEFAULT_PATHS)})")
    parser.add_argument("--format", choices=("text", "json"), default="text")
    parser.add_argument("--select", default=None, metavar="R1,R2",
                        help="comma-separated rule ids to run (default: all)")
    parser.add_argument("--baseline", default=None, metavar="FILE",
                        help="baseline JSON of grandfathered findings "
                             f"(default: {DEFAULT_BASELINE} if present)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore any baseline file")
    parser.add_argument("--write-baseline", action="store_true",
                        help="rewrite the baseline from current findings "
                             "and exit 0")
    parser.add_argument("--root", default=None,
                        help="path findings are reported relative to "
                             "(default: cwd)")
    args = parser.parse_args(argv)

    root = os.path.abspath(args.root or os.getcwd())
    if args.paths:
        # an explicitly named path that doesn't exist is a usage error,
        # not a clean run — a typo'd path in CI must fail the gate loudly
        missing = [p for p in args.paths if not os.path.exists(p)]
        if missing:
            print(f"graftlint: path(s) do not exist: {' '.join(missing)}",
                  file=sys.stderr)
            return 2
        paths = args.paths
    else:
        paths = default_paths(root)
    if not paths:
        print("graftlint: no existing paths to lint", file=sys.stderr)
        return 2

    select = None
    if args.select:
        select = [s.strip().upper() for s in args.select.split(",") if s.strip()]
        bad = [s for s in select if s not in RULE_IDS]
        if bad:
            print(f"graftlint: unknown rule id(s) {bad}; known: "
                  f"{', '.join(RULE_IDS)}", file=sys.stderr)
            return 2

    findings = run_lint(paths, root=root, select=select)

    baseline_path = args.baseline or os.path.join(root, DEFAULT_BASELINE)
    if args.write_baseline:
        write_baseline(findings, baseline_path)
        print(f"graftlint: wrote {len(findings)} finding(s) to "
              f"{baseline_path}")
        return 0

    baselined = 0
    if not args.no_baseline and os.path.exists(baseline_path):
        try:
            baseline = load_baseline(baseline_path)
        except ValueError as e:
            print(f"graftlint: {e}", file=sys.stderr)
            return 2
        findings, baselined = subtract_baseline(findings, baseline)

    if args.format == "json":
        sys.stdout.write(render_json(findings, baselined))
    else:
        print(render_text(findings, baselined))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
