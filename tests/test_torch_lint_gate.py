"""The port's graftlint gate (``python -m kubernetes_tpu_torch.lint``).

1. The gate: the CLI with no paths lints ``kubernetes_tpu_torch/``,
   ``chip_smoke.py`` and ``scripts/torch_*.py`` against the committed
   ``.graftlint-torch-baseline.json`` (empty: the tree lints clean) and
   exits 0.
2. The CLI contract of the reference linter: exit 0 clean, 1 on findings
   (a seeded fixture for each of R0-R10), 2 on a missing path or an
   unknown ``--select`` id.
3. ``testing.lint_clean`` on ``ops/assign.py``'s round bodies.
4. Parity with the reference linter (``kubernetes_tpu.lint``) on the same
   sources — the plain-Python snippets of the rule tests and the whole
   ``kubernetes_tpu_torch/`` tree: R0, R6 and R9 findings equal as
   (rule, path, line, col); the port's R4 and R10 findings a superset of
   the reference's (the port adds torch's global generator and its device
   syncs). Both linters are deterministic, so there is no tolerance. The
   reference linter also finds nothing on the port's tree.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import pytest

from test_torch_lint_rules import CASES, TORCH_CASES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "kubernetes_tpu_torch")
BASELINE = os.path.join(REPO, ".graftlint-torch-baseline.json")

#: the rules both linters implement the same way (equal) and the ones the
#: port widens for torch (superset)
EQUAL_RULES = ("R0", "R6", "R9")
SUPERSET_RULES = ("R4", "R10")


def _cli(*args, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "kubernetes_tpu_torch.lint", *args],
        capture_output=True, text=True, cwd=cwd, timeout=300,
        env=dict(os.environ, PYTHONPATH=REPO))


def test_gate_default_paths_lint_clean_with_an_empty_baseline():
    from kubernetes_tpu_torch.lint.__main__ import (
        DEFAULT_BASELINE,
        default_paths,
    )

    with open(BASELINE, encoding="utf-8") as fh:
        assert json.load(fh) == {"findings": {}, "version": 1}
    assert DEFAULT_BASELINE == os.path.basename(BASELINE)
    paths = {os.path.relpath(p, REPO) for p in default_paths(REPO)}
    assert {"kubernetes_tpu_torch", "chip_smoke.py",
            "scripts/torch_kernel_sweep.py"} <= paths
    assert not any(p.startswith("kubernetes_tpu" + os.sep) or
                   p == "kubernetes_tpu" for p in paths)
    out = _cli("--format", "json")
    assert out.returncode == 0, out.stdout + out.stderr
    payload = json.loads(out.stdout)
    assert payload["findings"] == [] and payload["baselined"] == 0


def test_cli_json_exit_codes(tmp_path):
    """The reference CLI's contract: exit 0 + empty findings on a clean
    file, exit 1 + populated JSON on a dirty one, exit 2 on a missing
    path."""
    clean = tmp_path / "clean.py"
    clean.write_text("import time\n\nSTAMP = time.monotonic\n")
    dirty = tmp_path / "dirty.py"
    dirty.write_text("import time\n\ndef f():\n    return time.time()\n")

    def run(target):
        return _cli(str(target), "--format", "json", "--no-baseline",
                    "--root", str(tmp_path))

    ok = run(clean)
    assert ok.returncode == 0, ok.stderr
    assert json.loads(ok.stdout)["findings"] == []

    bad = run(dirty)
    assert bad.returncode == 1, bad.stderr
    payload = json.loads(bad.stdout)
    assert payload["counts"].get("R4") == 1
    f = payload["findings"][0]
    assert f["rule"] == "R4" and f["path"] == "dirty.py" and f["line"] == 4

    typo = run(tmp_path / "no_such_dir")
    assert typo.returncode == 2, (typo.stdout, typo.stderr)
    assert "do not exist" in typo.stderr


def test_cli_unknown_select_rule_is_usage_error(tmp_path):
    from kubernetes_tpu_torch.lint.engine import RULE_IDS

    target = tmp_path / "ok.py"
    target.write_text("X = 1\n")
    bad = _cli(str(target), "--select", "R9,R99", "--no-baseline",
               "--root", str(tmp_path))
    assert bad.returncode == 2, (bad.stdout, bad.stderr)
    assert "unknown rule id" in bad.stderr and "R99" in bad.stderr
    for rule in RULE_IDS:
        assert rule in bad.stderr


def test_cli_baseline_grandfathers_and_write_baseline(tmp_path):
    from kubernetes_tpu_torch.lint.__main__ import main

    dirty = tmp_path / "dirty.py"
    dirty.write_text("import time\n\ndef f():\n    return time.time()\n")
    bl = tmp_path / "bl.json"
    args = [str(dirty), "--root", str(tmp_path), "--baseline", str(bl)]
    assert main(args) == 1
    assert main(args + ["--write-baseline"]) == 0
    assert main(args) == 0
    assert main(args + ["--no-baseline"]) == 1


#: one seeded fixture per rule: (rule, file name under the tmp root, source)
SEEDED = [
    ("R0", "a.py", "X = 1  # graftlint: disable=R4\n"),
    ("R1", "a.py", textwrap.dedent("""\
        from kubernetes_tpu_torch.ops import device_loop

        def f(x, s, first, tag):
            if x > 0:
                s = s + 1
            return s, s.any(), None

        def g(x, s, v):
            return device_loop.run(f, x, s, v, 4, statics=("f",))
        """)),
    ("R2", "a.py", "import numpy as np\n\ndef greedy_assign(x):\n"
                   "    return np.asarray(x)\n"),
    ("R3", "a.py", "import torch\n\ndef f(g):\n    return torch.compile(g)\n"),
    ("R4", "a.py", "import random\n\nX = random.random()\n"),
    ("R5", "kubernetes_tpu_torch/ops/k.py",
     "import torch\n\nX = torch.zeros(4, dtype=torch.float64)\n"),
    ("R6", "a.py", "def f(:\n    pass\n"),
    ("R7", "a.py", "import torch\n\ndef f(t):\n    return t.tolist()\n"),
    ("R8", "kubernetes_tpu_torch/k.py",
     "import torch\nfrom kubernetes_tpu_torch.parallel import mesh\n\n"
     "def f(t, m):\n    return t.to(m.devices[1])\n"),
    ("R9", "a.py", textwrap.dedent("""\
        import threading

        class Q:
            def __init__(self):
                self._lock = threading.Lock()
                self.pending = []  # guarded-by: _lock

            def add(self, x):
                with self._lock:
                    self.pending.append(x)

            def peek(self):
                return self.pending[0]
        """)),
    ("R10", "a.py", textwrap.dedent("""\
        import threading
        import torch

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            def f(self):
                with self._lock:
                    torch.cuda.synchronize()
        """)),
]


@pytest.mark.parametrize("rule,name,src", SEEDED, ids=[s[0] for s in SEEDED])
def test_cli_exits_1_on_a_seeded_fixture_of_each_rule(rule, name, src,
                                                     tmp_path, capsys):
    from kubernetes_tpu_torch.lint.__main__ import main

    path = tmp_path / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    rc = main([str(path), "--select", rule, "--no-baseline", "--format",
               "json", "--root", str(tmp_path)])
    payload = json.loads(capsys.readouterr().out)
    assert rc == 1, payload
    assert payload["counts"] == {rule: len(payload["findings"])}
    assert payload["findings"] and all(
        f["path"] == name for f in payload["findings"])


def test_cli_rule_ids_cover_r0_to_r10():
    from kubernetes_tpu_torch.lint.engine import RULE_IDS

    assert RULE_IDS == tuple(f"R{i}" for i in range(11))
    assert [s[0] for s in SEEDED] == list(RULE_IDS)


# --------------------------------------------------------------------------
# lint_clean on the round bodies
# --------------------------------------------------------------------------

def test_lint_clean_on_the_round_bodies():
    import inspect

    import kubernetes_tpu_torch.ops.assign as assign
    from kubernetes_tpu_torch.testing import lint_clean

    for fn in (assign._lean_round, assign._general_round,
               assign._solo_round):
        lint_clean(fn)
    # the real roots: every device_loop.run body of the module
    lint_clean(assign, rules=("R1", "R2", "R3", "R5"), capture_all=False)
    # a host read slipped into a round body is caught; the same read
    # under `if first:` (round 0 runs eagerly) is not
    src = textwrap.dedent(inspect.getsource(assign._lean_round))
    bad = src.replace("    active = (assigned == -1) & pods.valid\n",
                      "    active = (assigned == -1) & pods.valid\n"
                      "    n_left = int(active.sum())\n", 1)
    assert bad != src
    with pytest.raises(AssertionError) as e:
        lint_clean(bad)
    assert "R1" in str(e.value) and "int()" in str(e.value)
    first = src.replace("    active = (assigned == -1) & pods.valid\n",
                        "    active = (assigned == -1) & pods.valid\n"
                        "    if first:\n"
                        "        n_left = int(active.sum())\n", 1)
    lint_clean(first)


def test_the_round_bodies_are_the_capture_roots():
    from kubernetes_tpu_torch.lint.engine import Project

    project = Project.from_paths([os.path.join(PORT, "ops", "assign.py")],
                                 REPO)
    roots = sorted(r.name for r in project.capture_roots())
    assert roots == ["_batch_impl_sharded.body", "_general_round",
                     "_lean_round", "_solo_round"]
    general = project.files[0].functions["_general_round"]
    assert general.first_params == {"first"}
    assert {"first", "use_plan", "route_plan", "sk_tol"} <= \
        general.static_params


# --------------------------------------------------------------------------
# parity with the reference linter
# --------------------------------------------------------------------------

def _key(f):
    return (f.rule, f.path, f.line, f.col)


def _compare(port, ref, where):
    for rule in EQUAL_RULES:
        p = sorted(_key(f) for f in port if f.rule == rule)
        r = sorted(_key(f) for f in ref if f.rule == rule)
        assert p == r, (where, rule, p, r)
    for rule in SUPERSET_RULES:
        p = {_key(f) for f in port if f.rule == rule}
        r = {_key(f) for f in ref if f.rule == rule}
        assert r <= p, (where, rule, sorted(r - p))


#: the plain-Python snippets of the rule tests, and the port's own R10
#: device-sync fixtures (where the reference sees a subset)
_PLAIN = [c for c in CASES
          if "torch" not in c[1] and "jax" not in c[1]] + [
    c for c in TORCH_CASES if c[0].startswith(("r10_", "r4_"))]


@pytest.mark.parametrize("case", _PLAIN, ids=[c[0] for c in _PLAIN])
def test_parity_on_the_plain_python_corpus(case):
    from kubernetes_tpu.lint import lint_source as ref_lint
    from kubernetes_tpu_torch.lint import lint_source as port_lint

    name, src, kw = case
    src = textwrap.dedent(src)
    filename = kw.get("filename", "<snippet>")
    rules = EQUAL_RULES + SUPERSET_RULES
    for respect in (True, False):
        port = port_lint(src, filename=filename, select=rules,
                         respect_suppressions=respect)
        ref = ref_lint(src, filename=filename, select=rules,
                       respect_suppressions=respect)
        _compare(port, ref, (name, respect))


def test_corpus_covers_every_shared_rule():
    rules = {r for _n, src, _kw in _PLAIN
             for r in ("R0", "R4", "R6", "R9", "R10")
             if f"#> {r}" in src or f" {r}\n" in src}
    assert {"R4", "R6", "R9", "R10"} <= rules


def test_parity_on_the_port_tree_and_the_reference_finds_nothing():
    from kubernetes_tpu.lint.engine import Project as RefProject
    from kubernetes_tpu.lint.engine import lint_project as ref_project
    from kubernetes_tpu_torch.lint.engine import Project, lint_project

    rules = EQUAL_RULES + SUPERSET_RULES
    port_p = Project.from_paths([PORT], REPO)
    ref_p = RefProject.from_paths([PORT], REPO)
    port = lint_project(port_p, select=rules, respect_suppressions=False)
    ref = ref_project(ref_p, select=rules, respect_suppressions=False)
    _compare(port, ref, "kubernetes_tpu_torch/")
    # the reference linter (its baseline ignored) finds nothing on the
    # port: the two findings it raised on the parent carry the
    # reference's own suppressions now
    assert ref_project(ref_p) == []


def test_r3_reads_route_plan_as_first_only_and_catches_an_escape():
    """``_general_statics`` leaves ``route_plan`` out of the graph key:
    the round reads it only under ``if first:`` (it reaches the graph
    through round 0's tag, which is in the key), so R3 stays quiet. The
    same keyword read in a later round would replay a stale graph."""
    from kubernetes_tpu_torch.lint import lint_source

    path = os.path.join(PORT, "ops", "assign.py")
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    rel = "kubernetes_tpu_torch/ops/assign.py"
    assert lint_source(src, filename=rel, select=["R3"]) == []
    anchor = ("    cur = nodes_with_usage(nodes, u)\n"
              "    active = (assigned == -1) & pods.valid\n"
              "    mask = (yield from run_predicates_g(\n")
    assert src.count(anchor) == 1
    escaped = src.replace(anchor, "    _late = route_plan\n" + anchor)
    findings = lint_source(escaped, filename=rel, select=["R3"])
    assert [f.rule for f in findings] == ["R3"]
    assert "`route_plan`" in findings[0].message
    assert "functools.partial(_solo_round, _general_round" in \
        findings[0].snippet
