"""No run loads JAX or the JAX package; the reference loads nothing of
the program; without a card the command prints no result."""

import os
import subprocess
import sys

from schedbench.core.harness import forbidden_modules
from tiny import ROOT_DIR

RUN_TINY = """
import sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from schedbench.core.harness import forbidden_modules, run_cell
from tiny import tiny
out = run_cell(tiny('sched-perf-5k.affinity'), 9, 0.2, False, device='cpu')
assert out.result['correct'], out.checks
print(sorted(m for m in sys.modules if m.split('.')[0] in
             ('jax', 'jaxlib', 'flax', 'kubernetes_tpu')))
print('kubernetes_tpu_torch' in sys.modules)
"""


def _python(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT_DIR, env=env, timeout=600)


def test_a_run_loads_no_jax():
    tests = os.path.dirname(os.path.abspath(__file__))
    p = _python(RUN_TINY.format(root=ROOT_DIR, tests=tests))
    assert p.returncode == 0, p.stderr[-2000:]
    last = p.stdout.strip().splitlines()
    assert last[-2] == "[]" and last[-1] == "True"


def test_whole_top_level_names_are_compared():
    sys.modules["kubernetes_tpu_torchlike_probe"] = sys
    try:
        assert "kubernetes_tpu_torchlike_probe" not in forbidden_modules()
        assert "kubernetes_tpu_torch" not in forbidden_modules()
        sys.modules["kubernetes_tpu.probe"] = sys
        assert forbidden_modules()[-1] == "kubernetes_tpu.probe" or \
            "kubernetes_tpu.probe" in forbidden_modules()
    finally:
        sys.modules.pop("kubernetes_tpu_torchlike_probe", None)
        sys.modules.pop("kubernetes_tpu.probe", None)


def test_the_reference_imports_nothing_of_the_program():
    p = _python(
        f"import sys; sys.path.insert(0, {ROOT_DIR!r})\n"
        "import schedbench.reference.plain, schedbench.core.workload\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'kubernetes_tpu', "
        "'kubernetes_tpu_torch', 'torch')))")
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"


def test_without_a_card_the_command_prints_no_result():
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    p = subprocess.run([sys.executable, "schedbench/run.py", "--workload",
                        "sched-perf-5k.basic", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], capture_output=True, text=True,
                       cwd=ROOT_DIR, env=env, timeout=600)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr
