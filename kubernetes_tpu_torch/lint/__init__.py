"""graftlint for the PyTorch port — AST-based capture-safety /
determinism / host-sync / concurrency linter over ``kubernetes_tpu_torch``.

The port keeps its ground rules at runtime only, on the shapes a test
happens to run: a round body must stay capturable into a CUDA graph, every
device read goes through ``ops/sync.to_host``, a captured body bakes in
nothing its ``statics`` do not name, the solver stays float32, and shards
exchange data only in ``parallel/collectives.py``. graftlint moves those
checks to parse time: a cross-file call graph from the round bodies handed
to ``device_loop.run`` decides which functions run under capture, an
interprocedural taint pass decides which values are tensors there, and the
rule classes (R1–R10, plus R0 suppression hygiene) turn the hazards into
findings a CPU test can enforce. Rule ids, ``Finding`` fields and the
suppression syntax are the reference linter's (``kubernetes_tpu.lint``),
so a ``# graftlint:`` comment means the same to both.

Rule classes
------------

==== =================================================================
R0   suppression hygiene — every inline disable needs a justification
R1   capture-unsafe Python in a captured round body (``if``/``while``/
     ``bool()``/``int()``/``float()``/``.item()``/``.tolist()``/
     ``.cpu()`` on a tensor, ``nonzero``/one-argument ``torch.where``/
     ``masked_select``/``unique``/boolean-mask indexing,
     ``torch.tensor`` of host data); ``if first:`` bodies run eagerly
R2   host↔device sync in hot paths (``np.asarray``/``.item()``/
     ``.tolist()``/``.cpu()``/``torch.cuda.synchronize`` inside the
     per-cycle solve loop or a captured body)
R3   re-capture hazards (a CUDA graph outside ``ops/device_loop.py``;
     ``torch.compile``/``torch.jit.script`` built per call; a
     ``functools.partial`` keyword the loop's ``statics`` do not carry)
R4   non-determinism (bare ``random.*``/``np.random.*`` global state,
     ``time.time()``, argless ``datetime.now()``, torch's global
     generator in production modules)
R5   dtype drift (float64 in device-math modules, ``torch.float64``,
     ``.double()``)
R6   Py3.10 f-string backslash (the seed-breaking SyntaxError class)
R7   device read outside the declared ``ops/sync.py`` boundary
R8   sharded-value gather in a mesh-aware module (outside
     ``parallel/collectives.py``)
R9   lock discipline — ``# guarded-by:`` (declared or inferred) state
     accessed without its lock
R10  blocking under a lock (hub RPC verbs, ``time.sleep``, readback,
     ``.result()``, event-sink emission, ``torch.cuda.synchronize``,
     event/stream waits, ``to_host``/``to_cpu``, tensor reads)
==== =================================================================

Suppression forms (justification after ``--`` is mandatory, R0-checked)::

    x = t.tolist()  # graftlint: disable=R7 -- host copy, no device sync
    # graftlint: disable=R4 -- wall time is the payload here
    stamp = time.time()
    # graftlint: disable-scope=R2 -- host oracle: CPU math by design
    def _exact_solve(...): ...

Programmatic entry points: :func:`run_lint` (paths → findings) and
:func:`lint_source` (one source string → findings, used by
``kubernetes_tpu_torch.testing.lint_clean``).
"""

from kubernetes_tpu_torch.lint.engine import (
    Finding,
    Project,
    lint_source,
    run_lint,
)
from kubernetes_tpu_torch.lint.report import (
    load_baseline,
    render_json,
    render_text,
    subtract_baseline,
    write_baseline,
)

__all__ = [
    "Finding",
    "Project",
    "lint_source",
    "run_lint",
    "load_baseline",
    "render_json",
    "render_text",
    "subtract_baseline",
    "write_baseline",
]
