"""The port's graftlint rules (``kubernetes_tpu_torch.lint``), one fixture
per judgment: every case of the reference linter's rule tests
(``tests/test_graftlint_rules.py``) has a counterpart here — the same
source where the rule is plain Python, its torch transliteration where the
rule is recast — and every torch case the port adds has a positive and a
negative fixture.

A fixture marks the findings it expects on their own lines: ``#> R1``
(``#> R2 R7`` for two). The case passes when the linter's (rule, line)
pairs are exactly the marked ones. CPU only; nothing here imports JAX.
"""

from __future__ import annotations

import json
import re
import textwrap

import pytest

from kubernetes_tpu_torch.lint import (
    Finding,
    lint_source,
    load_baseline,
    run_lint,
    subtract_baseline,
    write_baseline,
)
from kubernetes_tpu_torch.lint.report import per_rule_counts, render_json, render_text

_MARK = re.compile(r"#>\s*((?:R\d+\s*)+)$")


def lint(src, **kw):
    return lint_source(textwrap.dedent(src), **kw)


def rules_of(findings):
    return [f.rule for f in findings]


def marked(src):
    """The (rule, line) pairs a fixture's ``#>`` markers expect."""
    out = []
    for i, text in enumerate(textwrap.dedent(src).splitlines(), 1):
        m = _MARK.search(text)
        if m:
            out.extend((r, i) for r in m.group(1).split())
    return sorted(out)


def got(findings):
    return sorted((f.rule, f.line) for f in findings)


#: a round body's imports (the reference's JIT_HEADER has three lines too)
ROUND = """\
    import functools
    import torch
    from kubernetes_tpu_torch.ops import device_loop
"""

# --------------------------------------------------------------------------
# Counterparts of the reference's snippet cases: (id, source, lint kwargs).
# The expected findings are the source's markers.
# --------------------------------------------------------------------------

CASES = [
    # ---- R1: capture safety ----------------------------------------------
    ("r1_flags_branch_conversion_iteration_sync", ROUND + """
    # a round body (run below)
    def f(x, y, first, tag):
        if x > 0:              #> R1
            y = y + 1
        z = float(x)           #> R1
        s = x.sum()
        for v in s:            #> R1
            y = y + v
        while y.any():         #> R1
            break
        b = x.item()           #> R1 R7
        return y, z, b

    def solve(x, y, valid):
        return device_loop.run(f, x, y, valid, 8, statics=("f",))
    """, {}),
    ("r1_blessed_idioms_stay_quiet", ROUND + """
    from typing import Dict, Optional

    def f(ctx, mask: torch.Tensor, first, tag, *, flag=False,
          hoisted: Optional[Dict[str, tuple]] = None):
        x, extra = ctx
        hoisted = hoisted or {}          # keyword-only: a static
        if flag:                         # statics
            x = x + 1
        if extra is not None:            # `is` check on a tensor slot
            x = x + extra
        if x.shape[0] > 4:               # shape projection
            x = x * 2
        for name in hoisted:             # container iteration
            kind, val = hoisted[name]
            if kind == "full":           # str-constant compare
                x = x + val
        n = len(mask)                    # len() is static
        return x + n, mask.any(), None

    def solve(ctx, mask, valid):
        body = functools.partial(f, flag=True, hoisted=None)
        return device_loop.run(body, ctx, mask, valid, 8,
                               statics=("f", True, None))
    """, {}),
    ("r1_namedtuple_field_iteration_semantics", ROUND + """
    # iterating the bundle is fine; iterating a field (a tensor) is not
    def f(pods, state, first, tag):
        rebuilt = [t for t in pods]          # fine: container-or-tensor
        total = 0.0
        for row in pods.req:                 #> R1
            total = total + row
        return (rebuilt, total), state.any(), None

    def solve(pods, state, valid):
        return device_loop.run(f, pods, state, valid, 4, statics=("f",))
    """, {}),
    ("r1_transitive_call_graph_and_annotation_pin", ROUND + """
    def helper(a, reverse: bool):
        if reverse:           # bool annotation: a host value
            return a
        if a.max() > 0:       #> R1
            return a + 1
        return a

    def f(q, state, first, tag):
        return helper(q, True), state.any(), None

    def solve(q, state, valid):
        return device_loop.run(f, q, state, valid, 4, statics=("f",))
    """, {}),
    ("r1_partial_value_and_nested_program", ROUND + """
    def body(ctx, state, first, tag):
        acc, i = state
        if i == 0:            #> R1
            acc = acc + 1
        return (acc, i + 1), acc.any(), None

    def _solo(program, ctx, state, first, tag):
        return program(ctx, state, first, tag)

    def g(x, valid):
        step = functools.partial(_solo, body)
        return device_loop.run(step, x, (x, x), valid, 4, statics=("g",))
    """, {}),
    ("r1_match_statement_bodies_are_walked", ROUND + """
    def f(x, state, first, tag, *, mode: int = 1):
        match mode:
            case 1:
                if x > 0:          #> R1
                    x = x + 1
        match x:                   #> R1
            case [a, b]:
                if a > 0:          #> R1
                    return b, state.any(), None
        return x, state.any(), None

    def solve(x, state, valid):
        return device_loop.run(functools.partial(f, mode=1), x, state,
                               valid, 4, statics=("f", 1))
    """, {}),
    ("r1_match_on_static_subject_stays_quiet", ROUND + """
    def f(x, state, first, tag, *, mode="double"):
        match mode:
            case "double":
                x = x * 2
            case _:
                x = x + 1
        return x, state.any(), None

    def solve(x, state, valid, mode):
        return device_loop.run(functools.partial(f, mode=mode), x, state,
                               valid, 4, statics=("f", mode))
    """, {}),
    ("r1_loop_carried_taint_settles_for", ROUND + """
    def f(x, state, first, tag):
        a = 0
        for _ in range(3):
            if a:              #> R1
                x = x + 1
            a = x
        return x, state.any(), None

    def solve(x, state, valid):
        return device_loop.run(f, x, state, valid, 4, statics=("f",))
    """, {}),
    ("r1_loop_carried_taint_settles_while", ROUND + """
    def f(x, state, first, tag):
        done = False
        while done:            #> R1
            done = x.any()
        return x, state.any(), None

    def solve(x, state, valid):
        return device_loop.run(f, x, state, valid, 4, statics=("f",))
    """, {}),
    ("r1_r2_taint_crosses_method_boundaries", ROUND + """
    import numpy as np

    class S:
        def step(self, x, state, first, tag):
            return self.helper(x), state.any(), None

        def helper(self, x):
            if x > 0:                        #> R1
                return np.asarray(x)         #> R2 R7
            return x

        def solve(self, x, state, valid):
            return device_loop.run(self.step, x, state, valid, 4,
                                   statics=("s",))
    """, {}),
    ("r1_positional_partial_args_are_static", ROUND + """
    def g(n, x, state, first, tag):
        if n > 0:
            return x + n, state.any(), None
        return x, state.any(), None

    def solve(x, state, valid):
        return device_loop.run(functools.partial(g, 3), x, state, valid, 4,
                               statics=("g", 3))
    """, {}),

    # ---- R2: host syncs in hot paths -------------------------------------
    ("r2_flags_numpy_readback_in_capture_and_hot_funcs", ROUND + """
    import numpy as np

    def f(x, state, first, tag):
        return np.asarray(x), state.any(), None    #> R2 R7

    def batch_assign(pods, nodes):
        a = np.array(pods)              #> R2 R7
        b = nodes.cpu()                 #> R2 R7
        c = pods.item()                 #> R2 R7
        return a, b, c

    def cold_helper(x):
        return np.asarray(x)   #> R7

    def solve(x, state, valid):
        return device_loop.run(f, x, state, valid, 4, statics=("f",))
    """, {}),
    ("r2_negative_device_code_is_quiet", ROUND + """
    def f(x, mask, first, tag):
        return torch.where(mask, x, 0.0).sum(1), mask.any(), None

    def solve(x, mask, valid):
        return device_loop.run(f, x, mask, valid, 4, statics=("f",))
    """, {}),

    # ---- R3: re-capture hazards ------------------------------------------
    ("r3_compile_in_function_and_loop", """
    import torch

    def profile(fns):
        out = []
        for fn in fns:
            out.append(torch.compile(fn)())     #> R3
        g = torch.compile(lambda x: x + 1)      #> R3
        return out, g
    """, {}),
    ("r3_module_scope_compile_is_blessed", """
    import torch

    def _impl(x):
        return x + 1

    fast = torch.compile(_impl)

    @torch.compile
    def g(x, k=2):
        return x * k
    """, {}),
    ("r3_partial_keyword_names_no_parameter", ROUND + """
    def _round(ctx, state, first, tag, *, weights_key=None, no_ports=False):
        return state, state.any(), None

    def solve(ctx, state, valid, wk):
        body = functools.partial(_round, weights_key=wk, no_prots=True)  #> R3
        return device_loop.run(body, ctx, state, valid, 4,
                               statics=("r", wk, True))
    """, {}),

    # ---- R4: determinism (plain Python: the reference's own sources) -----
    ("r4_flags_global_rng_wallclock_datetime", """
    import random
    import time
    import numpy as np
    from datetime import datetime

    def jitter():
        return random.random() * time.time()   #> R4 R4

    def spread(xs):
        np.random.shuffle(xs)                  #> R4
        return xs

    def stamp():
        return datetime.now()                  #> R4
    """, {}),
    ("r4_blessed_forms_stay_quiet", """
    import random
    import time
    import numpy as np
    from typing import Callable
    from datetime import datetime, timezone

    class FaultInjector:
        def __init__(self, seed: int = 0,
                     clock: Callable[[], float] = time.monotonic):
            self.rng = random.Random(seed)
            self.clock = clock

        def roll(self):
            return self.rng.random() < 0.5, self.clock()

    def gen(seed):
        return np.random.default_rng(seed).normal()

    def stamp(now=None):
        return now or datetime.now(timezone.utc)
    """, {}),

    # ---- R5: dtype drift -------------------------------------------------
    ("r5_float64_in_ops_scope", """
    import numpy as np
    import torch

    A = np.zeros((4,), np.float64)                       #> R5
    B = torch.tensor([1.0], dtype=torch.float64)         #> R5
    C = np.arange(4, dtype=float)                        #> R5
    D = A.astype(float)                                  #> R5
    """, {"filename": "kubernetes_tpu_torch/ops/kernel.py"}),
    ("r5_float64_out_of_scope", """
    import numpy as np
    import torch

    A = np.zeros((4,), np.float64)
    B = torch.tensor([1.0], dtype=torch.float64)
    C = np.arange(4, dtype=float)
    D = A.astype(float)
    """, {"filename": "kubernetes_tpu_torch/sim.py"}),
    ("r5_float32_is_quiet", """
    import numpy as np
    import torch
    A = np.zeros((4,), np.float32)
    B = torch.arange(4, dtype=torch.int32)
    """, {"filename": "kubernetes_tpu_torch/ops/kernel.py"}),

    # ---- R6: the parse gate (plain Python) -------------------------------
    ("r6_generic_syntax_error_still_reports", """
    def f(:              #> R6
        pass
    """, {}),
    ("r6_legal_fstrings_are_quiet", """
    NL = "\\n"
    def render(rows, name):
        return f"{NL.join(rows)} {name} ok\\n"
    """, {}),

    # ---- suppressions + R0 (plain Python) --------------------------------
    ("suppression_with_justification_works", """
    import time

    def f():
        return time.time()  # graftlint: disable=R4 -- wall time is the payload here
    """, {}),
    ("standalone_suppression_skips_comment_continuation", """
    import time

    def f():
        # graftlint: disable=R4 -- wall time is the payload; the
        # justification wraps over two comment lines
        return time.time()
    """, {}),
    ("disable_scope_covers_whole_function", """
    import numpy as np
    import torch

    # graftlint: disable-scope=R2,R7 -- deliberate host boundary (fixture)
    def validate_solution(assigned, usage):
        a = np.asarray(assigned)
        b = usage.cpu()
        return a, b
    """, {}),
    ("disable_file_covers_everything", """
    # graftlint: disable-file=R4 -- profiler: wall time is the product
    import time

    def a():
        return time.time()

    def b():
        return time.time()
    """, {}),
    ("suppression_same_rule_covers_the_line", """
    import time
    import random

    def f():
        # graftlint: disable=R4 -- only the clock is justified
        return time.time(), random.random()
    """, {}),
    ("suppression_does_not_leak_to_other_rules", ROUND + """
    import numpy as np

    def f(x, state, first, tag):
        return np.asarray(x), state.any(), None  # graftlint: disable=R4 -- wrong rule id

    def solve(x, state, valid):
        return device_loop.run(f, x, state, valid, 4, statics=("f",))
    """, {"expect": [("R2", 8), ("R7", 8)]}),
    ("disable_covers_multiline_trailing", """
    import time

    def poll():
        return time.time(
        )  # graftlint: disable=R4 -- replayed log stamp, never ordered
    """, {}),
    ("disable_covers_multiline_standalone", """
    import time

    def poll():
        # graftlint: disable=R4 -- replayed log stamp, never ordered
        return (1,
                time.time())
    """, {}),
    ("disable_on_compound_header_does_not_blanket_body", """
    import random

    def loop():
        for i in range(3):  # graftlint: disable=R4 -- header only
            x = random.random()      #> R4
        return x
    """, {}),

    # ---- R7: reads outside ops/sync.py -----------------------------------
    ("r7_flags_readback_outside_boundary", """
    import numpy as np
    import torch

    def decode(result):
        return np.asarray(result)         #> R7

    def pull(x):
        return x.cpu()                    #> R7
    """, {"select": ["R7"]}),
    ("r7_host_literals_are_quiet", """
    import numpy as np
    import torch

    def pack(idx):
        a = np.asarray([1, 2, 3])
        b = np.asarray((0,))
        c = np.asarray([i for i in idx])
        return a, b, c
    """, {"select": ["R7"]}),
    ("r7_numpy_only_modules_are_out_of_scope", """
    import numpy as np

    def pack(rows):
        return np.asarray(rows)
    """, {"select": ["R7"]}),
    ("r7_boundary_module_exempt", """
    import numpy as np
    import torch

    def to_host(x):
        return np.asarray(x.cpu())
    """, {"select": ["R7"],
          "filename": "kubernetes_tpu_torch/ops/sync.py"}),
    ("r7_test_module_exempt", """
    import numpy as np
    import torch

    def to_host(x):
        return np.asarray(x.cpu())
    """, {"select": ["R7"], "filename": "tests/test_something.py"}),
    ("r7_script_exempt", """
    import numpy as np
    import torch

    def to_host(x):
        return np.asarray(x.cpu())
    """, {"select": ["R7"], "filename": "scripts/torch_bench_foo.py"}),
    ("r7_production_module_is_the_target", """
    import numpy as np
    import torch

    def to_host(x):
        return np.asarray(x.cpu())        #> R7 R7
    """, {"select": ["R7"], "filename": "kubernetes_tpu_torch/solver2.py"}),
    ("r7_scope_suppression_with_justification", """
    import numpy as np
    import torch

    # graftlint: disable-scope=R7 -- host oracle by design (fixture)
    def validate(assigned):
        return np.asarray(assigned)
    """, {"select": ["R7"]}),
    ("r7_frame_loop_through_the_declared_readback", """
    import torch

    def solve_blocks(self, blocks, dp):
        for b in blocks:
            payload = solve_one(dp, b)
            host = self.obs.jax.readback("cold-block", payload)
            consume(host)
    """, {"select": ["R7"]}),
    ("r7_frame_loop_bare_readback", """
    import numpy as np
    import torch

    def solve_blocks(blocks, dp):
        out = []
        for b in blocks:
            out.append(np.asarray(solve_one(dp, b)))      #> R7
        return out
    """, {"select": ["R7"]}),

    # ---- R8: gathers in mesh-aware modules -------------------------------
    ("r8_flags_gather_in_parallel_importing_module", """
    import numpy as np
    import torch
    from kubernetes_tpu_torch.parallel import shard_nodes

    def pull(sharded):
        a = np.asarray(sharded)          #> R8
        b = sharded.cpu()                #> R8
        c = sharded.tolist()             #> R8
        return a, b, c
    """, {"select": ["R8"], "filename": "kubernetes_tpu_torch/solver2.py"}),
    ("r8_needs_the_parallel_import", """
    import numpy as np
    import torch

    def pull(sharded):
        a = np.asarray(sharded)
        b = sharded.cpu()
        c = sharded.tolist()
        return a, b, c
    """, {"select": ["R8"], "filename": "kubernetes_tpu_torch/solver2.py"}),
    ("r8_bare_import_form_package", """
    import numpy as np
    import torch
    import kubernetes_tpu_torch.parallel

    def pull(sharded):
        return np.asarray(sharded)       #> R8
    """, {"select": ["R8"], "filename": "kubernetes_tpu_torch/solver2.py"}),
    ("r8_bare_import_form_module", """
    import numpy as np
    import torch
    import kubernetes_tpu_torch.parallel.mesh

    def pull(sharded):
        return np.asarray(sharded)       #> R8
    """, {"select": ["R8"], "filename": "kubernetes_tpu_torch/solver2.py"}),
    ("r8_function_level_import_is_in_scope", """
    import numpy as np
    import torch

    def pull(sharded):
        from kubernetes_tpu_torch.parallel.mesh import replicas
        return np.asarray(sharded)       #> R8
    """, {"select": ["R8"], "filename": "kubernetes_tpu_torch/solver2.py"}),
    ("r8_exempt_in_tests", """
    import numpy as np
    import torch
    from kubernetes_tpu_torch.parallel import shard_nodes

    def pull(sharded):
        return np.asarray(sharded), sharded.cpu(), sharded.tolist()
    """, {"select": ["R8"], "filename": "tests/test_x.py"}),
    ("r8_exempt_in_scripts", """
    import numpy as np
    import torch
    from kubernetes_tpu_torch.parallel import shard_nodes

    def pull(sharded):
        return np.asarray(sharded), sharded.cpu(), sharded.tolist()
    """, {"select": ["R8"], "filename": "scripts/torch_bench_x.py"}),
    ("r8_exempt_in_the_exchange_module", """
    import numpy as np
    import torch
    from kubernetes_tpu_torch.parallel import mesh

    def pull(sharded, devices):
        return torch.cat([s.to(devices[0]) for s in sharded]), sharded.cpu()
    """, {"select": ["R8"],
          "filename": "kubernetes_tpu_torch/parallel/collectives.py"}),
    ("r8_host_literals_are_quiet", """
    import numpy as np
    import torch
    from kubernetes_tpu_torch.parallel import shard_nodes

    def pack():
        return np.asarray([1, 2, 3])
    """, {"select": ["R8"], "filename": "kubernetes_tpu_torch/solver2.py"}),
    ("r8_declared_boundary_is_quiet", """
    import numpy as np
    import torch
    from kubernetes_tpu_torch.parallel import shard_nodes

    def pull(obs, sharded):
        return obs.jax.readback("solve-result", sharded)
    """, {"select": ["R8"], "filename": "kubernetes_tpu_torch/solver2.py"}),
    ("r8_scope_suppression_is_quiet", """
    import numpy as np
    import torch
    from kubernetes_tpu_torch.parallel import shard_nodes

    # graftlint: disable-scope=R8 -- deliberate full gather (fixture)
    def exact_oracle(sharded):
        return np.asarray(sharded)
    """, {"select": ["R8"], "filename": "kubernetes_tpu_torch/solver2.py"}),

    # ---- R9: lock discipline (plain Python) ------------------------------
    ("r9_declared_guard_flags_offlock_access", """
    import threading

    class Q:
        def __init__(self):
            self._lock = threading.Lock()
            self.pending = []  # guarded-by: _lock

        def add(self, x):
            with self._lock:
                self.pending.append(x)

        def peek(self):
            return self.pending[0]       #> R9
    """, {}),
    ("r9_inference_from_locked_write_majority", """
    import threading

    class Elector:
        def __init__(self):
            self._lock = threading.Lock()
            self.pending = []

        def enqueue(self, fn):
            with self._lock:
                self.pending.append(fn)

        def clear(self):
            with self._lock:
                self.pending = []

        def tick(self):
            for fn in self.pending:      #> R9
                fn()
    """, {}),
    ("r9_inference_below_threshold_stays_quiet", """
    import threading

    class Sloppy:
        def __init__(self):
            self._lock = threading.Lock()
            self.n = 0

        def locked_inc(self):
            with self._lock:
                self.n += 1

        def unlocked_inc(self):
            self.n += 1

        def read(self):
            return self.n
    """, {}),
    ("r9_interprocedural_helper_under_lock_is_covered", """
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self.items = {}  # guarded-by: _lock

        def put(self, k, v):
            with self._lock:
                self._store(k, v)

        def _store(self, k, v):
            self.items[k] = v
    """, {}),
    ("r9_locked_suffix_convention_assumes_locks_held", """
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self.items = {}  # guarded-by: _lock

        def put(self, k, v):
            with self._lock:
                self._store_locked(k, v)

        def _store_locked(self, k, v):
            self.items[k] = v
    """, {}),
    ("r9_helper_also_called_offlock_flags", """
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self.items = {}  # guarded-by: _lock

        def put(self, k, v):
            with self._lock:
                self._store(k, v)

        def sneak(self, k, v):
            self._store(k, v)

        def _store(self, k, v):
            self.items[k] = v            #> R9
    """, {}),
    ("r9_init_writes_do_not_need_the_lock", """
    import threading

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self.items = {}  # guarded-by: _lock
            self.items["warm"] = 1

        def put(self, k, v):
            with self._lock:
                self.items[k] = v
    """, {}),
    ("r9_unguarded_class_stays_quiet", """
    class Free:
        def __init__(self):
            self.items = {}

        def put(self, k, v):
            self.items[k] = v
    """, {}),
    ("r9_catches_the_work_helper_offlock_shape", """
    import threading

    class Model:
        def __init__(self):
            self._lock = threading.Lock()
            self.sig = {}  # guarded-by: _lock

        def record(self, k, v):
            with self._lock:
                self.sig[k] = v

        def anchored(self, k):
            with self._lock:
                return self._work(k)

        def predict(self, k):
            return self._work(k)

        def _work(self, k):
            return self.sig.get(k, 0)    #> R9
    """, {}),
    ("r9_catches_the_ack_revision_offlock_shape", """
    import threading

    class Stream:
        def __init__(self):
            self.lock = threading.Lock()
            self.revision = 0

        def apply(self, delta):
            with self.lock:
                self.revision = max(self.revision, delta)
            return self.revision         #> R9
    """, {}),

    # ---- R10: blocking under a lock (plain Python) -----------------------
    ("r10_flags_sleep_result_readback_under_lock", """
    import threading
    import time

    class C:
        def __init__(self):
            self._lock = threading.Lock()

        def bad_sleep(self):
            with self._lock:
                time.sleep(0.1)                          #> R10

        def bad_result(self, fut):
            with self._lock:
                return fut.result()                      #> R10

        def bad_readback(self, obs, x):
            with self._lock:
                return obs.jax.readback("site", x)       #> R10
    """, {}),
    ("r10_flags_hub_rpc_verb_under_lock", """
    import threading

    class Service:
        def __init__(self, hub):
            self._lock = threading.Lock()
            self.hub = hub

        def rebind(self, pod, node):
            with self._lock:
                self.hub.bind_pod(pod, node)             #> R10
    """, {}),
    ("r10_intraclass_verb_named_methods_are_not_rpcs", """
    import threading

    class Hub:
        def __init__(self):
            self._lock = threading.Lock()
            self.pods = {}

        def delete_pod(self, key):
            self.pods.pop(key, None)

        def gc(self, keys):
            with self._lock:
                for k in keys:
                    self.delete_pod(k)
    """, {}),
    ("r10_event_emission_under_lock_flags", """
    import threading

    class Watchdog:
        def __init__(self, sink):
            self._lock = threading.Lock()
            self.event_sink = sink

        def observe(self, x):
            with self._lock:
                if x > 1:
                    self.event_sink("Burn", None, "over budget")   #> R10
    """, {}),
    ("r10_emitter_closure_watchdog_shape", """
    import threading

    class Watchdog:
        def __init__(self, sink):
            self._lock = threading.Lock()
            self.event_sink = sink
            self.burning = False

        def observe(self, x):
            with self._lock:
                self._flip(x)                                    #> R10

        def _flip(self, x):
            self.burning = x > 1
            if self.burning:
                self.event_sink("Burn", None, "over budget")     #> R10
    """, {}),
    ("r10_emit_outside_lock_is_the_blessed_form", """
    import threading

    class Watchdog:
        def __init__(self, sink):
            self._lock = threading.Lock()
            self.event_sink = sink

        def observe(self, x):
            with self._lock:
                burn = x > 1
            if burn:
                self.event_sink("Burn", None, "over budget")
    """, {}),
    ("r10_sleep_outside_lock_stays_quiet", """
    import threading
    import time

    class C:
        def __init__(self):
            self._lock = threading.Lock()

        def pace(self):
            with self._lock:
                n = 1
            time.sleep(n)
    """, {}),
    ("r10_scope_disable_with_reason", """
    import threading
    import time

    class C:
        def __init__(self):
            self._lock = threading.Lock()

        # graftlint: disable-scope=R10 -- deliberate paced drain
        def pace(self):
            with self._lock:
                time.sleep(0.01)

        def bad(self):
            with self._lock:
                time.sleep(0.01)         #> R10
    """, {}),
]


R9_POSITIVE = """
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
"""

# --------------------------------------------------------------------------
# The torch cases the port adds: each a positive and a negative fixture.
# --------------------------------------------------------------------------

TORCH_CASES = [
    # R1: round 0 runs eagerly — its host read is not a capture hazard
    ("r1_first_only_read_is_eager", ROUND + """
    from kubernetes_tpu_torch.parallel import collectives as coll

    def f(ctx, state, first, tag, *, auto=True):
        use = tag
        if auto and first:
            use = bool((yield coll.host(ctx.any())))
        return state, state.any(), use

    def solve(ctx, state, valid):
        return device_loop.run(functools.partial(f, auto=True), ctx, state,
                               valid, 4, statics=("f", True))
    """, {}),
    ("r1_host_read_outside_first_is_a_hazard", ROUND + """
    from kubernetes_tpu_torch.parallel import collectives as coll

    def f(ctx, state, first, tag, *, auto=True):
        use = bool((yield coll.host(ctx.any())))          #> R1
        return state, state.any(), use

    def solve(ctx, state, valid):
        return device_loop.run(functools.partial(f, auto=True), ctx, state,
                               valid, 4, statics=("f", True))
    """, {}),
    ("r1_to_host_in_a_captured_body", ROUND + """
    from kubernetes_tpu_torch.ops.sync import to_host

    def f(ctx, state, first, tag):
        if first:
            n = to_host(ctx.sum())
        m = to_host(ctx.sum())                            #> R1
        return state, state.any(), None

    def solve(ctx, state, valid):
        return device_loop.run(f, ctx, state, valid, 4, statics=("f",))
    """, {}),
    ("r1_statics_none_keeps_the_python_loop", ROUND + """
    def f(ctx, state, first, tag):
        if ctx.sum() > 0:
            state = state + 1
        return state, state.any(), None

    def solve(ctx, state, valid):
        return device_loop.run(f, ctx, state, valid, 4, statics=None)
    """, {}),
    ("r1_statics_named_captures_the_body", ROUND + """
    def f(ctx, state, first, tag):
        if ctx.sum() > 0:                                 #> R1
            state = state + 1
        return state, state.any(), None

    def solve(ctx, state, valid):
        return device_loop.run(f, ctx, state, valid, 4, statics=("f",))
    """, {}),
    ("r1_data_dependent_shapes", ROUND + """
    def f(x, mask, first, tag):
        a = torch.nonzero(mask)                           #> R1
        b = mask.nonzero()                                #> R1
        c = torch.where(mask)                             #> R1
        d = torch.masked_select(x, mask)                  #> R1
        e = x.unique()                                    #> R1
        g = x[x > 0]                                      #> R1
        keep = (x > 0) & mask
        x[keep] = 0.0                                     #> R1
        h = x[~mask]                                      #> R1
        return x, mask.any(), None

    def solve(x, mask, valid):
        return device_loop.run(f, x, mask, valid, 4, statics=("f",))
    """, {}),
    ("r1_static_shapes_are_quiet", ROUND + """
    def f(x, mask, first, tag):
        idx = torch.argsort(x, stable=True)
        a = x[idx]
        b = torch.where(mask, x, 0.0)
        c = x.masked_fill(~mask, 0.0)
        d = torch.as_tensor(x)
        e = x[:, 0]
        n = x.size(0) + x.dim() + x.numel()
        if x.device.type == "cuda" and x.shape[0] > n:
            x = x + 1
        return x, mask.any(), None

    def solve(x, mask, valid):
        return device_loop.run(f, x, mask, valid, 4, statics=("f",))
    """, {}),
    ("r1_host_data_upload_and_cpu", ROUND + """
    import numpy as np

    def f(x, state, first, tag):
        a = torch.tensor([1.0, 2.0], device=x.device)     #> R1
        b = torch.as_tensor(np.zeros(4), device=x.device)  #> R1
        c = x.cpu()                                       #> R1 R7
        d = x.tolist()                                    #> R1 R7
        return state, state.any(), None

    def solve(x, state, valid):
        return device_loop.run(f, x, state, valid, 4, statics=("f",))
    """, {}),
    ("r1_host_return_annotation_pins_the_result", ROUND + """
    def route(n, *ts) -> bool:
        return n % 16 == 0

    def fit(t):
        return t.data_ptr() % 16 == 0

    def f(x, state, first, tag):
        if route(x.shape[1], x):
            x = x + 1
        if fit(x):                                        #> R1
            x = x + 2
        return x, state.any(), None

    def solve(x, state, valid):
        return device_loop.run(f, x, state, valid, 4, statics=("f",))
    """, {}),
    # R2: the barrier in the hot loop
    ("r2_synchronize_in_a_hot_function", """
    import torch

    def greedy_assign(pods, nodes):
        torch.cuda.synchronize()                          #> R2
        return pods

    def report(pods):
        torch.cuda.synchronize()
        return pods
    """, {"select": ["R2"]}),
    # R3: a graph outside the one capture site
    ("r3_graph_outside_device_loop", """
    import torch

    def replay(fn, x):
        g = torch.cuda.CUDAGraph()                        #> R3
        with torch.cuda.graph(g):                         #> R3
            y = fn(x)
        return g, y
    """, {"filename": "kubernetes_tpu_torch/ops/other.py"}),
    ("r3_graph_in_device_loop_is_the_site", """
    import torch

    def replay(fn, x):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            y = fn(x)
        return g, y
    """, {"filename": "kubernetes_tpu_torch/ops/device_loop.py"}),
    # R3: a partial keyword the statics do not carry
    ("r3_partial_keyword_missing_from_statics", ROUND + """
    def _round(ctx, state, first, tag, *, scale, cap):
        return state * scale + cap, state.any(), None

    def solve(ctx, state, valid, scale, cap):
        body = functools.partial(_round, scale=scale, cap=cap)  #> R3
        return device_loop.run(body, ctx, state, valid, 4,
                               statics=("round", cap))
    """, {"select": ["R3"]}),
    ("r3_partial_keywords_in_statics", ROUND + """
    def _round(ctx, state, first, tag, *, scale, cap, route=None):
        use = tag
        if first:
            use = route is not None
        return state * scale + cap, state.any(), use

    def solve(ctx, state, valid, scale, cap, route):
        body = functools.partial(_round, scale=scale, cap=cap, route=route)
        return device_loop.run(body, ctx, state, valid, 4,
                               statics=("round", scale, cap))
    """, {"select": ["R3"]}),
    ("r3_partial_dict_keywords_through_a_statics_function", ROUND + """
    def _statics(flags):
        return ("g", *[(k, v) for k, v in flags.items() if k != "scale"])

    def _round(ctx, state, first, tag, *, scale, cap):
        return state * scale + cap, state.any(), None

    def _solo(program, ctx, state, first, tag, **kw):
        return program(ctx, state, first, tag, **kw)

    def solve(ctx, state, valid, scale, cap):
        flags = dict(scale=scale, cap=cap)
        return device_loop.run(
            functools.partial(_solo, _round, **flags),  #> R3
            ctx, state, valid, 4, _statics(flags))
    """, {"select": ["R3"]}),
    ("r3_partial_dict_keywords_all_carried", ROUND + """
    def _statics(flags):
        return ("g", *[(k, v) for k, v in flags.items()])

    def _round(ctx, state, first, tag, *, scale, cap):
        return state * scale + cap, state.any(), None

    def _solo(program, ctx, state, first, tag, **kw):
        return program(ctx, state, first, tag, **kw)

    def solve(ctx, state, valid, scale, cap):
        flags = dict(scale=scale, cap=cap)
        return device_loop.run(
            functools.partial(_solo, _round, **flags),
            ctx, state, valid, 4, _statics(flags))
    """, {"select": ["R3"]}),
    ("r3_partial_keyword_into_an_open_target", ROUND + """
    def _round(ctx, state, first, tag, **kw):
        return state, state.any(), None

    def solve(ctx, state, valid):
        body = functools.partial(_round, anything=1)
        return device_loop.run(body, ctx, state, valid, 4, statics=("r",))
    """, {"select": ["R3"]}),
    # R4: torch's global generator in production modules
    ("r4_torch_global_generator", """
    import torch

    def draw(n):
        torch.manual_seed(0)                              #> R4
        a = torch.rand((n,))                              #> R4
        b = torch.randint(0, 4, (n,))                     #> R4
        return torch.randperm(n), a, b                    #> R4
    """, {"filename": "kubernetes_tpu_torch/sim2.py"}),
    ("r4_torch_seeded_generator_is_quiet", """
    import torch

    def draw(n, seed):
        gen = torch.Generator().manual_seed(seed)
        a = torch.rand((n,), generator=gen)
        b = torch.randint(0, 4, (n,), generator=gen)
        return torch.randperm(n, generator=gen), a, b
    """, {"filename": "kubernetes_tpu_torch/sim2.py"}),
    ("r4_torch_global_generator_in_a_harness", """
    import torch

    def draw(n):
        torch.manual_seed(0)
        return torch.rand((n,))
    """, {"filename": "chip_smoke.py"}),
    # R5: torch's float64 spellings
    ("r5_torch_float64_spellings", """
    import torch

    def widen(x):
        a = x.double()                                    #> R5
        b = x.to(torch.double)                            #> R5
        return torch.zeros(4, dtype=torch.complex128), a, b   #> R5
    """, {"filename": "kubernetes_tpu_torch/parallel/x.py"}),
    ("r5_torch_float32_is_quiet", """
    import torch

    def narrow(x):
        return x.float(), x.to(torch.float32), torch.zeros(4)
    """, {"filename": "kubernetes_tpu_torch/parallel/x.py"}),
    # R7: the boundary is ops/sync.py
    ("r7_tolist_outside_the_boundary", """
    import torch

    def read(t):
        return t.tolist(), t.item(), t.numpy(), t.to("cpu")   #> R7 R7 R7 R7
    """, {"filename": "kubernetes_tpu_torch/obs/other.py"}),
    ("r7_tolist_inside_the_boundary", """
    import torch

    def read(t):
        return t.tolist(), t.item(), t.numpy(), t.to("cpu")
    """, {"filename": "kubernetes_tpu_torch/ops/sync.py"}),
    ("r7_host_values_after_the_boundary_are_quiet", """
    import numpy as np
    import torch
    from kubernetes_tpu_torch.ops.sync import to_host, to_cpu

    def read(self, t, parts):
        host = self.obs.jax.readback("site", t)
        code, host = host[-1], host[:-1]
        a = np.asarray(host, np.int64)
        b = np.asarray(to_host(t)).tolist()
        c = [x.numpy() for x in to_cpu(parts)]
        return a, b, c, code
    """, {"filename": "kubernetes_tpu_torch/obs/other.py"}),
    # R8: exchanges between shard devices
    ("r8_cross_device_moves", """
    import torch
    from kubernetes_tpu_torch.parallel.mesh import replicas

    def gather(states, mesh):
        devs = mesh.devices
        v = torch.cat([st.to(devs[0]) for st in states])    #> R8
        blocks = [b.to(d) for b, d in zip(v.chunk(2), mesh.devices)]   #> R8
        return v, blocks, states[0].to(mesh.device)         #> R8
    """, {"select": ["R8"], "filename": "kubernetes_tpu_torch/ops/x.py"}),
    ("r8_same_device_work_is_quiet", """
    import torch
    from kubernetes_tpu_torch.parallel.mesh import replicas

    def local(states, x):
        v = torch.cat([st.to(torch.float32) for st in states])
        return v, x.to(x.device), torch.stack([x, x])
    """, {"select": ["R8"], "filename": "kubernetes_tpu_torch/ops/x.py"}),
    # R10: the port's device syncs under a lock
    ("r10_device_syncs_under_a_lock", """
    import threading
    import torch
    from kubernetes_tpu_torch.ops.sync import to_host

    class C:
        def __init__(self):
            self._lock = threading.Lock()

        def bad(self, t, ev):
            with self._lock:
                torch.cuda.synchronize()                  #> R10
                ev.synchronize()                          #> R10
                n = to_host(t)                            #> R10
                return t.tolist(), n                      #> R10
    """, {"select": ["R10"]}),
    ("r10_device_syncs_after_the_lock", """
    import threading
    import torch
    from kubernetes_tpu_torch.ops.sync import to_host

    class C:
        def __init__(self):
            self._lock = threading.Lock()

        def good(self, t, ev):
            with self._lock:
                x = t
            torch.cuda.synchronize()
            ev.synchronize()
            return to_host(x), x.tolist()
    """, {"select": ["R10"]}),
]


def _check(src, kw):
    kw = dict(kw)
    expect = kw.pop("expect", None)
    findings = lint(src, **kw)
    want = sorted(expect) if expect is not None else marked(src)
    assert got(findings) == want, render_text(findings)
    return findings


@pytest.mark.parametrize("src,kw", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_reference_counterpart(src, kw):
    """Each snippet case of the reference's rule tests, recast for the
    port where its rule is: the marked (rule, line) pairs exactly."""
    _check(src, kw)


@pytest.mark.parametrize("src,kw", [c[1:] for c in TORCH_CASES],
                         ids=[c[0] for c in TORCH_CASES])
def test_torch_case(src, kw):
    """The port's own torch cases, each with a positive and a negative
    fixture."""
    _check(src, kw)


# --------------------------------------------------------------------------
# message needles, hygiene and the rest of the reference's tests
# --------------------------------------------------------------------------

def test_r1_messages_name_the_hazard():
    findings = _check(CASES[0][1], {})
    messages = " | ".join(f.message for f in findings)
    for needle in ("`if` branch", "`float()`", "iteration over a tensor",
                   "`while` condition", ".item()", "captured `f`"):
        assert needle in messages


def test_r1_transitive_finding_names_the_helper():
    findings = lint(dict((c[0], c[1]) for c in CASES)[
        "r1_transitive_call_graph_and_annotation_pin"])
    assert findings[0].message.endswith("`helper`")


def test_r3_messages_name_site_and_keyword():
    cases = dict((c[0], c[1]) for c in CASES + TORCH_CASES)
    loop = lint(cases["r3_compile_in_function_and_loop"])
    assert "inside a loop" in loop[0].message
    assert "inside a function body" in loop[1].message
    typo = lint(cases["r3_partial_keyword_names_no_parameter"])
    assert "no_prots" in typo[0].message
    stale = lint(cases["r3_partial_keyword_missing_from_statics"],
                 select=["R3"])
    assert "`scale`" in stale[0].message and "statics" in stale[0].message


def test_r6_fstring_backslash_is_caught_not_crashed():
    # the seed's metrics.py failure class: on 3.10 this does not parse,
    # and the linter must DIAGNOSE it (R6) rather than fall over
    findings = lint('''
    def render(rows):
        return f"{'\\n'.join(rows)} done"
    ''')
    assert rules_of(findings) == ["R6"]
    assert "backslash" in findings[0].message.lower()


def test_r6_generic_syntax_error_message():
    findings = lint("""
    def f(:
        pass
    """)
    assert "does not parse" in findings[0].message


def test_suppression_without_justification_is_r0_and_inert():
    findings = lint("""
    import time

    def f():
        return time.time()  # graftlint: disable=R4
    """)
    assert sorted(rules_of(findings)) == ["R0", "R4"]


def test_suppression_unknown_rule_is_r0():
    findings = lint("""
    import time

    def f():
        return time.time()  # graftlint: disable=R99 -- because
    """)
    assert sorted(rules_of(findings)) == ["R0", "R4"]


def test_disable_scope_not_on_def_is_r0():
    findings = lint("""
    import time

    # graftlint: disable-scope=R4 -- dangling
    x = 1
    """)
    assert rules_of(findings) == ["R0"]


def test_r9_messages_name_attr_lock_and_basis():
    cases = dict((c[0], c[1]) for c in CASES)
    declared = lint(cases["r9_declared_guard_flags_offlock_access"])
    assert "pending" in declared[0].message and "_lock" in declared[0].message
    inferred = lint(cases["r9_inference_from_locked_write_majority"])
    assert "inferred" in inferred[0].message
    ack = lint(cases["r9_catches_the_ack_revision_offlock_shape"])
    assert "revision" in ack[0].message


def test_r10_hub_verb_message():
    findings = lint(dict((c[0], c[1]) for c in CASES)[
        "r10_flags_hub_rpc_verb_under_lock"])
    assert "bind_pod" in findings[0].message


def test_r9_inline_disable_with_reason():
    src = R9_POSITIVE.replace(
        "return self.pending[0]",
        "return self.pending[0]"
        "  # graftlint: disable=R9 -- single-writer init path")
    assert lint(src) == []


def test_r9_disable_without_reason_trips_hygiene():
    # a justification-free disable is no suppression at all: the R9
    # finding survives AND the hygiene rule flags the naked directive
    src = R9_POSITIVE.replace(
        "return self.pending[0]",
        "return self.pending[0]  # graftlint: disable=R9")
    assert sorted(rules_of(lint(src))) == ["R0", "R9"]


def test_r9_r10_baseline_roundtrip(tmp_path):
    findings = lint(R9_POSITIVE)
    assert rules_of(findings) == ["R9"]
    path = tmp_path / "baseline.json"
    write_baseline(findings, str(path))
    kept, baselined = subtract_baseline(findings, load_baseline(str(path)))
    assert kept == [] and baselined == 1


def test_baseline_roundtrip_and_line_drift(tmp_path):
    src_v1 = "import time\n\ndef f():\n    return time.time()\n"
    p = tmp_path / "mod.py"
    p.write_text(src_v1)
    findings = run_lint([str(p)], root=str(tmp_path))
    assert rules_of(findings) == ["R4"]

    bl = tmp_path / "baseline.json"
    write_baseline(findings, str(bl))
    loaded = load_baseline(str(bl))
    fresh, matched = subtract_baseline(findings, loaded)
    assert fresh == [] and matched == 1

    # unrelated edits above the finding shift its line; the fingerprint
    # (rule+path+snippet+occurrence) still matches
    p.write_text("import time\n\nPAD = 1\nPAD2 = 2\n\ndef f():\n    return time.time()\n")
    drifted = run_lint([str(p)], root=str(tmp_path))
    assert rules_of(drifted) == ["R4"] and drifted[0].line == 7
    fresh, matched = subtract_baseline(drifted, loaded)
    assert fresh == [] and matched == 1

    # a genuinely NEW finding of the same shape is not absorbed
    p.write_text("import time\n\ndef f():\n    return time.time()\n\n"
                 "def g():\n    return time.time()\n")
    doubled = run_lint([str(p)], root=str(tmp_path))
    assert len(doubled) == 2
    fresh, matched = subtract_baseline(doubled, loaded)
    assert matched == 1 and len(fresh) == 1


def test_render_json_shape():
    f = Finding("a.py", 3, 0, "R4", "msg", "time.time()")
    payload = json.loads(render_json([f], baselined=2))
    assert payload["counts"] == {"R4": 1}
    assert payload["baselined"] == 2
    assert payload["findings"][0]["fingerprint"] == f.fingerprint()
    assert "a.py:3:1: R4 msg" in render_text([f])
    assert per_rule_counts([f, f]) == {"R4": 2}


def test_baseline_sibling_ambiguity_is_labeled():
    # line-free fingerprints can't tell identical snippets apart: when a
    # NEW copy of a baselined snippet appears, which line gets blamed is
    # positional — the surviving finding must say so explicitly
    src1 = "import time\n\ndef a():\n    return time.time()\n"
    base_entries = {
        f.fingerprint(): {"rule": f.rule, "path": f.path,
                          "snippet": " ".join(f.snippet.split()),
                          "occurrence": f.occurrence}
        for f in lint_source(src1, filename="t.py", select=("R4",))
    }
    src2 = ("import time\n\ndef z():\n    return time.time()\n\n"
            "def a():\n    return time.time()\n")
    fresh, matched = subtract_baseline(
        lint_source(src2, filename="t.py", select=("R4",)), base_entries
    )
    assert matched == 1 and len(fresh) == 1
    assert "identical baselined occurrence" in fresh[0].message
    # no siblings -> no warning noise
    fresh2, _ = subtract_baseline(
        lint_source(src1, filename="other.py", select=("R4",)), base_entries
    )
    assert "identical baselined" not in fresh2[0].message


def test_taint_fixpoint_guard_fails_loud(monkeypatch):
    # the iteration guard is a backstop against analysis bugs: tripping
    # it must raise, never silently report partial R1/R2 coverage clean
    from kubernetes_tpu_torch.lint import rules as rules_mod

    chain = ("from kubernetes_tpu_torch.ops import device_loop\n\n"
             "def f0(x, state, first, tag):\n    return f1(x), state, None\n"
             + "".join(f"\ndef f{i}(x):\n    return f{i + 1}(x)\n"
                       for i in range(1, 10))
             + "\ndef f10(x):\n    return x\n"
             "\ndef solve(x, s, v):\n"
             "    return device_loop.run(f0, x, s, v, 4, statics=('c',))\n")
    monkeypatch.setattr(rules_mod, "_FIXPOINT_LIMIT", 3)
    with pytest.raises(RuntimeError, match="fixpoint exceeded"):
        lint_source(chain, filename="c.py", select=("R1",))
    monkeypatch.setattr(rules_mod, "_FIXPOINT_LIMIT", None)
    assert lint_source(chain, filename="c.py", select=("R1",)) == []


# --------------------------------------------------------------------------
# testing.lint_clean
# --------------------------------------------------------------------------

def test_lint_clean_accepts_clean_kernel_source():
    from kubernetes_tpu_torch.testing import lint_clean

    lint_clean(textwrap.dedent("""
    import torch

    def kernel(x, mask):
        return torch.where(mask, x, 0.0).sum(1)
    """))


def test_lint_clean_raises_with_findings_listed():
    from kubernetes_tpu_torch.testing import lint_clean

    with pytest.raises(AssertionError) as e:
        lint_clean(textwrap.dedent("""
        def kernel(x):
            if x > 0:
                return x
            return -x
        """))
    assert "R1" in str(e.value)


def test_lint_clean_capture_all_uses_call_site_taint_for_called_helpers():
    # a helper the snippet calls is NOT force-rooted: it inherits taint
    # from its call sites, so branching on a static shape is fine ...
    from kubernetes_tpu_torch.testing import lint_clean

    src = textwrap.dedent("""
    def _pick_block(n):
        if n > 128:
            return 128
        return n

    def kernel(x):
        return x * _pick_block(x.shape[0])
    """)
    lint_clean(src)
    # ... but a tensor flowing into the same helper is still caught
    with pytest.raises(AssertionError) as e:
        lint_clean(src.replace("_pick_block(x.shape[0])", "_pick_block(x)"))
    assert "R1" in str(e.value)


def test_lint_clean_never_passes_unparseable_source():
    # every rule but R6 is vacuous on source that does not parse, so the
    # helper forces the syntax gate into ANY rule selection
    from kubernetes_tpu_torch.testing import lint_clean

    for bad in ("def kernel(x:\n    pass\n",
                "def render(rows):\n    return f\"{'\\n'.join(rows)}\"\n"):
        with pytest.raises(AssertionError) as e:
            lint_clean(bad, rules=("R1",))
        assert "R6" in str(e.value)


def test_lint_clean_on_real_ops_module():
    # assign.py mixes round programs with deliberate host-boundary
    # functions (validate_solution), so it lints via its real
    # device_loop.run roots; the split kernels' module lints whole
    import kubernetes_tpu_torch.ops.assign as assign
    import kubernetes_tpu_torch.parallel.collectives as coll
    from kubernetes_tpu_torch.testing import lint_clean

    lint_clean(assign, rules=("R1", "R3", "R5"), capture_all=False)
    lint_clean(coll, rules=("R1", "R3", "R5"), capture_all=False)
