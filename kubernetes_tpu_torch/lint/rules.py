"""graftlint rule implementations for the PyTorch port.

R1 is the deep one: a cross-file, interprocedural taint pass that starts
from every capture root's tensor parameters (``ctx`` and ``state`` of a
round body handed to ``device_loop.run``) and follows values through
assignments, field access and first-party call edges, flagging the Python
constructs that read a tensor on the host or give it a data-dependent
shape — what a CUDA graph capture cannot hold. The other rules are
syntactic scans scoped by the same capture call graph (R2) or by file
class (R4/R5/R7/R8) — cheap by design so the CPU suite can afford to run
the whole thing on every change.

Taint lattice: ``None < "pytree" < "maybe" < "array"``.

- ``"array"`` — definitely a device tensor (torch result, field access
  on a tensor bundle). Everything flags: truthiness, conversion,
  iteration, membership.
- ``"maybe"`` — unknown (unannotated parameter, element of a mixed
  container, opaque call result). Truthiness and conversions flag;
  iteration does not — iterating a NamedTuple of tensors is legal and
  common.
- ``"pytree"`` — definitely a container of tensors (dict/tuple literal,
  ``dict()``-family ctor). Containers have host truthiness, so only
  element access re-taints.

Parameter type annotations refine the entry kind: ``x: torch.Tensor`` →
array, ``hoisted: Dict[...] | None`` → pytree, ``reverse: bool`` /
``name: str`` → host. Comparisons against string constants are host
metadata checks (``kind == "full"``) and never taint.

Round 0 of a captured loop runs eagerly, outside the graph
(``ops/device_loop.py``): the body of ``if first:`` (or ``if x and
first:``) in a round body is judged by R2/R7, not R1.
"""

from __future__ import annotations

import ast
import re
import sys
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

from kubernetes_tpu_torch.lint.engine import (
    RULE_IDS,
    FileInfo,
    Finding,
    FuncRecord,
    Project,
    dotted_name,
    first_only_test,
    is_partial,
    local_binding,
    loop_bodies,
    loop_run_statics,
    register_rule,
    resolve_dotted,
)

# --- taint lattice ---------------------------------------------------------

_ORDER = {None: 0, "pytree": 1, "maybe": 2, "array": 3}

#: kinds whose truthiness / host conversion a capture cannot survive
_HAZARD_KINDS = ("maybe", "array")


def _join(a: Optional[str], b: Optional[str]) -> Optional[str]:
    return a if _ORDER[a] >= _ORDER[b] else b


#: annotation leaf name -> entry taint kind. None means host value
#: (trusted, never a tensor); absent leaves mean "maybe".
_ANNOTATION_KINDS = {
    "tensor": "array", "ndarray": "array", "array": "array",
    "arraylike": "array",
    "dict": "pytree", "mapping": "pytree", "defaultdict": "pytree",
    "list": "pytree", "tuple": "pytree", "sequence": "pytree",
    "set": "pytree", "frozenset": "pytree", "iterable": "pytree",
    "bool": None, "str": None, "bytes": None, "callable": None,
    "none": None, "nonetype": None, "int": None, "float": None,
    "device": None, "dtype": None,
}


def _annotation_kind(ann: Optional[ast.expr]) -> Tuple[Optional[str], bool]:
    """(entry kind, recognized?) for a parameter annotation. Optional[X]
    and ``X | None`` unwrap to X; unions join their parts."""
    if ann is None:
        return "maybe", False
    if isinstance(ann, ast.Constant):
        if ann.value is None:  # the `| None` / Optional member
            return None, True
        if isinstance(ann.value, str):  # string annotation
            leaf = ann.value.split("[")[0].split(".")[-1].strip().lower()
            if leaf in _ANNOTATION_KINDS:
                return _ANNOTATION_KINDS[leaf], True
        return "maybe", False
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        k1, r1 = _annotation_kind(ann.left)
        k2, r2 = _annotation_kind(ann.right)
        if r1 and r2:
            return _join(k1, k2), True
        # `DevicePods | None`: an unrecognized union member means the
        # value can be anything — do not let the recognized side pin it
        return "maybe", False
    if isinstance(ann, ast.Subscript):
        base = dotted_name(ann.value)
        leaf = (base or "").split(".")[-1].lower()
        if leaf in ("optional", "union"):
            parts = (ann.slice.elts if isinstance(ann.slice, ast.Tuple)
                     else [ann.slice])
            kind: Optional[str] = None
            recognized = True
            for p in parts:
                k, r = _annotation_kind(p)
                recognized &= r
                kind = _join(kind, k)
            return (kind, True) if recognized else ("maybe", False)
        return _annotation_kind(ann.value)
    name = dotted_name(ann)
    if name is not None:
        leaf = name.split(".")[-1].lower()
        if leaf in _ANNOTATION_KINDS:
            return _ANNOTATION_KINDS[leaf], True
    return "maybe", False


def _param_pins(rec: FuncRecord) -> Dict[str, Tuple[Optional[str], bool]]:
    """Per-parameter (annotation kind, recognized) for a function."""
    a = rec.node.args
    return {p.arg: _annotation_kind(p.annotation)
            for p in a.posonlyargs + a.args + a.kwonlyargs}


#: attribute projections of a tensor that are plain host values (safe to
#: branch on): its metadata, fixed when the graph is captured
STATIC_ATTRS = {
    "shape", "dtype", "ndim", "device", "is_cuda", "layout",
    "requires_grad", "itemsize", "nbytes", "is_sparse",
}

#: tensor methods whose result is host metadata, never a device value
_HOST_METHODS = {
    "size", "dim", "numel", "nelement", "element_size", "stride",
    "is_contiguous", "data_ptr", "get_device", "is_floating_point",
    "storage_offset",
}

#: builtins whose result is a host value even on a tensor
_HOST_RESULT_CALLS = {
    "len", "range", "isinstance", "issubclass", "type", "id", "repr",
    "str", "callable", "print", "format", "hasattr",
}

#: conversions that force a concrete value out of a tensor (R1)
_CONVERSIONS = {"bool", "int", "float", "complex"}

#: tensor methods that read device values to the host (R1 in a captured
#: body, R2 in the hot host loop, R7 outside the boundary)
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}

#: tensor methods and torch functions whose output shape depends on the
#: data: the capture has to read the tensor to size them (R1)
_DATA_SHAPE_METHODS = {"nonzero", "masked_select", "unique",
                       "unique_consecutive", "argwhere"}
_DATA_SHAPE_CALLS = {"torch." + m for m in _DATA_SHAPE_METHODS}

#: torch calls that build a tensor from host data: an upload the graph
#: would replay with the capture's values baked in (R1)
_HOST_DATA_CALLS = {"torch.tensor", "torch.as_tensor", "torch.from_numpy"}

#: call targets that read a whole tensor back (R2/R7/R8)
_SYNC_CALLS = {"numpy.asarray", "numpy.array", "numpy.ascontiguousarray"}

#: R2 only: the device-wide barrier
_BARRIER_CALLS = {"torch.cuda.synchronize"}

#: host functions that form the per-cycle solve loop (R2 hot scope) in
#: addition to every capture-context function. schedule_cycle itself is
#: the documented host boundary (results must come back to bind) and is
#: deliberately NOT in this set.
HOT_FUNC_NAMES = {
    "Scheduler._run_tier", "Scheduler._solve_ladder", "Scheduler._exact_solve",
    "validate_solution", "greedy_assign", "batch_assign",
}

#: modules the taint pass does not follow into: the shard-program runners
#: (``solo``, ``lockstep``) and request constructors of the partitioned
#: solve, host plumbing that dispatches on request kinds. Like a
#: control-flow transform in the reference, a call into them returns a
#: tensor when its arguments are tensors.
_CAPTURE_OPAQUE_PREFIXES = ("kubernetes_tpu_torch.parallel.collectives.",)

#: modules whose tensors must stay float32 (R5): the device-math layer
#: plus the host oracles that feed it
_DTYPE_SCOPE_MARKERS = ("/ops/", "/parallel/")
_DTYPE_SCOPE_FILES = ("native.py",)

_F64_ATTRS = {
    "numpy.float64", "numpy.double", "numpy.float128", "numpy.longdouble",
    "numpy.complex128", "torch.float64", "torch.double", "torch.complex128",
    "torch.cdouble",
}

#: top-level directories and root files that hold harnesses, not the
#: production modules: tests, offline scripts and the card's smoke run
#: read device values by design
_HARNESS_TOPDIRS = ("tests", "tests_tpu", "scripts")
_HARNESS_FILES = ("chip_smoke.py", "bench.py")


def _is_harness(fi: FileInfo) -> bool:
    rel = fi.relpath.replace("\\", "/")
    return (rel.split("/", 1)[0] in _HARNESS_TOPDIRS
            or rel in _HARNESS_FILES)


def _imports_torch(fi: FileInfo) -> bool:
    return any(v == "torch" or v.startswith("torch.")
               for v in fi.imports.values())


def _is_cpu_device(node: ast.expr) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and dotted_name(node.func) in (
            "torch.device", "device") and node.args:
        return _is_cpu_device(node.args[0])
    return False


def _to_cpu_call(node: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    if node.args and _is_cpu_device(node.args[0]):
        return True
    return any(kw.arg == "device" and _is_cpu_device(kw.value)
               for kw in node.keywords)


def _read_method(node: ast.Call) -> Optional[str]:
    """The device-read spelling of a method call (``.tolist()``,
    ``.item()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``), else None."""
    if isinstance(node.func, ast.Attribute):
        if node.func.attr in _SYNC_METHODS:
            return f".{node.func.attr}()"
        if _to_cpu_call(node):
            return '.to("cpu")'
    return None


#: the declared reads of ops/sync.py (counted, sync-debug-mode aware)
_BOUNDARY_READS = {"to_host", "to_cpu"}


def _is_host_read(node: ast.Call, imports: Dict[str, str]) -> bool:
    """A sanctioned host read: ``to_host``/``to_cpu`` of ops/sync.py, or
    a telemetry ``.readback(site, x)`` (which calls ``to_host``)."""
    if isinstance(node.func, ast.Attribute) and node.func.attr == "readback":
        return True
    full = resolve_dotted(dotted_name(node.func), imports) or ""
    leaf = full.split(".")[-1]
    return leaf in _BOUNDARY_READS and (
        full == leaf or full.endswith("sync." + leaf))


def _host_read_name(node: ast.Call) -> str:
    if isinstance(node.func, ast.Attribute):
        return "." + node.func.attr + "()"
    return (dotted_name(node.func) or "read") + "()"


def _is_host_request(node: ast.expr, imports: Dict[str, str]) -> bool:
    """``coll.host(x)``: a shard program's request for one host read."""
    if not isinstance(node, ast.Call):
        return False
    full = resolve_dotted(dotted_name(node.func), imports) or ""
    return full.endswith("collectives.host")


_HOST_LEAVES = {"bool", "int", "float", "str", "bytes", "none", "complex"}
_HOST_CONTAINERS = {"tuple", "list", "sequence", "set", "frozenset"}


def _host_annotation(ann: Optional[ast.expr]) -> bool:
    """Does a return annotation declare a host value: a scalar, None, or
    a tuple/list of them (``Tuple[int, ...]``)?"""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant):
        if ann.value is None or ann.value is Ellipsis:
            return True
        if isinstance(ann.value, str):
            try:
                return _host_annotation(ast.parse(ann.value,
                                                  mode="eval").body)
            except SyntaxError:
                return False
        return False
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return _host_annotation(ann.left) and _host_annotation(ann.right)
    if isinstance(ann, ast.Subscript):
        leaf = (dotted_name(ann.value) or "").split(".")[-1].lower()
        if leaf not in _HOST_CONTAINERS | {"optional", "union"}:
            return False
        parts = (ann.slice.elts if isinstance(ann.slice, ast.Tuple)
                 else [ann.slice])
        return all(_host_annotation(p) for p in parts)
    name = dotted_name(ann)
    return name is not None and name.split(".")[-1].lower() in _HOST_LEAVES


# ==========================================================================
# R1 — capture safety (interprocedural taint)
# ==========================================================================

class _FnAnalysis:
    """Analyze one function under a parameter-taint assignment.

    Flow-sensitive single-environment walk. Loop bodies are walked
    twice so loop-carried taint settles (`a = x` at the bottom of the
    body reaches an `if a:` at the top on the second walk); the hazard
    dict is keyed by (line, col, message), so re-walks never duplicate
    findings. Nested defs/lambdas are walked inline with their
    parameters tainted "maybe" (annotation-refined). An ``if first:``
    body of a round runs eagerly: it is walked for its bindings with
    flagging and call propagation off.
    """

    def __init__(self, rec: FuncRecord, param_taint: Dict[str, Optional[str]],
                 project: Project) -> None:
        self.rec = rec
        self.fi = rec.file
        self.project = project
        self.param_taint = {k: v for k, v in param_taint.items() if v}
        self.env: Dict[str, Optional[str]] = {}
        self.boolish: Set[str] = set()
        self.calls: Dict[str, Dict[str, str]] = {}  # callee qual -> param taint
        self.callee_recs: Dict[str, FuncRecord] = {}
        self.hazards: Dict[Tuple[int, int, str], Finding] = {}
        self.collect = False
        self.eager = False

    # -- entry --

    def run(self, collect: bool) -> None:
        self.collect = collect
        self.env = dict(self.param_taint)
        for stmt in self.rec.node.body:
            self.stmt(stmt)

    def findings(self) -> List[Finding]:
        return [self.hazards[k] for k in sorted(self.hazards)]

    def _flag(self, node: ast.AST, message: str) -> None:
        if not self.collect or self.eager:
            return
        key = (node.lineno, node.col_offset, message)
        self.hazards[key] = self.fi.finding(
            node, "R1", f"{message} in captured `{self.rec.name}`"
        )

    def _edge(self, callee: FuncRecord, taints: Dict[str, str]) -> None:
        if self.eager or not taints:
            return
        merged = self.calls.setdefault(callee.qual, {})
        for p, k in taints.items():
            merged[p] = _join(merged.get(p), k) or k
        self.callee_recs[callee.qual] = callee

    # -- statements --

    def stmt(self, node: ast.stmt) -> None:
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = node.value
            kind = self.eval(value) if value is not None else None
            if isinstance(node, ast.AugAssign):
                kind = _join(kind, self.eval_target_as_expr(node.target))
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            boolish = value is not None and self._boolish(value)
            for t in targets:
                self.bind(t, kind)
                self._mask_target(t)
                if isinstance(t, ast.Name):
                    if boolish:
                        self.boolish.add(t.id)
                    else:
                        self.boolish.discard(t.id)
        elif isinstance(node, (ast.Expr, ast.Return)):
            if node.value is not None:
                self.eval(node.value)
        elif isinstance(node, ast.If):
            self.truthiness(node.test, "`if` branch on a tensor")
            if first_only_test(node.test, self.rec.first_params):
                eager, self.eager = self.eager, True
                for s in node.body:
                    self.stmt(s)
                self.eager = eager
                for s in node.orelse:
                    self.stmt(s)
            else:
                for s in node.body + node.orelse:
                    self.stmt(s)
        elif isinstance(node, ast.While):
            self.truthiness(node.test, "`while` condition on a tensor")
            for _ in range(2):
                for s in node.body:
                    self.stmt(s)
                # the condition re-runs on loop-carried taint
                self.truthiness(node.test, "`while` condition on a tensor")
            for s in node.orelse:
                self.stmt(s)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            k = self.eval(node.iter)
            if k == "array":
                self._flag(node.iter, "iteration over a tensor (unrolls "
                                      "per row at capture; keep it "
                                      "vectorized)")
            for _ in range(2):
                self.bind(node.target,
                          "array" if k == "array" else ("maybe" if k else None))
                for s in node.body:
                    self.stmt(s)
            for s in node.orelse:
                self.stmt(s)
        elif isinstance(node, ast.Match):
            k = self.eval(node.subject)
            if k in _HAZARD_KINDS:
                self._flag(node.subject,
                           "`match` on a tensor (pattern matching reads "
                           "it on the host — use torch.where)")
            for case in node.cases:
                self._bind_pattern(case.pattern,
                                   "maybe" if k in _HAZARD_KINDS else None)
                if case.guard is not None:
                    self.truthiness(case.guard, "`case` guard on a tensor")
                for s in case.body:
                    self.stmt(s)
        elif isinstance(node, ast.Assert):
            self.truthiness(node.test, "`assert` on a tensor")
            if node.msg is not None:
                self.eval(node.msg)
        elif isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                k = self.eval(item.context_expr)
                if item.optional_vars is not None:
                    self.bind(item.optional_vars, k)
            for s in node.body:
                self.stmt(s)
        elif isinstance(node, ast.Try):
            for s in node.body + node.orelse + node.finalbody:
                self.stmt(s)
            for h in node.handlers:
                for s in h.body:
                    self.stmt(s)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            for p in a.posonlyargs + a.args + a.kwonlyargs:
                kind, known = _annotation_kind(p.annotation)
                self.env[p.arg] = kind if known else "maybe"
            for s in node.body:
                self.stmt(s)
            self.env[node.name] = None
        elif isinstance(node, ast.ClassDef):
            for s in node.body:
                self.stmt(s)
        elif isinstance(node, (ast.Delete,)):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.env[t.id] = None
        # Pass/Break/Continue/Import/Global/Nonlocal: nothing to do
        elif isinstance(node, ast.Raise):
            if node.exc is not None:
                self.eval(node.exc)

    def _bind_pattern(self, pat: ast.pattern, kind: Optional[str]) -> None:
        """Bind capture names of a match-case pattern; destructuring a
        tensor subject yields tensor pieces."""
        if isinstance(pat, ast.MatchAs):
            if pat.pattern is not None:
                self._bind_pattern(pat.pattern, kind)
            if pat.name:
                self.env[pat.name] = kind
        elif isinstance(pat, ast.MatchStar):
            if pat.name:
                self.env[pat.name] = kind
        elif isinstance(pat, ast.MatchMapping):
            for p in pat.patterns:
                self._bind_pattern(p, kind)
            if pat.rest:
                self.env[pat.rest] = kind
        elif isinstance(pat, (ast.MatchSequence, ast.MatchOr)):
            for p in pat.patterns:
                self._bind_pattern(p, kind)
        elif isinstance(pat, ast.MatchClass):
            for p in list(pat.patterns) + list(pat.kwd_patterns):
                self._bind_pattern(p, kind)
        elif isinstance(pat, ast.MatchValue):
            self.eval(pat.value)

    def bind(self, target: ast.AST, kind: Optional[str]) -> None:
        if isinstance(target, ast.Name):
            self.env[target.id] = kind
        elif isinstance(target, (ast.Tuple, ast.List)):
            elt_kind = kind if kind is None else (
                "array" if kind == "array" else "maybe"
            )
            for e in target.elts:
                self.bind(e, elt_kind)
        elif isinstance(target, ast.Starred):
            self.bind(target.value, "maybe" if kind else None)
        # Attribute/Subscript targets mutate containers: no new name taint

    def eval_target_as_expr(self, target: ast.AST) -> Optional[str]:
        if isinstance(target, ast.Name):
            return self.env.get(target.id)
        return None

    # -- boolean masks --

    def _boolish(self, node: ast.expr) -> bool:
        """Is ``node`` (syntactically) a boolean tensor: a comparison, a
        ``~``/``&``/``|``/``^`` of one, a name bound to one, or a torch
        predicate?"""
        if isinstance(node, ast.Compare):
            return not all(isinstance(o, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                           for o in node.ops)
        if isinstance(node, ast.Name):
            return node.id in self.boolish
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return True  # `~mask`: the logical-not spelling of a mask
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self._boolish(node.left) or self._boolish(node.right)
        if isinstance(node, ast.Call):
            full = resolve_dotted(dotted_name(node.func), self.fi.imports) or ""
            if full in ("torch.isfinite", "torch.isnan", "torch.isinf",
                        "torch.logical_and", "torch.logical_or",
                        "torch.logical_not", "torch.isin"):
                return True
            if isinstance(node.func, ast.Attribute) and node.func.attr == "bool":
                return True
        return False

    def _mask_index(self, node: ast.Subscript) -> bool:
        if self.eval_quiet(node.value) not in _HAZARD_KINDS:
            return False
        parts = (node.slice.elts if isinstance(node.slice, ast.Tuple)
                 else [node.slice])
        return any(self._boolish(p) for p in parts)

    def _mask_target(self, target: ast.AST) -> None:
        if isinstance(target, ast.Subscript) and self._mask_index(target):
            self._flag(target, "boolean-mask index assignment (its size "
                               "depends on the data — use torch.where)")
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._mask_target(e)

    def eval_quiet(self, node: ast.expr) -> Optional[str]:
        """The taint of ``node`` without flagging or call edges."""
        collect, eager = self.collect, self.eager
        self.collect, self.eager = False, True
        try:
            return self.eval(node)
        finally:
            self.collect, self.eager = collect, eager

    # -- truthiness contexts --

    def truthiness(self, test: ast.expr, message: str) -> None:
        if isinstance(test, ast.Compare) and all(
            isinstance(o, (ast.Is, ast.IsNot)) for o in test.ops
        ):
            # `x is None` never calls __bool__ on a tensor — the blessed
            # Optional-arg branch form
            for v in [test.left] + test.comparators:
                self.eval(v)
            return
        if isinstance(test, ast.BoolOp):
            for v in test.values:
                self.truthiness(v, message)
            return
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            self.truthiness(test.operand, message)
            return
        k = self.eval(test)
        if k in _HAZARD_KINDS:
            self._flag(test, message + " (use torch.where)")

    # -- expressions --

    def eval(self, node: ast.expr) -> Optional[str]:  # noqa: C901
        if isinstance(node, ast.Name):
            return self.env.get(node.id)
        if isinstance(node, ast.Constant):
            return None
        if isinstance(node, ast.Attribute):
            base = self.eval(node.value)
            if node.attr in STATIC_ATTRS:
                return None
            if base in _HAZARD_KINDS:
                return "array"
            return "maybe" if base else None
        if isinstance(node, ast.Subscript):
            base = self.eval(node.value)
            self.eval(node.slice)
            if self._mask_index(node):
                self._flag(node, "boolean-mask indexing (its size depends "
                                 "on the data — use torch.where)")
            if base == "array":
                return "array"
            return "maybe" if base else None
        if isinstance(node, ast.Call):
            return self.eval_call(node)
        if isinstance(node, ast.BinOp):
            return _join(self.eval(node.left), self.eval(node.right))
        if isinstance(node, ast.UnaryOp):
            k = self.eval(node.operand)
            if isinstance(node.op, ast.Not):
                if k in _HAZARD_KINDS:
                    self._flag(node, "`not` on a tensor")
                return None
            return k
        if isinstance(node, ast.BoolOp):
            # `a and b` outside an `if` still calls bool(a)
            out: Optional[str] = None
            for i, v in enumerate(node.values):
                k = self.eval(v)
                if k in _HAZARD_KINDS and i < len(node.values) - 1:
                    self._flag(v, "`and`/`or` short-circuit on a tensor")
                out = _join(out, k)
            return out
        if isinstance(node, ast.Compare):
            operands = [node.left] + list(node.comparators)
            kinds = [self.eval(v) for v in operands]
            if all(isinstance(o, (ast.Is, ast.IsNot)) for o in node.ops):
                return None
            if any(isinstance(v, ast.Constant) and isinstance(v.value, str)
                   for v in operands):
                # comparing against a string constant is a host metadata
                # check (`kind == "full"`) — tensors don't compare to str
                return None
            if any(kinds) and len(node.ops) > 1:
                self._flag(node, "chained comparison on tensors "
                                 "(implicit `and` calls bool())")
            if "array" in kinds and any(isinstance(o, (ast.In, ast.NotIn))
                                        for o in node.ops):
                self._flag(node, "membership test on a tensor")
            if "array" in kinds:
                return "array"
            return "maybe" if "maybe" in kinds else None
        if isinstance(node, ast.IfExp):
            self.truthiness(node.test, "conditional expression on a tensor")
            return _join(self.eval(node.body), self.eval(node.orelse))
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            kinds = [self.eval(e) for e in node.elts]
            return "pytree" if any(kinds) else None
        if isinstance(node, ast.Dict):
            kinds = [self.eval(v) for v in node.values if v is not None]
            kinds += [self.eval(k) for k in node.keys if k is not None]
            return "pytree" if any(kinds) else None
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            self._comp_generators(node.generators)
            k = self.eval(node.elt)
            return "pytree" if k else None
        if isinstance(node, ast.DictComp):
            self._comp_generators(node.generators)
            k = _join(self.eval(node.key), self.eval(node.value))
            return "pytree" if k else None
        if isinstance(node, ast.Lambda):
            a = node.args
            for p in a.posonlyargs + a.args + a.kwonlyargs:
                self.env[p.arg] = "maybe"
            self.eval(node.body)
            return None
        if isinstance(node, ast.Starred):
            return self.eval(node.value)
        if isinstance(node, ast.NamedExpr):
            k = self.eval(node.value)
            self.bind(node.target, k)
            return k
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                self.eval(v)
            return None
        if isinstance(node, ast.FormattedValue):
            self.eval(node.value)
            return None
        if isinstance(node, (ast.Await, ast.YieldFrom)):
            return self.eval(node.value)
        if isinstance(node, ast.Yield):
            if node.value is None:
                return None
            k = self.eval(node.value)
            if _is_host_request(node.value, self.fi.imports):
                self._flag(node, "`coll.host` reads a tensor on the host "
                                 "(a counted sync)")
                return None  # the shard program resumes with a host value
            return k
        if isinstance(node, ast.Slice):
            for part in (node.lower, node.upper, node.step):
                if part is not None:
                    self.eval(part)
            return None
        return None

    def _comp_generators(self, gens) -> None:
        for g in gens:
            k = self.eval(g.iter)
            if k == "array":
                self._flag(g.iter, "iteration over a tensor (unrolls per "
                                   "row at capture; keep it vectorized)")
            self.bind(g.target,
                      "array" if k == "array" else ("maybe" if k else None))
            for cond in g.ifs:
                self.truthiness(cond, "comprehension filter on a tensor")

    def eval_call(self, node: ast.Call) -> Optional[str]:  # noqa: C901
        arg_kinds = [self.eval(a) for a in node.args]
        kw_kinds = {kw.arg: self.eval(kw.value) for kw in node.keywords}
        all_kinds = arg_kinds + list(kw_kinds.values())
        any_taint = any(all_kinds)
        hazard_arg = any(k in _HAZARD_KINDS for k in all_kinds)
        name = dotted_name(node.func)
        full = resolve_dotted(name, self.fi.imports)

        # self.meth(...) / cls.meth(...): resolve within the enclosing
        # class and thread argument taint through like any first-party
        # call — without this, interprocedural R1/R2 stops dead at every
        # method boundary of class-structured round code
        if (isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in ("self", "cls")
                and "." in self.rec.name):
            cls_prefix = self.rec.name.rsplit(".", 1)[0] + "."
            meth = self.fi.functions.get(cls_prefix + node.func.attr)
            if meth is not None:
                recv = self.env.get(node.func.value.id)
                taints: Dict[str, str] = {}
                if recv and meth.params:
                    taints[meth.params[0]] = recv  # receiver slot
                for i, k in enumerate(arg_kinds):
                    if (k and i + 1 < len(meth.params)
                            and not any(isinstance(a, ast.Starred)
                                        for a in node.args[: i + 1])):
                        taints[meth.params[i + 1]] = k
                for kwname, k in kw_kinds.items():
                    if k and kwname and kwname in meth.params:
                        taints[kwname] = k
                self._edge(meth, taints)
                if _host_annotation(meth.node.returns):
                    return None
                return "maybe" if (any_taint or recv) else None

        # method-style: base.method(...)
        if isinstance(node.func, ast.Attribute):
            base = self.eval(node.func.value)
            attr = node.func.attr
            if base in _HAZARD_KINDS:
                read = _read_method(node)
                if read is not None:
                    self._flag(node, f"`{read}` reads a tensor on the host")
                    return None
                if attr in _DATA_SHAPE_METHODS:
                    self._flag(node, f"`.{attr}()` has a data-dependent "
                                     "shape (the capture must read the "
                                     "tensor to size it)")
                    return "array"
                if attr in _HOST_METHODS:
                    return None
                return "array"
            if base == "pytree":
                # dict/tuple methods (.items(), .get(), .keys()) return
                # host iterables whose elements may be tensors
                return "maybe"

        if _is_host_read(node, self.fi.imports):
            # the sanctioned reads return host values; in a captured
            # round they are a sync the capture cannot hold
            self._flag(node, f"`{_host_read_name(node)}` reads a tensor on "
                             "the host (a counted sync)")
            return None
        if full in _HOST_RESULT_CALLS:
            return None
        if full in _CONVERSIONS:
            if hazard_arg:
                self._flag(node, f"`{full}()` on a tensor")
            return None
        if full in ("dict", "list", "tuple", "set", "frozenset", "sorted",
                    "reversed", "zip", "enumerate"):
            return "pytree" if any_taint else None
        if full and (full == "torch" or full.startswith("torch.")
                     or full.startswith("numpy.")):
            if full in _DATA_SHAPE_CALLS and any_taint:
                self._flag(node, f"`{full}` has a data-dependent shape "
                                 "(the capture must read the tensor to "
                                 "size it)")
            elif (full == "torch.where" and len(node.args) == 1
                  and not node.keywords):
                self._flag(node, "one-argument `torch.where` has a "
                                 "data-dependent shape (it is `nonzero`)")
            elif (full in _HOST_DATA_CALLS
                  and not (arg_kinds and arg_kinds[0] in _HAZARD_KINDS)):
                self._flag(node, f"`{full}` of host data uploads it at "
                                 "capture; the graph replays those values "
                                 "(build it outside the round, pass it "
                                 "in ctx)")
            # a first-party function passed by name into a torch call
            # (torch.vmap, torch.func ...) runs on tensors
            for a in node.args:
                if isinstance(a, (ast.Name, ast.Attribute)):
                    cb = self.project.resolve_name(dotted_name(a), self.fi)
                    if cb is not None and cb.params:
                        self._edge(cb, {p: "maybe" for p in cb.params})
            return "array" if any_taint else None
        if full and full.startswith(_CAPTURE_OPAQUE_PREFIXES):
            # the shard-program runners and collective requests: host
            # plumbing around the programs, not followed
            return "maybe" if any_taint else None

        callee = self.project.resolve_call(node, self.fi)
        if callee is not None:
            taints = {}
            for i, k in enumerate(arg_kinds):
                if k and not any(isinstance(a, ast.Starred)
                                 for a in node.args[: i + 1]):
                    if i < len(callee.params):
                        taints[callee.params[i]] = k
            for kwname, k in kw_kinds.items():
                if k and kwname and kwname in callee.params:
                    taints[kwname] = k
            self._edge(callee, taints)
            if _host_annotation(callee.node.returns):
                # `-> bool` / `-> Tuple[int, ...]`: the declared contract
                # says the result is host metadata
                return None
        return "maybe" if any_taint else None


#: test hook: when set, overrides the computed fixpoint iteration budget
_FIXPOINT_LIMIT: Optional[int] = None


def _capture_taint_state(project: Project) -> Dict[str, Tuple[FuncRecord, Dict[str, str]]]:
    """Fixed-point interprocedural propagation from capture roots.
    Returns qual -> (record, param taints) for every function that runs
    in a captured round. Cached on the project (R1 and R2 share it)."""
    cached = getattr(project, "_graftlint_capture_state", None)
    if cached is not None:
        return cached
    state: Dict[str, Tuple[FuncRecord, Dict[str, str]]] = {}
    work: deque = deque()
    for rec in project.capture_roots():
        pins = _param_pins(rec)
        taint = {}
        for p in rec.params:
            if p in rec.static_params:
                continue
            kind, known = pins.get(p, ("maybe", False))
            kind = kind if known else "maybe"
            if kind:
                taint[p] = kind
        state[rec.qual] = (rec, taint)
        work.append(rec.qual)
    # monotone 4-level lattice: each function re-enters the worklist at
    # most a few times, so pops are bounded by ~levels × call edges. The
    # guard only exists to catch an analysis bug — tripping it must be
    # LOUD, never a silent truncation of R1/R2 coverage that lets the
    # gate pass with unanalyzed functions
    guard = 0
    guard_limit = _FIXPOINT_LIMIT or max(
        2000, 8 * sum(len(fi.functions) for fi in project.files)
    )
    while work:
        guard += 1
        if guard > guard_limit:
            raise RuntimeError(
                f"graftlint: interprocedural taint fixpoint exceeded "
                f"{guard_limit} iterations (still {len(work)} pending) — "
                "analysis bug or pathological call graph; refusing to "
                "report partial R1/R2 coverage as clean"
            )
        qual = work.popleft()
        rec, taint = state[qual]
        an = _FnAnalysis(rec, dict(taint), project)
        an.run(collect=False)
        for callee_qual, ptaints in an.calls.items():
            callee = an.callee_recs[callee_qual]
            pins = _param_pins(callee)
            if callee.capture_root:
                # statics of a root stay host even when called inline
                ptaints = {p: k for p, k in ptaints.items()
                           if p not in callee.static_params}
            prev = state.get(callee_qual)
            cur = dict(prev[1]) if prev else {}
            changed = prev is None
            for p, k in ptaints.items():
                kind, known = pins.get(p, ("maybe", False))
                if known:
                    # a recognized annotation pins the entry kind: the
                    # author's declared contract beats call-site guessing
                    k = kind
                    if not k:
                        continue
                nk = _join(cur.get(p), k)
                if nk != cur.get(p):
                    cur[p] = nk or k
                    changed = True
            if changed:
                state[callee_qual] = (callee, cur)
                work.append(callee_qual)
    project._graftlint_capture_state = state
    return state


@register_rule("R1")
def rule_r1_capture_safety(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for qual, (rec, taint) in sorted(_capture_taint_state(project).items()):
        an = _FnAnalysis(rec, dict(taint), project)
        an.run(collect=True)
        findings.extend(an.findings())
    return findings


# ==========================================================================
# R2 — host↔device sync in hot paths
# ==========================================================================

def _first_only_lines(rec: FuncRecord) -> Set[int]:
    """Lines of ``rec``'s ``if first:`` bodies (round 0, eager)."""
    out: Set[int] = set()
    if not rec.first_params:
        return out
    for node in ast.walk(rec.node):
        if isinstance(node, ast.If) and first_only_test(node.test,
                                                        rec.first_params):
            for s in node.body:
                out.update(range(s.lineno, (s.end_lineno or s.lineno) + 1))
    return out


@register_rule("R2")
def rule_r2_host_sync(project: Project) -> List[Finding]:
    captured = _capture_taint_state(project)
    findings: List[Finding] = []
    for fi in project.files:
        if fi.tree is None:
            continue
        for rec in fi.functions.values():
            hot = rec.qual in captured or rec.name in HOT_FUNC_NAMES \
                or rec.name.split(".")[-1] in HOT_FUNC_NAMES
            if not hot:
                continue
            in_capture = rec.qual in captured
            where = ("captured" if in_capture
                     else "hot-path") + f" `{rec.name}`"
            host = _HostValues(rec.node, fi.imports)
            for node in ast.walk(rec.node):
                if not isinstance(node, ast.Call):
                    continue
                full = resolve_dotted(dotted_name(node.func), fi.imports)
                read = _read_method(node)
                if full in _BARRIER_CALLS or (
                        full in _SYNC_CALLS
                        and _readback_desc(node, fi.imports, host)):
                    findings.append(fi.finding(
                        node, "R2",
                        f"`{full}` forces a host↔device sync inside {where} "
                        "(keep device values on device; move readback to "
                        "the cycle boundary)",
                    ))
                elif (read is not None and not in_capture
                      and _readback_desc(node, fi.imports, host)):
                    # in a captured body R1 already reports a tensor read
                    findings.append(fi.finding(
                        node, "R2",
                        f"`{read}` is a device sync inside {where}",
                    ))
    return findings


# ==========================================================================
# R3 — re-capture hazards
# ==========================================================================

#: the one module that captures CUDA graphs (cached per key)
_CAPTURE_SITE_MODULES = ("ops/device_loop.py",)
_GRAPH_CTORS = {"torch.cuda.CUDAGraph", "torch.cuda.graph",
                "torch.cuda.graphs.CUDAGraph", "torch.cuda.graphs.graph",
                "torch.cuda.make_graphed_callables"}
_COMPILE_CTORS = {"torch.compile", "torch.jit.script", "torch.jit.trace"}


@register_rule("R3")
def rule_r3_recapture(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for fi in project.files:
        if fi.tree is None:
            continue
        findings.extend(_r3_graph_outside_site(fi))
        findings.extend(_r3_compile_in_body(fi))
        findings.extend(_r3_partial_statics(fi, project))
    return findings


def _r3_graph_outside_site(fi: FileInfo) -> List[Finding]:
    """A CUDA graph captured anywhere but ``ops/device_loop.py``: a
    second capture site has no shared key and no cache, so its graph is
    either re-captured per call or replayed stale."""
    rel = fi.relpath.replace("\\", "/")
    if (any(rel.endswith(m) for m in _CAPTURE_SITE_MODULES)
            or "raph" not in fi.source):
        return []
    out = []
    for node in ast.walk(fi.tree):
        if isinstance(node, ast.Call):
            full = resolve_dotted(dotted_name(node.func), fi.imports)
            if full in _GRAPH_CTORS:
                out.append(fi.finding(
                    node, "R3",
                    f"`{full}` outside ops/device_loop.py, the one cached "
                    "capture site — a graph captured here is keyed by "
                    "nothing (re-captured per call, or replayed with "
                    "stale statics)",
                ))
    return out


def _r3_compile_in_body(fi: FileInfo) -> List[Finding]:
    """``torch.compile(...)`` / ``torch.jit.script(...)`` built inside a
    function or loop makes a fresh wrapper (an empty cache) per call — the
    recompile storm. Decorators and module-scope wrappers are the blessed
    forms."""
    findings: List[Finding] = []
    if "compile" not in fi.source and "jit" not in fi.source:
        return findings

    def walk(node: ast.AST, in_def: bool, in_loop: bool) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                walk(dec, in_def, in_loop)
            for s in node.body:
                walk(s, True, False)
            return
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            in_loop = True
        if isinstance(node, ast.Call):
            full = resolve_dotted(dotted_name(node.func), fi.imports)
            if full in _COMPILE_CTORS and (in_def or in_loop):
                site = "a loop" if in_loop else "a function body"
                findings.append(fi.finding(
                    node, "R3",
                    f"{full} built inside {site}: every call builds a "
                    "fresh wrapper with an empty cache — hoist to module "
                    "scope or memoize",
                ))
        for child in ast.iter_child_nodes(node):
            walk(child, in_def, in_loop)

    walk(fi.tree, False, False)
    return findings


def _names_in(node: Optional[ast.AST]) -> Set[str]:
    if node is None:
        return set()
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _dict_keys(expr: Optional[ast.AST]) -> Optional[Dict[str, ast.expr]]:
    """Keys -> values of a ``dict(k=v, ...)`` call or a ``{"k": v}``
    literal, else None."""
    if isinstance(expr, ast.Call) and dotted_name(expr.func) == "dict" \
            and not expr.args:
        if any(kw.arg is None for kw in expr.keywords):
            return None
        return {kw.arg: kw.value for kw in expr.keywords}
    if isinstance(expr, ast.Dict):
        out = {}
        for k, v in zip(expr.keys, expr.values):
            if not (isinstance(k, ast.Constant) and isinstance(k.value, str)):
                return None
            out[k.value] = v
        return out
    return None


def _statics_fn_keys(rec: FuncRecord, keys: Set[str]) -> Optional[Set[str]]:
    """Which keys of the dict ``rec`` takes as its first parameter does
    its result carry? It carries ``p["k"]``, and every key of a
    ``p.items()`` / ``p.keys()`` / ``p`` iteration its filters do not
    drop (``k not in ("a", "b")`` / ``k != "a"``). None when it cannot
    be read."""
    if not rec.params:
        return None
    p = rec.params[0]
    carried: Set[str] = set()
    read = False
    for node in ast.walk(rec.node):
        if (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name)
                and node.value.id == p and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)):
            carried.add(node.slice.value)
            read = True
        if isinstance(node, ast.comprehension):
            it = node.iter
            if isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute):
                it = it.func.value if it.func.attr in ("items", "keys") \
                    else None
            if not (isinstance(it, ast.Name) and it.id == p):
                continue
            tgt = node.target
            key = (tgt.elts[0] if isinstance(tgt, ast.Tuple) and tgt.elts
                   else tgt)
            if not isinstance(key, ast.Name):
                return None
            dropped: Set[str] = set()
            for cond in node.ifs:
                if not (isinstance(cond, ast.Compare)
                        and isinstance(cond.left, ast.Name)
                        and cond.left.id == key.id and len(cond.ops) == 1):
                    return None
                op, rhs = cond.ops[0], cond.comparators[0]
                if isinstance(op, ast.NotIn) and isinstance(
                        rhs, (ast.Tuple, ast.List, ast.Set)):
                    dropped |= {e.value for e in rhs.elts
                                if isinstance(e, ast.Constant)}
                elif isinstance(op, ast.NotEq) and isinstance(rhs, ast.Constant):
                    dropped.add(rhs.value)
                else:
                    return None
            carried |= keys - dropped
            read = True
    return carried if read else None


def _first_only_reads(rec: FuncRecord, param: str) -> bool:
    """Is every read of ``param`` in ``rec`` inside an ``if first:``
    body? Then it reaches the graph only through round 0's tag, which is
    in the cache key."""
    lines = _first_only_lines(rec)
    loads = [n for n in ast.walk(rec.node)
             if isinstance(n, ast.Name) and n.id == param
             and isinstance(n.ctx, ast.Load)]
    return bool(lines) and all(n.lineno in lines for n in loads)


def _r3_partial_statics(fi: FileInfo, project: Project) -> List[Finding]:
    """A ``functools.partial`` round body handed to ``device_loop.run``:
    a bound keyword its ``statics`` does not carry is baked into the
    cached graph but missing from its key, so a later call with another
    value replays the stale one; a keyword that names no parameter of
    the round program is a TypeError at capture."""
    out: List[Finding] = []
    for call, func, body in loop_bodies(fi):
        if not is_partial(body, fi.imports):
            continue
        statics = loop_run_statics(call)
        if statics is None or (isinstance(statics, ast.Constant)
                               and statics.value is None):
            continue
        target = (fi.functions.get(body.args[0].id)
                  if isinstance(body.args[0], ast.Name) else None)
        values = [fi.functions[a.id] for a in body.args[1:]
                  if isinstance(a, ast.Name) and a.id in fi.functions]
        programs = ([target] if target is not None else []) + values
        kws: Dict[str, Optional[ast.expr]] = {}
        for kw in body.keywords:
            if kw.arg is not None:
                kws[kw.arg] = kw.value
                continue
            spread = kw.value
            if isinstance(spread, ast.Name):
                spread = local_binding(func, spread.id, call.lineno)
            keys = _dict_keys(spread)
            if keys is None:
                kws = {}
                break
            kws.update(keys)
        # the keywords reach the first program that takes them: the
        # partial's target, or (through its **kw) a program it passes on
        takes: Dict[str, FuncRecord] = {}
        for rec in programs:
            for p in rec.params:
                takes.setdefault(p, rec)
        receivers = (values if target is not None and values
                     and target.node.args.kwarg is not None else programs)
        open_kw = any(r.node.args.kwarg is not None for r in receivers)
        if programs and not open_kw:
            missing = sorted(k for k in kws if k not in takes)
            if missing:
                out.append(fi.finding(
                    body, "R3",
                    f"partial binds {missing}, which name no parameter of "
                    f"the round program(s) "
                    f"{[r.name for r in programs]} — a TypeError at capture",
                ))
        if isinstance(statics, ast.Name):
            statics = local_binding(func, statics.id, call.lineno) or statics
        carried_names = _names_in(statics)
        carried_keys: Optional[Set[str]] = None
        if isinstance(statics, ast.Call) and statics.args:
            fn = project.resolve_call(statics, fi)
            if fn is not None:
                carried_keys = _statics_fn_keys(fn, set(kws))
                if carried_keys is None:
                    continue  # unreadable statics: nothing provable
        for k, v in sorted(kws.items()):
            if carried_keys is not None and k in carried_keys:
                continue
            if carried_keys is None:
                names = _names_in(v)
                if not names or names <= carried_names:
                    continue
            rec = takes.get(k)
            if rec is not None and _first_only_reads(rec, k):
                continue
            out.append(fi.finding(
                body, "R3",
                f"round body keyword `{k}` is baked into the captured "
                "graph but its `statics` do not carry it — a later call "
                "with another value replays the stale graph (add it to "
                "statics, or read it only under `if first:`)",
            ))
    return out


# ==========================================================================
# R4 — determinism
# ==========================================================================

_RANDOM_OK = {"Random", "SystemRandom", "getstate", "setstate"}
_NP_RANDOM_OK = {
    "default_rng", "Generator", "RandomState", "SeedSequence", "PCG64",
    "Philox", "bit_generator",
}
_DATETIME_NOW = {
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.date.today", "datetime.datetime.today",
}
#: torch samplers that draw from the global generator unless handed one
_TORCH_SAMPLERS = {
    "torch.rand", "torch.randn", "torch.randint", "torch.randperm",
    "torch.multinomial", "torch.bernoulli", "torch.normal", "torch.poisson",
    "torch.rand_like", "torch.randn_like", "torch.randint_like",
}
_TORCH_GLOBAL_SEED = {"torch.manual_seed", "torch.seed",
                      "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
                      "torch.cuda.seed", "torch.cuda.seed_all"}


@register_rule("R4")
def rule_r4_determinism(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for fi in project.files:
        if fi.tree is None:
            continue
        production = not _is_harness(fi)
        for node in ast.walk(fi.tree):
            if not isinstance(node, ast.Call):
                continue
            full = resolve_dotted(dotted_name(node.func), fi.imports)
            if not full:
                continue
            if full.startswith("random.") and full.count(".") == 1:
                leaf = full.split(".")[1]
                if leaf not in _RANDOM_OK:
                    findings.append(fi.finding(
                        node, "R4",
                        f"`{full}()` uses the global random state — seed a "
                        "`random.Random(seed)` instance and thread it "
                        "through (the sim/faults idiom)",
                    ))
            elif full.startswith("numpy.random."):
                leaf = full.split(".")[2]
                if leaf not in _NP_RANDOM_OK:
                    findings.append(fi.finding(
                        node, "R4",
                        f"`{full}()` uses numpy's global RNG — use "
                        "`np.random.default_rng(seed)`",
                    ))
            elif full == "time.time":
                findings.append(fi.finding(
                    node, "R4",
                    "`time.time()` is wall-clock — inject a clock "
                    "(`clock: Callable[[], float] = time.monotonic`) so "
                    "sim/chaos runs stay deterministic",
                ))
            elif full in _DATETIME_NOW and not node.args and not node.keywords:
                findings.append(fi.finding(
                    node, "R4",
                    f"argless `{full}()` — inject a clock or pass an "
                    "explicit timezone/timestamp",
                ))
            elif production and full in _TORCH_GLOBAL_SEED:
                findings.append(fi.finding(
                    node, "R4",
                    f"`{full}()` sets torch's global generator — seed a "
                    "`torch.Generator` and pass it as `generator=`",
                ))
            elif (production and full in _TORCH_SAMPLERS
                  and not any(kw.arg == "generator" for kw in node.keywords)):
                findings.append(fi.finding(
                    node, "R4",
                    f"`{full}()` without `generator=` draws from torch's "
                    "global generator — pass a seeded `torch.Generator`",
                ))
    return findings


# ==========================================================================
# R5 — dtype drift in device-math modules
# ==========================================================================

def _in_dtype_scope(fi: FileInfo) -> bool:
    rel = "/" + fi.relpath
    return (any(m in rel for m in _DTYPE_SCOPE_MARKERS)
            or any(rel.endswith("/" + f) for f in _DTYPE_SCOPE_FILES))


@register_rule("R5")
def rule_r5_dtype(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for fi in project.files:
        if fi.tree is None or not _in_dtype_scope(fi):
            continue
        for node in ast.walk(fi.tree):
            if isinstance(node, ast.Attribute):
                full = resolve_dotted(dotted_name(node), fi.imports)
                if full in _F64_ATTRS:
                    findings.append(fi.finding(
                        node, "R5",
                        f"`{full}` in a device-math module — the solver "
                        "rides float32 end to end; widening silently "
                        "doubles memory traffic and splits graph keys",
                    ))
            elif isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg == "dtype":
                        v = kw.value
                        if isinstance(v, ast.Name) and v.id == "float":
                            findings.append(fi.finding(
                                v, "R5",
                                "`dtype=float` is float64 — spell the "
                                "narrow dtype (torch.float32) explicitly",
                            ))
                for arg in list(node.args) + [kw.value for kw in node.keywords]:
                    if (isinstance(arg, ast.Constant)
                            and arg.value in ("float64", "complex128")):
                        findings.append(fi.finding(
                            arg, "R5",
                            f"dtype string '{arg.value}' in a device-math "
                            "module — use float32",
                        ))
                if isinstance(node.func, ast.Attribute):
                    if node.func.attr == "astype" and node.args:
                        a0 = node.args[0]
                        if isinstance(a0, ast.Name) and a0.id == "float":
                            findings.append(fi.finding(
                                a0, "R5",
                                "`.astype(float)` is float64 — use "
                                "np.float32",
                            ))
                    elif node.func.attr == "double" and not node.args:
                        findings.append(fi.finding(
                            node, "R5",
                            "`.double()` is float64 — use `.float()`",
                        ))
    return findings


# ==========================================================================
# R6 — syntax gate: Py3.10 f-string backslash (the seed breaker)
# ==========================================================================

@register_rule("R6")
def rule_r6_fstring_backslash(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for fi in project.files:
        if fi.parse_error is not None:
            line = getattr(fi.parse_error, "lineno", None) or 1
            if _looks_like_fstring_backslash(fi, line):
                findings.append(Finding(
                    fi.relpath, line, 0, "R6",
                    "f-string expression contains a backslash — a "
                    "SyntaxError on Python 3.10 (the class that broke the "
                    "seed's metrics.py); pull the escape into a variable",
                    fi.line_text(line),
                ))
            else:
                findings.append(Finding(
                    fi.relpath, line, 0, "R6",
                    f"file does not parse: {fi.parse_error}",
                    fi.line_text(line),
                ))
            continue
        # forward-compat: on interpreters where the construct parses
        # (3.12+, PEP 701), catch it from the AST so the repo stays
        # 3.10-loadable. Before 3.12 every FormattedValue in a joined
        # string shares the whole string's span (adjacent `\n` literals
        # would false-positive) — and the construct cannot parse there
        # anyway, so the parse_error path above is the real check.
        if sys.version_info < (3, 12):
            continue
        if "\\" not in fi.source:
            continue
        lines = None
        for node in ast.walk(fi.tree):
            if isinstance(node, ast.FormattedValue):
                if lines is None:
                    lines = [ln.encode("utf-8") for ln in
                             ast._splitlines_no_ff(fi.source)]
                seg = _segment(lines, node)
                if seg and b"\\" in seg:
                    findings.append(fi.finding(
                        node, "R6",
                        "backslash inside an f-string expression — "
                        "SyntaxError on Python 3.10; pull the escape into "
                        "a variable",
                    ))
    return findings


def _segment(lines: List[bytes], node: ast.AST) -> bytes:
    """The UTF-8 source bytes of ``node`` — ``ast.get_source_segment``
    over lines split once per file."""
    first, last = node.lineno - 1, node.end_lineno - 1
    if first == last:
        return lines[first][node.col_offset:node.end_col_offset]
    return (lines[first][node.col_offset:] + b"".join(lines[first + 1:last])
            + lines[last][:node.end_col_offset])


def _looks_like_fstring_backslash(fi: FileInfo, around_line: int) -> bool:
    pat = re.compile(r"""[fF][rRbB]?(['"]).*{[^{}]*\\[^}]*}.*\1""")
    lo = max(0, around_line - 3)
    hi = min(len(fi.lines), around_line + 2)
    return any(pat.search(text) for text in fi.lines[lo:hi])


# ==========================================================================
# R7 — device reads outside the declared boundary
# ==========================================================================

#: the declared boundary: ``to_host`` and ``to_cpu`` count every read
_R7_BOUNDARY_MODULES = ("ops/sync.py",)

#: argument AST nodes that cannot be device buffers (host literals and
#: comprehensions) — np.asarray over them is host-on-host bookkeeping
_R7_HOST_LITERALS = (ast.List, ast.Tuple, ast.Dict, ast.Set, ast.Constant,
                     ast.ListComp, ast.SetComp, ast.DictComp,
                     ast.GeneratorExp, ast.JoinedStr)


class _HostValues:
    """Which expressions of one function are host data for certain: host
    literals, results of numpy calls and of the declared reads
    (``to_host``, ``to_cpu``, ``.readback``), methods, items and fields of
    those, and names every assignment binds to one of them."""

    def __init__(self, func: ast.AST, imports: Dict[str, str]) -> None:
        self.imports = imports
        self.names: Set[str] = set()
        binds: Dict[str, List[ast.expr]] = {}
        other: Set[str] = set()
        def bind(target: ast.AST, value: Optional[ast.expr]) -> None:
            # a piece of host data is host data: unpacked names and loop
            # variables bind to the whole value
            if value is None:
                other.update(_names_in(target))
            elif isinstance(target, ast.Name):
                binds.setdefault(target.id, []).append(value)
            elif isinstance(target, (ast.Tuple, ast.List)):
                pair = (isinstance(value, (ast.Tuple, ast.List))
                        and len(value.elts) == len(target.elts))
                for i, t in enumerate(target.elts):
                    bind(t, value.elts[i] if pair else value)
            elif isinstance(target, ast.Starred):
                bind(target.value, value)
            else:
                other.update(_names_in(target))

        for node in ast.walk(func):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    bind(t, node.value)
            elif isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
                bind(node.target, node.iter)
            elif isinstance(node, (ast.AugAssign, ast.With, ast.NamedExpr)):
                target = getattr(node, "target", None)
                other |= _names_in(target)
                for item in getattr(node, "items", ()):
                    other |= _names_in(item.optional_vars)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.Lambda)) and node is not func:
                a = node.args
                other |= {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
        if isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = func.args
            other |= {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}
        # the greatest fixpoint: assume every bound name host, then drop
        # the ones with a bind that is not, until nothing changes (so
        # `host = host[:-2]` stays host)
        self.names = {n for n in binds if n not in other}
        changed = True
        while changed:
            changed = False
            for name in sorted(self.names):
                if not all(self.is_host(v) for v in binds[name]):
                    self.names.discard(name)
                    changed = True

    def is_host(self, e: Optional[ast.expr]) -> bool:
        if e is None:
            return False
        if isinstance(e, _R7_HOST_LITERALS):
            return True
        if isinstance(e, ast.Name):
            return e.id in self.names
        if isinstance(e, (ast.Subscript, ast.Attribute)):
            return self.is_host(e.value)
        if isinstance(e, ast.IfExp):
            return self.is_host(e.body) and self.is_host(e.orelse)
        if isinstance(e, ast.BinOp):
            return self.is_host(e.left) and self.is_host(e.right)
        if isinstance(e, ast.Call):
            if _is_host_read(e, self.imports):
                return True
            full = resolve_dotted(dotted_name(e.func), self.imports) or ""
            if full.startswith("numpy."):
                return True
            return (isinstance(e.func, ast.Attribute)
                    and self.is_host(e.func.value))
        return False


def _readback_desc(node: ast.Call, imports: Dict[str, str],
                   host: Optional[_HostValues] = None) -> Optional[str]:
    """The spelling of a device read at this call (R7's set), else None:
    a read method, or ``np.asarray``/``np.array`` of a non-literal —
    neither on a value already known to be host data."""
    read = _read_method(node)
    if read is not None:
        if host is not None and host.is_host(node.func.value):
            return None
        return read
    full = resolve_dotted(dotted_name(node.func), imports)
    if full in _SYNC_CALLS:
        if node.args and isinstance(node.args[0], _R7_HOST_LITERALS):
            return None
        if node.args and host is not None and host.is_host(node.args[0]):
            return None
        return full
    return None


@register_rule("R7")
def rule_r7_undeclared_readback(project: Project) -> List[Finding]:
    """A device read (``.tolist()``, ``.item()``, ``.cpu()``,
    ``.numpy()``, ``.to("cpu")``, ``np.asarray``/``np.array`` of a
    non-literal) outside ``ops/sync.py``, whose ``to_host``/``to_cpu``
    count every read and lift the sync debug mode for it. The ratchet
    that keeps new uncounted readback sites from sneaking in: a path run
    under ``torch.cuda.set_sync_debug_mode("error")`` only catches the
    reads its test shapes reach. Scope: production modules that import
    torch (harnesses read by design; pure-numpy host modules hold no
    tensor); host literals are exempt; legitimate host-copy sites carry
    suppressions with justifications."""
    findings: List[Finding] = []
    for fi in project.files:
        if fi.tree is None:
            continue
        rel = fi.relpath.replace("\\", "/")
        if any(rel.endswith(m) for m in _R7_BOUNDARY_MODULES):
            continue
        if _is_harness(fi) or not _imports_torch(fi):
            continue
        for func, nodes in _enclosing_functions(fi.tree):
            host = _HostValues(func, fi.imports)
            for node in nodes:
                if not isinstance(node, ast.Call):
                    continue
                desc = _readback_desc(node, fi.imports, host)
                if desc is None:
                    continue
                findings.append(fi.finding(
                    node, "R7",
                    f"`{desc}` reads a (potential) device value back "
                    "outside the declared boundary — route it through "
                    "ops/sync.py's to_host/to_cpu so the sync is counted "
                    "(and the sync debug mode sees the rest)",
                ))
    return findings


# ==========================================================================
# R8 — sharded-value gather in mesh-aware modules
# ==========================================================================

_R8_SCOPE_PREFIX = "kubernetes_tpu_torch.parallel"

#: the one module where shards exchange data
_R8_EXCHANGE_MODULES = ("parallel/collectives.py",)

#: names that hold a mesh's device list by convention
_MESH_DEVICE_NAMES = {"devices", "devs"}


def _imports_parallel(fi: FileInfo) -> bool:
    """Does this module import the mesh layer (any form, any level)?
    ``fi.imports`` alone is not enough: the engine maps a bare
    ``import a.b.c`` to its top-level name only, so the scope check
    walks the AST for Import/ImportFrom nodes too."""
    if any(v == _R8_SCOPE_PREFIX or v.startswith(_R8_SCOPE_PREFIX + ".")
           for v in fi.imports.values()):
        return True
    for node in ast.walk(fi.tree):
        if isinstance(node, ast.Import):
            if any(a.name == _R8_SCOPE_PREFIX
                   or a.name.startswith(_R8_SCOPE_PREFIX + ".")
                   for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom) and node.module:
            if (node.module == _R8_SCOPE_PREFIX
                    or node.module.startswith(_R8_SCOPE_PREFIX + ".")):
                return True
    return False


class _MeshDevices:
    """Which expressions of one function name a mesh device: ``*.devices``
    (and its items), ``mesh.device``, names bound from those (``devs =
    mesh.devices``, ``for dv in devs``, ``zip(blocks, mesh.devices)``)."""

    def __init__(self, func: ast.AST) -> None:
        self.names: Set[str] = set(_MESH_DEVICE_NAMES)
        for _ in range(2):
            for node in ast.walk(func):
                if isinstance(node, ast.Assign) and self.is_dev(node.value):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            self.names.add(t.id)
                elif isinstance(node, (ast.For, ast.comprehension)):
                    self._bind_iter(node.target, node.iter)

    def _bind_iter(self, target: ast.AST, it: ast.expr) -> None:
        if (isinstance(it, ast.Call) and dotted_name(it.func) == "zip"
                and isinstance(target, ast.Tuple)
                and len(target.elts) == len(it.args)):
            for t, a in zip(target.elts, it.args):
                if isinstance(t, ast.Name) and self.is_dev(a):
                    self.names.add(t.id)
        elif (isinstance(it, ast.Call) and dotted_name(it.func) == "enumerate"
              and it.args and self.is_dev(it.args[0])
              and isinstance(target, ast.Tuple) and len(target.elts) == 2
              and isinstance(target.elts[1], ast.Name)):
            self.names.add(target.elts[1].id)
        elif isinstance(target, ast.Name) and self.is_dev(it):
            self.names.add(target.id)

    def is_dev(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Attribute):
            if node.attr == "devices":
                return True
            if node.attr == "device":
                base = dotted_name(node.value) or ""
                return base.split(".")[-1] == "mesh"
            return False
        if isinstance(node, ast.Subscript):
            return self.is_dev(node.value)
        return False

    def cross_device_to(self, node: ast.AST) -> bool:
        """``x.to(<mesh device>, ...)`` / ``x.to(device=<mesh device>)``."""
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "to"):
            return False
        if node.args and self.is_dev(node.args[0]):
            return True
        return any(kw.arg == "device" and self.is_dev(kw.value)
                   for kw in node.keywords)


def _enclosing_functions(tree: ast.Module):
    """(function or module, its own nodes) — nodes of nested defs are
    attributed to the innermost def."""
    out = []

    def collect(root: ast.AST) -> None:
        own = []
        stack = list(ast.iter_child_nodes(root))
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                collect(n)
                continue
            own.append(n)
            stack.extend(ast.iter_child_nodes(n))
        out.append((root, own))

    collect(tree)
    return out


@register_rule("R8")
def rule_r8_mesh_gather(project: Project) -> List[Finding]:
    """A gather of a (potentially) sharded value inside a PRODUCTION
    module that imports ``kubernetes_tpu_torch.parallel``: a device read
    (R7's set), a cross-device ``.to(<mesh device>)``, or a
    ``torch.cat``/``torch.stack`` over per-shard tensors copied from
    their devices — outside ``parallel/collectives.py``, the one place
    shards exchange data (gathering in shard order, with byte
    accounting in ``collectives.STATS``). On a mesh over distinct cards
    each such line moves a block across the interconnect that the
    collective cost model (``parallel/costmodel.py``) does not see.
    Scope mirrors R7 (harnesses exempt; host literals exempt); the
    declared readback boundary (``to_host`` via ``obs.jax.readback``)
    is not a gather here."""
    findings: List[Finding] = []
    for fi in project.files:
        if fi.tree is None:
            continue
        rel = fi.relpath.replace("\\", "/")
        if any(rel.endswith(m) for m in _R8_EXCHANGE_MODULES):
            continue
        if _is_harness(fi) or not _imports_parallel(fi):
            continue
        for func, nodes in _enclosing_functions(fi.tree):
            mesh = _MeshDevices(func)
            host = _HostValues(func, fi.imports)
            inner: Set[int] = set()
            for node in nodes:
                if not isinstance(node, ast.Call):
                    continue
                full = resolve_dotted(dotted_name(node.func), fi.imports)
                if full in ("torch.cat", "torch.stack") and node.args:
                    seq = node.args[0]
                    moves = [n for n in ast.walk(seq)
                             if mesh.cross_device_to(n)]
                    if moves:
                        inner |= {id(n) for n in moves}
                        findings.append(fi.finding(
                            node, "R8",
                            f"`{full}` over per-shard tensors copied from "
                            "their devices — a gather outside "
                            "parallel/collectives.py (use coll.all_gather "
                            "or a shard program's request)",
                        ))
            for node in nodes:
                if not isinstance(node, ast.Call) or id(node) in inner:
                    continue
                desc = _readback_desc(node, fi.imports, host)
                if desc is not None:
                    findings.append(fi.finding(
                        node, "R8",
                        f"`{desc}` materializes a (potentially node-axis-"
                        "sharded) value on the host in a mesh-aware module "
                        "— read it through the declared to_host boundary "
                        "on a value the collectives already reduced",
                    ))
                elif mesh.cross_device_to(node):
                    findings.append(fi.finding(
                        node, "R8",
                        "`.to(<mesh device>)` copies a (potentially "
                        "sharded) tensor across the mesh outside "
                        "parallel/collectives.py — an exchange the "
                        "collective stats and cost model do not see",
                    ))
    return findings


# ==========================================================================
# R9 / R10 — lock discipline + blocking-under-lock
# ==========================================================================

#: lock constructors recognized on ``self.X = threading.Lock()`` — plus
#: any injectable factory whose name mentions "lock" (the sanitize.py
#: seam: ``self._lock = lock_factory("cache.snap")``)
_LOCK_CTOR_LEAVES = {
    "lock", "rlock", "condition", "semaphore", "boundedsemaphore",
}

#: ``# guarded-by: self._lock`` — the explicit declaration form; the
#: lock name normalizes through a leading ``self.``
_GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*(?P<lock>[A-Za-z_][\w.]*)")

#: container mutations that count as WRITES for guard inference — in
#: this codebase shared state is mostly dicts/deques mutated in place,
#: not rebound
_MUTATOR_METHODS = {
    "append", "appendleft", "add", "insert", "extend", "update", "pop",
    "popleft", "popitem", "remove", "discard", "clear", "setdefault",
}

#: files R9/R10 never look at: test fakes and offline harnesses are
#: single-threaded by design, same scoping as R7/R8
_LOCK_EXEMPT_TOPDIRS = ("tests", "tests_tpu", "scripts")

#: directly-blocking operations for R10 — the shapes that have bitten
#: this codebase: hub RPC verbs, the declared d2h boundary, sleeps,
#: event-sink emission, and device syncs
_R10_BLOCKING_DOTTED = {"time.sleep"}
_R10_BLOCKING_METHODS = {"result", "block_until_ready", "readback"}
_R10_HUB_VERBS = {
    "bind", "bind_pod", "create_pod", "update_pod", "delete_pod",
    "patch_pod", "list_pods", "get_pod",
}
_R10_SINK_NAMES = {"event_sink"}
_R10_SINK_DESC = "event-sink emission"
#: the port's device syncs: the barrier, event/stream waits, the counted
#: reads of ops/sync.py and the tensor read methods
_R10_DEVICE_SYNC_DOTTED = {"torch.cuda.synchronize"}
_R10_COUNTED_READS = {"to_host", "to_cpu"}
_R10_SYNC_MODULE = "kubernetes_tpu_torch.ops.sync"


def _r10_blocking_desc(node: ast.Call, imports: Dict[str, str]) -> Optional[str]:
    """Human description when this call is a known-blocking op, else
    None. Callers exclude intraclass ``self.meth()`` calls first —
    a class invoking its OWN ``delete_pod`` is in-process bookkeeping,
    not a stub RPC."""
    func = node.func
    name = dotted_name(func)
    full = resolve_dotted(name, imports)
    leaf = (name or "").split(".")[-1]
    if full in _R10_BLOCKING_DOTTED:
        return f"`{full}()`"
    if leaf == "block_until_ready" or (
            full and full.endswith(".block_until_ready")):
        return "`block_until_ready` (device sync)"
    if isinstance(func, ast.Attribute) and func.attr in _R10_BLOCKING_METHODS:
        return (f"`.{func.attr}()` "
                + ("(declared d2h readback)" if func.attr == "readback"
                   else "(device/future sync)"))
    if isinstance(func, ast.Attribute) and func.attr in _R10_HUB_VERBS:
        return f"hub RPC `.{func.attr}()`"
    if leaf in _R10_SINK_NAMES:
        return _R10_SINK_DESC
    if full in _R10_DEVICE_SYNC_DOTTED:
        return f"`{full}()` (device sync)"
    if isinstance(func, ast.Attribute) and func.attr == "synchronize":
        return "`.synchronize()` (event/stream wait)"
    if leaf in _R10_COUNTED_READS and (
            full in (f"{_R10_SYNC_MODULE}.{leaf}", leaf)
            or (full or "").endswith(f"sync.{leaf}")):
        return f"`{leaf}()` (counted device read)"
    read = _read_method(node)
    if read is not None:
        return f"`{read}` (device read)"
    return None


#: name tokens that mean "this is a lock" — token-wise so ``clock`` /
#: ``blocked`` never match
_LOCKISH_TOKENS = {"lock", "rlock", "mutex", "cond", "condition"}


def _lockish_name(leaf: str) -> bool:
    tokens = leaf.lower().strip("_").split("_")
    return any(t in _LOCKISH_TOKENS for t in tokens)


def _is_lock_ctor(call: ast.Call, imports: Dict[str, str]) -> bool:
    name = dotted_name(call.func)
    full = resolve_dotted(name, imports) or ""
    leaf = full.split(".")[-1].lower()
    if full.startswith("threading.") and leaf in _LOCK_CTOR_LEAVES:
        return True
    # injectable lock factories (kubernetes_tpu_torch/sanitize.py seam)
    return _lockish_name((name or "").split(".")[-1])


def _lockish_expr(expr: ast.expr, locks: Set[str]) -> Optional[str]:
    """Dotted name of a with-item that acquires a lock, else None.
    ``self.X`` for a known class lock always counts; otherwise the last
    segment must look lock-like (lock / cond / mutex)."""
    name = dotted_name(expr)
    if name is None:
        return None
    parts = name.split(".")
    if len(parts) == 2 and parts[0] == "self" and parts[1] in locks:
        return name
    if _lockish_name(parts[-1]):
        return name
    return None


class _MethodLockScan:
    """One method's lock-relevant events: attribute accesses (with the
    self-locks held at that point), intraclass ``self.meth()`` call
    sites, and R10-relevant blocking calls (with every held lock expr,
    including non-self ones like ``loop.lock``)."""

    def __init__(self, cls: "_ClassLockInfo", meth_name: str,
                 node: ast.AST) -> None:
        self.cls = cls
        self.name = meth_name
        self.node = node
        #: (attr, is_write, frozenset(held self-locks), node)
        self.accesses: List[Tuple[str, bool, frozenset, ast.AST]] = []
        #: (callee method leaf name, frozenset(held self-locks),
        #:  tuple(held lock exprs), node)
        self.self_calls: List[Tuple[str, frozenset, Tuple[str, ...], ast.AST]] = []
        #: (description, tuple(held lock exprs), node) — direct blocking
        self.blocking: List[Tuple[str, Tuple[str, ...], ast.AST]] = []
        #: does this method directly call the event sink?
        self.emits = False

    # -- walk ---------------------------------------------------------------

    def run(self) -> None:
        for stmt in self.node.body:
            self._stmt(stmt, frozenset(), ())

    def _stmt(self, node: ast.stmt, held: frozenset,
              held_exprs: Tuple[str, ...]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            # a nested def runs LATER, on whatever thread calls it —
            # never under the locks held at definition time
            for s in getattr(node, "body", ()):
                self._stmt(s, frozenset(), ())
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new_held = set(held)
            new_exprs = list(held_exprs)
            for item in node.items:
                self._expr(item.context_expr, held, held_exprs)
                lk = _lockish_expr(item.context_expr, self.cls.locks)
                if lk is not None:
                    new_exprs.append(lk)
                    parts = lk.split(".")
                    if (len(parts) == 2 and parts[0] == "self"
                            and parts[1] in self.cls.locks):
                        new_held = new_held | {parts[1]}
            for s in node.body:
                self._stmt(s, frozenset(new_held), tuple(new_exprs))
            return
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            if node.value is not None:
                self._expr(node.value, held, held_exprs)
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                self._target(t, held, held_exprs,
                             aug=isinstance(node, ast.AugAssign))
            return
        if isinstance(node, ast.Delete):
            for t in node.targets:
                self._target(t, held, held_exprs)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                self._stmt(child, held, held_exprs)
            elif isinstance(child, ast.expr):
                self._expr(child, held, held_exprs)
            elif isinstance(child, ast.excepthandler):
                for s in child.body:
                    self._stmt(s, held, held_exprs)

    def _self_attr(self, node: ast.AST) -> Optional[str]:
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return node.attr
        return None

    def _target(self, node: ast.AST, held: frozenset,
                held_exprs: Tuple[str, ...], aug: bool = False) -> None:
        attr = self._self_attr(node)
        if attr is not None:
            self._record(attr, True, held, node)
            return
        if isinstance(node, ast.Subscript):
            base = self._self_attr(node.value)
            if base is not None:
                # self.A[k] = v mutates A in place
                self._record(base, True, held, node.value)
            else:
                self._expr(node.value, held, held_exprs)
            self._expr(node.slice, held, held_exprs)
            return
        if isinstance(node, (ast.Tuple, ast.List)):
            for e in node.elts:
                self._target(e, held, held_exprs)
            return
        if isinstance(node, ast.Starred):
            self._target(node.value, held, held_exprs)
            return
        if isinstance(node, ast.Attribute):
            self._expr(node.value, held, held_exprs)

    def _record(self, attr: str, is_write: bool, held: frozenset,
                node: ast.AST) -> None:
        if attr in self.cls.locks or attr in self.cls.method_names:
            return
        self.accesses.append((attr, is_write, held, node))

    def _expr(self, node: ast.expr, held: frozenset,
              held_exprs: Tuple[str, ...]) -> None:
        if isinstance(node, (ast.Lambda,)):
            # runs later, lock-free (same as nested defs)
            self._expr(node.body, frozenset(), ())
            return
        if isinstance(node, ast.Call):
            self._call(node, held, held_exprs)
            return
        attr = self._self_attr(node)
        if attr is not None:
            self._record(attr, False, held, node)
            self._expr(node.value, held, held_exprs)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child, held, held_exprs)

    def _call(self, node: ast.Call, held: frozenset,
              held_exprs: Tuple[str, ...]) -> None:
        func = node.func
        meth = self._self_attr(func)
        intraclass = meth is not None and meth in self.cls.method_names
        desc = (None if intraclass
                else _r10_blocking_desc(node, self.cls.fi.imports))
        if desc is not None and desc == _R10_SINK_DESC:
            self.emits = True
        if desc is not None and held_exprs:
            self.blocking.append((desc, held_exprs, node))
        # intraclass call edge: self.meth(...) — an in-process call, not
        # a stub RPC, even when the method name is a hub verb; whatever
        # blocking IT does is reached through the entry/emitter closures
        if intraclass:
            self.self_calls.append((meth, held, held_exprs, node))
        # `self.A.append(x)` mutates A in place: a WRITE for guard
        # inference — the dominant shape for this codebase's shared
        # deques/dicts, which are mutated, not rebound
        if isinstance(func, ast.Attribute) and not intraclass:
            base = self._self_attr(func.value)
            if base is not None:
                self._record(base, func.attr in _MUTATOR_METHODS,
                             held, func.value)
            else:
                self._expr(func.value, held, held_exprs)
        for a in node.args:
            self._expr(a, held, held_exprs)
        for kw in node.keywords:
            self._expr(kw.value, held, held_exprs)


class _ClassLockInfo:
    """Per-class lock model: which attributes are locks, which state
    they guard (declared or inferred), and which methods are only ever
    entered with a lock already held."""

    def __init__(self, fi: FileInfo, node: ast.ClassDef) -> None:
        self.fi = fi
        self.node = node
        self.locks: Set[str] = set()
        self.declared: Dict[str, str] = {}  # attr -> lock attr
        self.method_names: Set[str] = set()
        self.scans: Dict[str, _MethodLockScan] = {}
        #: attr -> (lock, "declared"|"inferred", locked_writes, writes)
        self.guarded: Dict[str, Tuple[str, str, int, int]] = {}
        #: method leaf name -> self-locks guaranteed held on entry
        self.entry: Dict[str, frozenset] = {}
        #: methods that (transitively, intraclass) emit events
        self.emitters: Set[str] = set()

    # -- construction -------------------------------------------------------

    def build(self) -> None:
        methods = [n for n in self.node.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        self.method_names = {m.name for m in methods}
        for m in methods:
            self._find_locks_and_declarations(m)
        # class-level ``# guarded-by:`` annotations on assignments
        for n in self.node.body:
            if isinstance(n, (ast.Assign, ast.AnnAssign)):
                self._declare_from_line(n)
        if not self.locks:
            return
        for m in methods:
            if m.name in ("__init__", "__post_init__"):
                continue
            scan = _MethodLockScan(self, m.name, m)
            scan.run()
            self.scans[m.name] = scan
        self._infer_guards()
        self._entry_closure()
        self._emitter_closure()

    def _find_locks_and_declarations(self, meth: ast.AST) -> None:
        for node in ast.walk(meth):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                for t in node.targets:
                    if (isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                            and _is_lock_ctor(node.value, self.fi.imports)):
                        self.locks.add(t.attr)
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                self._declare_from_line(node)

    def _declare_from_line(self, node: ast.stmt) -> None:
        for ln in range(node.lineno, (node.end_lineno or node.lineno) + 1):
            if not 1 <= ln <= len(self.fi.lines):
                continue
            m = _GUARDED_BY_RE.search(self.fi.lines[ln - 1])
            if m is None:
                continue
            lock = m.group("lock")
            if lock.startswith("self."):
                lock = lock[len("self."):]
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    self.declared[t.attr] = lock
                elif isinstance(t, ast.Name):
                    self.declared[t.id] = lock
            return

    # -- guard inference ----------------------------------------------------

    def _infer_guards(self) -> None:
        for attr, lock in self.declared.items():
            if lock in self.locks:
                self.guarded[attr] = (lock, "declared", 0, 0)
        writes: Dict[str, List[frozenset]] = {}
        for scan in self.scans.values():
            for attr, is_write, held, _node in scan.accesses:
                if is_write:
                    writes.setdefault(attr, []).append(held)
        for attr, helds in writes.items():
            if attr in self.guarded:
                continue
            total = len(helds)
            best_lock, best_k = None, 0
            for lock in self.locks:
                k = sum(1 for h in helds if lock in h)
                if k > best_k:
                    best_lock, best_k = lock, k
            if best_lock is not None and total and best_k / total >= 0.8:
                self.guarded[attr] = (best_lock, "inferred", best_k, total)

    # -- interprocedural closures (intraclass call graph) -------------------

    def _entry_closure(self) -> None:
        # *_locked is the codebase's declared caller-holds-the-lock
        # convention (cache._refresh_host_locked); everything else starts
        # lock-free and is promoted only when EVERY intraclass call site
        # provably holds the lock
        for name in self.scans:
            self.entry[name] = (frozenset(self.locks)
                                if name.endswith("_locked") else frozenset())
        sites: Dict[str, List[Tuple[str, frozenset]]] = {}
        for scan in self.scans.values():
            for callee, held, _exprs, _node in scan.self_calls:
                sites.setdefault(callee, []).append((scan.name, held))
        for _ in range(len(self.scans) + 2):
            changed = False
            for name, scan in self.scans.items():
                if name.endswith("_locked"):
                    continue
                calls = sites.get(name)
                if not calls:
                    continue
                new = frozenset.intersection(*[
                    held | self.entry.get(caller, frozenset())
                    for caller, held in calls
                ])
                if new != self.entry[name]:
                    self.entry[name] = new
                    changed = True
            if not changed:
                break

    def _emitter_closure(self) -> None:
        self.emitters = {n for n, s in self.scans.items() if s.emits}
        for _ in range(len(self.scans) + 2):
            grown = False
            for name, scan in self.scans.items():
                if name in self.emitters:
                    continue
                if any(callee in self.emitters
                       for callee, _h, _e, _n in scan.self_calls):
                    self.emitters.add(name)
                    grown = True
            if not grown:
                break


def _lock_state(project: Project) -> List[_ClassLockInfo]:
    """Per-class lock models for every production file; cached on the
    project (R9 and R10 share it, like the R1/R2 capture-taint cache)."""
    cached = getattr(project, "_graftlint_lock_state", None)
    if cached is not None:
        return cached
    out: List[_ClassLockInfo] = []
    for fi in project.files:
        if fi.tree is None:
            continue
        rel = fi.relpath.replace("\\", "/")
        if rel.split("/", 1)[0] in _LOCK_EXEMPT_TOPDIRS:
            continue
        for node in ast.walk(fi.tree):
            if isinstance(node, ast.ClassDef):
                info = _ClassLockInfo(fi, node)
                info.build()
                if info.locks:
                    out.append(info)
    project._graftlint_lock_state = out
    return out


@register_rule("R9")
def rule_r9_lock_discipline(project: Project) -> List[Finding]:
    """Guarded state accessed off-lock. An attribute is guarded by a
    lock when a ``# guarded-by: self._lock`` comment says so, or when
    >= 80% of its writes (rebinds AND in-place container mutations,
    ``__init__`` excluded — construction precedes sharing) happen under
    ``with self._lock``. Every other access — reads included, because
    unlocked snapshot reads are exactly the torn-read bug class — must
    hold that lock, either lexically or by being a method whose every
    intraclass call site holds it (``self._helper()`` under the lock,
    the ``*_locked`` naming convention)."""
    findings: List[Finding] = []
    for info in _lock_state(project):
        for scan in info.scans.values():
            entry = info.entry.get(scan.name, frozenset())
            for attr, is_write, held, node in scan.accesses:
                g = info.guarded.get(attr)
                if g is None:
                    continue
                lock, how, k, n = g
                if lock in held or lock in entry:
                    continue
                basis = ("declared guarded-by" if how == "declared"
                         else f"inferred from {k}/{n} locked writes")
                verb = "written" if is_write else "read"
                findings.append(info.fi.finding(
                    node, "R9",
                    f"`self.{attr}` is guarded by `self.{lock}` ({basis}) "
                    f"but {verb} here without holding it — a data race "
                    f"with the locked writers (torn reads / lost updates)",
                ))
    return findings


@register_rule("R10")
def rule_r10_blocking_under_lock(project: Project) -> List[Finding]:
    """Known-blocking operations while a lock is statically held — the
    shape of the watchdog-events bug (events emitted inside the
    watchdog mutex, deadlocking any sink that calls back into the
    ledger). Blocking set: hub RPC verbs, the declared readback,
    ``time.sleep``, event-sink emission, ``.result()`` /
    ``block_until_ready``, and the port's device syncs:
    ``torch.cuda.synchronize``, ``Event``/``Stream.synchronize``,
    ``to_host``/``to_cpu``, ``.tolist()``/``.item()``/``.cpu()``/
    ``.numpy()``. Held means: inside ``with <lock>`` (any lock-named
    context manager, self or not), or in a method whose every
    intraclass call site holds one (incl. ``*_locked``). Collect what
    you need under the lock, drop it, THEN block."""
    findings: List[Finding] = []
    for info in _lock_state(project):
        for scan in info.scans.values():
            # blocking ops under a lexically held with-lock
            for desc, held_exprs, node in scan.blocking:
                locks = ", ".join(f"`{e}`" for e in held_exprs)
                findings.append(info.fi.finding(
                    node, "R10",
                    f"{desc} while holding {locks} — blocking under a "
                    "lock stalls every thread contending for it (and an "
                    "emission sink calling back in deadlocks); collect "
                    "under the lock, release, then block",
                ))
            # blocking ops in methods whose every intraclass call site
            # holds a lock (incl. *_locked), and emitter methods invoked
            # under a lexically held lock
            entry = info.entry.get(scan.name, frozenset())
            if entry:
                locks = ", ".join(f"`self.{l}`" for l in sorted(entry))
                for node in _r10_unlocked_blocking_nodes(scan):
                    findings.append(info.fi.finding(
                        node[1], "R10",
                        f"{node[0]} in `{scan.name}`, which is only ever "
                        f"called with {locks} held — blocking under a "
                        "caller-held lock; hoist the blocking work out "
                        "of the locked region",
                    ))
            for callee, held, held_exprs, node in scan.self_calls:
                if held_exprs and callee in info.emitters:
                    locks = ", ".join(f"`{e}`" for e in held_exprs)
                    findings.append(info.fi.finding(
                        node, "R10",
                        f"`self.{callee}()` emits events and is called "
                        f"while holding {locks} — the watchdog-events "
                        "bug shape; emit after the lock drops",
                    ))
    return findings


def _r10_unlocked_blocking_nodes(scan: _MethodLockScan):
    """Blocking calls in a scan that are NOT under a lexical with-lock
    (those already reported) — used for caller-held-lock methods."""
    out = []
    seen_lex = {id(n) for _d, _e, n in scan.blocking}

    class _V(ast.NodeVisitor):
        def visit_Call(self, node: ast.Call) -> None:
            if id(node) not in seen_lex:
                func = node.func
                intraclass = (isinstance(func, ast.Attribute)
                              and isinstance(func.value, ast.Name)
                              and func.value.id == "self"
                              and func.attr in scan.cls.method_names)
                if not intraclass:
                    desc = _r10_blocking_desc(node, scan.cls.fi.imports)
                    if desc is not None:
                        out.append((desc, node))
            self.generic_visit(node)

    _V().visit(scan.node)
    return out


# ==========================================================================
# R0 — suppression hygiene
# ==========================================================================

@register_rule("R0")
def rule_r0_suppression_hygiene(project: Project) -> List[Finding]:
    findings: List[Finding] = []
    for fi in project.files:
        for d in fi.suppressions.hygiene:
            if d.form == "malformed":
                msg = ("malformed graftlint directive — expected "
                       "`# graftlint: disable=R2 -- justification`")
            elif not d.why.strip():
                msg = (f"suppression of {','.join(d.rules) or '?'} has no "
                       "justification — add ` -- <why this is safe>`")
            elif any(r not in RULE_IDS for r in d.rules):
                msg = f"unknown rule id in suppression: {d.rules}"
            else:
                msg = ("disable-scope directive is not attached to a "
                       "def/class header")
            findings.append(Finding(fi.relpath, d.line, 0, "R0", msg,
                                    fi.line_text(d.line)))
    return findings


def ensure_registered() -> None:
    """Importing this module registers every rule; hook for the engine."""
