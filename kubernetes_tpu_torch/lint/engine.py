"""graftlint core for the PyTorch port — file loading, comment
directives, the capture-root call graph and the rule registry plumbing.

The engine works from source text and ``ast`` alone, so the linter runs on
files that would crash on import (that is the point of the R6 parse gate)
and inside the CPU test suite without touching a card. It keeps the
reference linter's rule ids, ``Finding`` fields and suppression syntax, so
a ``# graftlint:`` comment means the same to both linters.

The reference's jit roots become **capture roots** here: the round bodies
handed to :func:`kubernetes_tpu_torch.ops.device_loop.run`, which captures
them into one CUDA graph. A body's contract is ``round_fn(ctx, state,
first, tag)``: ``ctx`` and ``state`` are tensors, ``first`` and ``tag``
are host values, and keyword-only parameters (what ``functools.partial``
binds) are the statics the graph's key names.
"""

from __future__ import annotations

import ast
import hashlib
import io
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: every rule class the engine knows; report/CLI validate --select and
#: suppression comments against this
RULE_IDS = ("R0", "R1", "R2", "R3", "R4", "R5", "R6", "R7", "R8", "R9", "R10")


@dataclass(frozen=True)
class Finding:
    """One lint finding. ``fingerprint`` is line-number-free (rule + file
    + normalized source text + occurrence index) so committed baselines
    survive unrelated edits above the finding."""

    path: str  # root-relative, '/'-separated
    line: int
    col: int
    rule: str
    message: str
    snippet: str = ""
    occurrence: int = 0  # index among identical (rule, path, snippet)

    def fingerprint(self) -> str:
        key = "|".join(
            (self.rule, self.path, " ".join(self.snippet.split()),
             str(self.occurrence))
        )
        return hashlib.sha1(key.encode("utf-8")).hexdigest()[:16]

    def as_dict(self) -> Dict[str, object]:
        return {
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "rule": self.rule,
            "message": self.message,
            "snippet": self.snippet,
            "fingerprint": self.fingerprint(),
        }


# --------------------------------------------------------------------------
# suppression directives
# --------------------------------------------------------------------------

_DIRECTIVE_RE = re.compile(
    r"graftlint:\s*(?P<form>disable(?:-scope|-file)?)\s*=\s*"
    r"(?P<rules>[A-Za-z0-9_,\s]+?)\s*(?:--\s*(?P<why>.+?)\s*)?$"
)


@dataclass
class _Directive:
    line: int
    standalone: bool
    form: str  # disable | disable-scope | disable-file
    rules: Tuple[str, ...]
    why: str


class Suppressions:
    """Inline ``# graftlint:`` directives for one file.

    - ``disable=``: trailing comment suppresses its own line; a
      standalone comment line suppresses the next line.
    - ``disable-scope=``: standalone comment immediately above a
      ``def``/``class`` (or trailing on its header line) suppresses the
      whole body.
    - ``disable-file=``: suppresses the rule everywhere in the file.

    A justification after `` -- `` is mandatory; directives without one
    (or naming unknown rules) become R0 findings instead of working.
    """

    def __init__(self) -> None:
        self.line_rules: Dict[int, Set[str]] = {}
        self.span_rules: List[Tuple[int, int, Set[str]]] = []
        self.file_rules: Set[str] = set()
        self.hygiene: List[_Directive] = []
        self._directives: List[_Directive] = []

    def allows(self, line: int, rule: str) -> bool:
        if rule in self.file_rules:
            return True
        if rule in self.line_rules.get(line, ()):
            return True
        return any(a <= line <= b and rule in rules
                   for a, b, rules in self.span_rules)


def _parse_directives(source: str) -> List[_Directive]:
    out: List[_Directive] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        # unparseable file: fall back to a per-line scan so a broken file
        # can still carry directives (and R0 still checks them)
        tokens = []
        for i, text in enumerate(source.splitlines(), 1):
            pos = text.find("#")
            if pos >= 0 and "graftlint:" in text[pos:]:
                tok = tokenize.TokenInfo(
                    tokenize.COMMENT, text[pos:], (i, pos), (i, len(text)), text
                )
                tokens.append(tok)
    for tok in tokens:
        if tok.type != tokenize.COMMENT or "graftlint:" not in tok.string:
            continue
        m = _DIRECTIVE_RE.search(tok.string)
        line = tok.start[0]
        before = tok.line[: tok.start[1]]
        standalone = not before.strip()
        if m is None:
            out.append(_Directive(line, standalone, "malformed", (), ""))
            continue
        rules = tuple(
            r.strip().upper() for r in m.group("rules").split(",") if r.strip()
        )
        out.append(_Directive(
            line, standalone, m.group("form"), rules, m.group("why") or ""
        ))
    return out


#: statement types a line-level ``disable`` may widen to: simple (non-
#: block) statements only, so a trailing directive on a compound header
#: can never blanket the whole body
_SIMPLE_STMTS = (
    ast.Assign, ast.AnnAssign, ast.AugAssign, ast.Expr, ast.Return,
    ast.Assert, ast.Raise, ast.Delete, ast.Import, ast.ImportFrom,
)


def _simple_stmt_span(tree: Optional[ast.Module], line: int) -> Tuple[int, int]:
    """(lineno, end_lineno) of the innermost simple statement containing
    ``line``, or (line, line). Lets a ``disable`` directive govern a call
    that wraps over several lines — whether the comment trails the first
    line, a continuation line, or stands above the statement — since
    findings anchor to the offending node's own line."""
    if tree is not None:
        for node in ast.walk(tree):
            if isinstance(node, _SIMPLE_STMTS):
                end = node.end_lineno or node.lineno
                if node.lineno <= line <= end:
                    return (node.lineno, end)
    return (line, line)


def _def_spans(tree: ast.Module) -> List[Tuple[int, int, int]]:
    """(first_line_incl_decorators, header_line, end_line) per def/class."""
    spans = []
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            first = min([node.lineno] + [d.lineno for d in node.decorator_list])
            spans.append((first, node.lineno, node.end_lineno or node.lineno))
    return spans


def build_suppressions(source: str, tree: Optional[ast.Module]) -> Suppressions:
    sup = Suppressions()
    spans = _def_spans(tree) if tree is not None else []
    lines = source.splitlines()

    def next_code_line(after: int) -> int:
        """First non-blank, non-comment line after ``after`` (1-based) —
        standalone directives may wrap their justification over several
        comment lines before the code they govern."""
        for i in range(after, len(lines)):
            text = lines[i].strip()
            if text and not text.startswith("#"):
                return i + 1
        return after + 1

    for d in _parse_directives(source):
        sup._directives.append(d)
        bad = (
            d.form == "malformed"
            or not d.rules
            or not d.why.strip()
            or any(r not in RULE_IDS for r in d.rules)
        )
        if bad:
            sup.hygiene.append(d)
            continue
        rules = set(d.rules)
        if d.form == "disable-file":
            sup.file_rules |= rules
        elif d.form == "disable-scope":
            code_line = d.line if not d.standalone else next_code_line(d.line)
            target = None
            for first, header, end in spans:
                if first <= code_line <= header:
                    # directive sits on/above the header (decorators count)
                    target = (min(first, d.line), end)
                    break
            if target is None:
                sup.hygiene.append(d)
            else:
                sup.span_rules.append((target[0], target[1], rules))
        else:  # disable
            target_line = next_code_line(d.line) if d.standalone else d.line
            first, last = _simple_stmt_span(tree, target_line)
            for ln in range(first, last + 1):
                sup.line_rules.setdefault(ln, set()).update(rules)
    return sup


# --------------------------------------------------------------------------
# AST helpers shared by the rules
# --------------------------------------------------------------------------

def dotted_name(node: ast.AST) -> Optional[str]:
    """'torch.cuda.synchronize' for nested Attribute/Name chains, else
    None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def resolve_dotted(name: Optional[str], imports: Dict[str, str]) -> Optional[str]:
    """Rewrite the first segment of a dotted name through the file's
    import table: ``coll.all_max`` →
    ``kubernetes_tpu_torch.parallel.collectives.all_max``."""
    if not name:
        return None
    head, _, rest = name.partition(".")
    base = imports.get(head)
    if base is None:
        return name
    return base + ("." + rest if rest else "")


def is_partial(node: ast.AST, imports: Dict[str, str]) -> bool:
    """Is this a ``functools.partial(...)`` call?"""
    if not isinstance(node, ast.Call) or not node.args:
        return False
    fn = resolve_dotted(dotted_name(node.func), imports)
    return fn in ("functools.partial", "partial")


def is_loop_run(call: ast.Call, imports: Dict[str, str]) -> bool:
    """Is this call :func:`kubernetes_tpu_torch.ops.device_loop.run`, the
    one site that captures a round body into a CUDA graph?"""
    full = resolve_dotted(dotted_name(call.func), imports) or ""
    return full == "device_loop.run" or full.endswith(".device_loop.run")


def loop_run_statics(call: ast.Call) -> Optional[ast.expr]:
    """The ``statics`` argument of a ``device_loop.run`` call (sixth
    positional or keyword), or None when it is left out."""
    if len(call.args) > 5:
        return call.args[5]
    for kw in call.keywords:
        if kw.arg == "statics":
            return kw.value
    return None


def local_binding(func: Optional[ast.AST], name: str,
                  before: int) -> Optional[ast.AST]:
    """The last ``name = <expr>`` (the expression) or ``def name`` (the
    def) in ``func``'s own body before line ``before``, else None.
    Nested defs are searched too, but not their bodies."""
    if func is None:
        return None
    found: Optional[ast.AST] = None

    def visit(body: Sequence[ast.stmt]) -> None:
        nonlocal found
        for node in body:
            if node.lineno >= before:
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if node.name == name:
                    found = node
                continue
            if isinstance(node, ast.ClassDef):
                continue
            if isinstance(node, ast.Assign):
                if any(isinstance(t, ast.Name) and t.id == name
                       for t in node.targets):
                    found = node.value
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(node, attr, None)
                if isinstance(sub, list) and sub and isinstance(sub[0], ast.stmt):
                    visit(sub)
            for h in getattr(node, "handlers", ()):
                visit(h.body)

    visit(func.body)
    return found


def first_only_test(test: ast.expr, first: Set[str]) -> bool:
    """Does ``if <test>:`` run its body only in round 0? True when the
    test is the round's ``first`` flag, or an ``and`` that includes it —
    :func:`device_loop.run` runs round 0 eagerly, outside the graph."""
    if not first:
        return False
    if isinstance(test, ast.Name):
        return test.id in first
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        return any(first_only_test(v, first) for v in test.values)
    return False


# --------------------------------------------------------------------------
# files, functions, project
# --------------------------------------------------------------------------

@dataclass
class FuncRecord:
    qual: str  # "<relpath>::Outer.name"
    name: str
    node: ast.AST  # FunctionDef / AsyncFunctionDef
    file: "FileInfo"
    params: List[str]
    capture_root: bool = False
    #: parameters that are host values by the round contract: ``first``,
    #: ``tag``, everything ``functools.partial`` binds, keyword-only
    static_params: Set[str] = field(default_factory=set)
    #: the round-0 flag: ``if first:`` bodies run eagerly, uncaptured
    first_params: Set[str] = field(default_factory=set)

    @property
    def line(self) -> int:
        return self.node.lineno


@dataclass
class FileInfo:
    path: str  # absolute
    relpath: str  # root-relative, '/'-separated — Finding.path
    source: str
    lines: List[str]
    tree: Optional[ast.Module]
    parse_error: Optional[BaseException]
    suppressions: Suppressions
    imports: Dict[str, str] = field(default_factory=dict)
    functions: Dict[str, FuncRecord] = field(default_factory=dict)  # local name -> rec
    module: Optional[str] = None  # dotted module when under a package

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def finding(self, node_or_line, rule: str, message: str) -> Finding:
        if isinstance(node_or_line, int):
            line, col = node_or_line, 0
        else:
            line, col = node_or_line.lineno, node_or_line.col_offset
        return Finding(self.relpath, line, col, rule, message,
                       self.line_text(line))


def _collect_imports(tree: ast.Module) -> Dict[str, str]:
    imports: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                imports[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0]
                )
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for a in node.names:
                if a.name == "*":
                    continue
                imports[a.asname or a.name] = f"{node.module}.{a.name}"
    return imports


def _params_of(node: ast.AST) -> List[str]:
    a = node.args
    return [p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)]


def _collect_functions(fi: FileInfo) -> None:
    """Top-level (and class-level) function records + capture-root
    marking. Nested defs are analyzed inside their parent, not indexed —
    except a nested round body handed to ``device_loop.run``."""

    def visit(body: Sequence[ast.stmt], prefix: str) -> None:
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                rec = FuncRecord(
                    qual=f"{fi.relpath}::{prefix}{node.name}",
                    name=prefix + node.name, node=node, file=fi,
                    params=_params_of(node),
                )
                fi.functions[prefix + node.name] = rec
            elif isinstance(node, ast.ClassDef):
                visit(node.body, prefix + node.name + ".")

    if fi.tree is not None:
        visit(fi.tree.body, "")
        _mark_capture_roots(fi)


def mark_round_root(rec: FuncRecord, n_bound: int = 0,
                    bound_kw: Iterable[str] = ()) -> None:
    """Mark ``rec`` a capture root under the round contract, after
    ``n_bound`` leading parameters a ``functools.partial`` closed over:
    the next two are ``ctx`` and ``state`` (tensors), the two after them
    ``first`` and ``tag`` (host); keyword-only parameters and the
    partial's keywords are statics."""
    rec.capture_root = True
    a = rec.node.args
    positional = [p.arg for p in a.posonlyargs + a.args]
    rec.static_params |= set(positional[:n_bound])
    rec.static_params |= set(positional[n_bound + 2: n_bound + 4])
    rec.static_params |= {p.arg for p in a.kwonlyargs}
    rec.static_params |= set(bound_kw)
    if len(positional) > n_bound + 2:
        rec.first_params.add(positional[n_bound + 2])


def loop_bodies(fi: FileInfo) -> List[Tuple[ast.Call, Optional[ast.AST], ast.AST]]:
    """Every ``device_loop.run`` call of the file as (call, enclosing
    function or None, resolved body expression: a partial call, a def,
    or the first argument itself)."""
    out = []

    def walk(node: ast.AST, func: Optional[ast.AST]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                walk(child, child)
                continue
            if (isinstance(child, ast.Call) and child.args
                    and is_loop_run(child, fi.imports)):
                body: ast.AST = child.args[0]
                if isinstance(body, ast.Name):
                    bound = local_binding(func, body.id, child.lineno)
                    if bound is not None:
                        body = bound
                out.append((child, func, body))
            walk(child, func)

    if fi.tree is not None and "device_loop" in fi.source:
        walk(fi.tree, None)
    return out


def _mark_capture_roots(fi: FileInfo) -> None:
    """Mark the round bodies handed to ``device_loop.run``: a module
    function named directly, a nested def, or a ``functools.partial`` —
    its target after the positions it binds, and every module function it
    passes as a value (``partial(_solo_round, _general_round, **flags)``
    roots both). A call whose ``statics`` is the literal ``None`` keeps
    the Python loop, so its body is no root."""
    for call, func, body in loop_bodies(fi):
        statics = loop_run_statics(call)
        if statics is None or (isinstance(statics, ast.Constant)
                               and statics.value is None):
            continue
        if isinstance(body, ast.Name) and body.id in fi.functions:
            mark_round_root(fi.functions[body.id])
        elif (isinstance(body, ast.Attribute)
              and isinstance(body.value, ast.Name)
              and body.value.id == "self" and func is not None):
            # a bound method of the caller's class: `self` is bound
            outer = next((r for r in fi.functions.values()
                          if r.node is func), None)
            prefix = outer.name.rsplit(".", 1)[0] + "." \
                if outer is not None and "." in outer.name else ""
            rec = fi.functions.get(prefix + body.attr)
            if rec is not None:
                mark_round_root(rec, n_bound=1)
        elif isinstance(body, (ast.FunctionDef, ast.AsyncFunctionDef)):
            outer = fi.functions.get(func.name) if func is not None else None
            prefix = (outer.name + "." if outer is not None
                      else "<locals>.")
            name = prefix + body.name
            rec = fi.functions.get(name)
            if rec is None:
                rec = FuncRecord(qual=f"{fi.relpath}::{name}", name=name,
                                 node=body, file=fi,
                                 params=_params_of(body))
                fi.functions[name] = rec
            mark_round_root(rec)
        elif is_partial(body, fi.imports):
            target = body.args[0]
            kws = {kw.arg for kw in body.keywords if kw.arg}
            if isinstance(target, ast.Name) and target.id in fi.functions:
                mark_round_root(fi.functions[target.id],
                                n_bound=len(body.args) - 1, bound_kw=kws)
            for a in body.args[1:]:
                if isinstance(a, ast.Name) and a.id in fi.functions:
                    mark_round_root(fi.functions[a.id], bound_kw=kws)


def _module_name(path: str) -> Optional[str]:
    """Dotted module for a file under package dirs (walks up while
    __init__.py exists)."""
    path = os.path.abspath(path)
    parts = [os.path.splitext(os.path.basename(path))[0]]
    d = os.path.dirname(path)
    while os.path.exists(os.path.join(d, "__init__.py")):
        parts.append(os.path.basename(d))
        d = os.path.dirname(d)
    if len(parts) == 1 and parts[0] != "__init__":
        return None
    if parts[0] == "__init__":
        parts = parts[1:]
    return ".".join(reversed(parts)) or None


def load_file(path: str, root: str) -> FileInfo:
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        source = f.read()
    return make_fileinfo(source, path, root)


def make_fileinfo(source: str, path: str, root: str) -> FileInfo:
    rel = os.path.relpath(path, root).replace(os.sep, "/") \
        if os.path.isabs(path) else path.replace(os.sep, "/")
    tree: Optional[ast.Module] = None
    err: Optional[BaseException] = None
    try:
        tree = ast.parse(source, filename=path)
    except (SyntaxError, ValueError, RecursionError) as e:
        err = e
    fi = FileInfo(
        path=path, relpath=rel, source=source,
        lines=source.splitlines(), tree=tree, parse_error=err,
        suppressions=build_suppressions(source, tree),
    )
    if tree is not None:
        fi.imports = _collect_imports(tree)
        _collect_functions(fi)
    fi.module = _module_name(path) if os.path.isabs(path) else None
    return fi


def iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        p = os.path.abspath(p)
        if os.path.isfile(p) and p.endswith(".py"):
            out.append(p)
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d != "__pycache__" and not d.startswith(".")]
                out.extend(os.path.join(dirpath, f)
                           for f in sorted(filenames) if f.endswith(".py"))
    return sorted(set(out))


class Project:
    """All files under analysis + the cross-file function index the
    interprocedural rules (R1/R2) need."""

    def __init__(self, files: Sequence[FileInfo]) -> None:
        self.files = list(files)
        #: dotted module -> FileInfo (only files that live under packages)
        self.modules: Dict[str, FileInfo] = {
            fi.module: fi for fi in self.files if fi.module
        }

    @classmethod
    def from_paths(cls, paths: Sequence[str], root: str) -> "Project":
        return cls([load_file(p, root) for p in iter_py_files(paths)])

    def resolve_call(self, call: ast.Call, fi: FileInfo,
                     local_prefix: str = "") -> Optional[FuncRecord]:
        """Map a call expression to a first-party FuncRecord, through the
        caller file's imports, or None for stdlib/third-party/dynamic."""
        return self.resolve_name(dotted_name(call.func), fi, local_prefix)

    def resolve_name(self, name: Optional[str], fi: FileInfo,
                     local_prefix: str = "") -> Optional[FuncRecord]:
        """Resolve a (dotted) function reference to a FuncRecord."""
        if name is None:
            return None
        if name in fi.functions:
            return fi.functions[name]
        if local_prefix and (local_prefix + name) in fi.functions:
            return fi.functions[local_prefix + name]
        full = resolve_dotted(name, fi.imports)
        if full is None or "." not in full:
            return None
        mod, _, func = full.rpartition(".")
        target = self.modules.get(mod)
        if target is not None and func in target.functions:
            return target.functions[func]
        return None

    def capture_roots(self) -> List[FuncRecord]:
        return [rec for fi in self.files
                for rec in fi.functions.values() if rec.capture_root]


# --------------------------------------------------------------------------
# rule registry + entry points
# --------------------------------------------------------------------------

#: rule id -> callable(project) -> List[Finding]; populated by rules.py
_PROJECT_RULES: Dict[str, Callable[[Project], List[Finding]]] = {}


def register_rule(rule_id: str):
    def deco(fn):
        _PROJECT_RULES[rule_id] = fn
        return fn
    return deco


def run_lint(
    paths: Sequence[str],
    root: Optional[str] = None,
    select: Optional[Iterable[str]] = None,
    respect_suppressions: bool = True,
) -> List[Finding]:
    """Lint ``paths`` (files/dirs). Returns surviving findings sorted by
    (path, line, rule); suppressed findings are dropped, and suppression
    hygiene problems surface as R0."""
    root = os.path.abspath(root or os.getcwd())
    project = Project.from_paths(paths, root)
    return lint_project(project, select=select,
                        respect_suppressions=respect_suppressions)


def lint_project(
    project: Project,
    select: Optional[Iterable[str]] = None,
    respect_suppressions: bool = True,
) -> List[Finding]:
    from kubernetes_tpu_torch.lint import rules as _rules  # registers on import

    _rules.ensure_registered()
    wanted = set(select) if select else set(RULE_IDS)
    unknown = wanted - set(RULE_IDS)
    if unknown:
        raise ValueError(f"unknown rule id(s): {sorted(unknown)}")
    findings: List[Finding] = []
    for rule_id, fn in sorted(_PROJECT_RULES.items()):
        if rule_id in wanted:
            findings.extend(fn(project))
    by_file = {fi.relpath: fi for fi in project.files}
    kept: List[Finding] = []
    for f in findings:
        fi = by_file.get(f.path)
        if (respect_suppressions and fi is not None
                and f.rule != "R0"
                and fi.suppressions.allows(f.line, f.rule)):
            continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.rule, f.col))
    # stable occurrence indices for identical (rule, path, snippet) triples
    seen: Dict[Tuple[str, str, str], int] = {}
    out: List[Finding] = []
    for f in kept:
        key = (f.rule, f.path, " ".join(f.snippet.split()))
        n = seen.get(key, 0)
        seen[key] = n + 1
        out.append(Finding(f.path, f.line, f.col, f.rule, f.message,
                           f.snippet, occurrence=n))
    return out


def lint_source(
    source: str,
    filename: str = "<snippet>",
    select: Optional[Iterable[str]] = None,
    capture_all: bool = False,
    respect_suppressions: bool = True,
) -> List[Finding]:
    """Lint one source string. ``capture_all=True`` treats every
    *uncalled* top-level function as a capture root — what
    :func:`kubernetes_tpu_torch.testing.lint_clean` uses so a round
    program's body is checked even though its ``device_loop.run`` call
    lives in the caller. Such a root's positional parameters are tensors
    except the round flag ``first`` (and ``tag``); keyword-only ones are
    statics. Functions the snippet itself calls are left to the
    interprocedural propagation, so a host helper invoked with static
    values is judged by its real call-site taint."""
    fi = make_fileinfo(source, filename, root=os.getcwd())
    if capture_all:
        called: Set[str] = set()
        for rec in fi.functions.values():
            for sub in ast.walk(rec.node):
                if isinstance(sub, ast.Call):
                    name = dotted_name(sub.func)
                    if name and name != rec.name and name in fi.functions:
                        called.add(name)
        for name, rec in fi.functions.items():
            if name not in called and not rec.capture_root:
                rec.capture_root = True
                a = rec.node.args
                rec.static_params |= {p.arg for p in a.kwonlyargs}
                for p in a.posonlyargs + a.args:
                    if p.arg in ("first", "tag"):
                        rec.static_params.add(p.arg)
                        if p.arg == "first":
                            rec.first_params.add(p.arg)
    return lint_project(Project([fi]), select=select,
                        respect_suppressions=respect_suppressions)
