"""Instrumented-lock runtime sanitizer — the dynamic half of the
concurrency-discipline layer (graftlint R9/R10 are the static half).

graftlint proves lock discipline for the lock acquisitions it can SEE
lexically; everything that crosses a class boundary (the ServingLoop
holding ``loop.lock`` while ``schedule_cycle`` walks the cache, the
/debug handler thread racing the soak's phase engine) is runtime
territory. :class:`LockSanitizer` covers it TSan-style, with the
machinery this codebase already trusts: injected clocks, deterministic
bookkeeping, findings as data.

Three finding kinds, all deduplicated and bounded:

``order-cycle``
    The per-process lock-acquisition-order graph (edge A→B when some
    thread acquired B while holding A) gained a cycle — two threads
    that interleave the involved acquisitions can deadlock. Detection
    is on the ORDER GRAPH, not on live contention, so a seeded test
    catches the hazard with plain sequential execution: thread 1 takes
    A then B, thread 2 takes B then A, and the second interleaving
    closes the cycle even though nobody ever blocked.

``held-too-long``
    A lock was held longer than ``hold_budget_s`` (measured on the
    injected clock). This is the runtime shadow of graftlint R10: a
    blocking call under a lock that the static rule could not see
    (through a callback, a stub, a C extension) still shows up as hold
    time.

``guard-violation``
    Debug-mode dynamic guarded-by: code paths that declare "this runs
    with lock L held" (``assert_held`` — the runtime analog of the
    ``*_locked`` naming convention and ``# guarded-by:`` comments)
    were entered by a thread not holding L.

Zero cost when off: components take an optional ``lock_factory``
callable and default to plain ``threading.Lock``/``RLock`` when it is
None — the sanitizer object, the wrapper class, and every check only
exist when ``observability.lockSanitizer.enabled`` armed them.
:func:`assert_held` no-ops (one ``getattr``) on plain locks.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Set, Tuple


@dataclass
class LockSanitizerConfig:
    """``observability.lockSanitizer`` — arming and budgets."""

    enabled: bool = False
    #: a lock held longer than this is a ``held-too-long`` finding
    #: (injected-clock seconds); 0 disables the hold check
    hold_budget_s: float = 0.25
    #: check ``assert_held`` declarations (guard-violation findings);
    #: cheap, but on the hottest paths, so separately gated
    debug_guards: bool = True
    #: findings ring capacity — counts keep accumulating past it
    max_findings: int = 256


@dataclass(frozen=True)
class LockFinding:
    kind: str  # order-cycle | held-too-long | guard-violation
    detail: str
    locks: Tuple[str, ...]
    thread: str

    def to_json(self) -> dict:
        return {"kind": self.kind, "detail": self.detail,
                "locks": list(self.locks), "thread": self.thread}


class LockSanitizer:
    """Process-wide acquisition-order bookkeeping for every
    :class:`InstrumentedLock` built through :meth:`make_lock`.

    ``on_finding`` (when given) is called OUTSIDE the sanitizer's own
    bookkeeping lock with the finding kind — the scheduler wires it to
    ``scheduler_lock_sanitizer_findings_total{kind}`` — so a metrics
    registry that itself locks can never close a cycle through us (we
    practice the R10 discipline we police).
    """

    KINDS = ("order-cycle", "held-too-long", "guard-violation")

    def __init__(self, config: Optional[LockSanitizerConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 on_finding: Optional[Callable[[str], None]] = None) -> None:
        self.config = config or LockSanitizerConfig()
        self.clock = clock
        self.on_finding = on_finding
        #: meta-lock for the graph/findings — plain, never instrumented
        self._meta = threading.Lock()
        self._tls = threading.local()
        #: acquisition-order edges: name -> set of names acquired while
        #: ``name`` was held
        self._edges: Dict[str, Set[str]] = {}
        self._findings: Deque[LockFinding] = deque(
            maxlen=max(1, int(self.config.max_findings)))
        self._counts: Dict[str, int] = {k: 0 for k in self.KINDS}
        #: dedupe keys (cycle signature / lock name / site) so one bad
        #: pattern in a hot loop is one finding, not a flood
        self._seen: Set[Tuple[str, str]] = set()

    # -- lock construction --------------------------------------------------

    def make_lock(self, name: str, kind: str = "lock"):
        """An instrumented ``threading.Lock`` (``kind='lock'``) or
        ``RLock`` (``kind='rlock'``) registered under ``name``."""
        inner = threading.RLock() if kind == "rlock" else threading.Lock()
        return InstrumentedLock(self, name, inner)

    def factory(self, prefix: str = "") -> Callable[..., "InstrumentedLock"]:
        """A ``lock_factory(name, kind='lock')`` bound to this sanitizer
        — the injectable seam components accept."""
        def make(name: str, kind: str = "lock"):
            return self.make_lock(prefix + name, kind)
        return make

    # -- per-thread held stack ----------------------------------------------

    def _held(self) -> List[Tuple[str, float]]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def held_names(self) -> Tuple[str, ...]:
        """Locks the CURRENT thread holds, in acquisition order."""
        return tuple(name for name, _t in self._held())

    # -- events (called by InstrumentedLock) --------------------------------

    def note_acquired(self, name: str, reentrant: bool) -> None:
        held = self._held()
        now = self.clock()
        if reentrant:
            held.append((name, now))
            return
        holders = [h for h, _t in held]
        held.append((name, now))
        if not holders:
            return
        with self._meta:
            new_edges = [(h, name) for h in holders
                         if name not in self._edges.setdefault(h, set())]
            for h, _ in new_edges:
                self._edges[h].add(name)
            cycles = [self._find_cycle(name, h) for h, _ in new_edges]
        for cyc in cycles:
            if cyc is not None:
                self._record(
                    "order-cycle",
                    "lock acquisition order forms a cycle "
                    f"({' -> '.join(cyc)} -> {cyc[0]}): threads that "
                    "interleave these acquisitions can deadlock",
                    tuple(cyc), dedupe="/".join(sorted(set(cyc))))

    def note_released(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name:
                _n, t0 = held.pop(i)
                break
        else:
            return
        if name in (h for h, _t in held):
            return  # still reentrantly held: the outer release times it
        budget = self.config.hold_budget_s
        if budget and budget > 0:
            dt = self.clock() - t0
            if dt > budget:
                self._record(
                    "held-too-long",
                    f"`{name}` held {dt:.3f}s against a "
                    f"{budget:.3f}s budget — blocking work is "
                    "happening under this lock",
                    (name,), dedupe=name)

    def _find_cycle(self, start: str, target: str) -> Optional[List[str]]:
        """DFS path start→…→target in the edge graph; with the new edge
        target→start that path IS the cycle. Called under ``_meta``."""
        stack: List[Tuple[str, List[str]]] = [(start, [start])]
        visited: Set[str] = set()
        while stack:
            node, path = stack.pop()
            if node == target:
                return path
            if node in visited:
                continue
            visited.add(node)
            for nxt in sorted(self._edges.get(node, ())):
                stack.append((nxt, path + [nxt]))
        return None

    # -- dynamic guarded-by -------------------------------------------------

    def note_guard_violation(self, lock_name: str, site: str) -> None:
        if not self.config.debug_guards:
            return
        self._record(
            "guard-violation",
            f"`{site}` declares it runs with `{lock_name}` held, but "
            "the current thread does not hold it",
            (lock_name,), dedupe=f"{lock_name}@{site}")

    # -- findings -----------------------------------------------------------

    def _record(self, kind: str, detail: str, locks: Tuple[str, ...],
                dedupe: str) -> None:
        with self._meta:
            if (kind, dedupe) in self._seen:
                return
            self._seen.add((kind, dedupe))
            self._counts[kind] = self._counts.get(kind, 0) + 1
            self._findings.append(LockFinding(
                kind, detail, locks, threading.current_thread().name))
        cb = self.on_finding
        if cb is not None:
            cb(kind)

    def counts(self) -> Dict[str, int]:
        with self._meta:
            return dict(self._counts)

    def total_findings(self) -> int:
        with self._meta:
            return sum(self._counts.values())

    def findings(self) -> List[LockFinding]:
        with self._meta:
            return list(self._findings)

    def snapshot(self) -> dict:
        """/debug- and flight-record-shaped summary."""
        with self._meta:
            return {
                "counts": dict(self._counts),
                "edges": sum(len(v) for v in self._edges.values()),
                "findings": [f.to_json() for f in self._findings],
            }


class InstrumentedLock:
    """Drop-in ``threading.Lock``/``RLock`` wrapper that reports
    acquire/release to its :class:`LockSanitizer`. Supports the full
    context-manager + acquire/release surface the codebase uses."""

    __slots__ = ("_san", "name", "_inner", "_depth_tls")

    def __init__(self, sanitizer: LockSanitizer, name: str, inner) -> None:
        self._san = sanitizer
        self.name = name
        self._inner = inner
        self._depth_tls = threading.local()

    def _depth(self) -> int:
        return getattr(self._depth_tls, "d", 0)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            reentrant = self._depth() > 0
            self._depth_tls.d = self._depth() + 1
            self._san.note_acquired(self.name, reentrant)
        return got

    def release(self) -> None:
        self._depth_tls.d = max(0, self._depth() - 1)
        self._san.note_released(self.name)
        self._inner.release()

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def held_by_me(self) -> bool:
        return self._depth() > 0

    def assert_held(self, site: str) -> None:
        if not self.held_by_me():
            self._san.note_guard_violation(self.name, site)


def assert_held(lock, site: str) -> None:
    """Declare "this code runs with ``lock`` held" — the runtime analog
    of the ``*_locked`` naming convention. One no-op ``getattr`` on a
    plain ``threading`` lock; a recorded ``guard-violation`` finding on
    an instrumented one when the declaration is false."""
    check = getattr(lock, "assert_held", None)
    if check is not None:
        check(site)


def make_lock(lock_factory, name: str, kind: str = "lock"):
    """The seam components use: ``lock_factory(name, kind)`` when armed,
    a plain ``threading`` lock when ``lock_factory`` is None."""
    if lock_factory is not None:
        return lock_factory(name, kind)
    return threading.RLock() if kind == "rlock" else threading.Lock()
