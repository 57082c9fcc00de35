"""Fault injection + resilience primitives for the batched solve path
(the port's copy of ``kubernetes_tpu/faults.py``; only
:func:`poison_solution` differs: it poisons tensors, not JAX arrays).

The paper's premise — a Go control plane trusting an out-of-process TPU
solver across the extender/gRPC seam — only holds if the scheduler
survives that solver timing out, crashing, or returning garbage. This
module supplies both halves of proving that:

- :class:`FaultInjector` — a **deterministic, seeded** harness that arms
  fault rules against named sites ("solve:batch", "extender:filter",
  "grpc:Filter") and fires them from a private RNG stream, so a chaos
  run replays bit-identically under ``-p no:randomly``. It plugs into
  the solver entry (``ops/assign.py`` ``fault_hook``), the HTTP extender
  transport, and the gRPC shim client.

- :class:`CircuitBreaker` — closed → open → half-open per solver tier /
  extender endpoint. While open the tier is skipped outright (no latency
  burned on a wedged TPU); after ``open_duration_s`` a bounded number of
  half-open probes retry the real call — the health probe IS a solve —
  and a success closes the breaker again.

- :class:`RetryPolicy` — bounded retry with exponential backoff + full
  jitter for the transport seams (and the in-process solver tiers, where
  the backoff sleep is injectable so fake-clock tests never block).

The injected fault classes map one-to-one onto the validation /
exception paths of the degradation ladder (scheduler.py
``_solve_ladder`` + ops/assign.py ``validate_solution``):

========== ============================================================
kind        what it simulates → what catches it
========== ============================================================
timeout     solver/transport deadline blown → SolverTimeout / socket.timeout
connection  TPU service crash / conn refused → SolverCrash / ConnectionError
partial     truncated response (half the rows) → shape check
stale       snapshot race: rows from a dead snapshot → range check
garbage     corrupt assignment indices → range/invalid-node check
nan         NaN/Inf cost or usage tensors → finiteness check
infeasible  lying solver overpacking node 0 → capacity re-check
truncated   torn wire frame → ValueError from the transport
error-field remote verb error → extender error-result path
corrupt     mistyped payload → response-parse hardening (ExtenderError)
========== ============================================================

The NETWORK fault kinds (the hub/REST/watch seam, PR 15) ride the same
injector through :meth:`FaultInjector.rpc_hook`:

=========== ===========================================================
rpc_error    the RPC definitely failed before the server acted →
             :class:`RPCError`; a blind retry is safe
rpc_timeout  the RPC timed out AMBIGUOUSLY — the server may or may not
             have committed → :class:`RPCTimeout`; the scheduler's bind
             protocol resolves it by read-your-write verification (GET
             the pod, compare uid+nodeName, adopt or requeue — never a
             blind re-bind that could double-place)
latency      the call succeeds after an injected delay (rule.latency_s)
drop /       watch-stream faults (chaos.FuzzedCursor at "watch:event" /
duplicate /  "watch:batch"): events vanish, repeat, or arrive out of
reorder      order — the Reflector's resourceVersion-monotonic dedupe
             must make them no-ops
compacted    a forced 410/Compacted on the watch — the relist-storm
             trigger
=========== ===========================================================
"""

from __future__ import annotations

import fnmatch
import socket
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple


class SolverFault(Exception):
    """Base of the injected/derived solver failures the ladder catches."""


class RPCError(Exception):
    """A hub RPC failed DEFINITELY before the server acted (connection
    refused, 5xx before the handler ran). The operation did not commit;
    retrying through the normal requeue path is safe."""


class RPCTimeout(Exception):
    """A hub RPC timed out with an AMBIGUOUS outcome: the server may or
    may not have committed the operation before the response was lost.
    For a bind this is the dangerous class — a blind retry could bind a
    pod that IS already bound (a hub CAS conflict at best, a double
    placement with a less careful store). The scheduler resolves it by
    read-your-write verification (GET the pod, compare uid + nodeName,
    then adopt or requeue — scheduler._resolve_ambiguous_bind)."""


class SolverTimeout(SolverFault):
    """The solve blew its deadline (injected, or a transport timeout)."""


class SolverCrash(SolverFault):
    """The solver process/connection died mid-solve."""


class SolverResultInvalid(SolverFault):
    """The solver answered, but validation rejected the result."""


class DeviceLost(SolverFault):
    """The accelerator went away under us (XLA "device lost" class):
    resident buffers — the device snapshot, in-flight solves — are gone.
    Recovery rebuilds the resident table from the host mirror
    (cache.drop_device_snapshot) and the ladder absorbs the solve
    outage (batch -> batch-cpu -> greedy) until the device heals."""


class DeviceOOM(SolverFault):
    """Device allocation failure (RESOURCE_EXHAUSTED class). Same
    recovery path as :class:`DeviceLost`: drop residents, rebuild from
    host, degrade to the CPU tiers meanwhile."""


class ShardLost(DeviceLost):
    """ONE device of a mesh went away (a single-chip loss on a multi-
    chip slice). Sharded resident buffers have a shard on every mesh
    device, so losing any one of them poisons every collective — the
    recovery path is the DeviceLost path (drop residents, host-mode
    snapshots through the cooloff), and the heal probe re-places
    SHARDED once the mesh answers again. ``shard`` carries the lost
    device's mesh index for the chaos reports."""

    def __init__(self, message: str, shard: int = 0) -> None:
        super().__init__(message)
        self.shard = int(shard)


# ---------------------------------------------------------------------------
# Circuit breaker (closed -> open -> half-open)
# ---------------------------------------------------------------------------

CLOSED, HALF_OPEN, OPEN = "closed", "half-open", "open"

#: numeric encoding for the scheduler_circuit_breaker_state gauge
STATE_CODE = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}


class CircuitBreaker:
    """Per-target breaker: ``failure_threshold`` consecutive failures
    open it; after ``open_duration_s`` it half-opens and admits up to
    ``half_open_probes`` trial calls (the health probes — real calls,
    not pings); a probe success closes it, a probe failure re-opens."""

    def __init__(
        self,
        failure_threshold: int = 3,
        open_duration_s: float = 30.0,
        half_open_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[str, str], None]] = None,
    ) -> None:
        self.failure_threshold = max(1, int(failure_threshold))
        self.open_duration_s = open_duration_s
        self.half_open_probes = max(1, int(half_open_probes))
        self.clock = clock
        self.on_transition = on_transition
        self.state = CLOSED
        self.consecutive_failures = 0
        self.opened_at = 0.0
        self._probes_used = 0
        #: lifetime transition count (observability/tests)
        self.opens = 0

    def _transition(self, new: str) -> None:
        old, self.state = self.state, new
        if new == OPEN:
            self.opens += 1
            self.opened_at = self.clock()
        if new == HALF_OPEN:
            self._probes_used = 0
        if self.on_transition is not None and old != new:
            self.on_transition(old, new)

    def allow(self) -> bool:
        """May the next call go through? Half-open admits a bounded
        number of probes per open->half-open episode."""
        if self.state == CLOSED:
            return True
        if self.state == OPEN:
            if self.clock() - self.opened_at < self.open_duration_s:
                return False
            self._transition(HALF_OPEN)
        # HALF_OPEN
        if self._probes_used < self.half_open_probes:
            self._probes_used += 1
            return True
        return False

    def record_success(self) -> None:
        self.consecutive_failures = 0
        if self.state != CLOSED:
            self._transition(CLOSED)

    def record_failure(self) -> None:
        self.consecutive_failures += 1
        if self.state == HALF_OPEN or (
            self.state == CLOSED
            and self.consecutive_failures >= self.failure_threshold
        ):
            self._transition(OPEN)

    def state_code(self) -> int:
        return STATE_CODE[self.state]


# ---------------------------------------------------------------------------
# Bounded retry with exponential backoff + jitter
# ---------------------------------------------------------------------------


class RetryPolicy:
    """``call(fn)`` retries on the configured exception classes with
    exponential backoff and full jitter (AWS-style: sleep uniform in
    [0, min(max, base·2^attempt)·(1+jitter)]). ``sleep`` is injectable
    so fake-clock tests and the in-cycle solver retries never block."""

    def __init__(
        self,
        max_retries: int = 2,
        base_s: float = 0.05,
        max_s: float = 2.0,
        jitter: float = 0.2,
        seed: int = 0,
        sleep: Callable[[float], None] = time.sleep,
        retry_on: Tuple[type, ...] = (Exception,),
    ) -> None:
        import random

        self.max_retries = max(0, int(max_retries))
        self.base_s = base_s
        self.max_s = max_s
        self.jitter = jitter
        self.sleep = sleep
        self.retry_on = retry_on
        self._rng = random.Random(seed)
        #: lifetime retry count (tests/metrics read this)
        self.retries = 0

    def backoff_s(self, attempt: int) -> float:
        cap = min(self.max_s, self.base_s * (2.0 ** attempt))
        # clamp: a jitter > 1 (or negative base) must never produce a
        # negative delay — time.sleep(negative) raises
        return max(0.0, cap * (1.0 + self.jitter
                               * (self._rng.random() * 2.0 - 1.0)))

    def call(self, fn, deadline_s: Optional[float] = None,
             clock: Callable[[], float] = time.monotonic,
             on_retry: Optional[Callable[[int, Exception], None]] = None):
        """Run ``fn`` with bounded retries. ``deadline_s`` (absolute, on
        ``clock``) stops retrying when the next backoff would cross it —
        the last error propagates rather than blowing the cycle budget."""
        attempt = 0
        while True:
            try:
                return fn()
            except self.retry_on as e:
                if attempt >= self.max_retries:
                    raise
                delay = self.backoff_s(attempt)
                if deadline_s is not None and clock() + delay >= deadline_s:
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                self.retries += 1
                self.sleep(delay)
                attempt += 1


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------

#: kinds that raise at the call site instead of corrupting a payload
_RAISING = {
    "timeout": lambda site: socket.timeout(f"injected timeout at {site}"),
    "connection": lambda site: ConnectionError(
        f"injected connection reset at {site}"),
    "truncated": lambda site: ValueError(
        f"injected truncated frame at {site}"),
}

#: solver-side raising kinds (typed for the ladder's except clauses)
_SOLVER_RAISING = {
    "timeout": lambda site: SolverTimeout(f"injected solver timeout at {site}"),
    "connection": lambda site: SolverCrash(
        f"injected solver connection loss at {site}"),
    "crash": lambda site: SolverCrash(f"injected solver crash at {site}"),
    "device_lost": lambda site: DeviceLost(
        f"injected device loss at {site}"),
    "device_oom": lambda site: DeviceOOM(
        f"injected device OOM at {site}"),
    "shard_lost": lambda site: ShardLost(
        f"injected mesh shard loss at {site}"),
}

#: kinds the device-site hook (snapshot scatter / warmup compile) raises —
#: the accelerator-loss class, distinct from solver-result corruption
_DEVICE_RAISING = {
    "device_lost": _SOLVER_RAISING["device_lost"],
    "device_oom": _SOLVER_RAISING["device_oom"],
    "shard_lost": _SOLVER_RAISING["shard_lost"],
}


@dataclass
class FaultRule:
    """One armed fault: fnmatch ``site`` pattern, fault ``kind``, firing
    probability ``rate``, optional bounded ``remaining`` shot count.
    ``shard`` rides along for ``shard_lost`` rules so the raised
    :class:`ShardLost` names the lost mesh device; ``latency_s`` is the
    injected delay of a ``latency`` rule; ``commit_rate`` is the
    probability an ambiguous ``rpc_timeout`` DID commit server-side
    before the response was lost."""

    site: str
    kind: str
    rate: float = 1.0
    remaining: Optional[int] = None
    shard: Optional[int] = None
    latency_s: float = 0.0
    commit_rate: float = 0.5


class FaultInjector:
    """Deterministic seeded fault source shared by every hook site.

    Arm rules with :meth:`arm`; each hook consults :meth:`pick` with its
    site name. Rules match by ``fnmatch`` (so ``"solve:batch*"`` poisons
    both the TPU and CPU batch tiers but not the greedy oracle), fire
    from one private RNG stream (replayable), and may be shot-limited.
    """

    def __init__(self, seed: int = 0) -> None:
        import random

        self.rng = random.Random(seed)
        self.rules: List[FaultRule] = []
        #: (site, kind) -> times fired (assertable by chaos tests)
        self.fired: Dict[Tuple[str, str], int] = {}

    def arm(self, site: str, kind: str, rate: float = 1.0,
            count: Optional[int] = None,
            shard: Optional[int] = None,
            latency_s: float = 0.0,
            commit_rate: float = 0.5) -> "FaultInjector":
        self.rules.append(FaultRule(site, kind, rate, count, shard,
                                    latency_s, commit_rate))
        return self

    def fired_total(self, site_pattern: str = "*") -> int:
        return sum(n for (s, _), n in self.fired.items()
                   if fnmatch.fnmatch(s, site_pattern))

    def disarm(self, site_pattern: str = "*",
               kind: Optional[str] = None) -> int:
        """Remove armed rules matching ``site_pattern`` (and ``kind``,
        when given); returns how many were removed. The phase-scoped
        fault window: a soak phase arms its rules at entry and disarms
        exactly its own at exit, leaving any longer-lived rules (a
        whole-soak background latency rule) in place — clearing
        ``rules`` wholesale would close those too. Firing counters
        survive disarm: per-phase deltas stay attributable."""
        keep = [r for r in self.rules
                if not (fnmatch.fnmatch(r.site, site_pattern)
                        and (kind is None or r.kind == kind))]
        removed = len(self.rules) - len(keep)
        self.rules[:] = keep
        return removed

    def window(self, site: str, kind: str, **kw):
        """Context manager: arm one rule on entry, disarm THAT rule on
        exit (even on error) — the bracket a :class:`soak.SoakPhase`'s
        arm/disarm hooks are built from."""
        import contextlib

        @contextlib.contextmanager
        def _window():
            self.arm(site, kind, **kw)
            rule = self.rules[-1]
            try:
                yield rule
            finally:
                with contextlib.suppress(ValueError):
                    self.rules.remove(rule)

        return _window()

    def pick_rule(self, site: str,
                  kinds: Optional[Tuple[str, ...]] = None
                  ) -> Optional[FaultRule]:
        """First armed, matching, non-exhausted rule that passes its
        rate roll; records the firing and decrements bounded shots.
        ``kinds`` restricts the roll to rules of those kinds — callers
        whose site hosts several kinds with different applicability
        (watch:batch: a 410 fires on any poll, a reorder only when
        there are >= 2 frames to shuffle) roll each separately so an
        inapplicable pick never burns a bounded rule's shot or records
        a firing that did nothing."""
        for rule in self.rules:
            if rule.remaining == 0 or not fnmatch.fnmatch(site, rule.site):
                continue
            if kinds is not None and rule.kind not in kinds:
                continue
            if rule.rate < 1.0 and self.rng.random() >= rule.rate:
                continue
            if rule.remaining is not None:
                rule.remaining -= 1
            key = (site, rule.kind)
            self.fired[key] = self.fired.get(key, 0) + 1
            return rule
        return None

    def pick(self, site: str,
             kinds: Optional[Tuple[str, ...]] = None) -> Optional[str]:
        """Kind-only view of :meth:`pick_rule` (the original surface)."""
        rule = self.pick_rule(site, kinds)
        return rule.kind if rule is not None else None

    # -- transport seam (HTTP extender / gRPC shim) ------------------------

    def transport_fault(self, site: str) -> Optional[str]:
        """Raise for raising kinds; return corruption kinds ("corrupt",
        "error-field", "partial") for the caller to apply to its
        response; None = no fault."""
        kind = self.pick(site)
        if kind in _RAISING:
            raise _RAISING[kind](site)
        return kind

    @staticmethod
    def corrupt_response(kind: Optional[str], resp: dict) -> dict:
        """Apply a non-raising transport fault to a decoded response."""
        if kind == "error-field":
            return {"error": "injected remote failure"}
        if kind == "corrupt":
            # mistyped payload: exercises the parse hardening, which must
            # convert it into ExtenderError instead of crashing the cycle
            return {"nodenames": 12345, "failedNodes": "not-a-map"}
        if kind == "partial":
            # keys missing entirely — a half-written frame that still
            # decoded as JSON
            return {}
        return resp

    # -- device seam (snapshot scatter / warmup compile) -------------------

    def device_hook(self, site: str) -> Optional[str]:
        """Raise for the accelerator-loss kinds (``device_lost``,
        ``device_oom``, ``shard_lost``) armed at a device site — the
        snapshot scatter ("snapshot:device") and the AOT warmup
        ("warmup:compile") call this before touching the device; other
        kinds are returned for the caller to interpret (usually
        ignored). A ``shard_lost`` rule's ``shard`` index rides the
        raised exception."""
        rule = self.pick_rule(site)
        if rule is None:
            return None
        if rule.kind == "shard_lost":
            raise ShardLost(f"injected mesh shard loss at {site}",
                            shard=rule.shard or 0)
        if rule.kind in _DEVICE_RAISING:
            raise _DEVICE_RAISING[rule.kind](site)
        return rule.kind

    # -- hub RPC seam (binder / REST facade / pod-reader GET) --------------

    def rpc_hook(self, site: str):
        """Network-fault decision for one hub RPC (the bind commit, a
        verification GET, a REST verb). Returns ``None`` (no fault) or a
        triple ``(kind, rule, committed)``:

        - ``("rpc_error", rule, False)`` — the caller must raise
          :class:`RPCError` WITHOUT performing the server-side effect;
        - ``("rpc_timeout", rule, committed)`` — the AMBIGUOUS kind: the
          caller performs the server-side effect iff ``committed`` (the
          rule's ``commit_rate`` coin, rolled on the injector's private
          stream so runs replay), then raises :class:`RPCTimeout` either
          way — the client can never tell the two apart;
        - ``("latency", rule, True)`` — delay ``rule.latency_s`` then
          proceed normally.

        Other kinds armed at an rpc site are returned verbatim for the
        caller to interpret (site-specific extensions)."""
        rule = self.pick_rule(site)
        if rule is None:
            return None
        if rule.kind == "rpc_timeout":
            return (rule.kind, rule, self.rng.random() < rule.commit_rate)
        if rule.kind == "rpc_error":
            return (rule.kind, rule, False)
        return (rule.kind, rule, True)

    # -- solver seam (ops/assign.py fault_hook) ----------------------------

    def solver_hook(self, site: str, assigned, usage, rounds, n_nodes: int):
        """The ``fault_hook`` contract of batch_assign/greedy_assign:
        called after the solve with the would-be result; may raise a
        :class:`SolverFault` or return a poisoned (assigned, usage,
        rounds) triple."""
        kind = self.pick(site)
        if kind is None:
            return assigned, usage, rounds
        if kind in _SOLVER_RAISING:
            raise _SOLVER_RAISING[kind](site)
        return poison_solution(kind, assigned, usage, rounds, n_nodes,
                               self.rng)


def poison_solution(kind: str, assigned, usage, rounds, n_nodes: int, rng):
    """Corrupt a solver result the way a specific failure class would —
    each mapping to exactly one validate_solution rejection reason. A
    poisoned assignment goes back where the solver left it (the device
    of ``assigned``); the read that materialises it is counted."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.ops.sync import to_host

    dev = assigned.device if isinstance(assigned, torch.Tensor) else None
    # graftlint: disable=R7,R8 -- chaos harness: materializes the result
    # to poison it (a device result through the counted to_host; on a
    # mesh the assignment is already merged on the first device)
    a = np.asarray(to_host(assigned) if dev is not None else assigned,
                   np.int32)

    def back(x):
        return torch.as_tensor(x, device=dev) if dev is not None else x

    if kind == "partial":
        # truncated response: half the rows never arrived
        return back(a[: max(1, a.shape[0] // 2)]), usage, rounds
    if kind == "stale":
        # stale-snapshot race: node rows that only existed in a previous
        # snapshot generation (indices past the live table)
        return back(np.where(a >= 0, a + n_nodes + 3, a)), usage, rounds
    if kind == "garbage":
        a = np.asarray(
            [rng.randrange(-3, n_nodes + 5) for _ in range(a.shape[0])],
            dtype=np.int32,
        )
        return back(a), usage, rounds
    if kind == "nan":
        from kubernetes_tpu_torch.parallel.mesh import per_shard

        # a partitioned solve's usage is per shard (parallel.mesh.Blocks)
        usage = usage._replace(requested=per_shard(
            torch.full_like, usage.requested, float("nan"), split=0))
        return back(a), usage, rounds
    if kind == "infeasible":
        # the lying solver: every pod "fits" on node 0
        return back(np.where(a >= 0, 0, a)), usage, rounds
    raise ValueError(f"unknown fault kind {kind!r}")
