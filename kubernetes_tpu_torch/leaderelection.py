"""Leader election — active-passive HA for the scheduler, mirroring
client-go ``tools/leaderelection`` (``leaderelection.go:317``
tryAcquireOrRenew): CAS on a lease record with holder identity, lease
duration, renew deadline, and retry period. The scheduler only runs while
leading (app/server.go:261 OnStartedLeading -> sched.Run).

The lock is pluggable: :class:`InMemoryLock` for tests/single-process,
:class:`FileLock` (atomic rename CAS) for multi-process on one host, and
:class:`LeaseLock` CASing a coordination Lease API object through the
hub — the reference's production path (resourcelock/leaselock.go via
interface.go:100), which makes failover observable/mediated by the
control plane itself. The elector is tick-driven (no background threads)
so the caller controls time. (The port of ``kubernetes_tpu/
leaderelection.py``; :class:`LeaseLock`'s hub is duck-typed — any object
with ``get_lease`` and ``cas_lease`` — since the port has no simulated
cluster yet, ROADMAP A.16.)"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

from kubernetes_tpu_torch.config import LeaderElectionConfig


@dataclass
class LeaderElectionRecord:
    """resourcelock.LeaderElectionRecord wire shape."""

    holder_identity: str = ""
    lease_duration_s: float = 15.0
    acquire_time: float = 0.0
    renew_time: float = 0.0
    leader_transitions: int = 0


class InMemoryLock:
    """Shared-object lock for in-process elections (tests, sim)."""

    def __init__(self) -> None:
        self._record: Optional[LeaderElectionRecord] = None

    def get(self) -> Optional[LeaderElectionRecord]:
        return self._record

    def create_or_update(self, record: LeaderElectionRecord, old) -> bool:
        """CAS: succeeds only if the current record still equals ``old``
        (the optimistic-concurrency resourceVersion check)."""
        if self._record is not old:
            return False
        self._record = record
        return True


class FileLock:
    """File-based lock: read-modify-write with atomic rename; the loaded
    JSON doubles as the resourceVersion (compare-and-swap on content).
    The compare and the replace are made atomic by holding an OS mutex
    (``fcntl.flock`` on a sidecar file) across the read-modify-write —
    without it two candidates can both pass the compare and both become
    leader (split brain), the exact failure leader election exists to
    prevent (tryAcquireOrRenew, leaderelection.go:317, relies on the
    apiserver's CAS being atomic)."""

    def __init__(self, path: str) -> None:
        self.path = path

    def _read(self) -> Optional[LeaderElectionRecord]:
        try:
            with open(self.path) as f:
                d = json.load(f)
            return LeaderElectionRecord(**d)
        except (OSError, ValueError):
            return None

    def get(self) -> Optional[LeaderElectionRecord]:
        return self._read()

    def create_or_update(self, record: LeaderElectionRecord, old) -> bool:
        import fcntl

        with open(f"{self.path}.lock", "a+") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                cur = self._read()
                if (cur is None) != (old is None):
                    return False
                if (
                    cur is not None
                    and old is not None
                    and cur.__dict__ != old.__dict__
                ):
                    return False
                tmp = f"{self.path}.tmp.{os.getpid()}"
                with open(tmp, "w") as f:
                    json.dump(record.__dict__, f)
                os.replace(tmp, self.path)
                return True
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)


class LeaseLock:
    """CAS a Lease API object through the hub — the reference's
    LeasesResourceLock (resourcelock/leaselock.go:86 Update does a
    client-go Update whose optimistic concurrency is the stored
    resourceVersion; here that is ``hub.cas_lease``). The rv observed at
    :meth:`get` bounds the CAS window, so two candidates that both read
    rv N can never both win the write."""

    def __init__(self, hub, namespace: str = "kube-system",
                 name: str = "kube-scheduler") -> None:
        self.hub = hub
        self.namespace = namespace
        self.name = name
        self._rv = 0

    def get(self) -> Optional[LeaderElectionRecord]:
        record, self._rv = self.hub.get_lease(self.namespace, self.name)
        return record

    def create_or_update(self, record: LeaderElectionRecord, old) -> bool:
        return self.hub.cas_lease(
            self.namespace, self.name, record, self._rv
        ) is not None


class LeaderElector:
    """leaderelection.go LeaderElector, tick-driven. Call ``tick()`` at
    least every retry_period; it acquires/renews and fires the callbacks."""

    def __init__(
        self,
        identity: str,
        lock,
        config: Optional[LeaderElectionConfig] = None,
        clock: Callable[[], float] = time.monotonic,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ) -> None:
        self.identity = identity
        self.lock = lock
        self.config = config or LeaderElectionConfig()
        self.clock = clock
        self.on_started_leading = on_started_leading or (lambda: None)
        self.on_stopped_leading = on_stopped_leading or (lambda: None)
        self._leading = False
        self._observed: Optional[LeaderElectionRecord] = None
        self._observed_at: float = 0.0
        #: fencing token: bumps on every not-leading -> leading
        #: transition, so work stamped with an older epoch is provably
        #: from a deposed incarnation (the Lamport/ZooKeeper fencing
        #: pattern; the reference gets the same property from the Lease
        #: resourceVersion its writes CAS against)
        self.epoch = 0

    def is_leader(self) -> bool:
        return self._leading

    # -- bind fencing ------------------------------------------------------

    def allow_bind(self) -> bool:
        """The fencing check the scheduler's bind path consults: may a
        side-effecting write go out NOW? True only while leading AND the
        lease, as last successfully renewed on our clock, is younger
        than ``renew_deadline_s`` — the reference's rule that a leader
        unable to renew by renewDeadline must stop acting
        (leaderelection.go:278 renew loop). A wedged leader that missed
        its ticks therefore fences ITSELF before the lease even expires,
        closing the window where a deposed leader's in-flight binds race
        the new leader's."""
        if not self._leading or self._observed is None:
            return False
        horizon = min(self.config.renew_deadline_s,
                      self._observed.lease_duration_s)
        return self.clock() < self._observed_at + horizon

    def release(self) -> bool:
        """Graceful lease release on shutdown (leaderelection.go:295
        release): CAS an already-expired anonymous record so a standby's
        next tick acquires immediately instead of waiting out the full
        lease duration. Returns True when the release wrote (we were
        leading and the CAS won); a lost CAS means someone already took
        over — nothing to release."""
        if not self._leading:
            return False
        cur = self.lock.get()
        now = self.clock()
        if cur is None or cur.holder_identity != self.identity:
            # the lease is no longer OURS (a successor already acquired
            # while our local flag was stale — e.g. a wedged leader
            # SIGTERMed after the standby took over): clobbering the
            # live record with an expired one would re-open the
            # double-leader window release() exists to avoid. Step down
            # locally, write nothing.
            self._set_leading(False)
            return False
        rec = LeaderElectionRecord(
            holder_identity="",
            lease_duration_s=0.0,
            acquire_time=now,
            renew_time=now,
            leader_transitions=(cur.leader_transitions
                                if cur is not None else 0),
        )
        wrote = self.lock.create_or_update(rec, cur)
        self._observed = rec if wrote else None
        self._observed_at = now
        self._set_leading(False)
        return wrote

    def tick(self) -> bool:
        """tryAcquireOrRenew (leaderelection.go:317). Returns leading."""
        now = self.clock()
        cur = self.lock.get()
        if cur is not None and cur != self._observed:
            self._observed = cur
            self._observed_at = now

        if cur is not None and cur.holder_identity != self.identity:
            # someone else holds it; steal only once their lease expires
            if self._observed_at + cur.lease_duration_s > now:
                self._set_leading(False)
                return False

        new = LeaderElectionRecord(
            holder_identity=self.identity,
            lease_duration_s=self.config.lease_duration_s,
            acquire_time=(
                cur.acquire_time
                if cur is not None and cur.holder_identity == self.identity
                else now
            ),
            renew_time=now,
            leader_transitions=(
                cur.leader_transitions
                if cur is not None and cur.holder_identity == self.identity
                else (cur.leader_transitions + 1 if cur is not None else 0)
            ),
        )
        if not self.lock.create_or_update(new, cur):
            self._set_leading(False)
            return False
        self._observed = new
        self._observed_at = now
        self._set_leading(True)
        return True

    def _set_leading(self, leading: bool) -> None:
        if leading and not self._leading:
            self._leading = True
            self.epoch += 1
            self.on_started_leading()
        elif not leading and self._leading:
            self._leading = False
            self.on_stopped_leading()
