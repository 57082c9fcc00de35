"""Incident autopsies: one correlated bundle per trigger, not four
uncorrelated /debug endpoints (the port of
``kubernetes_tpu/obs/incidents.py``).

When something goes wrong today the evidence is scattered: the flight
recorder has the cycle records, /debug/ledger has the SLO verdict,
/debug/memory has the OOM forensics, the queue gauges have the depth —
and nothing ties them to the SAME moment. The
:class:`IncidentRecorder` watches five trigger seams at every cycle
close (all derived from state the facade already holds — zero new
scheduler seams, zero device syncs):

=======================  ================================================
trigger                  detection (at ``Observability.end_cycle``)
=======================  ================================================
``slo-burn``             the SLO watchdog's ``burns_total()``
                         advanced this cycle
``invariant-violation``  the state-conservation auditor stamped
                         violations on the cycle record
``oom``                  a DeviceOOM forensic flag landed on the record
``retrace-storm``        the capture telemetry's per-site storm
                         counters advanced (obs/jaxtel.py)
``ladder-fallback``      the cycle burned >= ``fallback_burst_threshold``
                         ladder fallbacks
=======================  ================================================

Each non-suppressed trigger captures ONE bundle — the flight-recorder
window around the trigger cycle, the perf-ledger and memory-ledger
snapshots, the queue depths, the slowest in-flight journeys, and the
cycle's top unschedulable reasons, all stamped with the SAME trigger
cycle — onto a bounded ring served at ``/debug/incidents`` and
appended to the SIGUSR2 dump. A per-trigger ``cooldown_cycles``
suppression keeps a sustained burn from flooding the ring with
near-identical bundles.

Optionally (config-gated, default off) an incident arms a
``torch.profiler`` capture of the next ``profile_cycles`` cycles (CUDA
and CPU activities on the card, CPU activities on the CPU; the reference
runs ``jax.profiler.start_trace``) into a bounded artifact directory
(at most ``max_profiles`` captures per process), written as a Chrome
trace when the window closes; ``/debug/profile`` arms the same capture
on demand. The profiler's start and stop are best-effort: a failure is
counted in ``profile_errors`` and swallowed — profiling is forensics,
never a crash vector. Profilers do not nest: a capture must not be armed
while another ``torch.profiler`` session runs in the process.
"""

from __future__ import annotations

import os
import time
from collections import deque
from typing import Callable, List, Optional

from kubernetes_tpu_torch.sanitize import make_lock

#: the closed trigger vocabulary (metric label values, bundle tags)
TRIGGERS = ("slo-burn", "invariant-violation", "oom", "retrace-storm",
            "ladder-fallback")


class IncidentRecorder:
    """Bounded incident-bundle ring + the optional profiler capture.

    ``config``: :class:`kubernetes_tpu_torch.config.IncidentsConfig`
    (duck).
    The evidence sources (``recorder``, ``ledger``, ``memledger``,
    ``jaxtel``, ``journeys``) are attached by the Observability facade
    at construction; ``queue_snapshot`` is duck-attached by the
    Scheduler (a callable returning the pending-counts dict) the same
    way the memory ledger rides the cache."""

    def __init__(self, config=None, metrics=None,
                 clock: Callable[[], float] = time.monotonic,
                 lock_factory=None, recorder=None, ledger=None,
                 memledger=None, jaxtel=None, journeys=None) -> None:
        if config is None:
            from kubernetes_tpu_torch.config import IncidentsConfig

            config = IncidentsConfig()
        self.config = config
        self.metrics = metrics
        self.clock = clock
        self.recorder = recorder
        self.ledger = ledger
        self.memledger = memledger
        self.jaxtel = jaxtel
        self.journeys = journeys
        #: duck-attached by the Scheduler: () -> {queue: depth}
        self.queue_snapshot: Optional[Callable[[], dict]] = None
        self._lock = make_lock(lock_factory, "obs.incidents")
        self._ring: deque = deque(
            maxlen=max(int(getattr(config, "capacity", 16)), 1))
        self.total = 0
        self.by_trigger = {t: 0 for t in TRIGGERS}
        #: trigger -> cycle of its last bundle (cooldown suppression)
        self._last_cycle = {}
        # baselines for the delta-detected triggers
        self._burns_seen = 0
        self._storms_seen = 0
        # -- profiler capture state (all under the lock) --
        self._profile_left = 0     # cycles remaining in a live capture
        self._profile_active = False
        self.profiles_taken = 0
        self.profile_errors = 0
        #: the live torch.profiler session and its directory
        self._profiler = None
        self._profile_path = ""
        #: the Chrome traces the closed captures wrote
        self.profile_paths: List[str] = []

    @property
    def enabled(self) -> bool:
        return bool(getattr(self.config, "enabled", False))

    # -- trigger evaluation (called once per eventful cycle close) ---------

    def _burns_total(self) -> int:
        led = self.ledger
        wd = getattr(led, "watchdog", None) if led is not None else None
        try:
            return int(wd.burns_total()) if wd is not None else 0
        except Exception:
            return 0

    def _storms_total(self) -> int:
        jt = self.jaxtel
        try:
            return int(jt.storm_total()) if jt is not None else 0
        except Exception:
            return 0

    def observe_cycle(self, rec) -> List[dict]:
        """Evaluate every trigger against the just-closed cycle record;
        capture one bundle per non-suppressed trigger. Returns the new
        bundles (tests; callers may ignore)."""
        if not self.enabled or rec is None:
            return []
        fired: List[tuple] = []
        burns = self._burns_total()
        if burns > self._burns_seen:
            fired.append(("slo-burn", f"slo burns +{burns - self._burns_seen}"))
        self._burns_seen = burns
        storms = self._storms_total()
        if storms > self._storms_seen:
            fired.append(("retrace-storm",
                          f"retrace storms +{storms - self._storms_seen}"))
        self._storms_seen = storms
        if getattr(rec, "invariant_violations", 0) > 0:
            fired.append(("invariant-violation",
                          f"violations={rec.invariant_violations}"))
        if getattr(rec, "oom_forensic", ""):
            fired.append(("oom", rec.oom_forensic))
        burst = int(getattr(self.config, "fallback_burst_threshold", 3))
        if burst > 0 and getattr(rec, "fallbacks", 0) >= burst:
            fired.append(("ladder-fallback",
                          f"fallbacks={rec.fallbacks}"))
        out: List[dict] = []
        for trigger, detail in fired:
            b = self._capture(trigger, detail, rec)
            if b is not None:
                out.append(b)
        self._profile_tick()
        return out

    def _capture(self, trigger: str, detail: str, rec) -> Optional[dict]:
        cycle = getattr(rec, "cycle", 0)
        cooldown = int(getattr(self.config, "cooldown_cycles", 64))
        with self._lock:
            last = self._last_cycle.get(trigger)
            if last is not None and cycle - last < cooldown:
                return None
            self._last_cycle[trigger] = cycle
        bundle = self._bundle(trigger, detail, rec)
        with self._lock:
            self._ring.append(bundle)
            self.total += 1
            self.by_trigger[trigger] = self.by_trigger.get(trigger, 0) + 1
        if self.metrics is not None:
            self.metrics.incidents_total.inc(trigger=trigger)
        if int(getattr(self.config, "profile_cycles", 0)) > 0:
            self.arm_profile(int(self.config.profile_cycles),
                             tag=f"{trigger}-c{cycle}")
        return bundle

    def _bundle(self, trigger: str, detail: str, rec) -> dict:
        cycle = getattr(rec, "cycle", 0)
        window = int(getattr(self.config, "flight_window", 16))
        flight = []
        if self.recorder is not None:
            flight = [r.to_json() for r in self.recorder.records()
                      if abs(getattr(r, "cycle", 0) - cycle) <= window]
        led = self.ledger
        ledger_snap = (led.snapshot()
                       if led is not None and getattr(led, "enabled", False)
                       else None)
        mem = self.memledger
        mem_snap = (mem.snapshot()
                    if mem is not None and getattr(mem, "enabled", False)
                    else None)
        queues = None
        if self.queue_snapshot is not None:
            try:
                queues = dict(self.queue_snapshot())
            except Exception:
                queues = None
        jr = self.journeys
        slow = (jr.inflight_slowest(
            int(getattr(self.config, "journeys_k", 4)))
            if jr is not None and getattr(jr, "enabled", False) else [])
        return {
            "trigger": trigger,
            "detail": detail,
            "cycle": cycle,
            "t": round(self.clock(), 6),
            "top_reasons": list(getattr(rec, "top_reasons", ()) or ()),
            "flight_window": flight,
            "ledger": ledger_snap,
            "memory": mem_snap,
            "queues": queues,
            "journeys": slow,
        }

    # -- profiler capture ---------------------------------------------------

    def arm_profile(self, cycles: int, tag: str = "manual") -> bool:
        """Start a ``torch.profiler`` capture of the next ``cycles``
        cycle closes into ``profile_dir`` (bounded by ``max_profiles``
        per process). Returns True when a capture actually started."""
        cycles = int(cycles)
        outdir = str(getattr(self.config, "profile_dir", "") or "")
        with self._lock:
            if (cycles <= 0 or not outdir or self._profile_active
                    or self.profiles_taken
                    >= int(getattr(self.config, "max_profiles", 4))):
                return False
            self._profile_active = True
            self._profile_left = cycles
            self.profiles_taken += 1
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            path = os.path.join(outdir, f"profile-{tag}")
            os.makedirs(path, exist_ok=True)
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
            with self._lock:
                self._profiler = prof
                self._profile_path = path
            return True
        except Exception:  # noqa: BLE001 — forensics never fails a cycle
            with self._lock:
                self._profile_active = False
                self._profile_left = 0
                self.profile_errors += 1
            return False

    def _profile_tick(self) -> None:
        with self._lock:
            if not self._profile_active:
                return
            self._profile_left -= 1
            if self._profile_left > 0:
                return
            self._profile_active = False
            prof, path = self._profiler, self._profile_path
            self._profiler = None
        try:
            prof.stop()
            out = os.path.join(path, "trace.json")
            prof.export_chrome_trace(out)
            with self._lock:
                self.profile_paths.append(out)
        except Exception:  # noqa: BLE001 — forensics never fails a cycle
            with self._lock:
                self.profile_errors += 1

    # -- read side ----------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def incidents(self) -> List[dict]:
        with self._lock:
            return list(self._ring)

    def sizes(self) -> dict:
        with self._lock:
            return {"incident_ring": len(self._ring)}

    def snapshot(self) -> dict:
        """The ``/debug/incidents`` body."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "capacity": self._ring.maxlen,
                "total": self.total,
                "by_trigger": {k: v for k, v in self.by_trigger.items()
                               if v},
                "profiles_taken": self.profiles_taken,
                "profile_active": self._profile_active,
                "profile_errors": self.profile_errors,
                "incidents": list(self._ring),
            }

    def dump(self) -> str:
        """SIGUSR2 debugger section: one line per bundle, newest last."""
        with self._lock:
            rows = list(self._ring)
            total = self.total
        lines = [f"== incident ring ({len(rows)} bundles, "
                 f"{total} total) =="]
        for b in rows:
            lines.append(
                f"c{b['cycle']:>6} t={b['t']:.3f} {b['trigger']}: "
                f"{b['detail']} (flight={len(b['flight_window'])} "
                f"journeys={len(b['journeys'])})")
        return "\n".join(lines)
