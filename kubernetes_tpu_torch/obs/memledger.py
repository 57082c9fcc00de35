"""Device-memory ledger — device-memory accounting, modeled-vs-measured
bytes, capacity preflight and OOM forensics (the port of
``kubernetes_tpu/obs/memledger.py``; the byte-side twin of the perf
ledger, obs/ledger.py). Three faces, one :class:`MemoryLedger` facade
that :class:`~kubernetes_tpu_torch.obs.core.Observability` owns:

- **Resident accounting** — every device-resident structure registers
  through the cache and scheduler seams (the resident node table, the
  score summary, the warm Sinkhorn potentials, the last pod-batch
  upload) with MODELED bytes from shapes x dtypes
  (:func:`~kubernetes_tpu_torch.obs.jaxtel.tree_nbytes`: metadata only,
  no sync). The MEASURED side is sampled at cycle boundaries and idle
  ticks only. On the card it reads the caching allocator's host-side
  counters (``torch.cuda.memory_stats``: ``allocated_bytes.all.current``
  as resident, ``allocated_bytes.all.peak`` as peak) and the device's
  ``total_memory`` (read once) as the limit: no device sync, no
  ``mem_get_info``. On the CPU, where no allocator counts, it takes a
  census — the stand-in for the reference's ``jax.live_arrays()`` walk;
  its series is labelled ``device="census"`` and is never a device
  number. PyTorch keeps no registry of live tensors, so the ledger keeps
  its own: weak references to the CPU tensors every resident was
  registered with (:meth:`MemoryLedger.register_tree`), at most
  ``census_limit`` of them, the oldest dropped first. The census counts
  those still alive, each storage once: the scheduler's own tensors,
  including a deregistered resident something still holds (a leak shows
  as measured above modeled). Its cost is bounded by ``census_limit``
  whatever the process holds, so it runs on every sample, as the
  reference's walk does.
  ``scheduler_device_memory_bytes{kind,device}`` and
  ``scheduler_memory_model_efficiency`` confront the two: -1 sentinel on
  sample-free cycles, stale device series zeroed.
- **Capacity preflight** — warmup measures each warmed bucket
  (:func:`capture_memory_analysis`: the allocator's peak over the
  bucket's first solve, which captures its round-loop graph, plus the
  solve's argument and output bytes) into a per-shape peak table
  (:meth:`record_bucket_memory`), and the scheduler preflights each
  cycle's (P, N, mesh) against ``limit x headroom_frac``
  (:meth:`preflight`), splitting the batch down to a smaller warmed
  bucket or shedding it back to the queue instead of running out of
  memory (``scheduler_memory_preflight_total{action=ok|split|shed}``).
  The reference reads the same table from XLA's ``memory_analysis()``
  of each compiled bucket; a CUDA graph has no such analysis, so the
  port measures the capture instead.
- **OOM forensics** — the device-loss recovery path calls
  :meth:`record_oom` BEFORE dropping the resident table: a ranked
  snapshot (top residents, watermark history, the cycle's shapes and
  preflight verdict) lands in a bounded forensic ring, readable from
  ``/debug/memory``, the SIGUSR2 debugger dump and the flight record's
  ``mem=`` flag.

Everything runs on the owner's injected clock and is thread-safe: the
scheduler thread observes while the ``/debug/memory`` handler thread
snapshots."""

from __future__ import annotations

import time
import weakref
from collections import OrderedDict, deque
from typing import Callable, Dict, List, Optional, Tuple

from kubernetes_tpu_torch.obs.ledger import _dist_summary
from kubernetes_tpu_torch.sanitize import make_lock

#: forensic OOM records retained (each is small; an OOM storm must not
#: grow memory while the process is already memory-sick)
OOM_RING = 16

#: watermark history points retained per ledger (t, measured, modeled)
WATERMARK_RING = 256

def capture_memory_analysis(solve: Callable[[], object], device,
                            argument_bytes: int) -> Optional[dict]:
    """Measure one solve's device-memory footprint on the card:
    ``solve()`` runs it (the first solve at a warmed bucket, which also
    captures its round-loop graph into the graph's private pool). The
    allocator's peak over the run's start is the ``temp_bytes``; the
    solve's argument bytes (given) and output bytes (the returned
    tensors' metadata) are added, as XLA's ``memory_analysis()`` adds
    them, into ``total_bytes``. Returns the reference's dict shape, or
    None on the CPU, where no allocator counts. Warmup is
    single-threaded: nothing else may reset the peak meanwhile. A fault
    of the solve propagates (the caller decides what it is)."""
    import torch

    from kubernetes_tpu_torch.obs.jaxtel import tree_nbytes

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    start = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = solve()
    torch.cuda.synchronize(dev)
    temp = max(torch.cuda.max_memory_allocated(dev) - start, 0)
    stats = {"argument_bytes": int(argument_bytes),
             "output_bytes": int(tree_nbytes(out)),
             "temp_bytes": int(temp), "code_bytes": 0, "alias_bytes": 0}
    stats["total_bytes"] = (stats["argument_bytes"] + stats["output_bytes"]
                            + stats["temp_bytes"])
    return stats


def _census(refs, cap: int) -> Tuple[int, int]:
    """(tensors, bytes) of the live tensors among the weak references
    ``refs``, each storage counted once, stopping at ``cap`` tensors: the
    CPU stand-in for the reference's ``jax.live_arrays()`` walk (metadata
    only, O(len(refs)))."""
    seen = set()
    n = b = 0
    for ref in refs:
        if n >= cap:
            break
        t = ref()
        if t is None:
            continue
        st = t.untyped_storage()
        key = st.data_ptr()
        if key in seen or not st.nbytes():
            continue
        seen.add(key)
        n += 1
        b += int(st.nbytes())
    return n, b


class MemoryLedger:
    """The facade: resident accounting + measured sampling + preflight
    table + forensic ring, one ``observe_cycle`` call per eventful
    cycle from ``Observability.end_cycle`` (zero device syncs), one
    thread-safe ``snapshot`` for ``/debug/memory``."""

    def __init__(self, config=None, metrics=None,
                 clock: Callable[[], float] = time.monotonic,
                 lock_factory=None) -> None:
        if config is None:
            from kubernetes_tpu_torch.config import MemoryLedgerConfig

            config = MemoryLedgerConfig()
        self.config = config
        self.metrics = metrics
        self.clock = clock
        self._lock = make_lock(lock_factory, "obs.memledger")
        #: name -> {"bytes": int, "shape": str, "t": float} — the
        #: modeled resident table (register/deregister through the
        #: cache/warmup seams)
        self._residents: Dict[str, Dict] = {}
        #: (P, N, mesh) -> memory_analysis dict — the warmup-captured
        #: per-bucket peak table the preflight judges against
        self._buckets: Dict[Tuple[int, int, int], Dict[str, int]] = {}
        #: (t, measured_bytes, modeled_bytes) history (bounded)
        self._watermarks: deque = deque(maxlen=WATERMARK_RING)
        #: per-cycle entries: {"cycle", "t", "modeled", "measured",
        #: "efficiency", "preflight"} (bounded by config.history)
        self._entries: deque = deque(
            maxlen=max(1, int(getattr(config, "history", 128))))
        #: forensic OOM records (bounded ring — see record_oom)
        self._ooms: deque = deque(maxlen=OOM_RING)
        #: preflight verdict counts + the last full verdict (forensics)
        self.preflights: Dict[str, int] = {"ok": 0, "split": 0, "shed": 0}
        self._last_preflight: Dict = {}
        #: measured-side state: last sample clock stamp, last per-device
        #: readings, ratcheting peak, last census (arrays, bytes)
        self._last_sample_t = float("-inf")
        self._last_measured: Dict[str, Dict[str, int]] = {}
        self._measured_total = -1  # -1 = never sampled
        self._peak_total = 0
        self._census = (0, 0)
        #: id -> weak reference of each CPU tensor a resident was
        #: registered with (the census's population; insertion order,
        #: bounded by census_limit)
        self._tracked: "OrderedDict[int, weakref.ref]" = OrderedDict()
        #: lifetime observed cycles + samples (eviction observable)
        self.observed = 0
        self.samples = 0
        #: (kind, device) gauge series ever exported — stale series
        #: zero (the explain-gauge freshness rule)
        self._series_seen: set = set()
        #: the torch device whose allocator the measured side reads
        #: (the scheduler sets its own; None or a CPU device = the
        #: census) and its total memory, read at the first sample
        self.device = None
        self._device_total: Optional[int] = None

    @property
    def enabled(self) -> bool:
        return bool(getattr(self.config, "enabled", True))

    @property
    def preflight_on(self) -> bool:
        return self.enabled and bool(getattr(self.config, "preflight",
                                             True))

    # -- resident accounting (modeled side) ---------------------------------

    def register(self, name: str, nbytes: int, shape: str = "") -> None:
        """Register (or re-register: last write wins) one
        device-resident structure with its MODELED byte size — callers
        compute it from shapes x dtypes metadata
        (:func:`~kubernetes_tpu_torch.obs.jaxtel.tree_nbytes`), never by
        touching device values."""
        if not self.enabled:
            return
        n = int(nbytes)
        with self._lock:
            if n <= 0:
                self._residents.pop(name, None)
            else:
                self._residents[name] = {"bytes": n, "shape": shape,
                                         "t": self.clock()}

    def register_tree(self, name: str, *trees, shape: str = "") -> None:
        """Register a resident pytree by its metadata byte size; its CPU
        tensors join the census's population (weakly held)."""
        if not self.enabled:
            return
        import torch

        from kubernetes_tpu_torch.obs.jaxtel import _leaves, tree_nbytes

        self.register(name, tree_nbytes(*trees), shape=shape)
        cap = self._census_cap()
        with self._lock:
            for t in trees:
                for x in _leaves(t, []):
                    if isinstance(x, torch.Tensor) and x.is_cpu and \
                            x.layout == torch.strided:
                        self._tracked[id(x)] = weakref.ref(x)
                        self._tracked.move_to_end(id(x))
            while len(self._tracked) > cap:
                self._tracked.popitem(last=False)

    def _census_cap(self) -> int:
        return max(int(getattr(self.config, "census_limit", 4096)), 1)

    def deregister(self, name: str) -> None:
        with self._lock:
            self._residents.pop(name, None)

    def deregister_prefix(self, prefix: str) -> int:
        """Drop every resident whose name starts with ``prefix`` (the
        device-loss path releases a whole family at once); returns how
        many were dropped."""
        with self._lock:
            names = [n for n in self._residents if n.startswith(prefix)]
            for n in names:
                del self._residents[n]
            return len(names)

    def resident_bytes(self) -> int:
        """Total MODELED resident bytes currently registered."""
        with self._lock:
            return sum(r["bytes"] for r in self._residents.values())

    def resident_count(self) -> int:
        with self._lock:
            return len(self._residents)

    def ranked_residents(self, top: int = 0) -> List[Tuple[str, int, str]]:
        """(name, bytes, shape) ranked largest-first (the forensic
        ordering); ``top`` > 0 truncates."""
        with self._lock:
            rows = sorted(
                ((n, r["bytes"], r["shape"])
                 for n, r in self._residents.items()),
                key=lambda x: (-x[1], x[0]))
        return rows[:top] if top else rows

    # -- measured side -------------------------------------------------------

    def census_count(self) -> int:
        with self._lock:
            return self._census[0]

    def _sample_locked(self, now: float) -> None:
        """One measured-side sample: the caching allocator's counters on
        the card, the bounded live-tensor census on the CPU. Host-only
        reads at the cycle boundary: no device sync. Caller holds
        self._lock."""
        measured: Dict[str, Dict[str, int]] = {}
        dev = self.device
        if dev is not None and dev.type == "cuda":
            import torch

            # the allocator's host-side counters (no sync); the limit is
            # the device's total memory, read once
            # graftlint: disable=R2 -- declared measured-side
            # boundary: allocator COUNTERS (host metadata), read at
            # the cycle boundary only, never a device value sync
            ms = torch.cuda.memory_stats(dev)
            if self._device_total is None:
                self._device_total = int(
                    torch.cuda.get_device_properties(dev).total_memory)
            total = int(ms.get("allocated_bytes.all.current", 0))
            peak = int(ms.get("allocated_bytes.all.peak", 0))
            measured[str(dev.index if dev.index is not None else 0)] = {
                "resident": total, "peak": peak,
                "limit": self._device_total}
        else:
            # the CPU: no allocator counts, so count the live tensors of
            # the registered residents (deduplicated by storage); the
            # population is bounded by census_limit, so a leak cannot make
            # its own measurement unboundedly slow. Dead references go
            for k in [k for k, r in self._tracked.items() if r() is None]:
                del self._tracked[k]
            # graftlint: disable=R2 -- declared measured-side
            # boundary: live-tensor METADATA walk (nbytes, no d2h),
            # cycle-boundary only — the CPU stand-in for memory_stats
            self._census = _census(self._tracked.values(),
                                   self._census_cap())
            total = self._census[1]
            peak = max(self._peak_total, total)
            measured["census"] = {"resident": total, "peak": peak,
                                  "limit": 0}
        self._last_measured = measured
        self._measured_total = total
        self._peak_total = max(self._peak_total, peak, total)
        self._last_sample_t = now
        self.samples += 1
        self._watermarks.append((now, total, sum(
            r["bytes"] for r in self._residents.values())))

    def limit_bytes(self) -> int:
        """The preflight budget's denominator: the configured limit
        when set, else the backend-reported one (summed across
        devices; 0 = unknown — the preflight then never fires)."""
        lim = int(getattr(self.config, "limit_bytes", 0) or 0)
        if lim > 0:
            return lim
        with self._lock:
            return sum(r.get("limit", 0)
                       for r in self._last_measured.values())

    # -- capacity preflight --------------------------------------------------

    def record_bucket_memory(self, P: int, N: int, mesh: int,
                             stats: Optional[dict]) -> None:
        """Land one warmed bucket's AOT ``memory_analysis()`` capture
        in the per-shape peak table (warmup seam; None = the backend
        declined — nothing lands, the preflight stays
        absence-tolerant)."""
        if stats is None or not self.enabled:
            return
        with self._lock:
            self._buckets[(int(P), int(N), int(mesh))] = dict(stats)

    def bucket_table(self) -> Dict[Tuple[int, int, int], Dict[str, int]]:
        with self._lock:
            return dict(self._buckets)

    def preflight(self, P: int, N: int, mesh: int) -> Tuple[str, int, dict]:
        """Judge one cycle's padded (P, N, mesh) against
        ``limit x headroom_frac`` BEFORE the batch is uploaded.
        Returns ``(action, split_P, verdict)``:

        - ``("ok", P, ...)`` — fits, or the ledger cannot judge (no
          warmed capture for this shape, no known limit) — absence
          tolerant by design: an unwarmed shape must not be shed on a
          guess.
        - ``("split", P', ...)`` — over budget, but a smaller warmed
          bucket P' < P fits: the caller trims the batch to P' pods
          and requeues the rest.
        - ``("shed", 0, ...)`` — over budget and no warmed bucket
          fits: the caller requeues the whole batch (APF admission
          sheds upstream; the cycle must not OOM).

        Counts land on ``scheduler_memory_preflight_total{action}``;
        the full verdict is retained for the forensic record."""
        P, N, mesh = int(P), int(N), int(mesh)
        verdict: Dict = {"P": P, "N": N, "mesh": mesh, "action": "ok",
                         "basis": ""}
        action, split_P = "ok", P
        limit = self.limit_bytes()
        frac = min(max(float(getattr(self.config, "headroom_frac", 0.9)),
                       0.0), 1.0)
        budget = int(limit * frac)
        if not self.preflight_on or budget <= 0:
            verdict["basis"] = "no-limit" if self.preflight_on else "off"
        else:
            with self._lock:
                entry = self._buckets.get((P, N, mesh))
                need = entry["total_bytes"] if entry else 0
                verdict.update(budget=budget, need=need)
                if entry is None:
                    verdict["basis"] = "unwarmed"
                elif need <= budget:
                    verdict["basis"] = "fits"
                else:
                    # over budget: the largest warmed smaller pod
                    # bucket at the SAME (N, mesh) that fits wins
                    fit = [p for (p, n, m), e in self._buckets.items()
                           if n == N and m == mesh and p < P
                           and e["total_bytes"] <= budget]
                    if fit:
                        action, split_P = "split", max(fit)
                        verdict["basis"] = "over-budget"
                    else:
                        action, split_P = "shed", 0
                        verdict["basis"] = "over-budget-no-bucket"
        verdict["action"] = action
        verdict["split_P"] = split_P
        with self._lock:
            self.preflights[action] = self.preflights.get(action, 0) + 1
            self._last_preflight = dict(verdict)
        c = getattr(self.metrics, "memory_preflight", None)
        if c is not None:  # duck-typed: metrics fakes stay valid
            c.inc(action=action)
        return action, split_P, verdict

    # -- per-cycle accounting ------------------------------------------------

    def observe_cycle(self, rec=None) -> Optional[dict]:
        """Fold one cycle boundary in: maybe take a measured sample
        (interval-gated on the owner clock), confront modeled resident
        bytes with it, publish the gauges, append the ledger entry.
        Returns the entry dict (None when disabled). ``rec`` is the
        CycleRecord ``end_cycle`` just built (may be None on tick)."""
        if not self.enabled:
            return None
        now = self.clock()
        interval = float(getattr(self.config, "sample_interval_s", 0.0))
        with self._lock:
            sampled = now - self._last_sample_t >= interval
            if sampled:
                self._sample_locked(now)
            modeled = sum(r["bytes"] for r in self._residents.values())
            measured = self._measured_total if sampled else -1
            last = dict(self._last_preflight)
        eff = -1.0
        if measured > 0:
            # clipped like the perf ledger's verdict: a pathological
            # model must not mint absurd gauges
            eff = min(max(float(modeled) / float(measured), 0.0), 8.0)
        entry = {
            "cycle": int(getattr(rec, "cycle", 0) or 0) if rec else 0,
            "t": round(now, 6),
            "modeled_bytes": modeled,
            "measured_bytes": measured,
            "efficiency": round(eff, 4),
            "preflight": last.get("action", ""),
        }
        with self._lock:
            self._entries.append(entry)
            self.observed += 1
        self._publish(modeled, eff)
        return entry

    def tick(self) -> None:
        """Idle-path sample (Scheduler.idle_tick): keep the watermark
        history and the gauges live while no eventful cycle arrives —
        a leak during an idle period must still be visible."""
        if not self.enabled:
            return
        now = self.clock()
        interval = float(getattr(self.config, "sample_interval_s", 0.0))
        with self._lock:
            if now - self._last_sample_t < interval:
                return
            self._sample_locked(now)
            modeled = sum(r["bytes"] for r in self._residents.values())
            measured = self._measured_total
        eff = -1.0
        if measured > 0:
            eff = min(max(float(modeled) / float(measured), 0.0), 8.0)
        self._publish(modeled, eff)

    def _publish(self, modeled: int, eff: float) -> None:
        m = self.metrics
        if m is None:
            return
        g = getattr(m, "device_memory_bytes", None)
        if g is not None:
            with self._lock:
                rows = {d: dict(r) for d, r in self._last_measured.items()}
            live = {("modeled", "all")}
            g.set(float(modeled), kind="modeled", device="all")
            for dev, row in rows.items():
                for kind in ("resident", "peak", "limit"):
                    g.set(float(row.get(kind, 0)), kind=kind, device=dev)
                    live.add((kind, dev))
            # freshness: a device that stops reporting (mesh change,
            # lost shard) zeroes instead of serving its last reading
            for kind, dev in self._series_seen - live:
                g.set(0.0, kind=kind, device=dev)
            self._series_seen |= live
        g_eff = getattr(m, "memory_model_efficiency", None)
        if g_eff is not None:
            g_eff.set(round(eff, 4) if eff >= 0 else -1.0)

    # -- OOM forensics -------------------------------------------------------

    def record_oom(self, site: str, error: str = "", shapes: str = "",
                   cycle: int = 0) -> dict:
        """Capture the ranked forensic record for one DeviceOOM /
        device-loss event — called BEFORE the recovery path drops the
        resident table, so the record shows what was actually resident
        when the device died. Returns the record (also retained in the
        bounded forensic ring for /debug/memory and the debugger)."""
        top = self.ranked_residents(top=8)
        with self._lock:
            watermarks = list(self._watermarks)[-8:]
            last = dict(self._last_preflight)
            measured = self._measured_total
            modeled = sum(r["bytes"] for r in self._residents.values())
        record = {
            "t": round(self.clock(), 6),
            "cycle": int(cycle),
            "site": site,
            "error": str(error)[:200],
            "shapes": shapes,
            "modeled_bytes": modeled,
            "measured_bytes": measured,
            "limit_bytes": self.limit_bytes(),
            "top_residents": [
                {"name": n, "bytes": b, **({"shape": s} if s else {})}
                for n, b, s in top],
            "watermarks": [
                {"t": round(t, 6), "measured": me, "modeled": mo}
                for t, me, mo in watermarks],
            "preflight": last,
        }
        with self._lock:
            self._ooms.append(record)
        return record

    def oom_flag(self, record: dict) -> str:
        """The flight recorder's ``mem=`` flag text for one forensic
        record: site + the top resident — enough to route a postmortem
        to /debug/memory without bloating the record line."""
        top = record.get("top_residents") or []
        head = (f" top={top[0]['name']}:{top[0]['bytes']}B"
                if top else "")
        return f"oom@{record.get('site', '?')}{head}"

    def oom_records(self) -> List[dict]:
        with self._lock:
            return list(self._ooms)

    # -- export --------------------------------------------------------------

    def snapshot(self) -> dict:
        """The /debug/memory body (thread-safe, like /debug/ledger)."""
        with self._lock:
            residents = sorted(
                ({"name": n, **r} for n, r in self._residents.items()),
                key=lambda r: (-r["bytes"], r["name"]))
            modeled = sum(r["bytes"] for r in self._residents.values())
            buckets = {
                f"P{p}xN{n}" + (f"+mesh{m}" if m else ""): dict(e)
                for (p, n, m), e in sorted(self._buckets.items())}
            entries = list(self._entries)
            watermarks = [
                {"t": round(t, 6), "measured": me, "modeled": mo}
                for t, me, mo in self._watermarks]
            out = {
                "enabled": self.enabled,
                "observed": self.observed,
                "samples": self.samples,
                "modeled_bytes": modeled,
                "measured_bytes": self._measured_total,
                "peak_bytes": self._peak_total,
                "census": {"arrays": self._census[0],
                           "bytes": self._census[1]},
                "devices": {d: dict(r)
                            for d, r in self._last_measured.items()},
                "residents": residents,
                "buckets": buckets,
                "preflight": {"counts": dict(self.preflights),
                              "last": dict(self._last_preflight)},
                "watermarks": watermarks,
                "entries": entries,
                "oom_records": list(self._ooms),
            }
        out["limit_bytes"] = self.limit_bytes()
        effs = [e["efficiency"] for e in entries if e["efficiency"] >= 0]
        out["model_efficiency"] = _dist_summary(effs)
        return out

    def arm_summary(self) -> dict:
        """The bench-record shape (``memory`` block per arm;
        scripts/bench_compare.py's ``memory`` gate family reads exactly
        this): modeled-vs-measured resident bytes, efficiency summary,
        watermark vs limit, preflight engagement."""
        with self._lock:
            entries = list(self._entries)
            modeled = sum(r["bytes"] for r in self._residents.values())
            measured = self._measured_total
            peak = self._peak_total
            counts = dict(self.preflights)
            ooms = len(self._ooms)
        effs = [e["efficiency"] for e in entries if e["efficiency"] >= 0]
        return {
            "cycles": len(entries),
            "resident_bytes": {"modeled": modeled,
                               "measured": measured,
                               "peak": peak},
            "model_efficiency": _dist_summary(effs),
            "limit_bytes": self.limit_bytes(),
            "preflight": counts,
            "oom_records": ooms,
        }

    def dump(self) -> str:
        """Readable postmortem text (the SIGUSR2 / debugger.dump
        memory section)."""
        s = self.snapshot()
        lines = [
            f"Memory ledger: modeled={s['modeled_bytes']}B "
            f"measured={s['measured_bytes']}B peak={s['peak_bytes']}B "
            f"limit={s['limit_bytes'] or '-'} "
            f"preflight ok={s['preflight']['counts'].get('ok', 0)} "
            f"split={s['preflight']['counts'].get('split', 0)} "
            f"shed={s['preflight']['counts'].get('shed', 0)}"
        ]
        for r in s["residents"][:8]:
            lines.append(f"  resident {r['name']}: {r['bytes']}B"
                         + (f" {r['shape']}" if r.get("shape") else ""))
        for rec in s["oom_records"]:
            top = ",".join(f"{t['name']}:{t['bytes']}B"
                           for t in rec["top_residents"][:3])
            lines.append(
                f"  OOM @{rec['site']} cycle={rec['cycle']} "
                f"modeled={rec['modeled_bytes']}B "
                f"shapes={rec['shapes'] or '-'} top=[{top}]")
        return "\n".join(lines)
