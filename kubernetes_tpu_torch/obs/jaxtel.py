"""Transfer and capture telemetry — the port's counterpart of
``kubernetes_tpu/obs/jaxtel.py`` (same file name, same interface, so a
reader finds the twin).

The reference measures two things the static checks cannot see: whether
a call site keeps feeding its compiled program the same abstract
signature (a new one recompiles), and the bytes that cross the device
boundary at the host boundaries the driver declares. The port keeps both:

- **Signatures.** ``record_call(site, *trees, static=...)`` digests the
  shapes and dtypes of the call's tensors plus the static key — metadata
  only, it never reads a device value and never synchronises. The
  digest is what the round loop's graph key (``ops/device_loop.py``) is
  made of: a new digest at a site that already ran is the cycle that
  captures a new CUDA graph, the port's analog of an XLA recompile, so a
  "retrace" here is a capture after warmup. ``snapshot()`` carries the
  process's capture count (``device_loop.CAPTURES``) and its graph keys
  beside the per-site classes. Retrace storms (``storm_threshold``
  retraces within ``storm_window`` calls) count as in the reference.
- **Transfers.** ``readback(site, x)`` is the declared device-to-host
  boundary: it reads ``x`` through ``ops/sync.to_host`` (one counted
  sync) and charges its bytes to the site
  (``scheduler_host_transfer_total{site,direction="d2h"}``,
  ``scheduler_host_transfer_bytes_total``,
  ``scheduler_readback_bytes_total``). ``record_upload`` /
  ``record_transfer`` charge host-to-device uploads from tensor metadata.

``scheduler_jax_compile_cache_total`` stays unset: the port has no
compile cache (a CUDA graph is captured, not looked up in an on-disk
cache), so there is no hit or miss to count.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from kubernetes_tpu_torch.parallel.mesh import Abstract, abstract
from kubernetes_tpu_torch.sanitize import make_lock


def _leaves(x, out: List) -> List:
    """The leaves of a tree of tensors in the reference's pytree order:
    NamedTuples, tuples and lists in field order, dicts by sorted key,
    None contributes nothing. A value placed on a mesh's node-axis
    blocks reads as its global-shaped signature
    (``parallel.mesh.abstract``), so a mesh cycle digests and counts
    bytes as its mesh-off twin does."""
    if x is None:
        return out
    x = abstract(x)
    if isinstance(x, Abstract):
        out.append(x)
    elif isinstance(x, dict):
        for k in sorted(x):
            _leaves(x[k], out)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _leaves(v, out)
    else:
        out.append(x)
    return out


def _leaf_sig(x) -> object:
    """Abstract signature of one leaf: (shape, dtype) for anything
    array-like, the value itself for hashable host scalars, else repr."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return (tuple(shape), str(dtype))
    try:
        hash(x)
        return x
    except TypeError:
        return repr(x)


def abstract_digest(*trees, static=None) -> Tuple:
    """Hashable digest of the abstract (shape/dtype) signature of the
    given trees plus a static key. Reads metadata only: no device sync."""
    sigs = []
    for t in trees:
        if t is None:
            sigs.append(None)
            continue
        sigs.append(tuple(_leaf_sig(x) for x in _leaves(t, [])))
    return (tuple(sigs), static)


def _nbytes(x) -> int:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is None or dtype is None:
        return 0
    n = 1
    for d in shape:
        n *= int(d)
    size = getattr(x, "element_size", None)
    return n * (size() if callable(size) else np.dtype(str(dtype)).itemsize)


def tree_nbytes(*trees) -> int:
    """Total byte size of every array-like leaf (metadata only)."""
    return sum(_nbytes(x) for t in trees for x in _leaves(t, []))


class JaxTelemetry:
    """Per-site signature observation + transfer accounting (the
    reference's class name, kept so every caller reads ``obs.jax``).

    ``record_call(site, *trees, static=...)`` classifies the call:

    - first digest ever seen at the site -> "compile" (cold miss);
    - digest already seen -> "hit";
    - NEW digest at a site that already compiled -> "retrace".

    Retrace storms: >= ``storm_threshold`` retraces within the last
    ``storm_window`` calls at one site increments the storm counter once
    per crossing (the window then resets) — count-based, no clock."""

    def __init__(self, metrics=None, storm_threshold: int = 8,
                 storm_window: int = 64,
                 signature_capacity: int = 4096,
                 lock_factory=None) -> None:
        self.metrics = metrics
        self.storm_threshold = max(1, int(storm_threshold))
        self.storm_window = max(1, int(storm_window))
        #: per-site cap on retained signatures (LRU): a sustained storm
        #: mints a new digest every cycle and must not grow without bound
        self.signature_capacity = max(1, int(signature_capacity))
        #: site -> insertion-ordered {digest: None} used as an LRU set
        self._seen: Dict[str, dict] = {}
        #: one lock for every counter dict: the scheduler thread records
        #: while /debug/flightrecorder's handler thread snapshots
        self._lock = make_lock(lock_factory, "obs.jaxtel")
        self.calls: Dict[str, int] = {}
        self.hits: Dict[str, int] = {}
        self.compiles: Dict[str, int] = {}
        self.retraces: Dict[str, int] = {}
        self.storms: Dict[str, int] = {}
        #: call indices (per site) of recent retraces, for the storm window
        self._retrace_at: Dict[str, deque] = {}
        #: (site, direction) -> [count, bytes]
        self.transfers: Dict[Tuple[str, str], list] = {}

    # -- signatures ---------------------------------------------------------

    def record_call(self, site: str, *trees, static=None,
                    warmup: bool = False) -> str:
        """Record one solve-site observation; returns the class ("hit" |
        "compile" | "retrace"). ``warmup=True`` registers the warmup's
        deliberate captures: a new signature there is never a retrace."""
        digest = abstract_digest(*trees, static=static)
        with self._lock:
            seen = self._seen.setdefault(site, {})
            n = self.calls.get(site, 0) + 1
            self.calls[site] = n
            stormed = False
            if digest in seen:
                kind = "hit"
                self.hits[site] = self.hits.get(site, 0) + 1
                seen.pop(digest)  # re-inserted below as most-recent
            elif warmup or (not seen and not self.compiles.get(site)):
                kind = "compile"
                self.compiles[site] = self.compiles.get(site, 0) + 1
            else:
                kind = "retrace"
                self.retraces[site] = self.retraces.get(site, 0) + 1
                window = self._retrace_at.setdefault(site, deque())
                window.append(n)
                while window and n - window[0] >= self.storm_window:
                    window.popleft()
                if len(window) >= self.storm_threshold:
                    self.storms[site] = self.storms.get(site, 0) + 1
                    window.clear()
                    stormed = True
            seen[digest] = None
            while len(seen) > self.signature_capacity:
                seen.pop(next(iter(seen)))
        m = self.metrics
        if m is not None:
            if kind == "retrace":
                m.jax_retraces.inc(site=site)
            if stormed:
                m.jax_retrace_storms.inc(site=site)
        return kind

    def retrace_total(self, site: Optional[str] = None) -> int:
        with self._lock:
            if site is not None:
                return self.retraces.get(site, 0)
            return sum(self.retraces.values())

    def storm_total(self, site: Optional[str] = None) -> int:
        """Storm detections across all sites (or one)."""
        with self._lock:
            if site is not None:
                return self.storms.get(site, 0)
            return sum(self.storms.values())

    # -- transfers ----------------------------------------------------------

    def record_transfer(self, site: str, direction: str, nbytes: int) -> None:
        """Charge ``nbytes`` moved across the device boundary to a site.
        ``direction``: "h2d" (upload) or "d2h" (readback)."""
        with self._lock:
            row = self.transfers.setdefault((site, direction), [0, 0])
            row[0] += 1
            row[1] += int(nbytes)
        if self.metrics is not None:
            self.metrics.host_transfer_bytes.inc(
                int(nbytes), site=site, direction=direction)
            self.metrics.host_transfers.inc(site=site, direction=direction)
            if direction == "d2h":
                self.metrics.readback_bytes.inc(int(nbytes), site=site)

    def d2h_bytes_total(self) -> int:
        """Total d2h bytes across every site — the flight recorder diffs
        this per cycle into CycleRecord.readback_bytes."""
        with self._lock:
            return sum(row[1] for (site, d), row in self.transfers.items()
                       if d == "d2h")

    def readback(self, site: str, x):
        """The declared d2h boundary: read the tensor ``x`` back through
        ``ops/sync.to_host`` (one counted sync; Python scalars or nested
        lists come back) and charge its bytes as ONE transfer at the
        site."""
        from kubernetes_tpu_torch.ops.sync import to_host

        host = to_host(x)
        self.record_transfer(site, "d2h", _nbytes(x))
        return host

    def record_upload(self, site: str, *trees) -> None:
        """Account an h2d upload from tensor metadata (no sync)."""
        self.record_transfer(site, "h2d", tree_nbytes(*trees))

    # -- introspection ------------------------------------------------------

    def signature_count(self, site: Optional[str] = None) -> int:
        """Retained signature-LRU size — per site, or summed across all
        sites (the soak sentinel watches it)."""
        with self._lock:
            if site is not None:
                return len(self._seen.get(site, ()))
            return sum(len(s) for s in self._seen.values())

    def snapshot(self) -> dict:
        """JSON-shaped view for /debug endpoints: the per-site classes,
        the transfers, and the process's round-loop graph captures."""
        from kubernetes_tpu_torch.ops import device_loop

        with self._lock:
            return {
                "sites": {
                    site: {
                        "calls": self.calls.get(site, 0),
                        "hits": self.hits.get(site, 0),
                        "compiles": self.compiles.get(site, 0),
                        "retraces": self.retraces.get(site, 0),
                        "storms": self.storms.get(site, 0),
                    }
                    for site in sorted(self.calls)
                },
                "transfers": {
                    f"{site}:{direction}": {"count": row[0], "bytes": row[1]}
                    for (site, direction), row in sorted(
                        self.transfers.items())
                },
                "graph_captures": {
                    "captures": device_loop.CAPTURES.count,
                    "keys": len(device_loop.KEYS),
                },
            }
