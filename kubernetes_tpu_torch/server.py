"""HTTP serving shim: healthz + metrics + the extender-protocol server
(the port of ``kubernetes_tpu/server.py``).

Two serving roles, mirroring the reference's two integration surfaces:

- :func:`serve_scheduler` — the component's own ``/healthz`` + ``/metrics``
  endpoints (app/server.go:214-234 installs these on every scheduler),
  plus ``/version``, ``/debug/traces`` (Chrome trace-event document of
  the retained cycle traces), ``/debug/why`` (the pending-pod
  explanations), ``/debug/flightrecorder`` (the flight recorder's ring
  and the transfer telemetry), ``/debug/journeys`` (pod journeys,
  ``?pod=`` for one timeline), ``/debug/soak`` (an attached soak
  engine's live status), ``/debug/ledger`` (the perf ledger and its SLO
  watchdog), ``/debug/memory`` (the device-memory ledger),
  ``/debug/incidents`` (the incident ring) and ``/debug/profile``
  (``?cycles=N`` arms a ``torch.profiler`` capture).
- :class:`ExtenderServer` — the *reverse* integration seam: this
  framework served AS a scheduler extender. A stock Go kube-scheduler
  configured with an HTTPExtender pointing here (verbs
  ``filter``/``prioritize``, ``nodeCacheCapable: true``) offloads
  filtering/scoring to the port's (pods x nodes) passes while keeping its
  own control loop; wire shapes follow pkg/scheduler/api/types.go:284-345.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

from kubernetes_tpu_torch.api.types import OwnerReference, Pod, Resources


#: debug route -> (Observability attribute, what it is): the routes that
#: serve a backend's snapshot()
_SNAPSHOT_ROUTES = {
    "/debug/ledger": ("ledger", "perf ledger"),
    "/debug/memory": ("memledger", "memory ledger"),
    "/debug/incidents": ("incidents", "incident recorder"),
}


def parse_quantity(s, is_cpu: bool = False) -> float:
    """Wire-seam quantity decode: cpu strings → milli-CPU, everything
    else → base units (:mod:`kubernetes_tpu_torch.api.quantity`)."""
    from kubernetes_tpu_torch.api import quantity

    return quantity.parse_cpu(s) if is_cpu else quantity.parse_quantity(s)


def _parse_deletion_ts(v) -> float:
    if not v:
        return 0.0
    from kubernetes_tpu_torch.extender import rfc3339_to_epoch

    return rfc3339_to_epoch(v)


def pod_from_json(d: dict) -> Pod:
    """Inverse of extender.pod_to_json for the fields the passes read."""
    from kubernetes_tpu_torch.api.types import POD_PENDING, ReadinessProbe

    meta = d.get("metadata", {})
    spec = d.get("spec", {})
    status = d.get("status") or {}
    requests = Resources()
    probe = None
    for c in spec.get("containers", []):
        req = (c.get("resources") or {}).get("requests") or {}
        for name, q in req.items():
            if name == "cpu":
                requests.cpu_milli += parse_quantity(q, is_cpu=True)
            elif name == "memory":
                requests.memory += parse_quantity(q)
            elif name == "ephemeral-storage":
                requests.ephemeral_storage += parse_quantity(q)
            else:
                requests.scalars[name] = (requests.scalars.get(name, 0)
                                          + parse_quantity(q))
        rp = c.get("readinessProbe")
        if probe is None and rp is not None:
            probe = ReadinessProbe(
                initial_delay_s=float(rp.get("initialDelaySeconds", 0)))
    ready = any(
        c.get("type") == "Ready" and c.get("status") == "True"
        for c in (status.get("conditions") or [])
    )
    return Pod(
        phase=status.get("phase", POD_PENDING),
        ready=ready,
        readiness_probe=probe,
        name=meta.get("name", ""),
        namespace=meta.get("namespace", "default"),
        uid=meta.get("uid", ""),
        labels=dict(meta.get("labels") or {}),
        owner_refs=tuple(
            OwnerReference(kind=r.get("kind", ""), name=r.get("name", ""),
                           uid=r.get("uid", ""))
            for r in (meta.get("ownerReferences") or [])
        ),
        node_name=spec.get("nodeName", ""),
        node_selector=dict(spec.get("nodeSelector") or {}),
        priority=int(spec.get("priority") or 0),
        scheduler_name=spec.get("schedulerName") or "default-scheduler",
        requests=requests,
        nominated_node_name=status.get("nominatedNodeName", ""),
        preemption_policy=spec.get("preemptionPolicy")
        or "PreemptLowerPriority",
        deletion_timestamp=_parse_deletion_ts(meta.get("deletionTimestamp")),
    )


class ExtenderServer:
    """Serves filter/prioritize over the scheduler's cache snapshot — one
    pod per request (the extender protocol is per-pod), filtering and
    scoring the whole node axis in one pass on the scheduler's device.
    The passes are the reference's call: ``run_predicates``, then an
    unhoisted, unfused ``run_priorities`` (so no hand kernel launches
    here, as no Pallas kernel does in the reference's server); the mask,
    reasons and scores come back as one counted readback."""

    def __init__(self, scheduler) -> None:
        self.scheduler = scheduler

    # -- request handling --------------------------------------------------

    def handle(self, verb: str, payload: dict) -> dict:
        if verb == "filter":
            return self._filter(payload)
        if verb == "prioritize":
            return self._prioritize(payload)
        return {"error": f"unknown verb {verb!r}"}

    def _evaluate(self, payload: dict):
        import torch

        from kubernetes_tpu_torch.ops.arrays import (
            nodes_to_device,
            pods_to_device,
            selectors_to_device,
        )
        from kubernetes_tpu_torch.ops.predicates import run_predicates
        from kubernetes_tpu_torch.ops.priorities import run_priorities
        from kubernetes_tpu_torch.ops.sync import to_host

        s = self.scheduler
        dev = s.device
        pod = pod_from_json(payload["pod"])
        requested = payload.get("nodenames")
        pk = s.cache.packer
        pk.intern_pod(pod)
        nt = s.cache.snapshot()
        node_order = s.cache.node_order()
        dn = nodes_to_device(nt, device=dev)
        dp = pods_to_device(pk.pack_pods([pod]), device=dev)
        ds = selectors_to_device(pk.pack_selector_tables(), device=dev)
        fr = run_predicates(dp, dn, ds, None, None, None, s.pred_mask)
        score = run_priorities(dp, dn, ds, fr.mask, s.weights)
        # one readback: mask, reasons and scores are exact in f64
        mask, reasons, scores = to_host(torch.stack([
            fr.mask[0].to(torch.float64), fr.reasons[0].to(torch.float64),
            score[0].to(torch.float64)]))
        rows: Dict[str, int] = {n: i for i, n in enumerate(node_order)}
        names = requested if requested is not None else node_order
        return pod, names, rows, mask, reasons, scores

    def _filter(self, payload: dict) -> dict:
        from kubernetes_tpu_torch.ops.predicates import decode_reasons

        _, names, rows, mask, reasons, _ = self._evaluate(payload)
        ok, failed = [], {}
        for n in names:
            i = rows.get(n)
            if i is None:
                failed[n] = "node not in snapshot"
            elif mask[i]:
                ok.append(n)
            else:
                failed[n] = (",".join(decode_reasons(int(reasons[i])))
                             or "infeasible")
        return {"nodenames": ok, "failedNodes": failed, "error": ""}

    def _prioritize(self, payload: dict) -> dict:
        _, names, rows, mask, _, scores = self._evaluate(payload)
        # extender scores ride a 0-10 scale like in-tree priorities: the
        # total is a weighted SUM of 0-10 terms, so normalize per request
        # (max feasible score maps to 10, the reference's reduce-style
        # normalization) before the clamp
        vals = {
            n: float(scores[rows[n]])
            for n in names
            if rows.get(n) is not None and mask[rows[n]]
        }
        top = max(vals.values(), default=0.0)
        scale = 10.0 / top if top > 0 else 0.0
        out = []
        for n in names:
            val = vals.get(n, 0.0) * scale
            # integer floor like the Go reduce, so near-ties stay
            # distinguishable
            out.append({"host": n, "score": int(max(0.0, min(10.0, val)))})
        return out


def why_payload(sched, path: str):
    """The ``/debug/why`` body: ``?pod=<ns/name or name>`` returns that
    pod's latest explanation — per-predicate node exclusion counts and
    the top one-bit-away relaxations; without an argument, the latest
    cycle's cluster summary. Returns ``(status, json-able dict)``."""
    import heapq
    from urllib.parse import parse_qs, urlparse

    q = parse_qs(urlparse(path).query)
    pod = (q.get("pod") or [""])[0]
    why = getattr(sched, "why_pending", None)
    if why is None:
        return 404, {"error": "no explain surface on this scheduler"}
    # the handler runs on the HTTP thread while the scheduling loop
    # mutates why_pending: dict() is a GIL-atomic C-level copy
    why = dict(why)
    if pod:
        pe = why.get(pod)
        if pe is None and "/" not in pod:
            # bare names resolve like kubectl's default namespace, then
            # by suffix across namespaces
            pe = why.get(f"default/{pod}")
            if pe is None:
                hits = [k for k in why if k.endswith(f"/{pod}")]
                pe = why[hits[0]] if len(hits) == 1 else None
        if pe is None:
            return 404, {
                "error": f"no pending-pod explanation for {pod!r}",
                "known": heapq.nsmallest(50, why),
            }
        return 200, pe.to_json()
    rep = getattr(sched, "last_explain", None)
    if rep is None:
        return 200, {"unschedulable": 0, "pending_total": len(why),
                     "pending_known": heapq.nsmallest(50, why),
                     "note": "no unschedulable pods analyzed yet"}
    from kubernetes_tpu_torch.obs.explain import summarize_breakdown

    doc = rep.to_json()
    doc["pods"] = heapq.nsmallest(50, rep.pods)
    doc["summary"] = summarize_breakdown(rep.reason_pods, rep.n_nodes)
    doc["pending_total"] = len(why)
    doc["pending_known"] = heapq.nsmallest(50, why)
    return 200, doc


def journeys_payload(sched, path: str):
    """The ``/debug/journeys`` body (obs/journey.py): ``?pod=<ns/name or
    name>`` returns that pod's full timeline — phase decomposition,
    attempt rows, raw events; without an argument, the slowest-K
    completed table plus the oldest in-flight journeys. Returns
    ``(status, json-able dict)``."""
    import heapq
    from urllib.parse import parse_qs, urlparse

    q = parse_qs(urlparse(path).query)
    pod = (q.get("pod") or [""])[0]
    obs = getattr(sched, "obs", None)
    journeys = getattr(obs, "journeys", None)
    if journeys is None or not getattr(journeys, "enabled", False):
        return 404, {"error": "no journey tracker on this scheduler"}
    if not pod:
        return 200, journeys.snapshot()
    doc = journeys.timeline(pod)
    if doc is None and "/" not in pod:
        # bare names resolve like /debug/why: default namespace first,
        # then a unique suffix match across namespaces
        doc = journeys.timeline(f"default/{pod}")
        if doc is None:
            known = journeys.keys()
            hits = [k for k in known if k.endswith(f"/{pod}")]
            doc = journeys.timeline(hits[0]) if len(hits) == 1 else None
    if doc is None:
        return 404, {
            "error": f"no journey retained for {pod!r}",
            "known": heapq.nsmallest(50, journeys.keys()),
        }
    return 200, doc


def profile_payload(sched, path: str):
    """The ``/debug/profile`` body: arm an on-demand ``torch.profiler``
    capture of the next ``?cycles=N`` cycle closes (obs/incidents.py,
    bounded by the incidents config's profile_dir and max_profiles).
    Returns ``(status, json-able dict)``."""
    from urllib.parse import parse_qs, urlparse

    q = parse_qs(urlparse(path).query)
    obs = getattr(sched, "obs", None)
    incidents = getattr(obs, "incidents", None)
    if incidents is None:
        return 404, {"error": "no incident recorder on this scheduler"}
    try:
        cycles = int((q.get("cycles") or ["8"])[0])
    except ValueError:
        return 400, {"error": "cycles must be an integer"}
    started = incidents.arm_profile(cycles, tag="debug")
    return (200 if started else 409), {
        "started": started,
        "cycles": cycles,
        "profile_dir": str(getattr(incidents.config, "profile_dir", "")),
        "profiles_taken": incidents.profiles_taken,
        "note": ("" if started else
                 "not started: profiling disabled (empty profile_dir), "
                 "a capture is already active, or max_profiles reached"),
    }


def serve_scheduler(
    scheduler,
    host: str = "127.0.0.1",
    port: int = 0,
    extender: Optional[ExtenderServer] = None,
    fairness=None,
) -> ThreadingHTTPServer:
    """Start the healthz/metrics (+ optional extender) server on a daemon
    thread; returns the server (``.server_address`` has the bound port,
    ``.shutdown()`` stops it).

    ``fairness`` (serving.fairness.FlowController) installs APF-style
    load shedding ahead of the handlers: extender POSTs ride the
    mutating flow and are shed with 429 + Retry-After on overload, while
    /healthz, /metrics and the /debug endpoints classify exempt — the
    probes that diagnose an overload must survive it."""

    sched = scheduler

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _respond(self, code: int, body: bytes, ctype: str,
                     headers=None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _admit(self, verb: str):
            """Flow seat or None after a 429 was sent ("" = no filter)."""
            if fairness is None:
                return ""
            from kubernetes_tpu_torch.serving.fairness import RequestRejected

            try:
                return fairness.acquire(fairness.classify(verb, self.path))
            except RequestRejected as e:
                body = json.dumps({"error": str(e)}).encode()
                self._respond(
                    429, body, "application/json",
                    headers={"Retry-After":
                             str(max(int(round(e.retry_after_s)), 1))})
                return None

        def do_GET(self):
            seat = self._admit("GET")
            if seat is None:
                return
            try:
                self._do_get()
            finally:
                if seat and fairness is not None:
                    fairness.release(seat)

        def _do_get(self):
            route = self.path.split("?", 1)[0]
            if self.path == "/healthz":
                self._respond(200, b"ok", "text/plain")
            elif self.path == "/metrics":
                body = sched.metrics.registry.expose().encode()
                self._respond(200, body, "text/plain; version=0.0.4")
            elif self.path == "/version":
                from kubernetes_tpu_torch import version_info

                self._respond(200, json.dumps(version_info()).encode(),
                              "application/json")
            elif self.path == "/debug/traces":
                # Chrome trace-event document over the retained cycle
                # traces — open in chrome://tracing / Perfetto
                obs = getattr(sched, "obs", None)
                if obs is None:
                    self._respond(404, b"no observability layer",
                                  "text/plain")
                else:
                    self._respond(200, obs.export_chrome_trace().encode(),
                                  "application/json")
            elif self.path == "/debug/flightrecorder":
                obs = getattr(sched, "obs", None)
                if obs is None:
                    self._respond(404, b"no observability layer",
                                  "text/plain")
                else:
                    self._respond(
                        200, json.dumps(obs.debug_payload()).encode(),
                        "application/json")
            elif self.path == "/debug/soak":
                # the soak engine (soak.py) attached via
                # SoakEngine.attach(sched): current phase, per-phase
                # verdicts so far, live sentinel snapshot
                soak = getattr(sched, "soak", None)
                if soak is None:
                    self._respond(404, b"no soak engine attached",
                                  "text/plain")
                else:
                    self._respond(
                        200, json.dumps(soak.status()).encode(),
                        "application/json")
            elif route == "/debug/why":
                code, doc = why_payload(sched, self.path)
                self._respond(code, json.dumps(doc).encode(),
                              "application/json")
            elif route == "/debug/journeys":
                code, doc = journeys_payload(sched, self.path)
                self._respond(code, json.dumps(doc).encode(),
                              "application/json")
            elif self.path in _SNAPSHOT_ROUTES:
                # the perf ledger, the memory ledger, the incident ring:
                # each snapshot() is thread-safe (the scheduler thread
                # keeps observing while this handler serializes)
                attr, what = _SNAPSHOT_ROUTES[self.path]
                backend = getattr(getattr(sched, "obs", None), attr, None)
                if backend is None:
                    self._respond(404, f"no {what} on this scheduler"
                                  .encode(), "text/plain")
                else:
                    self._respond(
                        200, json.dumps(backend.snapshot()).encode(),
                        "application/json")
            elif route == "/debug/profile":
                code, doc = profile_payload(sched, self.path)
                self._respond(code, json.dumps(doc).encode(),
                              "application/json")
            else:
                self._respond(404, b"not found", "text/plain")

        def do_POST(self):
            seat = self._admit("POST")
            if seat is None:
                return
            try:
                if extender is None:
                    self._respond(404, b"no extender", "text/plain")
                    return
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n).decode() or "{}")
                verb = self.path.strip("/").split("/")[-1]
                result = extender.handle(verb, payload)
                self._respond(200, json.dumps(result).encode(),
                              "application/json")
            finally:
                if seat and fairness is not None:
                    fairness.release(seat)

    srv = ThreadingHTTPServer((host, port), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv
