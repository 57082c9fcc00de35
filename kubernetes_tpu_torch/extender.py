"""Scheduler extender — the out-of-process HTTP+JSON webhook protocol
(``pkg/scheduler/core/extender.go`` HTTPExtender; wire types
``pkg/scheduler/api/types.go:240-345``). The port's copy of
``kubernetes_tpu/extender.py``; ``ExtenderServer``, the serving side,
waits for the serve-loop slice.

This is the integration seam for a Go control plane: the wire shapes
(ExtenderArgs / ExtenderFilterResult / ExtenderBindingArgs /
ExtenderPreemptionArgs) keep the reference's JSON field names, so an
existing extender webhook works against this scheduler unchanged, and —
symmetrically — a Go kube-scheduler pointed at this framework running
behind :class:`ExtenderServer` offloads its filter/prioritize work to the
TPU batch kernels (BASELINE's "scheduler-extender protocol" target).

``nodeCacheCapable`` mode exchanges node *names* only (the extender keeps
its own cache), which is also how the TPU service keeps the columnar
snapshot resident device-side instead of shipping node objects per pod.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from kubernetes_tpu_torch.api import quantity
from kubernetes_tpu_torch.api.types import (
    Node,
    NodeCondition,
    Pod,
    Resources,
    Taint,
)
from kubernetes_tpu_torch.config import ExtenderConfig

# ---------------------------------------------------------------------------
# v1-shaped JSON serialization (the minimal slice extenders read)
# ---------------------------------------------------------------------------


def _rfc3339(epoch_s: float) -> str:
    """Seconds-epoch -> RFC3339 with microseconds (Go's time.Time JSON
    unmarshal accepts fractional RFC3339, so a metav1.Time-shaped
    consumer parses this; wire precision is 1 µs — the hub floors its
    terminating epsilon there)."""
    import datetime

    return datetime.datetime.fromtimestamp(
        epoch_s, datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%S.%fZ")


def rfc3339_to_epoch(v) -> float:
    """Inverse of :func:`_rfc3339` (fractional seconds optional); also
    accepts a bare number (the hub's internal clock is a float epoch)."""
    import datetime

    if isinstance(v, (int, float)):
        return float(v)
    s = str(v)
    fmt = "%Y-%m-%dT%H:%M:%S.%fZ" if "." in s else "%Y-%m-%dT%H:%M:%SZ"
    return datetime.datetime.strptime(s, fmt).replace(
        tzinfo=datetime.timezone.utc).timestamp()


def pod_to_json(pod: Pod) -> dict:
    """A v1.Pod-shaped document carrying the fields the scheduler consumes
    (metadata + the scheduling-relevant spec/status slice)."""
    return {
        "metadata": {
            "name": pod.name,
            "namespace": pod.namespace,
            "uid": pod.uid or pod.key(),
            "labels": dict(pod.labels),
            **({"ownerReferences": [
                {"kind": r.kind, "name": r.name,
                 **({"uid": r.uid} if r.uid else {})}
                for r in pod.owner_refs
            ]} if pod.owner_refs else {}),
            # metadata.deletionTimestamp as RFC3339 (metav1.Time
            # unmarshals only from that shape — a float here would break
            # any Go-side consumer of the extender wire). A terminating
            # pod must cross the wire as terminating or the remote
            # side's skipPodSchedule/preemption checks go blind.
            **({"deletionTimestamp": _rfc3339(pod.deletion_timestamp)}
               if pod.deletion_timestamp else {}),
        },
        "spec": {
            "nodeName": pod.node_name,
            "nodeSelector": dict(pod.node_selector),
            "priority": pod.priority,
            "schedulerName": pod.scheduler_name,
            "preemptionPolicy": pod.preemption_policy,
            "containers": [
                {
                    "name": "main",
                    "resources": {
                        "requests": {
                            "cpu": f"{int(pod.requests.cpu_milli)}m",
                            "memory": str(int(pod.requests.memory)),
                            **{k: str(v) for k, v in pod.requests.scalars.items()},
                        }
                    },
                    **({"readinessProbe": {
                        "initialDelaySeconds":
                            pod.readiness_probe.initial_delay_s}}
                       if pod.readiness_probe is not None else {}),
                }
            ],
        },
        "status": {
            "nominatedNodeName": pod.nominated_node_name,
            "phase": pod.phase,
            **({"conditions": [{"type": "Ready",
                                "status": "True" if pod.ready else "False"}]}
               if pod.readiness_probe is not None else {}),
        },
    }


def node_to_json(node) -> dict:
    c = node.conditions
    conditions = [
        {"type": "Ready", "status": "True" if c.ready else "False"},
        {"type": "MemoryPressure",
         "status": "True" if c.memory_pressure else "False"},
        {"type": "DiskPressure",
         "status": "True" if c.disk_pressure else "False"},
        {"type": "PIDPressure",
         "status": "True" if c.pid_pressure else "False"},
        {"type": "NetworkUnavailable",
         "status": "True" if c.network_unavailable else "False"},
    ]
    meta = {"name": node.name, "labels": dict(node.labels)}
    if node.annotations:
        meta["annotations"] = dict(node.annotations)
    if node.prefer_avoid_owner_uids:
        # the reference carries this via the preferAvoidPods annotation
        # (scheduler.alpha.kubernetes.io/preferAvoidPods, priorities/
        # node_prefer_avoid_pods.go) — keep the wire shape
        meta.setdefault("annotations", {})[
            "scheduler.alpha.kubernetes.io/preferAvoidPods"] = json.dumps({
                "preferAvoidPods": [
                    {"podSignature": {"podController": {"uid": uid}}}
                    for uid in node.prefer_avoid_owner_uids
                ]
            })
    status = {
        "allocatable": {
            "cpu": f"{int(node.allocatable.cpu_milli)}m",
            "memory": str(int(node.allocatable.memory)),
            "pods": str(int(node.allocatable.pods)),
            "ephemeral-storage": str(int(node.allocatable.ephemeral_storage)),
            **{k: str(v) for k, v in node.allocatable.scalars.items()},
        },
        "conditions": conditions,
    }
    if node.images:
        status["images"] = [
            {"names": [name], "sizeBytes": int(size)}
            for name, size in node.images.items()
        ]
    return {
        "metadata": meta,
        "spec": {
            "unschedulable": node.unschedulable,
            **({"podCIDR": node.pod_cidr} if node.pod_cidr else {}),
            "taints": [
                {"key": t.key, "value": t.value, "effect": t.effect}
                for t in node.taints
            ],
        },
        "status": status,
    }


def node_from_json(d: dict) -> Node:
    """Inverse of :func:`node_to_json` for the fields the kernels read
    (``grpc_shim.node_from_json`` is this function; the REST registry
    and the scheme decode nodes with it too)."""
    meta = d.get("metadata", {})
    status = d.get("status", {})
    alloc = status.get("allocatable") or {}
    res = Resources(
        cpu_milli=quantity.parse_cpu(alloc.get("cpu", "0")),
        memory=quantity.parse_quantity(alloc.get("memory", "0")),
        pods=quantity.parse_quantity(alloc.get("pods", "110")),
    )
    for name, q in alloc.items():
        if name not in ("cpu", "memory", "pods", "ephemeral-storage"):
            res.scalars[name] = quantity.parse_quantity(q)
    if "ephemeral-storage" in alloc:
        res.ephemeral_storage = quantity.parse_quantity(alloc["ephemeral-storage"])
    spec = d.get("spec") or {}
    taints = tuple(
        Taint(key=t.get("key", ""), value=t.get("value", ""),
              effect=t.get("effect", ""))
        for t in (spec.get("taints") or [])
    )
    # conditions: the two mandatory-predicate inputs plus the pressure
    # flags (CheckNodeConditionPredicate reads Ready/NetworkUnavailable;
    # absent Ready stays True — node_to_json always emits it)
    flags = {
        c.get("type"): c.get("status") == "True"
        for c in (status.get("conditions") or [])
    }
    cond = NodeCondition(
        ready=flags.get("Ready", True),
        memory_pressure=flags.get("MemoryPressure", False),
        disk_pressure=flags.get("DiskPressure", False),
        pid_pressure=flags.get("PIDPressure", False),
        network_unavailable=flags.get("NetworkUnavailable", False),
    )
    images = {}
    for img in status.get("images") or []:
        for name in img.get("names") or []:
            images[name] = float(img.get("sizeBytes", 0))
    avoid = ()
    ann = (meta.get("annotations") or {}).get(
        "scheduler.alpha.kubernetes.io/preferAvoidPods"
    )
    if ann:
        try:
            avoid = tuple(
                e["podSignature"]["podController"]["uid"]
                for e in json.loads(ann).get("preferAvoidPods", [])
                if e.get("podSignature", {}).get("podController", {}).get("uid")
            )
        except (ValueError, TypeError, KeyError, AttributeError):
            avoid = ()  # malformed annotation ignored, like the reference
    labels = dict(meta.get("labels") or {})
    # the kubelet self-labels every node with kubernetes.io/hostname
    # (pkg/kubelet well-known labels); nodes ingested without it would
    # break hostname-pinned placement (DaemonSet affinity)
    if meta.get("name"):
        labels.setdefault("kubernetes.io/hostname", meta["name"])
    # annotations round-trip EXCEPT preferAvoidPods, which parses into
    # the dedicated field (node_to_json re-emits it from there — keeping
    # both would double it on the next serialization)
    annotations = {k: v for k, v in (meta.get("annotations") or {}).items()
                   if k != "scheduler.alpha.kubernetes.io/preferAvoidPods"}
    return Node(
        name=meta.get("name", ""),
        labels=labels,
        allocatable=res,
        taints=taints,
        conditions=cond,
        unschedulable=bool(spec.get("unschedulable", False)),
        images=images,
        prefer_avoid_owner_uids=avoid,
        annotations=annotations,
        pod_cidr=spec.get("podCIDR", ""),
    )


# ---------------------------------------------------------------------------
# HTTP extender client
# ---------------------------------------------------------------------------


class ExtenderError(Exception):
    pass


class HTTPExtender:
    """core/extender.go:42 — POSTs JSON to urlPrefix/verb. ``transport``
    is injectable for tests (callable(url, payload_dict, timeout) ->
    response dict); the default uses urllib.

    Robustness seams (kubernetes_tpu_torch/faults.py): ``retry`` — a
    RetryPolicy applying bounded exponential backoff + jitter around the
    transport call (the scheduler wires its shared policy in when left
    None); ``fault_injector`` — the chaos harness hook, consulted before
    each send (may raise timeouts/connection errors) and after (may
    corrupt the decoded response); :meth:`set_call_budget` — the
    scheduler's per-cycle deadline propagation, clamping the next calls'
    transport timeout to the remaining cycle budget."""

    def __init__(
        self,
        config: ExtenderConfig,
        transport: Optional[Callable[[str, dict, float], dict]] = None,
        retry=None,
        fault_injector=None,
        clock: Callable[[], float] = None,
        obs=None,
    ) -> None:
        import time

        self.config = config
        self._transport = transport or _urllib_transport
        self.retry = retry
        self.fault_injector = fault_injector
        self._clock = clock or time.monotonic
        #: True when no clock was injected — the scheduler then adopts
        #: this extender onto its own clock (fake-clock tests stay
        #: deterministic across the budget-deadline math)
        self._clock_defaulted = clock is None
        #: observability facade (kubernetes_tpu_torch/obs): per-verb transport
        #: spans on the in-flight cycle trace; the scheduler wires it in
        #: like retry/fault_injector (None stays silent)
        self.obs = obs
        self._call_budget_s: Optional[float] = None
        #: absolute deadline on self._clock derived from the last
        #: set_call_budget — what bounds the RETRY loop and refreshes the
        #: per-attempt timeout clamp (a fixed budget snapshot would let
        #: attempt 3 run with attempt 1's generous clamp)
        self._budget_deadline: Optional[float] = None

    def name(self) -> str:
        return self.config.url_prefix

    def set_call_budget(self, seconds: Optional[float]) -> None:
        """Clamp subsequent transport timeouts to the caller's remaining
        cycle budget; re-armed per verb by the scheduler. ``None``
        clears the clamp (unbounded cycle) — required so a clamp from a
        deadline-bearing cycle can't leak into later verbs/cycles."""
        if seconds is None:
            self._call_budget_s = None
            self._budget_deadline = None
            return
        self._call_budget_s = max(float(seconds), 1e-3)
        self._budget_deadline = self._clock() + self._call_budget_s

    def is_ignorable(self) -> bool:
        return self.config.ignorable

    def is_binder(self) -> bool:
        return bool(self.config.bind_verb)

    def supports_preemption(self) -> bool:
        return bool(self.config.preempt_verb)

    def is_interested(self, pod: Pod) -> bool:
        """extender.go:417 IsInterested: no managed resources = interested
        in everything; otherwise only pods requesting one of them."""
        if not self.config.managed_resources:
            return True
        managed = set(self.config.managed_resources)
        return any(name in managed for name in pod.requests.scalars)

    def _send(self, verb: str, args: dict) -> dict:
        from contextlib import nullcontext

        url = self.config.url_prefix.rstrip("/") + "/" + verb

        def once() -> dict:
            # per-ATTEMPT timeout clamp, refreshed from the remaining
            # budget at each retry — the static snapshot it replaces let
            # later attempts run on a stale (too-generous) clamp and
            # blow the cycle deadline (ROADMAP bug (b))
            timeout = self.config.http_timeout_s
            if self._budget_deadline is not None:
                timeout = min(
                    timeout, max(self._budget_deadline - self._clock(), 1e-3))
            kind = None
            if self.fault_injector is not None:
                # may raise (timeout/connection/truncated) or return a
                # corruption to apply to the decoded response
                kind = self.fault_injector.transport_fault(
                    f"extender:{verb}")
            resp = self._transport(url, args, timeout)
            if kind is not None:
                resp = self.fault_injector.corrupt_response(kind, resp)
            return resp

        span = (self.obs.span(f"extender:{verb}", url=url)
                if self.obs is not None else nullcontext())
        with span:
            if self.retry is not None:
                # retries bounded by the same budget deadline: a backoff
                # that would land past it propagates the error instead
                # of burning cycle time the caller no longer has
                return self.retry.call(once,
                                       deadline_s=self._budget_deadline,
                                       clock=self._clock)
            return once()

    # -- verbs -------------------------------------------------------------

    def filter(
        self, pod: Pod, node_names: Sequence[str], nodes_by_name: Dict[str, object]
    ) -> Tuple[List[str], Dict[str, str]]:
        """Returns (feasible node names, failed nodes map). Raises
        ExtenderError on transport/remote error (caller applies the
        Ignorable policy, generic_scheduler.go:539-566)."""
        if not self.config.filter_verb:
            return list(node_names), {}
        args: dict = {"pod": pod_to_json(pod)}
        if self.config.node_cache_capable:
            args["nodenames"] = list(node_names)
        else:
            args["nodes"] = {
                "items": [node_to_json(nodes_by_name[n]) for n in node_names]
            }
        try:
            result = self._send(self.config.filter_verb, args)
        except Exception as e:
            raise ExtenderError(str(e))
        # parse hardening: a corrupt/mistyped response is a remote error
        # (ExtenderError, so the Ignorable policy applies) — it must
        # never escape as a TypeError that aborts the whole cycle
        try:
            if result.get("error"):
                raise ExtenderError(result["error"])
            if (self.config.node_cache_capable
                    and result.get("nodenames") is not None):
                names = [str(n) for n in result["nodenames"]]
            elif result.get("nodes") is not None:
                names = [
                    item["metadata"]["name"]
                    for item in result["nodes"].get("items", [])
                ]
            else:
                names = list(node_names)
            return names, dict(result.get("failedNodes") or {})
        except ExtenderError:
            raise
        except Exception as e:
            raise ExtenderError(f"malformed filter response: {e}")

    def prioritize(
        self, pod: Pod, node_names: Sequence[str], nodes_by_name: Dict[str, object]
    ) -> Tuple[Dict[str, float], int]:
        """Returns ({node: score}, weight) — the caller adds
        score*weight into the total (extender.go:318)."""
        if not self.config.prioritize_verb:
            return {n: 0.0 for n in node_names}, 1
        args: dict = {"pod": pod_to_json(pod)}
        if self.config.node_cache_capable:
            args["nodenames"] = list(node_names)
        else:
            args["nodes"] = {
                "items": [node_to_json(nodes_by_name[n]) for n in node_names]
            }
        try:
            result = self._send(self.config.prioritize_verb, args)
        except Exception as e:
            raise ExtenderError(str(e))
        try:
            scores = {hp["host"]: float(hp["score"]) for hp in (result or [])}
        except Exception as e:
            raise ExtenderError(f"malformed prioritize response: {e}")
        return scores, self.config.weight

    def bind(self, pod: Pod, node_name: str) -> None:
        """extender.go:360 — delegate the binding to the extender."""
        args = {
            "podName": pod.name,
            "podNamespace": pod.namespace,
            "podUID": pod.uid or pod.key(),
            "node": node_name,
        }
        result = self._send(self.config.bind_verb, args)
        if result and result.get("error"):
            raise ExtenderError(result["error"])

    def process_preemption(
        self, pod: Pod, victims_by_node: Dict[str, Tuple[List[Pod], int]]
    ) -> Dict[str, Tuple[List[Pod], int]]:
        """extender.go:135 ProcessPreemption: the extender may drop
        candidate nodes or shrink victim lists. Node-cache-capable wire
        form (metaVictims, pod UIDs only)."""
        if not self.config.preempt_verb:
            return victims_by_node
        pods_by_uid = {
            v.uid or v.key(): v
            for victims, _ in victims_by_node.values()
            for v in victims
        }
        args = {
            "pod": pod_to_json(pod),
            "nodeNameToMetaVictims": {
                node: {
                    "pods": [{"uid": v.uid or v.key()} for v in victims],
                    "numPDBViolations": npdb,
                }
                for node, (victims, npdb) in victims_by_node.items()
            },
        }
        try:
            result = self._send(self.config.preempt_verb, args)
        except Exception as e:
            raise ExtenderError(str(e))
        out: Dict[str, Tuple[List[Pod], int]] = {}
        for node, mv in (result.get("nodeNameToMetaVictims") or {}).items():
            victims = [
                pods_by_uid[p["uid"]]
                for p in mv.get("pods", [])
                if p.get("uid") in pods_by_uid
            ]
            out[node] = (victims, int(mv.get("numPDBViolations", 0)))
        return out


def _urllib_transport(url: str, payload: dict, timeout: float) -> dict:
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read().decode() or "{}")


def build_extenders(
    configs: Sequence[ExtenderConfig],
    transport: Optional[Callable] = None,
    retry=None,
    fault_injector=None,
    clock=None,
    obs=None,
) -> List[HTTPExtender]:
    return [HTTPExtender(c, transport, retry=retry,
                         fault_injector=fault_injector, clock=clock,
                         obs=obs) for c in configs]
