"""Service virtual-IP dataplane — the kube-proxy analog (SURVEY §2.2
"kube-proxy: Service VIP dataplane (iptables/ipvs rule compilers)",
reference ``pkg/proxy/iptables/proxier.go:283`` syncProxyRules and the
endpoints controller ``pkg/controller/endpoint/endpoints_controller.go``).

Three pieces, mirroring the reference's split:

- :class:`Service` / :class:`Endpoints` — the API objects (the v1 slice
  the proxy consumes: selector, ports, ClusterIP, NodePort, session
  affinity).
- :class:`EndpointsController` — control-plane reconciler: for every
  service, the ready addresses are the bound, live pods matching the
  selector (endpoints_controller.go syncService: pods from the selector,
  readiness split). Runs in the hub's controller-manager pass.
- :class:`ServiceProxy` — the per-node dataplane. The reference compiles
  the full iptables table from scratch on every sync (proxier.go:283 —
  one giant rule rewrite, versioned by endpoints/service change counts);
  here the analog is a deterministic routing table rebuilt from the
  (services, endpoints) snapshot: per-service backend lists plus a
  ClientIP affinity map with TTL. ``resolve`` implements the iptables
  ``-m statistic --mode random --probability 1/n`` chain as a seeded
  uniform pick, so distribution properties are testable.

The proxy is hollow the same way kubemark's hollow-proxy is (SURVEY §2.2
kubemark row: real proxy logic, fake iptables): the rule table is real
and queryable, no packets move.
"""

from __future__ import annotations

import dataclasses
import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import Pod

# ---------------------------------------------------------------------------
# API objects (v1.Service / v1.Endpoints slice)
# ---------------------------------------------------------------------------

AFFINITY_NONE = "None"
AFFINITY_CLIENT_IP = "ClientIP"

#: default ClientIP stickiness window — v1.DefaultClientIPServiceAffinitySeconds
DEFAULT_AFFINITY_SECONDS = 3 * 60 * 60


@dataclass(frozen=True)
class ServicePort:
    """One spec.ports entry: the VIP-side port and the pod-side target."""

    name: str = ""
    port: int = 0
    target_port: int = 0
    protocol: str = "TCP"
    node_port: int = 0  # 0 = not a NodePort service port


@dataclass
class Service:
    name: str
    namespace: str = "default"
    selector: Dict[str, str] = field(default_factory=dict)
    cluster_ip: str = ""  # assigned by the hub on create (apiserver analog)
    ports: Tuple[ServicePort, ...] = ()
    session_affinity: str = AFFINITY_NONE
    affinity_seconds: int = DEFAULT_AFFINITY_SECONDS
    #: spec.type — ClusterIP/NodePort/LoadBalancer; LoadBalancer
    #: additionally gets an external balancer from the service
    #: controller when a cloud is attached (cloud.ServiceLBController)
    type: str = "ClusterIP"
    #: status.loadBalancer.ingress[0], written by the service controller
    load_balancer_ingress: str = ""

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def selects(self, pod: Pod) -> bool:
        if not self.selector or pod.namespace != self.namespace:
            return False
        return all(pod.labels.get(k) == v for k, v in self.selector.items())


@dataclass(frozen=True)
class EndpointAddress:
    """One ready/not-ready address: the pod and where it runs (the slice
    of v1.EndpointAddress the proxy consumes: IP→pod identity, nodeName)."""

    pod_key: str
    node_name: str


@dataclass
class Endpoints:
    """v1.Endpoints, flattened: one subset, ready/not-ready address lists
    (the reference's per-port subsets collapse here because hollow pods
    serve every target port)."""

    name: str
    namespace: str = "default"
    ready: Tuple[EndpointAddress, ...] = ()
    not_ready: Tuple[EndpointAddress, ...] = ()

    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


# ---------------------------------------------------------------------------
# Endpoints controller (control plane)
# ---------------------------------------------------------------------------


def pod_endpoint_ready(p) -> bool:
    """The one Endpoints-membership rule (endpoints_controller.go
    shouldPodBeInEndpoints + the Ready-condition check): bound, not
    terminating, and — when a readiness probe exists — probe-ready. A
    probe-less pod is ready as soon as it is placed (the reference's
    status_manager defaults Ready=true with no probes)."""
    from kubernetes_tpu_torch.api.types import is_pod_terminated

    return (bool(p.node_name) and not p.deletion_timestamp
            and not is_pod_terminated(p)
            and (p.readiness_probe is None or p.ready))


class EndpointsController:
    """Reconciles Endpoints objects from (services, pods) truth —
    endpoints_controller.go syncService, driven from the hub's controller
    pass instead of a workqueue: list pods matching the service selector;
    bound + live ⇒ ready, pending/terminating ⇒ not-ready. Writes go
    through the hub so watchers (the per-node proxies) observe ordered
    ADDED/MODIFIED/DELETED endpoint events."""

    def __init__(self, hub) -> None:
        self.hub = hub

    def reconcile(self) -> int:
        """One full pass; returns the number of Endpoints writes."""
        hub = self.hub
        writes = 0
        live_eps = set()
        for svc in list(hub.services.values()):
            if not svc.selector:
                # selector-less service: endpoints are managed manually
                # (the external-backend pattern) — never reconciled, never
                # GC'd while the service lives (endpoints_controller.go
                # syncService returns early on nil selector)
                live_eps.add(svc.key())
                continue
            ready: List[EndpointAddress] = []
            not_ready: List[EndpointAddress] = []
            for p in hub.truth_pods.values():
                if not svc.selects(p):
                    continue
                addr = EndpointAddress(p.key(), p.node_name)
                if pod_endpoint_ready(p):
                    ready.append(addr)
                else:
                    not_ready.append(addr)
            ready.sort(key=lambda a: a.pod_key)
            not_ready.sort(key=lambda a: a.pod_key)
            ep = Endpoints(svc.name, svc.namespace,
                           tuple(ready), tuple(not_ready))
            live_eps.add(ep.key())
            old = hub.endpoints.get(ep.key())
            if old is None or (old.ready, old.not_ready) != (ep.ready,
                                                            ep.not_ready):
                hub.put_endpoints(ep)
                writes += 1
        for key in [k for k in hub.endpoints if k not in live_eps]:
            hub.delete_endpoints(key)
            writes += 1
        return writes


# ---------------------------------------------------------------------------
# Per-node proxy (dataplane)
# ---------------------------------------------------------------------------


@dataclass
class _Rule:
    """Compiled routing entry for one service port: the analog of that
    port's iptables KUBE-SVC-* chain."""

    service: str  # service key
    port: ServicePort
    backends: Tuple[EndpointAddress, ...]  # ready only, sorted
    session_affinity: str = AFFINITY_NONE
    affinity_seconds: int = DEFAULT_AFFINITY_SECONDS


class ServiceProxy:
    """One node's compiled service table. ``sync`` is the
    syncProxyRules analog: a full deterministic rebuild from the current
    (services, endpoints) snapshot — the reference never patches rules
    incrementally and neither does this. ``resolve`` is the packet path:
    VIP:port (or node port) + client → backend pod."""

    def __init__(self, node_name: str, clock=None) -> None:
        self.node_name = node_name
        self.clock = clock
        #: (cluster_ip, port) -> rule ; rebuilt wholesale by sync()
        self.vip_rules: Dict[Tuple[str, int], _Rule] = {}
        #: node_port -> rule
        self.node_port_rules: Dict[int, _Rule] = {}
        #: ClientIP affinity: (service, port, client) -> (pod_key, stamp)
        self._affinity: Dict[Tuple[str, int, str], Tuple[str, float]] = {}
        self.sync_count = 0

    def _now(self) -> float:
        return self.clock.t if self.clock is not None else 0.0

    def sync(self, services: Dict[str, Service],
             endpoints: Dict[str, Endpoints]) -> None:
        vip: Dict[Tuple[str, int], _Rule] = {}
        nps: Dict[int, _Rule] = {}
        for key, svc in services.items():
            ep = endpoints.get(key)
            backends = ep.ready if ep is not None else ()
            for sp in svc.ports:
                rule = _Rule(key, sp, backends, svc.session_affinity,
                             svc.affinity_seconds)
                if svc.cluster_ip:
                    vip[(svc.cluster_ip, sp.port)] = rule
                if sp.node_port:
                    nps[sp.node_port] = rule
        self.vip_rules = vip
        self.node_port_rules = nps
        # drop affinity entries whose service vanished (iptables flush of
        # the KUBE-SEP recent-match lists)
        live = {r.service for r in vip.values()}
        self._affinity = {k: v for k, v in self._affinity.items()
                          if k[0] in live}
        self.sync_count += 1

    # -- packet path -------------------------------------------------------

    def resolve(self, cluster_ip: str, port: int,
                client: str = "") -> Optional[EndpointAddress]:
        """Route VIP:port from ``client`` to a backend; None ⇒ no ready
        endpoints (the reference REJECTs with ICMP port unreachable)."""
        rule = self.vip_rules.get((cluster_ip, port))
        return self._pick(rule, client)

    def resolve_node_port(self, node_port: int,
                          client: str = "") -> Optional[EndpointAddress]:
        rule = self.node_port_rules.get(node_port)
        return self._pick(rule, client)

    def _pick(self, rule: Optional[_Rule],
              client: str) -> Optional[EndpointAddress]:
        if rule is None or not rule.backends:
            return None
        if rule.session_affinity == AFFINITY_CLIENT_IP and client:
            akey = (rule.service, rule.port.port, client)
            hit = self._affinity.get(akey)
            if hit is not None:
                pod_key, stamp = hit
                if self._now() - stamp <= rule.affinity_seconds:
                    for b in rule.backends:
                        if b.pod_key == pod_key:  # still ready?
                            self._affinity[akey] = (pod_key, self._now())
                            return b
                del self._affinity[akey]
        choice = rule.backends[self._uniform(rule, client)
                               % len(rule.backends)]
        if rule.session_affinity == AFFINITY_CLIENT_IP and client:
            self._affinity[(rule.service, rule.port.port, client)] = (
                choice.pod_key, self._now())
        return choice

    def _uniform(self, rule: _Rule, client: str) -> int:
        """Deterministic stand-in for the iptables statistic-random match:
        uniform over backends, independent across (node, service, port,
        client) — hash, not RNG, so tests can assert exact spread."""
        h = hashlib.blake2b(
            f"{self.node_name}|{rule.service}|{rule.port.port}|{client}"
            .encode(), digest_size=8)
        return int.from_bytes(h.digest(), "big")


# ---------------------------------------------------------------------------
# ClusterIP allocation (apiserver service-ip allocator analog)
# ---------------------------------------------------------------------------


class _RangeAllocator:
    """The one sequential integer-range allocator both service
    allocators ride (the reference's shared
    ``pkg/registry/core/service/allocator`` bitmap): unique values,
    wrap-scan allocate, conflict-checked reservation, release with
    revisit, exhaustion error."""

    def __init__(self, lo: int, hi: int, what: str) -> None:
        self.lo, self.hi = lo, hi
        self.what = what
        self._used: set = set()
        self._next = lo

    def allocate(self) -> int:
        n = self._next if self.lo <= self._next <= self.hi else self.lo
        for _ in range(self.hi - self.lo + 1):
            if n not in self._used:
                self._used.add(n)
                self._next = n + 1
                return n
            n = n + 1 if n < self.hi else self.lo
        raise RuntimeError(f"{self.what} exhausted")

    def reserve(self, n: int) -> None:
        """Claim a caller-chosen value; a DUPLICATE claim raises — the
        apiserver 422s 'provided port is already allocated' instead of
        silently sharing (silent sharing also corrupts release: the
        first delete would free the slot under the survivor)."""
        if not (self.lo <= n <= self.hi):
            return
        if n in self._used:
            raise ValueError(f"provided {self.what} {n} is already "
                             "allocated")
        self._used.add(n)

    def release(self, n: int) -> None:
        self._used.discard(n)
        if self.lo <= n <= self.hi:
            self._next = min(self._next, n)  # released slots revisited


class NodePortAllocator(_RangeAllocator):
    """Service node-port range
    (``pkg/registry/core/service/portallocator``; default 30000-32767)."""

    def __init__(self, lo: int = 30000, hi: int = 32767) -> None:
        super().__init__(lo, hi, "node-port range")


class ClusterIPAllocator:
    """Sequential allocator over a /16 service CIDR — the slice of
    ``pkg/registry/core/service/ipallocator`` the hub needs: unique IPs,
    release on delete, exhaustion error. Rides :class:`_RangeAllocator`
    with the IP-string encoding on top."""

    def __init__(self, prefix: str = "10.96") -> None:
        self.prefix = prefix
        self._core = _RangeAllocator(1, 65534, "service CIDR")

    def _decode(self, ip: str) -> Optional[int]:
        parts = ip.split(".")
        if len(parts) == 4 and f"{parts[0]}.{parts[1]}" == self.prefix:
            return (int(parts[2]) << 8) | int(parts[3])
        return None

    def allocate(self) -> str:
        n = self._core.allocate()
        return f"{self.prefix}.{n >> 8}.{n & 0xFF}"

    def reserve(self, ip: str) -> None:
        """Mark a caller-chosen VIP used (the apiserver honors an
        explicit spec.clusterIP by reserving it in the allocator
        bitmap). Unlike node ports, a repeat reservation of the SAME
        VIP is tolerated here: checkpoint restore and same-IP
        re-creates re-reserve legitimately (the reference repairs the
        bitmap from stored services on startup)."""
        n = self._decode(ip)
        if n is not None:
            self._core._used.add(n)

    def release(self, ip: str) -> None:
        n = self._decode(ip)
        if n is not None:
            self._core.release(n)
