"""Cloud-provider seam — the in-tree cloud provider analog (SURVEY §2.2
"cloud providers: legacy in-tree AWS/GCE/Azure"; reference
``pkg/cloudprovider/providers`` via the ``cloudprovider.Interface`` in
``staging/src/k8s.io/cloud-provider/cloud.go`` and the cloud node
controller ``staging/src/k8s.io/cloud-provider/controllers/node``).

What the scheduler stack actually needs from a cloud: node *initialization*
(zone/region labels the topology kernels key on, provider IDs, addresses)
and node *existence* (is a quiet node dead or just slow — the node
lifecycle controller asks the cloud before deleting). Both are behind
:class:`CloudProvider`; :class:`FakeCloud` is the hollow in-tree provider
(the containervm/fake analog ``pkg/cloudprovider/providers/fake``).

Flow (cloud_node_controller.go syncNode): nodes register with the
``uninitialized`` NoSchedule taint; the controller looks the instance up
in the cloud, stamps provider ID + zone/region labels + addresses, and
removes the taint — only then does the scheduler see a feasible node.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.types import EFFECT_NO_SCHEDULE, Node, Taint

#: cloudprovider.TaintExternalCloudProvider — kubelets register with this
#: until the cloud controller initializes them (api/core/v1/well_known_taints)
TAINT_UNINITIALIZED = "node.cloudprovider.kubernetes.io/uninitialized"

LABEL_ZONE = "failure-domain.beta.kubernetes.io/zone"
LABEL_REGION = "failure-domain.beta.kubernetes.io/region"
LABEL_INSTANCE_TYPE = "beta.kubernetes.io/instance-type"


@dataclass
class Instance:
    """One cloud VM record (the slice of Instances/Zones the node
    controller consumes)."""

    name: str
    provider_id: str = ""
    zone: str = ""
    region: str = ""
    instance_type: str = ""
    addresses: Tuple[Tuple[str, str], ...] = ()  # (type, address)
    exists: bool = True


class CloudProvider:
    """cloudprovider.Interface slice: Instances + Zones, plus the
    LoadBalancer and Routes halves the service/route controllers
    consume (cloud.go LoadBalancer()/Routes()). Implementations raise
    KeyError for unknown nodes (the NotFound the controller maps to
    'instance gone')."""

    def instance(self, node_name: str) -> Instance:
        raise NotImplementedError

    def instance_exists(self, node_name: str) -> bool:
        try:
            return self.instance(node_name).exists
        except KeyError:
            return False

    # -- LoadBalancer (cloud.go:116) ---------------------------------------

    def ensure_load_balancer(self, cluster: str, svc_key: str,
                             node_names: Tuple[str, ...]) -> str:
        """Create-or-update the external balancer for one service over
        the given backend node set; returns the ingress address
        (EnsureLoadBalancer is explicitly idempotent-upsert)."""
        raise NotImplementedError

    def ensure_load_balancer_deleted(self, cluster: str,
                                     svc_key: str) -> None:
        raise NotImplementedError

    def list_load_balancers(self, cluster: str) -> Tuple[str, ...]:
        """Service keys with a live balancer — what the service
        controller's needsCleanup pass sweeps (GetLoadBalancer per
        service in the reference; a listing here so one call covers
        the sweep)."""
        raise NotImplementedError

    # -- Routes (cloud.go:134) ---------------------------------------------

    def list_routes(self, cluster: str) -> Dict[str, str]:
        """node name -> destination CIDR."""
        raise NotImplementedError

    def create_route(self, cluster: str, node_name: str,
                     cidr: str) -> None:
        raise NotImplementedError

    def delete_route(self, cluster: str, node_name: str) -> None:
        raise NotImplementedError


class FakeCloud(CloudProvider):
    """The fake in-tree provider: dicts of instances / balancers /
    routes, mutable by tests (terminate() is the cloud-side VM deletion
    the lifecycle controller must notice; ``fail_routes`` makes
    create_route raise — the cloud-quota failure the route controller
    must surface, not crash on)."""

    def __init__(self, provider: str = "fake") -> None:
        self.provider = provider
        self.instances: Dict[str, Instance] = {}
        #: svc key -> {"ingress": ip, "nodes": (names...)}
        self.load_balancers: Dict[str, dict] = {}
        self._lb_next = 1
        #: cluster routes: node name -> pod CIDR
        self.routes: Dict[str, str] = {}
        self.fail_routes = False
        self.lb_calls = 0
        self.route_calls = 0

    def add_instance(self, inst: Instance) -> None:
        if not inst.provider_id:
            inst.provider_id = f"{self.provider}://{inst.name}"
        self.instances[inst.name] = inst

    def terminate(self, node_name: str) -> None:
        if node_name in self.instances:
            self.instances[node_name].exists = False

    def instance(self, node_name: str) -> Instance:
        return self.instances[node_name]

    def ensure_load_balancer(self, cluster: str, svc_key: str,
                             node_names: Tuple[str, ...]) -> str:
        self.lb_calls += 1
        lb = self.load_balancers.get(svc_key)
        if lb is None:
            # TEST-NET-1 — an address range no real backend answers
            lb = {"ingress": f"192.0.2.{self._lb_next}", "nodes": ()}
            self._lb_next += 1
            self.load_balancers[svc_key] = lb
        lb["nodes"] = tuple(sorted(node_names))
        return lb["ingress"]

    def ensure_load_balancer_deleted(self, cluster: str,
                                     svc_key: str) -> None:
        self.load_balancers.pop(svc_key, None)

    def list_load_balancers(self, cluster: str) -> Tuple[str, ...]:
        return tuple(sorted(self.load_balancers))

    def list_routes(self, cluster: str) -> Dict[str, str]:
        return dict(self.routes)

    def create_route(self, cluster: str, node_name: str,
                     cidr: str) -> None:
        self.route_calls += 1
        if self.fail_routes:
            raise RuntimeError("cloud route quota exceeded")
        self.routes[node_name] = cidr

    def delete_route(self, cluster: str, node_name: str) -> None:
        self.routes.pop(node_name, None)


def uninitialized_node(name: str, **node_kw) -> Node:
    """A node as the kubelet registers it under an external cloud
    provider: tainted uninitialized, no zone labels yet."""
    nd = Node(name, **node_kw)
    return dataclasses.replace(
        nd, taints=nd.taints + (Taint(TAINT_UNINITIALIZED, value="true",
                                      effect=EFFECT_NO_SCHEDULE),))


class ServiceLBController:
    """The service controller (pkg/controller/service/
    service_controller.go:293 syncLoadBalancerIfNeeded): services of
    Type=LoadBalancer get an external balancer over the READY,
    schedulable node set; status.loadBalancer.ingress is written back
    through the hub; a type change away from LoadBalancer (or service
    deletion) tears the balancer down (needsCleanup). The node-set sync
    (nodeSyncLoop, :632 includeNodeFromNodeList: Ready condition,
    not-unschedulable) re-ensures every balancer when membership
    changes."""

    def __init__(self, hub, cloud: CloudProvider,
                 cluster: str = "ktpu") -> None:
        self.hub = hub
        self.cloud = cloud
        self.cluster = cluster
        self.ensures = 0
        self.teardowns = 0

    def _backend_nodes(self) -> Tuple[str, ...]:
        return tuple(sorted(
            nd.name for nd in self.hub.truth_nodes.values()
            if nd.conditions.ready and not nd.unschedulable))

    def reconcile(self) -> None:
        hub = self.hub
        nodes = self._backend_nodes()
        lb_services = set()
        for key, svc in list(hub.services.items()):
            if getattr(svc, "type", "ClusterIP") != "LoadBalancer":
                continue
            lb_services.add(key)
            ingress = self.cloud.ensure_load_balancer(
                self.cluster, key, nodes)
            self.ensures += 1
            if svc.load_balancer_ingress != ingress:
                svc.load_balancer_ingress = ingress
                hub._commit(f"services/{key}", "MODIFIED", svc)
                hub.record_controller_event(
                    "EnsuredLoadBalancer", key,
                    f"Ensured load balancer at {ingress}",
                    involved_kind="Service")
        # needsCleanup: balancers whose service is gone or no longer
        # Type=LoadBalancer (the hub's delete_service cannot know about
        # cloud state — this pass owns the teardown)
        for key in [k for k in self.cloud.list_load_balancers(self.cluster)
                    if k not in lb_services]:
            self.cloud.ensure_load_balancer_deleted(self.cluster, key)
            self.teardowns += 1
        # a service that LEFT LoadBalancer type keeps no stale ingress
        for key, svc in hub.services.items():
            if (getattr(svc, "type", "ClusterIP") != "LoadBalancer"
                    and getattr(svc, "load_balancer_ingress", "")):
                svc.load_balancer_ingress = ""
                hub._commit(f"services/{key}", "MODIFIED", svc)


class RouteController:
    """The route controller (pkg/controller/route/
    route_controller.go:139 reconcile): every node with a podCIDR gets
    a cloud route; routes for deleted nodes (or stale CIDRs after a
    same-name re-add) are removed. Success clears the node's
    NetworkUnavailable condition (:222 updateNetworkingCondition) —
    the gate that keeps pods off a node the dataplane can't reach;
    a cloud-side create failure leaves the condition set and surfaces
    as a counter, never a crash."""

    def __init__(self, hub, cloud: CloudProvider,
                 cluster: str = "ktpu") -> None:
        self.hub = hub
        self.cloud = cloud
        self.cluster = cluster
        self.create_failures = 0

    def _set_network_unavailable(self, name: str, value: bool) -> None:
        nd = self.hub.truth_nodes.get(name)
        if nd is None or nd.conditions.network_unavailable == value:
            return
        self.hub._update_node(dataclasses.replace(
            nd, conditions=dataclasses.replace(
                nd.conditions, network_unavailable=value)))

    def reconcile(self) -> None:
        hub = self.hub
        routes = self.cloud.list_routes(self.cluster)
        want = {name: nd.pod_cidr
                for name, nd in hub.truth_nodes.items() if nd.pod_cidr}
        for name, cidr in routes.items():
            if want.get(name) != cidr:
                self.cloud.delete_route(self.cluster, name)
        for name, cidr in want.items():
            if routes.get(name) != cidr:
                try:
                    self.cloud.create_route(self.cluster, name, cidr)
                except Exception as e:
                    # no working route: RAISE the condition (the
                    # CheckNodeCondition predicate keeps pods off this
                    # node) — updateNetworkingCondition's failure half;
                    # a stale route was already withdrawn above, so
                    # leaving the condition clear would claim a
                    # dataplane that does not exist
                    self.create_failures += 1
                    self._set_network_unavailable(name, True)
                    # cluster-scoped involved object (Node): empty
                    # namespace segment, so involvedObject.namespace
                    # field selectors match the reference's "" instead
                    # of a fabricated "default"
                    hub.record_controller_event(
                        "FailedToCreateRoute", f"/{name}",
                        f"Could not create route {cidr}: {e}",
                        type_="Warning", involved_kind="Node")
                    continue
            self._set_network_unavailable(name, False)


class CloudNodeController:
    """cloud_node_controller.go syncNode + the lifecycle half
    (cloud_node_lifecycle_controller.go): initialize tainted nodes from
    the cloud; delete nodes whose instance is gone."""

    def __init__(self, hub, cloud: CloudProvider) -> None:
        self.hub = hub
        self.cloud = cloud
        self.initialized = 0
        self.deleted = 0

    def reconcile(self) -> None:
        for name, nd in list(self.hub.truth_nodes.items()):
            tainted = any(t.key == TAINT_UNINITIALIZED for t in nd.taints)
            if tainted:
                try:
                    inst = self.cloud.instance(name)
                except KeyError:
                    continue  # not in the cloud yet; retry next sync
                if not inst.exists:
                    # terminated before initialization finished: never
                    # un-taint a dead VM — remove it outright
                    self.hub.remove_node(name)
                    self.deleted += 1
                    continue
                labels = dict(nd.labels)
                if inst.zone:
                    labels[LABEL_ZONE] = inst.zone
                if inst.region:
                    labels[LABEL_REGION] = inst.region
                if inst.instance_type:
                    labels[LABEL_INSTANCE_TYPE] = inst.instance_type
                new = dataclasses.replace(
                    nd,
                    labels=labels,
                    taints=tuple(t for t in nd.taints
                                 if t.key != TAINT_UNINITIALIZED),
                )
                self.hub._update_node(new)
                self.initialized += 1
            elif not self.cloud.instance_exists(name):
                # the VM is gone at the provider: remove the node object
                # (cloud_node_lifecycle_controller.go MonitorNodes)
                self.hub.remove_node(name)
                self.deleted += 1
