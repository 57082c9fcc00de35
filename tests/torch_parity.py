"""Shared helpers for the tests that hold the PyTorch port
(``kubernetes_tpu_torch``) against the JAX package (``kubernetes_tpu``).

Clusters are built once, with the JAX package's API types (so the
existing seeded generators of the JAX suites are reused verbatim), then
converted field by field into the port's own copies of those types
(:func:`to_port`). Device tables go from JAX to the port through numpy
(:func:`port_tables`), so both packages compute on identical inputs.
"""

from __future__ import annotations

import dataclasses
import random

import numpy as np

import kubernetes_tpu.api.types as jtypes
import kubernetes_tpu_torch.api.types as ttypes
from kubernetes_tpu.ops.arrays import (
    DeviceNodes as JNodes,
    DevicePods as JPods,
    DeviceSelectors as JSelectors,
    DeviceVolumes as JVolumes,
    nodes_to_device,
    pods_to_device,
    selectors_to_device,
    volumes_to_device,
)
from kubernetes_tpu.snapshot import SnapshotPacker
from kubernetes_tpu.testing import make_node, make_pod
from kubernetes_tpu_torch.ops.arrays import from_numpy

_KIND_OF = {JNodes: "nodes", JPods: "pods", JSelectors: "selectors",
            JVolumes: "volumes"}


def to_port(obj):
    """The same object built from ``kubernetes_tpu_torch.api.types``."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(ttypes, type(obj).__name__)
        return cls(**{f.name: to_port(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(to_port(x) for x in obj)
    if isinstance(obj, list):
        return [to_port(x) for x in obj]
    if isinstance(obj, dict):
        return {k: to_port(v) for k, v in obj.items()}
    return obj


def port_table(jtable):
    """A JAX device table (DeviceNodes/...) as the port's CPU tensors."""
    kind = _KIND_OF[type(jtable)]
    return from_numpy(kind, {f: np.asarray(getattr(jtable, f))
                             for f in type(jtable)._fields}, device="cpu")


def jax_tables(nodes, scheduled, pending, pvcs=(), pvs=(), classes=(),
               volumes=False):
    """Pack a JAX-typed cluster with the JAX packer. Returns
    ``(dn, dp, ds, dv, nt, pt, pk)`` (``dv`` None unless ``volumes``)."""
    pk = SnapshotPacker()
    if volumes:
        pk.set_volume_state(pvcs, pvs, classes)
    for p in list(scheduled) + list(pending):
        pk.intern_pod(p)
    nt = pk.pack_nodes(nodes, scheduled)
    pt = pk.pack_pods(pending)
    dn, dp = nodes_to_device(nt), pods_to_device(pt)
    ds = selectors_to_device(pk.pack_selector_tables())
    dv = volumes_to_device(pk.pack_volume_tables(pending)) if volumes else None
    return dn, dp, ds, dv, nt, pt, pk


def port_tables(dn, dp, ds, dv=None):
    """The port's CPU tables holding exactly the JAX tables' values."""
    return (port_table(dn), port_table(dp), port_table(ds),
            None if dv is None else port_table(dv))


def resource_batch(rng, n_pods, big_frac=0.3):
    """Resource-only pending pods with mixed priorities (the lean-round
    parity batch of tests/test_fused_validate.py)."""
    pods = []
    for i in range(n_pods):
        big = rng.random() < big_frac
        pods.append(make_pod(
            f"q{i}",
            cpu_milli=rng.choice([100, 250, 500, 1500] if not big
                                 else [2000, 3000]),
            memory=rng.choice([128, 512, 1024]) * 2**20,
        ))
        pods[-1].priority = rng.choice([0, 0, 10, 100])
    return pods


def random_volume_cluster(seed: int):
    """A seeded cluster with in-tree, CSI and PVC-backed volumes, zone
    labels and attach limits (the construction of
    tests/test_volumes.py::test_differential_random_volume_clusters).
    Returns ``(nodes, scheduled, pending, pvcs, pvs, classes)``."""
    rng = random.Random(seed)
    zone_key = "failure-domain.beta.kubernetes.io/zone"
    zones = ["za", "zb", "zc"]
    classes = [
        jtypes.StorageClass("imm", binding_mode=jtypes.BINDING_IMMEDIATE),
        jtypes.StorageClass(
            "wffc", binding_mode=jtypes.BINDING_WAIT_FOR_FIRST_CONSUMER),
        jtypes.StorageClass(
            "dyn", binding_mode=jtypes.BINDING_WAIT_FOR_FIRST_CONSUMER,
            provisioner="p.example.com"),
    ]
    pvs = []
    for i in range(8):
        kind = rng.choice([jtypes.VOL_GCE_PD, jtypes.VOL_AWS_EBS,
                           jtypes.VOL_CSI, ""])
        affinity = ()
        if rng.random() < 0.4:
            affinity = (jtypes.NodeSelectorTerm((jtypes.Requirement(
                zone_key, "In", (rng.choice(zones),)),)),)
        pvs.append(jtypes.PersistentVolume(
            f"pv{i}", kind=kind, handle=f"h{rng.randrange(5)}",
            driver="drv.io" if kind == jtypes.VOL_CSI else "",
            labels=({zone_key: "__".join(rng.sample(zones,
                                                    rng.randrange(1, 3)))}
                    if rng.random() < 0.5 else {}),
            node_affinity=affinity,
            storage_class=rng.choice(["imm", "wffc", "dyn", ""]),
            claim_ref="x/claimed" if rng.random() < 0.3 else ""))
    pvc_names = []
    pvcs = []
    for i in range(8):
        pvc_names.append(f"c{i}")
        pvcs.append(jtypes.PersistentVolumeClaim(
            f"c{i}",
            volume_name=f"pv{rng.randrange(10)}" if rng.random() < 0.7 else "",
            storage_class=rng.choice(["imm", "wffc", "dyn", ""])))
    pvc_names.append("ghost")
    nodes = []
    for i in range(6):
        nd = make_node(f"n{i}",
                       zone=rng.choice(zones) if rng.random() < 0.7 else None)
        for key in ("attachable-volumes-gce-pd", "attachable-volumes-aws-ebs",
                    "attachable-volumes-csi-drv.io"):
            if rng.random() < 0.5:
                nd.allocatable.scalars[key] = rng.choice([1, 2])
        nodes.append(nd)

    def volume():
        r = rng.random()
        if r < 0.35:
            return jtypes.PodVolume(kind=jtypes.VOL_GCE_PD,
                                    handle=f"d{rng.randrange(4)}",
                                    read_only=rng.random() < 0.5)
        if r < 0.5:
            return jtypes.PodVolume(kind=jtypes.VOL_AWS_EBS,
                                    handle=f"v{rng.randrange(4)}",
                                    read_only=rng.random() < 0.5)
        if r < 0.6:
            return jtypes.PodVolume(kind=jtypes.VOL_ISCSI,
                                    handle=f"iqn{rng.randrange(3)}",
                                    read_only=rng.random() < 0.5)
        return jtypes.PodVolume(pvc=rng.choice(pvc_names))

    def pod(name, bound):
        vols = tuple(volume() for _ in range(rng.randrange(0, 3)))
        return make_pod(name, cpu_milli=rng.choice([0, 500]),
                        node_name=f"n{rng.randrange(len(nodes))}"
                        if bound else "", volumes=vols)

    scheduled = [pod(f"s{i}", True) for i in range(10)]
    pending = [pod(f"p{i}", False) for i in range(12)]
    return nodes, scheduled, pending, pvcs, pvs, classes


def pref_affinity_cluster(seed: int, n_nodes: int = 64, n_bound: int = 16,
                          n_pending: int = 512, oversized_every: int = 97):
    """The chip smoke cell (``smoke-5k-prefaffinity``) shrunk: nodes of
    4 CPU / 32 Gi / 110 pods over 10 zones, every 10th carrying the
    cluster-autoscaler's PreferNoSchedule taint; bound pods round-robin;
    pending pods of 100m / 500 Mi with a weight-50 preferred affinity to
    one seeded random zone, half tolerating the taint, mixed priorities,
    and every ``oversized_every``-th pod too big for any node (so some
    pods fail with reasons). Returns ``(nodes, bound, pending)`` with the
    JAX package's types."""
    from kubernetes_tpu.testing import node_affinity_preferred, req

    rng = random.Random(seed)
    zone_key = "failure-domain.beta.kubernetes.io/zone"
    taint = jtypes.Taint("DeletionCandidateOfClusterAutoscaler", "true",
                         "PreferNoSchedule")
    tol = (jtypes.Toleration(key="DeletionCandidateOfClusterAutoscaler",
                             operator="Exists", effect="PreferNoSchedule"),)
    nodes = [make_node(f"node-{i}", cpu_milli=4000, memory=32 * 2**30,
                       pods=110, zone=f"zone-{i % 10}",
                       taints=(taint,) if i % 10 == 0 else ())
             for i in range(n_nodes)]
    bound = [make_pod(f"bound-{i}", cpu_milli=100, memory=500 * 2**20,
                      node_name=f"node-{i % n_nodes}")
             for i in range(n_bound)]
    pending = []
    for i in range(n_pending):
        big = oversized_every and i % oversized_every == 0
        pending.append(make_pod(
            f"pod-{i}", cpu_milli=5000 if big else 100,
            memory=500 * 2**20,
            affinity=node_affinity_preferred(
                (50, [req(zone_key, "In", f"zone-{rng.randrange(10)}")])),
            tolerations=tol if i % 2 else (),
            priority=rng.choice([0, 0, 0, 100])))
    return nodes, bound, pending
