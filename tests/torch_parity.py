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
    DeviceTopology as JTopology,
    DeviceVolumes as JVolumes,
    nodes_to_device,
    pods_to_device,
    selectors_to_device,
    topology_to_device,
    volumes_to_device,
)
from kubernetes_tpu.snapshot import SnapshotPacker
from kubernetes_tpu.testing import make_node, make_pod
from kubernetes_tpu_torch.ops.arrays import from_numpy

_KIND_OF = {JNodes: "nodes", JPods: "pods", JSelectors: "selectors",
            JTopology: "topology", JVolumes: "volumes"}


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


def jax_topo_tables(nodes, scheduled, pending):
    """Pack a JAX-typed cluster with the JAX packer, topology tables
    included. Returns ``(dn, dp, ds, dt, nt, pt, pk)``."""
    dn, dp, ds, _dv, nt, pt, pk = jax_tables(nodes, scheduled, pending)
    return dn, dp, ds, topology_to_device(pk.pack_topology_tables()), nt, \
        pt, pk


def port_topo_tables(dn, dp, ds, dt):
    """The port's CPU tables (topology included) holding exactly the JAX
    tables' values."""
    return port_tables(dn, dp, ds)[:3] + (port_table(dt),)


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


def topo_mixed_cluster(seed: int, n_nodes: int = 64, n_bound: int = 16,
                       n_pending: int = 320, zones: int = 4,
                       anti_groups: int = 4, aff_groups: int = 4):
    """The chip smoke cell ``topo-5k-mixed`` shrunk: the smoke cell's
    nodes (4 CPU / 32 Gi / 110 pods, every 10th with the autoscaler's
    PreferNoSchedule taint) and round-robin bound pods, and pending pods
    of 100m / 500 Mi interleaved by ``i % 5``: 0 a weight-50 preferred
    zone (tolerating the taint on odd ``i``), 1 required hostname
    anti-affinity to its own ``anti-group``, 2 required zone affinity to
    its own ``aff-group``, 3 a hard hostname spread (maxSkew 1), 4 a soft
    zone spread. Returns ``(nodes, bound, pending)`` with the JAX
    package's types."""
    from kubernetes_tpu.testing import node_affinity_preferred, req

    rng = random.Random(seed)
    zone_key = "failure-domain.beta.kubernetes.io/zone"
    taint = jtypes.Taint("DeletionCandidateOfClusterAutoscaler", "true",
                         "PreferNoSchedule")
    tol = (jtypes.Toleration(key="DeletionCandidateOfClusterAutoscaler",
                             operator="Exists", effect="PreferNoSchedule"),)
    nodes = [make_node(f"node-{i}", cpu_milli=4000, memory=32 * 2**30,
                       pods=110, zone=f"zone-{i % zones}",
                       taints=(taint,) if i % 10 == 0 else ())
             for i in range(n_nodes)]
    bound = [make_pod(f"bound-{i}", cpu_milli=100, memory=500 * 2**20,
                      node_name=f"node-{i % n_nodes}")
             for i in range(n_bound)]

    def term(key, labels):
        return jtypes.PodAffinityTerm(
            label_selector=jtypes.LabelSelector(match_labels=dict(labels)),
            topology_key=key)

    def spread(key, when, labels):
        return jtypes.TopologySpreadConstraint(
            max_skew=1, topology_key=key, when_unsatisfiable=when,
            label_selector=jtypes.LabelSelector(match_labels=dict(labels)))

    pending = []
    for i in range(n_pending):
        kind, j = i % 5, i // 5
        kw = {}
        if kind == 0:
            kw = dict(affinity=node_affinity_preferred(
                (50, [req(zone_key, "In", f"zone-{rng.randrange(zones)}")])),
                tolerations=tol if i % 2 else ())
        elif kind == 1:
            labels = {"anti-group": f"g{j % anti_groups}"}
            kw = dict(labels=labels, affinity=jtypes.Affinity(
                pod_anti_affinity_required=(
                    term("kubernetes.io/hostname", labels),)))
        elif kind == 2:
            labels = {"aff-group": f"g{j % aff_groups}"}
            kw = dict(labels=labels, affinity=jtypes.Affinity(
                pod_affinity_required=(term(zone_key, labels),)))
        elif kind == 3:
            labels = {"spread-app": "hard"}
            kw = dict(labels=labels, topology_spread=(spread(
                "kubernetes.io/hostname", "DoNotSchedule", labels),))
        else:
            labels = {"spread-app": "soft"}
            kw = dict(labels=labels, topology_spread=(spread(
                zone_key, "ScheduleAnyway", labels),))
        pending.append(make_pod(f"pod-{i}", cpu_milli=100,
                                memory=500 * 2**20, **kw))
    return nodes, bound, pending


def preempt_burst_cluster(seed: int, n_nodes: int = 64, per_node: int = 4,
                          n_ordinary: int = 52, n_preemptors: int = 8,
                          n_poachers: int = 8):
    """The chip smoke cell ``preempt-5k-burst`` shrunk: the smoke cell's
    nodes, ``per_node`` bound pods of priority 0, 900m / 4 Gi on each
    (every 10th labelled ``app=guarded``, under one PDB with no
    disruptions allowed); wave 1 of ordinary pods (priority 0, 100m /
    500 Mi, a preferred zone, half tolerating the taint) and preemptors
    (priority 1000, 3000m / 500 Mi, a preferred zone); wave 2 of poachers
    (priority 0, 2000m / 500 Mi). Returns
    ``(nodes, bound, wave1, poachers, pdb)`` with the JAX package's
    types."""
    from kubernetes_tpu.testing import node_affinity_preferred, req

    rng = random.Random(seed)
    zone_key = "failure-domain.beta.kubernetes.io/zone"
    nodes, _bound, _pending = pref_affinity_cluster(
        seed, n_nodes=n_nodes, n_bound=0, n_pending=0)
    bound = [make_pod(f"bound-{k}", cpu_milli=900, memory=4 * 2**30,
                      node_name=f"node-{k // per_node}",
                      labels={"app": "guarded" if k % 10 == 0 else "filler"})
             for k in range(n_nodes * per_node)]
    tol = (jtypes.Toleration(key="DeletionCandidateOfClusterAutoscaler",
                             operator="Exists", effect="PreferNoSchedule"),)

    def prefer():
        return node_affinity_preferred(
            (50, [req(zone_key, "In", f"zone-{rng.randrange(10)}")]))

    wave1 = [make_pod(f"pod-{i}", cpu_milli=100, memory=500 * 2**20,
                      affinity=prefer(), tolerations=tol if i % 2 else ())
             for i in range(n_ordinary)]
    wave1 += [make_pod(f"preemptor-{i}", cpu_milli=3000, memory=500 * 2**20,
                       affinity=prefer(), priority=1000)
              for i in range(n_preemptors)]
    poachers = [make_pod(f"poacher-{i}", cpu_milli=2000, memory=500 * 2**20)
                for i in range(n_poachers)]
    pdb = jtypes.PodDisruptionBudget(
        name="guarded",
        selector=jtypes.LabelSelector(match_labels={"app": "guarded"}),
        disruptions_allowed=0)
    return nodes, bound, wave1, poachers, pdb


def incremental_pair(solver="batch", sched_kw=None, **inc):
    """The JAX package's ``Scheduler(pipeline_depth=1)`` and the port's
    ``Scheduler(device="cpu")``, each with its own package's
    ``IncrementalConfig(**inc)`` (enabled unless ``inc`` says otherwise),
    preemption off and a fake clock at 0. Returns ``(js, ts)``."""
    from kubernetes_tpu.config import IncrementalConfig as JInc
    from kubernetes_tpu.scheduler import Scheduler as JScheduler
    from kubernetes_tpu_torch.config import IncrementalConfig as TInc
    from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler

    inc = {"enabled": True, **inc}
    kw = {"enable_preemption": False, "solver": solver, **(sched_kw or {})}
    js = JScheduler(pipeline_depth=1, incremental=JInc(**inc),
                    clock=lambda: 0.0, **kw)
    ts = TScheduler(device="cpu", incremental=TInc(**inc),
                    clock=lambda: 0.0, **kw)
    return js, ts


def feed_pair(js, ts, events):
    """Apply one list of events to both schedulers: ``(op, arg)`` with op
    one of node_add, node_update, node_delete (arg: the node's name),
    pod_add, pod_delete, volume_state (arg ignored); ``arg`` is built with
    the JAX package's types and converted for the port."""
    for op, arg in events:
        if op == "node_delete":
            js.on_node_delete(arg)
            ts.on_node_delete(arg)
        elif op == "volume_state":
            js.set_volume_state(pvcs=[], pvs=[], classes=[])
            ts.set_volume_state(pvcs=[], pvs=[], classes=[])
        else:
            getattr(js, f"on_{op}")(arg)
            getattr(ts, f"on_{op}")(to_port(arg))


#: the CycleResult fields the incremental routes must reproduce
ROUTE_FIELDS = ("attempted", "scheduled", "unschedulable", "rounds",
                "assignments", "failure_reasons", "solver_tier",
                "snapshot_mode", "solve_scope", "reuse_frac", "cold_blocks")


def drive_pair(js, ts, cycles):
    """Feed each list of events of ``cycles`` to both schedulers and run
    one cycle on each; asserts the two results agree on ROUTE_FIELDS
    (``reuse_frac`` to 4 decimals, as both round it) and returns the
    port's results."""
    out = []
    for n, events in enumerate(cycles):
        feed_pair(js, ts, events)
        rj, rt = js.schedule_cycle(), ts.schedule_cycle()
        for f in ROUTE_FIELDS:
            assert getattr(rt, f) == getattr(rj, f), (n, f, getattr(rt, f),
                                                      getattr(rj, f))
        out.append(rt)
    return out


def incremental_cluster(n_nodes=96, hetero=True):
    """The 96-node cluster of tests/test_incremental.py's ``build()``
    (bucket_size(96) = 128 nodes padded, wider than C = 32): 500-pod
    nodes, hetero cpu and memory drawn from ``random.Random(7)``."""
    rng = random.Random(7)
    nodes = []
    for i in range(n_nodes):
        cpu = rng.choice([16000, 32000, 64000]) if hetero else 64000
        mem = (rng.choice([64, 128, 256]) if hetero else 256) * 2**30
        nodes.append(make_node(f"n{i}", cpu_milli=cpu, memory=mem, pods=500))
    return nodes


def scheduler_pair(**kw):
    """The JAX package's ``Scheduler(**kw)`` and the port's
    ``Scheduler(device="cpu", **kw)``, each with a fake clock at 0 (both
    at their own defaults for whatever ``kw`` leaves out: the pipelined
    executor at depth 2, chunks of 4096). Returns ``(js, ts)``."""
    from kubernetes_tpu.scheduler import Scheduler as JScheduler
    from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler

    return (JScheduler(clock=lambda: 0.0, **kw),
            TScheduler(device="cpu", clock=lambda: 0.0, **kw))


def feed_cluster(js, ts, nodes, pods):
    """Add JAX-typed nodes, then pods (bound or pending), to both
    schedulers."""
    feed_pair(js, ts, [("node_add", nd) for nd in nodes]
              + [("pod_add", p) for p in pods])


#: the CycleResult fields the pipelined executor must reproduce
PIPELINE_FIELDS = ("attempted", "scheduled", "unschedulable", "rounds",
                   "assignments", "failure_reasons", "fit_errors",
                   "preempted", "nominations", "solver_tier",
                   "snapshot_mode", "pipeline_chunks")


def explain_rows(report):
    """An UnschedulableReport as plain data: every pod's row and the
    cluster roll-up."""
    if report is None:
        return None
    return ({k: (pe.reasons, pe.message, pe.reason_node_counts,
                 [tuple(r) for r in pe.relaxations], pe.feasible_nodes)
             for k, pe in report.pods.items()},
            report.reason_node_counts, report.reason_pods)


def assert_same_cycle(rj, rt, fields=PIPELINE_FIELDS):
    """Both cycles agree on ``fields`` and on the explain report's rows."""
    for f in fields:
        assert getattr(rt, f) == getattr(rj, f), (f, getattr(rt, f),
                                                  getattr(rj, f))
    assert explain_rows(rt.explain) == explain_rows(rj.explain)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


#: the counters the ladder increments, compared across the packages
LADDER_METRICS = ("solver_fallbacks", "solver_retries", "solver_rejections",
                  "breaker_state", "deadline_exceeded", "extender_degraded",
                  "schedule_attempts", "cache_expired_assumptions")

#: the CycleResult fields the ladder decides
LADDER_FIELDS = ("attempted", "scheduled", "unschedulable", "assignments",
                 "failure_reasons", "solver_tier", "solver_fallbacks")


class Pair:
    """The JAX package's Scheduler and the port's (``device="cpu"``),
    built with the same arguments (``per_pkg``: a pair of dicts of
    arguments each package builds from its own modules, such as
    extenders), each with its own fake clock, event list and (when
    ``arm`` is given) its own package's FaultInjector seeded and armed
    the same way. ``cycle`` runs one cycle on each and asserts they agree
    on LADDER_FIELDS, LADDER_METRICS and the events."""

    def __init__(self, arm=None, seed=0, rc=None, clocks=None, per_pkg=None,
                 **kw):
        from kubernetes_tpu.config import RobustnessConfig as JRobustness
        from kubernetes_tpu.faults import FaultInjector as JInjector
        from kubernetes_tpu.scheduler import Scheduler as JScheduler
        from kubernetes_tpu_torch import faults as tfaults
        from kubernetes_tpu_torch.config import (
            RobustnessConfig as TRobustness,
        )
        from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler

        kw.setdefault("enable_preemption", False)
        self.events = ([], [])
        self.clocks = clocks or (FakeClock(), FakeClock())
        self.inj = []
        self.s = []
        for k, (S, R, F) in enumerate((
                (JScheduler, JRobustness, JInjector),
                (TScheduler, TRobustness, tfaults.FaultInjector))):
            inj = None
            if arm is not None:
                inj = F(seed=seed)
                for site, kind, count in arm:
                    inj.arm(site, kind, count=count)
            self.inj.append(inj)
            extra = {"device": "cpu"} if S is TScheduler else {}
            extra.update((per_pkg or ({}, {}))[k])
            ev = self.events[k]
            self.s.append(S(
                clock=self.clocks[k], fault_injector=inj,
                robustness=R(**(rc if rc is not None
                                else {"solver_retries": 0})),
                retry_sleep=lambda _s: None,
                event_sink=lambda r, o, m, ev=ev: ev.append((r, o.key(), m)),
                **extra, **kw))

    def feed(self, nodes=(), pods=()):
        for nd in nodes:
            self.s[0].on_node_add(nd)
            self.s[1].on_node_add(to_port(nd))
        for p in pods:
            self.s[0].on_pod_add(p)
            self.s[1].on_pod_add(to_port(p))

    def fill(self, n_nodes=6, n_pods=18, cpu=300):
        self.feed([make_node(f"n{i}", cpu_milli=4000)
                   for i in range(n_nodes)],
                  [make_pod(f"p{i}", cpu_milli=cpu) for i in range(n_pods)])

    def cycle(self):
        rj, rt = self.s[0].schedule_cycle(), self.s[1].schedule_cycle()
        for f in LADDER_FIELDS:
            assert getattr(rt, f) == getattr(rj, f), (f, getattr(rt, f),
                                                      getattr(rj, f))
        self.check_metrics()
        assert self.events[1] == self.events[0]
        return rt

    def check_metrics(self):
        for name in LADDER_METRICS:
            got = getattr(self.s[1].metrics, name)._values
            want = getattr(self.s[0].metrics, name)._values
            assert got == want, (name, got, want)

    def advance(self, dt):
        for c in self.clocks:
            c.advance(dt)


def config_pair(doc: dict, **kw):
    """Both packages' ``Scheduler.from_config`` built from one
    KubeSchedulerConfiguration document (decoded by each package's own
    ``cli.decode_config``), each with a fake clock at 0; the port's on
    CPU tensors. Returns ``(js, ts)``."""
    from kubernetes_tpu.cli import decode_config as jdecode
    from kubernetes_tpu.scheduler import Scheduler as JScheduler
    from kubernetes_tpu_torch.cli import decode_config as tdecode
    from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler

    kw.setdefault("clock", lambda: 0.0)
    return (JScheduler.from_config(jdecode(doc), **kw),
            TScheduler.from_config(tdecode(doc), device="cpu", **kw))
