"""The full loop over the port's gRPC seam, held against the JAX package's:
each of the three tests of ``tests/test_integration_grpc_hub.py`` runs one
script through both packages — a hollow hub feeding a service-side
``Scheduler`` (the port's on CPU tensors) over a real grpc socket through
``SnapshotDeltaBridge``, bindings POSTed back to the hub's CAS Binding
subresource — and the outcomes must be equal: pods bound, conflicts, bind
errors, the consistency oracle against the hub's truth, and every pod's
node."""

import random
import types

import pytest

grpc = pytest.importorskip("grpc")

import kubernetes_tpu.debugger as jdebugger
import kubernetes_tpu.grpc_shim as jshim
import kubernetes_tpu.scheduler as jsched
import kubernetes_tpu.sim as jsim
import kubernetes_tpu.testing as jtesting
import kubernetes_tpu_torch.debugger as tdebugger
import kubernetes_tpu_torch.grpc_shim as tshim
import kubernetes_tpu_torch.scheduler as tsched
import kubernetes_tpu_torch.sim as tsim
import kubernetes_tpu_torch.testing as ttesting

REF = types.SimpleNamespace(shim=jshim, sched=jsched, sim=jsim,
                            testing=jtesting, debugger=jdebugger, kw={})
PORT = types.SimpleNamespace(shim=tshim, sched=tsched, sim=tsim,
                             testing=ttesting, debugger=tdebugger,
                             kw={"device": "cpu"})


class Deployment:
    """A hub, a remote service-side scheduler behind ``serve_grpc`` and a
    bridge feeding it — the deployment the reference test exercises."""

    def __init__(self, pkg, seed: int) -> None:
        self.pkg = pkg
        self.hub = pkg.sim.HollowCluster(seed=seed, scheduler_kw=dict(pkg.kw))
        # the service's Binder: POST the binding to the hub's CAS
        # subresource, with its own rng (hub.rng drives the hub's seeds)
        self.binder = pkg.sim.FlakyBinder(self.hub, 0.0, random.Random(0))
        self.remote = pkg.sched.Scheduler(clock=self.hub.clock,
                                          enable_preemption=False,
                                          binder=self.binder, **pkg.kw)
        self.svc = pkg.shim.TpuSchedulerService(self.remote)
        self.server, port = pkg.shim.serve_grpc(self.remote, service=self.svc)
        self.client = pkg.shim.GrpcSchedulerClient(f"127.0.0.1:{port}")
        self.bridge = None

    def connect(self) -> None:
        self.bridge = self.pkg.shim.SnapshotDeltaBridge(self.hub, self.client)

    def step(self) -> int:
        """Deltas in over the wire; the service's cycle under its lock;
        the watch echo confirms."""
        self.bridge.pump()
        with self.svc.lock:
            res = self.remote.schedule_cycle()
        self.bridge.pump()
        return res.scheduled

    def oracle(self):
        truth = {k: p.node_name for k, p in self.hub.truth_pods.items()}
        return self.pkg.debugger.compare(self.remote, truth,
                                         list(self.hub.truth_nodes))

    def placements(self):
        return sorted((k, p.node_name)
                      for k, p in self.hub.truth_pods.items())

    def close(self) -> None:
        self.client.close()
        self.server.stop(grace=None)


def both(script):
    out = []
    for pkg in (REF, PORT):
        out.append(script(pkg))
    assert out[1] == out[0]
    return out[1]


def test_remote_scheduler_service_drives_hub_to_convergence():
    def script(pkg):
        d = Deployment(pkg, seed=21)
        try:
            for i in range(6):
                d.hub.add_node(pkg.testing.make_node(f"n{i}", cpu_milli=4000,
                                                     pods=20))
            for i in range(30):
                d.hub.create_pod(pkg.testing.make_pod(f"p{i}", cpu_milli=300))
            d.connect()
            total, steps = 0, 0
            for _ in range(10):
                total += d.step()
                steps += 1
                d.hub.clock.advance(2.0)
                if total >= 30:
                    break
            nd, pd = d.oracle()
            d.hub.clock.advance(60.0)
            expired = d.remote.cache.cleanup_expired()
            return (total, steps, d.hub.bound_total, d.binder.conflicts,
                    nd, pd, expired, d.placements())
        finally:
            d.close()

    total, _, bound, conflicts, nd, pd, expired, _ = both(script)
    assert total == 30 and bound == 30 and conflicts == 0
    assert not nd and not pd and expired == []


def test_remote_service_survives_churn_and_controller_refeed():
    def script(pkg):
        d = Deployment(pkg, seed=22)
        try:
            for i in range(4):
                d.hub.add_node(pkg.testing.make_node(f"n{i}", cpu_milli=4000,
                                                     pods=30))
            d.hub.add_replicaset(pkg.sim.ReplicaSet("web", replicas=12))
            d.connect()
            for t in range(12):
                d.hub.reconcile_controllers()
                d.step()
                if t % 3 == 2:
                    d.hub.churn(kill_pods=2)
                d.hub.clock.advance(2.0)
            for _ in range(6):
                d.hub.reconcile_controllers()
                d.step()
                d.hub.clock.advance(2.0)
            bound = [p for p in d.hub.truth_pods.values() if p.node_name]
            nd, pd = d.oracle()
            return len(bound), nd, pd, d.placements()
        finally:
            d.close()

    n_bound, nd, pd, _ = both(script)
    assert n_bound == 12 and not nd and not pd


def test_stale_service_view_hits_cas_conflict_and_recovers():
    def script(pkg):
        d = Deployment(pkg, seed=23)
        try:
            d.hub.add_node(pkg.testing.make_node("n0", cpu_milli=4000))
            d.hub.create_pod(pkg.testing.make_pod("raced", cpu_milli=100))
            d.connect()
            d.bridge.pump()
            # a competing writer binds it first (the service hasn't pumped)
            d.hub.confirm_binding(d.hub.truth_pods["default/raced"], "n0")
            with d.svc.lock:
                res = d.remote.schedule_cycle()  # stale view: binds too
            d.bridge.pump()  # the watch echo delivers the competing bind
            nd, pd = d.oracle()
            return d.binder.conflicts, res.bind_errors, nd, pd
        finally:
            d.close()

    conflicts, bind_errors, nd, pd = both(script)
    assert conflicts == 1 and bind_errors == 1 and not nd and not pd
