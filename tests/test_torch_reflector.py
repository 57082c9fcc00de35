"""The port's informer (``kubernetes_tpu_torch/sim.py`` ``Reflector``,
client-go's ListAndWatch) held against the JAX package's. Each case runs
one script on each package: its own hub, a scheduler of its own fed only
through its own Reflector, the same seeded inputs (a seeded relist
backoff where the progress deadline is on). The schedulers'
``debugger.compare`` against the truth, and the Reflectors' ``relists``,
``stalled_relists`` and ``deduped``, must be equal, and the pods each
Reflector holds must be the same keys."""

import json
import types

import pytest

import kubernetes_tpu.cli as jcli
import kubernetes_tpu.debugger as jdebugger
import kubernetes_tpu.faults as jfaults
import kubernetes_tpu.scheduler as jscheduler
import kubernetes_tpu.sim as jsim
import kubernetes_tpu.testing as jtesting
import kubernetes_tpu_torch.cli as tcli
import kubernetes_tpu_torch.debugger as tdebugger
import kubernetes_tpu_torch.faults as tfaults
import kubernetes_tpu_torch.scheduler as tscheduler
import kubernetes_tpu_torch.sim as tsim
import kubernetes_tpu_torch.testing as ttesting

REF = types.SimpleNamespace(sim=jsim, testing=jtesting, faults=jfaults,
                            scheduler=jscheduler, debugger=jdebugger,
                            cli=jcli, kw={})
PORT = types.SimpleNamespace(sim=tsim, testing=ttesting, faults=tfaults,
                             scheduler=tscheduler, debugger=tdebugger,
                             cli=tcli, kw={"device": "cpu"})


def cluster(pkg, seed=3, n_nodes=6, n_pods=12):
    hub = pkg.sim.HollowCluster(seed=seed, scheduler_kw=dict(pkg.kw))
    for i in range(n_nodes):
        hub.add_node(pkg.testing.make_node(f"n{i}", cpu_milli=4000))
    for i in range(n_pods):
        hub.create_pod(pkg.testing.make_pod(
            f"p{i}", cpu_milli=300, labels={"app": "web" if i % 2 else "db"}))
    hub.step()
    hub.settle()
    return hub


def shadow(pkg, hub, **kw):
    return pkg.scheduler.Scheduler(clock=hub.clock, enable_preemption=False,
                                   binder=hub.binder, **kw, **pkg.kw)


def outcome(pkg, hub, sink, refl, selected=lambda p: True) -> dict:
    truth = {k: p.node_name for k, p in hub.truth_pods.items()
             if selected(p)}
    return {"compare": pkg.debugger.compare(sink, truth,
                                            list(hub.truth_nodes)),
            "relists": refl.relists, "stalled": refl.stalled_relists,
            "deduped": refl.deduped, "pods": sorted(refl.pods),
            "revision": hub._revision}


class Eater:
    """A watch stream that delivers nothing while ``on`` (a half-open
    connection); the cursor underneath still advances."""

    on = False

    def __init__(self, cur) -> None:
        self.cur = cur

    def poll(self):
        got = self.cur.poll()
        return [] if type(self).on else got


class Fuzzer:
    """Every poll's frames delivered twice, the second copy reversed:
    duplicated and reordered frames the dedupe must drop."""

    def __init__(self, cur) -> None:
        self.cur = cur

    def poll(self):
        got = self.cur.poll()
        return got + list(reversed(got))


def list_and_watch(pkg):
    hub = cluster(pkg)
    sink = shadow(pkg, hub)
    refl = pkg.sim.Reflector(hub, sink)
    refl.list_and_watch()
    first = outcome(pkg, hub, sink, refl)
    hub.create_pod(pkg.testing.make_pod("w", cpu_milli=100))
    hub.delete_pod("default/p0")
    n = refl.pump()
    res = sink.schedule_cycle()
    hub.settle()
    refl.pump()
    return {"first": first, "pumped": n, "placed": dict(res.assignments),
            "then": outcome(pkg, hub, sink, refl)}


def relist_after_410(pkg):
    hub = cluster(pkg)
    sink = shadow(pkg, hub)
    refl = pkg.sim.Reflector(hub, sink)
    refl.list_and_watch()
    # while the watch lags: a delete (the relist must synthesize its
    # DELETE), a bound pod deleted and recreated unbound under its key
    # (replayed as delete + add), a new pod; then the history compacts
    hub.delete_pod("default/p1")
    hub.delete_pod("default/p2")
    hub.create_pod(pkg.testing.make_pod("p2", cpu_milli=300))
    hub.create_pod(pkg.testing.make_pod("late", cpu_milli=100))
    hub.compact()
    n = refl.pump()
    assert refl.relists == 1 and n == 1
    before = sink.cache.pod_count()
    refl.resync()
    assert sink.cache.pod_count() == before
    return {"pumped": n, "pending": sorted(
        p.key() for q in sink.queue.pending_pods().values() for p in q),
            "out": outcome(pkg, hub, sink, refl)}


def selectors(pkg):
    hub = cluster(pkg)
    sink = shadow(pkg, hub)
    refl = pkg.sim.Reflector(hub, sink, pod_label_selector="app=web",
                             pod_field_selector="spec.nodeName!=n0")
    refl.list_and_watch()
    sel = dict(refl.pods)
    # a pod bound onto n0 leaves the field selector: a DELETE to the sink
    import dataclasses

    key = next(k for k, p in hub.truth_pods.items()
               if p.labels.get("app") == "web" and p.node_name != "n0")
    old = hub.truth_pods[key]
    hub.delete_pod(key)
    moved = dataclasses.replace(old, node_name="", uid="")
    hub.create_pod(moved)
    hub.confirm_binding(hub.truth_pods[key], "n0")
    hub.create_pod(pkg.testing.make_pod("web-new", cpu_milli=100,
                                        labels={"app": "web"}))
    refl.pump()

    def selected(p):
        return p.labels.get("app") == "web" and p.node_name != "n0"

    return {"listed": sorted(sel), "left": key not in refl.pods,
            "out": outcome(pkg, hub, sink, refl, selected)}


def dedupe(pkg):
    hub = cluster(pkg)
    sink = shadow(pkg, hub)
    refl = pkg.sim.Reflector(hub, sink, cursor_wrap=Fuzzer)
    refl.list_and_watch()
    for i in range(4):
        hub.create_pod(pkg.testing.make_pod(f"d{i}", cpu_milli=100))
    hub.delete_pod("default/p3")
    hub.step()
    refl.pump()
    sink.schedule_cycle()
    hub.settle()
    refl.pump()
    assert refl.deduped > 0
    return outcome(pkg, hub, sink, refl)


def stall(pkg):
    hub = cluster(pkg)
    sink = shadow(pkg, hub)
    backoff = pkg.faults.RetryPolicy(base_s=1.0, max_s=30.0, jitter=0.5,
                                     seed=11)
    refl = pkg.sim.Reflector(hub, sink, clock=hub.clock,
                             progress_deadline_s=5.0,
                             relist_backoff=backoff, cursor_wrap=Eater)
    refl.list_and_watch()
    trace = []
    Eater.on = True
    try:
        for i in range(6):
            hub.create_pod(pkg.testing.make_pod(f"s{i}", cpu_milli=100))
            trace.append(refl.pump())
            hub.clock.advance(2.0)
            trace.append((refl.relists, refl.stalled_relists,
                          refl._next_relist_ok))
    finally:
        Eater.on = False
    assert refl.stalled_relists >= 1
    refl.pump()
    return {"trace": trace, "out": outcome(pkg, hub, sink, refl)}


def deadline_zero(pkg):
    hub = cluster(pkg)
    sink = shadow(pkg, hub)
    refl = pkg.sim.Reflector(hub, sink, clock=hub.clock,
                             progress_deadline_s=0.0, cursor_wrap=Eater)
    refl.list_and_watch()
    Eater.on = True
    try:
        for i in range(5):
            hub.create_pod(pkg.testing.make_pod(f"z{i}", cpu_milli=100))
            refl.pump()
            hub.clock.advance(60.0)
    finally:
        Eater.on = False
    # idled forever: no relist, and the sink never saw the new pods
    assert refl.relists == 0 and refl.stalled_relists == 0
    assert all(sink.queue.pod(f"default/z{i}") is None for i in range(5))
    return outcome(pkg, hub, sink, refl)


CASES = [list_and_watch, relist_after_410, selectors, dedupe, stall,
         deadline_zero]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_reflector_matches_reference(case):
    assert case(PORT) == case(REF)


@pytest.mark.parametrize("doc, want", [
    ({"apiVersion": "kubescheduler.config.k8s.io/v1alpha1",
      "kind": "KubeSchedulerConfiguration",
      "robustness": {"watchProgressDeadline": "7s"}}, 7.0),
    ({"apiVersion": "kubescheduler.config.k8s.io/v1alpha1",
      "kind": "KubeSchedulerConfiguration",
      "robustness": {"watchProgressDeadline": "0s"}}, 0.0),
    ({"robustness": {"watch_progress_deadline_s": 12.5}}, 12.5),
])
def test_watch_progress_deadline_from_a_config_file_reaches_the_reflector(
        tmp_path, doc, want):
    """``robustness.watchProgressDeadline`` is no longer refused: a
    scheduler built from the file hands it to every Reflector built on
    it, as the reference's does."""
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(doc))
    got = []
    for pkg in (REF, PORT):
        cfg = pkg.cli.load_config_file(str(path))
        assert pkg.cli.validate_config(cfg) == []
        hub = pkg.sim.HollowCluster(seed=1, scheduler_kw=dict(pkg.kw))
        sink = pkg.scheduler.Scheduler.from_config(
            cfg, clock=hub.clock, binder=hub.binder, **pkg.kw)
        got.append(pkg.sim.Reflector(hub, sink,
                                     clock=hub.clock).progress_deadline_s)
    assert tcli.unported_features(cfg) == []
    assert got == [want, want]
