"""The port's pipelined cycle executor and its device round loop, held
against the JAX package on the CPU.

The port's ``Scheduler(device="cpu")`` and the JAX ``Scheduler`` run side
by side at ``pipeline_depth`` 2, 3 and 5 (``pipeline_chunk=32``) on the
reference suite's clusters (tests/test_pipeline.py): placements, chunk
counts, rounds, failure reasons, FitError text, the explain report's
rows, and the victims and nominations of preemption over pipelined
failures are bit-identical, and so is the fall-back to the monolithic
cycle for nominated pods, gangs and host plugins. The seeded probe pins
the fault this executor fixes: at the defaults a chunked cycle places
differently from one monolithic solve, and the port must place as the
reference does. Sync accounting: a cycle that places everything reads
back once (twice with the auto-router), a pipelined cycle once per
chunk; ``batch_assign`` returns its round count as a tensor. The round
bodies are checked for what a CUDA graph capture refuses (host reads,
data-dependent shapes, host data copied in)."""

import random

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import kubernetes_tpu.ops.assign as ja
import kubernetes_tpu.framework as jfw
import kubernetes_tpu_torch.framework as tfw
import kubernetes_tpu_torch.ops.assign as ta
from kubernetes_tpu.models.cluster import make_gang_pods
from kubernetes_tpu.testing import make_node, make_pod
from kubernetes_tpu_torch.ops import device_loop
from kubernetes_tpu_torch.ops.sync import SYNCS
from test_predicates import random_cluster
from torch_parity import (
    assert_same_cycle,
    feed_cluster,
    jax_tables,
    jax_topo_tables,
    port_tables,
    port_topo_tables,
    pref_affinity_cluster,
    random_volume_cluster,
    scheduler_pair,
    topo_mixed_cluster,
    to_port,
)


def _nodes(n=16, cpu=4000, pods=110):
    return [make_node(f"n{i}", cpu_milli=cpu, memory=32 * 2**30, pods=pods)
            for i in range(n)]


def _pods(n, cpu=100, prefix="p"):
    return [make_pod(f"{prefix}{i}", cpu_milli=cpu, memory=256 * 2**20,
                     priority=i % 3) for i in range(n)]


def _cycle(nodes, pods, **kw):
    """One cycle of each package on the same cluster; returns
    ``(js, ts, rj, rt)``."""
    kw.setdefault("enable_preemption", False)
    js, ts = scheduler_pair(**kw)
    feed_cluster(js, ts, nodes, pods)
    return js, ts, js.schedule_cycle(), ts.schedule_cycle()


@pytest.mark.parametrize("depth", [2, 3, 5])
def test_pipeline_engages_and_matches_the_reference(depth):
    _js, _ts, rj, rt = _cycle(_nodes(), _pods(150), pipeline_depth=depth,
                              pipeline_chunk=32)
    assert rt.scheduled == 150 and rt.unschedulable == 0
    assert rt.pipeline_chunks == 5  # ceil(150/32)
    assert_same_cycle(rj, rt)


def test_pipeline_is_depth_invariant():
    runs = [_cycle(_nodes(), _pods(150), pipeline_depth=d,
                   pipeline_chunk=32)[3].assignments for d in (2, 3, 5)]
    assert runs[0] == runs[1] == runs[2]


def test_depth_one_is_monolithic():
    _js, _ts, rj, rt = _cycle(_nodes(), _pods(150), pipeline_depth=1,
                              pipeline_chunk=32)
    assert rt.scheduled == 150 and rt.pipeline_chunks == 0
    assert_same_cycle(rj, rt)


@pytest.mark.parametrize("depth", [1, 2])
def test_greedy_chunked_matches_the_reference(depth):
    """Chunked greedy is the serial loop over queue-order prefixes: it
    places as the monolithic greedy does, in both packages."""
    _js, _ts, rj, rt = _cycle(_nodes(), _pods(100), solver="greedy",
                              pipeline_depth=depth, pipeline_chunk=32)
    assert rt.scheduled == 100
    assert rt.pipeline_chunks == (4 if depth > 1 else 0)
    assert_same_cycle(rj, rt)
    base = _cycle(_nodes(), _pods(100), solver="greedy", pipeline_depth=1,
                  pipeline_chunk=32)[3]
    assert rt.assignments == base.assignments


@pytest.mark.parametrize("depth", [2, 3])
def test_pipeline_contention_failures_and_explain_rows(depth):
    """4 nodes x 2 fit: 8 of 64 pods land; the residual pods get the
    reference's reasons, FitError text, explain rows, why-pending rows
    and requeue."""
    js, ts, rj, rt = _cycle(_nodes(4, cpu=1000), _pods(64, cpu=500),
                            pipeline_depth=depth, pipeline_chunk=16)
    assert rt.scheduled == 8 and rt.unschedulable == 56
    assert rt.pipeline_chunks == 4
    assert "Insufficient cpu" in next(iter(rt.fit_errors.values()))
    assert rt.explain is not None and len(rt.explain.pods) == 56
    assert_same_cycle(rj, rt)
    assert sorted(ts.why_pending) == sorted(js.why_pending)
    assert len(ts.queue) == len(js.queue) == 56


@pytest.mark.parametrize("depth", [2, 5])
def test_preemption_over_pipelined_failures(depth):
    """Full nodes; high-priority preemptors that fit nowhere straddle the
    chunks: the victims, the nominations and the explain rows of the
    pipelined cycle are the reference's."""
    nodes = _nodes(8, cpu=4000)
    bound = [make_pod(f"b{k}", cpu_milli=900, memory=2**30,
                      node_name=f"n{k // 4}") for k in range(32)]
    pending = _pods(40, cpu=100, prefix="s")
    pending += [make_pod(f"pre{i}", cpu_milli=3000, memory=2**30,
                         priority=1000) for i in range(8)]
    events = {"j": [], "t": []}
    js, ts = scheduler_pair(enable_preemption=True, pipeline_depth=depth,
                            pipeline_chunk=16)
    js.event_sink = lambda r, p, m: events["j"].append((r, p.key(), m))
    ts.event_sink = lambda r, p, m: events["t"].append((r, p.key(), m))
    feed_cluster(js, ts, nodes, bound + pending)
    rj, rt = js.schedule_cycle(), ts.schedule_cycle()
    assert rt.pipeline_chunks == 3
    assert rt.preempted > 0 and rt.nominations
    assert_same_cycle(rj, rt)
    assert events["t"] == events["j"]


def _host_filter(fw):
    class NotN0:
        def name(self):
            return "NotN0"

        def filter(self, state, pod, node_name):
            return (fw.Status(fw.UNSCHEDULABLE, "no") if node_name == "n0"
                    else None)

    return fw.Framework(plugins=[NotN0()])


@pytest.mark.parametrize("feature", ["gang", "host-plugin"])
def test_ineligible_features_fall_back_to_monolithic(feature):
    if feature == "gang":
        js, ts, rj, rt = _cycle(_nodes(), make_gang_pods(4, 8),
                                pipeline_chunk=16)
        assert rt.scheduled == 32
    else:
        js, ts = scheduler_pair(enable_preemption=False, pipeline_chunk=16)
        js.framework = _host_filter(jfw)
        ts.framework = _host_filter(tfw)
        feed_cluster(js, ts, _nodes(), _pods(64))
        rj, rt = js.schedule_cycle(), ts.schedule_cycle()
        assert rt.scheduled == 64
        assert "n0" not in rt.assignments.values()
    assert rt.pipeline_chunks == rj.pipeline_chunks == 0
    assert_same_cycle(rj, rt)


def test_nominated_pods_keep_the_monolithic_cycle():
    js, ts = scheduler_pair(pipeline_chunk=16)
    batch = _pods(64)
    nominated = [(make_pod("nom", cpu_milli=100), "n0")]
    for s, conv in ((js, lambda x: x), (ts, to_port)):
        assert s._pipeline_eligible(conv(batch), [])
        assert not s._pipeline_eligible(conv(batch), conv(nominated))
        assert not s._pipeline_eligible(conv(batch[:16]), [])


def test_pipeline_spans_make_the_cycle_trace():
    _js, ts, _rj, rt = _cycle(_nodes(), _pods(100), pipeline_chunk=32)
    assert rt.pipeline_chunks == 4
    spans = ts.obs.last_trace.span_durations()
    for k in range(4):
        for site in ("pack", "dispatch", "readback", "bind"):
            assert f"pipeline:{site}@{k}" in spans
    assert "snapshot" in spans and "solve:batch" not in spans
    events = ts.obs.chrome_trace()["traceEvents"]
    assert any(e["name"] == "pipeline:dispatch@3" for e in events)


def test_monolithic_cycle_spans():
    _js, ts, _rj, rt = _cycle(_nodes(), _pods(20))
    assert rt.pipeline_chunks == 0
    spans = ts.obs.last_trace.span_durations()
    for name in ("snapshot", "solve:batch", "validate", "bind"):
        assert name in spans, spans


def test_seeded_probe_places_as_the_reference():
    """16 nodes (2000m on every third, else 4000m), 150 pods of
    100 + 37 * (i % 7) m: at depth 2 in chunks of 32 the reference places
    109 pods elsewhere than one monolithic solve would; the port must
    follow the pipelined placements, not the monolithic ones."""
    nodes = [make_node(f"n{i}", cpu_milli=2000 if i % 3 == 0 else 4000,
                       memory=32 * 2**30, pods=110) for i in range(16)]
    pods = [make_pod(f"p{i}", cpu_milli=100 + 37 * (i % 7),
                     memory=256 * 2**20, priority=i % 3) for i in range(150)]
    _js, _ts, rj, rt = _cycle(nodes, pods, pipeline_depth=2,
                              pipeline_chunk=32)
    mono = _cycle(nodes, pods, pipeline_depth=1)[2]
    assert (rj.rounds, rj.pipeline_chunks, mono.rounds) == (11, 5, 8)
    differ = sum(rj.assignments[k] != mono.assignments[k]
                 for k in mono.assignments)
    assert differ == 109
    assert_same_cycle(rj, rt)


def test_defaults_match_the_reference_over_4096_pods():
    """At the defaults (depth 2, chunks of 4096) a batch of 4200 pods
    takes two chunks in both packages and places identically."""
    nodes = _nodes(48, cpu=32000, pods=110)
    pods = [make_pod(f"p{i}", cpu_milli=100 + 5 * (i % 11),
                     memory=64 * 2**20, priority=i % 3) for i in range(4200)]
    _js, ts, rj, rt = _cycle(nodes, pods)
    assert (ts.pipeline_depth, ts.pipeline_chunk) == (2, 4096)
    assert rt.pipeline_chunks == 2
    assert_same_cycle(rj, rt)


# ---------------------------------------------------------------------------
# sync accounting
# ---------------------------------------------------------------------------


def test_monolithic_cycle_reads_back_once():
    _js, ts = scheduler_pair(enable_preemption=False)
    feed_cluster(_js, ts, _nodes(), _pods(100))
    r = ts.schedule_cycle()
    assert r.scheduled == 100 and r.pipeline_chunks == 0
    assert r.host_syncs == 1


def test_monolithic_cycle_with_the_router_reads_back_twice():
    nodes, bound, pending = pref_affinity_cluster(3, n_nodes=32, n_bound=8,
                                                  n_pending=96,
                                                  oversized_every=0)
    _js, ts = scheduler_pair(enable_preemption=False)
    feed_cluster(_js, ts, nodes, bound + pending)
    r = ts.schedule_cycle()
    assert r.scheduled == 96 and r.pipeline_chunks == 0
    assert r.host_syncs == 2  # the readback and the router's decision


@pytest.mark.parametrize("chunk, chunks", [(32, 5), (64, 3)])
def test_pipelined_cycle_reads_back_once_per_chunk(chunk, chunks):
    _js, ts = scheduler_pair(enable_preemption=False, pipeline_chunk=chunk)
    feed_cluster(_js, ts, _nodes(), _pods(150))
    r = ts.schedule_cycle()
    assert r.scheduled == 150 and r.pipeline_chunks == chunks
    assert r.host_syncs == chunks


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("cap", [1, 4])
def test_batch_assign_rounds_is_a_tensor(seed, cap):
    nodes, scheduled, pending = random_cluster(random.Random(seed))
    jdn, jdp, jds, _dv, _nt, _pt, _pk = jax_tables(nodes, scheduled,
                                                   pending)
    dn, dp, ds, _ = port_tables(jdn, jdp, jds)
    s0 = SYNCS.count
    a, _u, rounds = ta.batch_assign(dp, dn, ds, per_node_cap=cap,
                                    auto_sinkhorn=False)
    assert SYNCS.count == s0  # the CPU loop's exit tests are not syncs
    ja_, _ju, jr = ja.batch_assign(jdp, jdn, jds, per_node_cap=cap,
                                   auto_sinkhorn=False)
    assert isinstance(rounds, torch.Tensor)
    assert rounds.dtype == torch.int32 and rounds.shape == ()
    assert int(rounds) == int(jr)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja_))


def test_zero_rounds_and_no_valid_pod():
    nodes, scheduled, pending = random_cluster(random.Random(0))
    jdn, jdp, jds, _dv, _nt, _pt, _pk = jax_tables(nodes, scheduled,
                                                   pending)
    dn, dp, ds, _ = port_tables(jdn, jdp, jds)
    _a, _u, r0 = ta.batch_assign(dp, dn, ds, max_rounds=0)
    assert int(r0) == 0
    none = dp._replace(valid=torch.zeros_like(dp.valid))
    a, _u, r = ta.batch_assign(none, dn, ds)
    assert int(r) == 0 and bool((a == -1).all())


# ---------------------------------------------------------------------------
# the round bodies the device loop captures
# ---------------------------------------------------------------------------

#: ops a CUDA graph capture refuses or that read the device from the host
_HOST_OPS = ("_local_scalar_dense", "nonzero", "masked_select", "lift_fresh",
             "is_nonzero", "unique", "masked_scatter", "repeat_interleave")


class _HostReads(TorchDispatchMode):
    """Records every op that reads a tensor on the host, makes a shape
    from data, or brings host data in."""

    def __init__(self):
        super().__init__()
        self.bad = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__
        if any(name.startswith(h) for h in _HOST_OPS):
            self.bad.append(name)
        if name.startswith("index.Tensor") or name.startswith("index_put"):
            idx = args[1] if len(args) > 1 else ()
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in idx):
                self.bad.append(name + "(bool)")
        return func(*args, **(kwargs or {}))


def _captured_body(monkeypatch, call):
    """Run ``call()`` and return the round body, inputs and statics it
    handed to the device loop."""
    got = {}
    real = device_loop.run

    def spy(round_fn, ctx, state, valid, max_rounds, statics=None,
            shape=()):
        got.update(fn=round_fn, ctx=ctx, state=state, statics=statics)
        return real(round_fn, ctx, state, valid, max_rounds, statics,
                    shape)

    monkeypatch.setattr(device_loop, "run", spy)
    call()
    return got


def _clusters():
    nodes, bound, pending = pref_affinity_cluster(2, n_nodes=32, n_bound=8,
                                                  n_pending=64)
    jdn, jdp, jds, _dv, nt, pt, _pk = jax_tables(nodes, bound, pending)
    dn, dp, ds, _ = port_tables(jdn, jdp, jds)
    yield "general", dict(pods=dp, nodes=dn, sel=ds, per_node_cap=2)
    yield "plan", dict(pods=dp, nodes=dn, sel=ds, per_node_cap=2,
                       use_sinkhorn=True, stats_out=True)
    yield "lean", dict(pods=dp, nodes=dn, sel=ds, per_node_cap=2,
                       auto_sinkhorn=False, no_ports=True,
                       skip_priorities=("NodeAffinityPriority",
                                        "TaintTolerationPriority",
                                        "SelectorSpreadPriority",
                                        "InterPodAffinityPriority",
                                        "EvenPodsSpreadPriority",
                                        "ImageLocalityPriority",
                                        "NodePreferAvoidPodsPriority",
                                        "ResourceLimitsPriority"))
    nodes, bound, pending = topo_mixed_cluster(2, n_nodes=24, n_bound=8,
                                               n_pending=60)
    jdn, jdp, jds, jdt, _nt, _pt, _pk = jax_topo_tables(nodes, bound,
                                                        pending)
    dn, dp, ds, dt = port_topo_tables(jdn, jdp, jds, jdt)
    yield "topology", dict(pods=dp, nodes=dn, sel=ds, topo=dt,
                           per_node_cap=4)
    nodes, scheduled, pending, pvcs, pvs, classes = random_volume_cluster(1)
    jdn, jdp, jds, jdv, _nt, _pt, _pk = jax_tables(
        nodes, scheduled, pending, pvcs, pvs, classes, volumes=True)
    dn, dp, ds, dv = port_tables(jdn, jdp, jds, jdv)
    yield "volumes", dict(pods=dp, nodes=dn, sel=ds, vol=dv, per_node_cap=2)


@pytest.mark.parametrize("route", ["general", "plan", "lean", "topology",
                                   "volumes"])
def test_round_body_is_capturable(monkeypatch, route):
    kw = dict(_clusters())[route]
    got = _captured_body(monkeypatch, lambda: ta.batch_assign(**kw))
    assert got["statics"] is not None
    hash(got["statics"])
    assert (route == "lean") == (got["statics"][0] == "lean")
    with _HostReads() as mode:
        state, cont, _tag = got["fn"](got["ctx"], got["state"], False,
                                      route == "plan")
    assert mode.bad == []
    assert cont.dtype == torch.bool and cont.shape == ()
    before = device_loop._tensors(got["state"])
    after = device_loop._tensors(state)
    assert [(t.shape, t.dtype) for t in after] == [
        (t.shape, t.dtype) for t in before]


def test_tolerance_gated_plan_keeps_the_host_loop(monkeypatch):
    kw = dict(_clusters())["plan"]
    got = _captured_body(monkeypatch, lambda: ta.batch_assign(
        **kw, sk_tol=1e-3))
    assert got["statics"] is None


def test_flatten_and_rebuild_round_trip():
    t = [torch.arange(3), torch.ones(2, 2), torch.zeros(1)]
    tree = (ta.UsageState(*([t[0]] * 14)), {"a": ("raw", t[1], True)},
            None, [t[2], 3, "x"])
    leaves = []
    sig = device_loop._flatten(tree, leaves)
    hash(sig)
    assert len(leaves) == 16
    back = device_loop._rebuild(tree, iter([x + 1 for x in leaves]))
    assert isinstance(back[0], ta.UsageState)
    assert torch.equal(back[1]["a"][1], t[1] + 1)
    assert back[1]["a"][2] is True and back[2] is None
    assert back[3][1:] == [3, "x"]
    # equal structure and shapes give equal signatures; values do not count
    assert device_loop._flatten(back, []) == sig
