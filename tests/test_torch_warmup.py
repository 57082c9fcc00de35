"""``Scheduler.warmup`` of the PyTorch port held against the JAX
package's: the same bucketed shapes and count, the same warmed candidate
ladder (``_warmed_cbuckets``, which unpins the bucket tuner), and cycles
after warmup that place as the reference's do. On the card warming means
capturing the round loop's CUDA graphs; on the CPU the device loop
records the key a card would cache each graph under
(``device_loop.KEYS``), so the tests check here that the warmed keys
cover every key the next cycles present: each pod bucket, both routes of
the auto-router and the nominated-pods variant."""

import pytest

from kubernetes_tpu.config import IncrementalConfig as JInc
from kubernetes_tpu.config import WarmupConfig as JWarm
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu_torch.config import IncrementalConfig as TInc
from kubernetes_tpu_torch.config import WarmupConfig as TWarm
from kubernetes_tpu_torch.ops import device_loop
from kubernetes_tpu_torch.scheduler import Scheduler as TScheduler
from torch_parity import (
    PIPELINE_FIELDS,
    assert_same_cycle,
    pref_affinity_cluster,
    to_port,
)


def _pair(inc=None, warm=None, **kw):
    inc = inc or {}
    warm = {"enabled": True, "min_bucket": 8, **(warm or {})}
    kw = {"max_batch": 32, "clock": lambda: 0.0, **kw}
    return (JScheduler(incremental=JInc(**inc), warmup=JWarm(**warm), **kw),
            TScheduler(device="cpu", incremental=TInc(**inc),
                       warmup=TWarm(**warm), **kw))


def _feed(js, ts, nodes, pods):
    for nd in nodes:
        js.on_node_add(nd)
        ts.on_node_add(to_port(nd))
    for p in pods:
        js.on_pod_add(p)
        ts.on_pod_add(to_port(p))


def _warm(js, ts, sample):
    device_loop.KEYS.clear()
    got = (js.warmup(sample_pods=sample),
           ts.warmup(sample_pods=[to_port(p) for p in sample]))
    return got, set(device_loop.KEYS)


@pytest.mark.parametrize("solver", ["batch", "sinkhorn"])
@pytest.mark.parametrize("inc", [
    {}, {"enabled": True, "candidate_bucket": 16},
    {"enabled": True, "candidate_bucket": 16, "auto_tune": True,
     "primary": True}])
def test_warmup_warms_the_references_shapes(solver, inc):
    nodes, bound, pending = pref_affinity_cluster(3, n_nodes=24, n_bound=8,
                                                  n_pending=24)
    js, ts = _pair(inc=inc, solver=solver, enable_preemption=False)
    _feed(js, ts, nodes, bound + pending)
    (cj, ct), _keys = _warm(js, ts, pending)
    assert ct == cj > 0
    assert ts._warmed_cbuckets == js._warmed_cbuckets
    assert (ts.metrics.warmup_compiles.value()
            == js.metrics.warmup_compiles.value())
    if inc.get("auto_tune"):
        # the tuner may move now: the ladder is warmed
        assert ts._warmed_cbuckets == {16}
    # the cycle after warmup places as the reference's
    rj, rt = js.schedule_cycle(), ts.schedule_cycle()
    assert_same_cycle(rj, rt, PIPELINE_FIELDS + ("solve_scope",))


def test_warmed_keys_cover_the_cycles_after_warmup():
    """Every round-loop key the next cycles present was warmed: both
    routes of the auto-router at each pod bucket (a fresh batch of each
    size), so on the card no cycle captures a graph."""
    nodes, bound, pending = pref_affinity_cluster(5, n_nodes=40, n_bound=8,
                                                  n_pending=60)
    js, ts = _pair(enable_preemption=False)
    _feed(js, ts, nodes, bound)
    _counts, warmed = _warm(js, ts, pending)
    # route tags: the general round's key ends its statics with the tag
    assert {k[3] for k in warmed} == {False, True}
    start = 0
    for n in (5, 14, 30, 11):  # buckets 8, 16, 32 (max_batch), 16
        _feed(js, ts, [], pending[start:start + n])
        start += n
        device_loop.KEYS.clear()
        rj, rt = js.schedule_cycle(), ts.schedule_cycle()
        assert_same_cycle(rj, rt)
        assert device_loop.KEYS and device_loop.KEYS <= warmed


@pytest.mark.parametrize("nominated_variant", [True, False])
def test_nominated_variant_warms_the_masked_graph(nominated_variant):
    nodes, bound, pending = pref_affinity_cluster(2, n_nodes=16, n_bound=4,
                                                  n_pending=16)
    js, ts = _pair(warm={"nominated_variant": nominated_variant,
                         "pod_buckets": (16,)})
    _feed(js, ts, nodes, bound)
    (cj, ct), warmed = _warm(js, ts, pending)
    assert ct == cj == 1

    def masked(key):
        # the general round's ctx: (pods, nodes, sel, topo, vol,
        # static_vol, extra_mask, ...); a tensor's signature starts "T"
        return key[0][1][6][0] == "T"

    assert any(masked(k) for k in warmed) == nominated_variant
    assert any(not masked(k) for k in warmed)


def test_warmup_needs_a_node_axis_like_the_reference():
    js, ts = _pair(warm={"pod_buckets": (8, 16)})
    assert (js.warmup(), ts.warmup()) == (0, 0)
    got = (js.warmup(node_count=20), ts.warmup(node_count=20))
    assert got[1] == got[0] == 2


def test_warmed_graphs_are_pinned_outside_the_cache_bound(monkeypatch):
    """Eviction retires the oldest UNPINNED loops beyond CACHE_SIZE; a
    loop run under ``pinning()`` stays until ``clear()``."""

    class Loop:
        done = None

        def release(self):
            pass

    monkeypatch.setattr(device_loop, "_cache", type(device_loop._cache)())
    monkeypatch.setattr(device_loop, "_pinned", set())
    monkeypatch.setattr(device_loop, "_retired", [])
    monkeypatch.setattr(device_loop, "CACHE_SIZE", 2)
    for k in range(6):
        device_loop._cache[("pinned", k)] = Loop()
        device_loop._pinned.add(("pinned", k))
    for k in range(5):
        device_loop._cache[("hot", k)] = Loop()
        device_loop._evict()
    assert [k for k in device_loop._cache if k[0] == "hot"] == [
        ("hot", 3), ("hot", 4)]
    assert device_loop.pinned_count() == 6
    assert len(device_loop._retired) == 3
    device_loop.clear()
    assert not device_loop._cache and device_loop.pinned_count() == 0
