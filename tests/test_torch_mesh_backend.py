"""The port's node-axis mesh (``kubernetes_tpu_torch/parallel/mesh.py``)
held against the JAX package's sharded backend on the CPU.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py``
forces; the port runs on logical meshes of the CPU device repeated (the
fixture below stands in ``local_devices`` for 8 of them, as the XLA flag
does for JAX). Each case runs one script through both packages and
compares what it returns, exactly: placements, rounds, the solve scope,
the snapshot mode, the ladder tier, the mesh gauge, the flight record's
``mesh`` and the ``+mesh{d}`` batch shape, at mesh widths {1, 2, 4, 8}.
The port's own cases: a mesh over distinct cards is built (and one that
mixes device types refused), the partitioned program runs at every
width above one, and a ``KernelError`` escapes the ``batch-single``
rung."""

import collections
import dataclasses
import random
import types

import numpy as np
import pytest
import torch

import jax

import kubernetes_tpu.api.config_v1alpha1 as jv1
import kubernetes_tpu.cache as jcache
import kubernetes_tpu.cli as jcli
import kubernetes_tpu.config as jconfig
import kubernetes_tpu.faults as jfaults
import kubernetes_tpu.models.cluster as jcluster
import kubernetes_tpu.parallel.mesh as jmesh
import kubernetes_tpu.scheduler as jscheduler
import kubernetes_tpu.testing as jtesting
import kubernetes_tpu_torch.api.config_v1alpha1 as tv1
import kubernetes_tpu_torch.cache as tcache
import kubernetes_tpu_torch.cli as tcli
import kubernetes_tpu_torch.config as tconfig
import kubernetes_tpu_torch.faults as tfaults
import kubernetes_tpu_torch.models.cluster as tcluster
import kubernetes_tpu_torch.parallel.mesh as tmesh
import kubernetes_tpu_torch.scheduler as tscheduler
import kubernetes_tpu_torch.testing as ttesting
from kubernetes_tpu.models.cluster import make_nodes, make_pods
from kubernetes_tpu.ops.arrays import (
    nodes_to_device,
    pods_to_device,
    selectors_to_device,
)
from kubernetes_tpu.ops.assign import batch_assign as jbatch_assign
from kubernetes_tpu.snapshot import SnapshotPacker
from kubernetes_tpu.testing import make_node, make_pod
from kubernetes_tpu_torch.kernels import KernelError
from kubernetes_tpu_torch.ops import device_loop
from kubernetes_tpu_torch.ops.assign import batch_assign as tbatch_assign
from torch_parity import port_tables

CPU = torch.device("cpu")


def _jwidth(cache, dev):
    """Devices the JAX resident table is sharded over (0: one device)."""
    sh = dev.allocatable.sharding
    return int(sh.mesh.devices.size) if hasattr(sh, "mesh") else 0


def _twidth(cache, dev):
    return tmesh.mesh_size(cache.resident_mesh)


REF = types.SimpleNamespace(
    cache=jcache, cli=jcli, cluster=jcluster, config=jconfig,
    faults=jfaults, mesh=jmesh, scheduler=jscheduler, testing=jtesting,
    v1=jv1, kw={},
    mesh_of=lambda d: jmesh.make_mesh(jax.devices()[:d]), width=_jwidth,
    cache_kw={})
PORT = types.SimpleNamespace(
    cache=tcache, cli=tcli, cluster=tcluster, config=tconfig,
    faults=tfaults, mesh=tmesh, scheduler=tscheduler, testing=ttesting,
    v1=tv1, kw={"device": "cpu"},
    mesh_of=lambda d: tmesh.make_mesh([CPU] * d), width=_twidth,
    cache_kw={"device": "cpu"})


@pytest.fixture(autouse=True)
def eight_logical_devices(monkeypatch):
    """The port's counterpart of the 8 virtual XLA devices: ``"auto"``
    and a device count resolve against 8 copies of the CPU device."""
    monkeypatch.setattr(tmesh, "local_devices",
                        lambda kind="cuda": [CPU] * 8)


def both(script):
    want, got = script(REF), script(PORT)
    assert got == want, (got, want)
    return got


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _sched(pkg, mesh=None, **kw):
    par = pkg.config.ParallelConfig(mesh=mesh) if mesh is not None else None
    kw.setdefault("clock", FakeClock())
    kw.setdefault("enable_preemption", False)
    return pkg.scheduler.Scheduler(parallel=par, **pkg.kw, **kw)


# ---------------------------------------------------------------------------
# Mesh construction: power-of-two validation, the spec resolver, refusals
# ---------------------------------------------------------------------------


def test_largest_pow2():
    got = both(lambda pkg: [pkg.mesh.largest_pow2(n)
                            for n in (1, 2, 3, 5, 6, 7, 8, 9)])
    assert got == [1, 2, 2, 4, 4, 4, 8, 8]


@pytest.mark.parametrize("given,kept", [(3, 2), (6, 4), (8, 8), (1, 1)])
def test_make_mesh_falls_back_to_pow2_subset(given, kept):
    assert both(lambda pkg: pkg.mesh.mesh_size(pkg.mesh_of(given))) == kept


def test_mesh_from_spec_vocabulary():
    def script(pkg):
        m = pkg.mesh
        with pytest.raises(ValueError):
            m.mesh_from_spec(-1)
        return (m.mesh_from_spec("off"), m.mesh_from_spec(None),
                m.mesh_size(m.mesh_from_spec("auto")),
                m.mesh_size(m.mesh_from_spec(4)),
                # more than available clamps (with a logged warning)
                m.mesh_size(m.mesh_from_spec(64)))

    assert both(script) == (None, None, 8, 4, 8)


def test_one_card_clamps_a_device_count(monkeypatch):
    """Only real devices count: on one device (the card, here the CPU)
    ``parallel.mesh: 8`` and ``auto`` are a mesh of 1, as the reference's
    on a one-device host."""
    monkeypatch.setattr(tmesh, "local_devices", lambda kind="cuda": [CPU])
    assert tmesh.mesh_size(tmesh.mesh_from_spec(8)) == 1
    assert tmesh.mesh_size(tmesh.mesh_from_spec("auto")) == 1
    want = jmesh.mesh_size(jmesh.mesh_from_spec(8, jax.devices()[:1]))
    assert want == 1
    s = _sched(PORT, mesh="auto")
    assert s.mesh.size == 1 and s.metrics.mesh_devices.value() == 1


@pytest.mark.parametrize("devices", [
    ["cpu", "meta"], ["cuda:0", "cpu"], ["cpu", "cuda:1", "cuda:2", "meta"]])
def test_mesh_over_distinct_devices_is_refused(devices, monkeypatch):
    """A mesh that mixes device types is no mesh any reference runs: it
    raises wherever it is built, naming the types, and nothing gathers it
    onto one device quietly."""
    devs = [torch.device(d) for d in devices]
    with pytest.raises(tmesh.MeshError, match="mixes device types"):
        tmesh.make_mesh(devs)
    with pytest.raises(tmesh.MeshError, match="mixes device types"):
        tmesh.mesh_from_spec("auto", devs)
    with pytest.raises(tmesh.MeshError, match="mixes device types"):
        tmesh.mesh_from_spec(2, devs)
    monkeypatch.setattr(tmesh, "local_devices", lambda kind="cuda": devs)
    with pytest.raises(tmesh.MeshError, match="mixes device types"):
        _sched(PORT, mesh="auto")
    # the one-device prefix is a mesh the port runs
    assert tmesh.mesh_from_spec(1, devs).size == 1


@pytest.mark.parametrize("devices,width", [
    (["cuda:0", "cuda:1"], 2), (["cuda:0", "cuda:1", "cuda:2"], 2),
    ([f"cuda:{i}" for i in range(8)], 8)])
def test_mesh_over_distinct_cards_is_built(devices, width):
    """Distinct cards make a real mesh: the largest power-of-two prefix,
    one device per shard in order, from every spelling; the placement
    helpers lay row block i out for ``devices[i]`` (shapes only: the
    copies need the cards)."""
    devs = [torch.device(d) for d in devices]
    for m in (tmesh.make_mesh(devs), tmesh.mesh_from_spec("auto", devs),
              tmesh.mesh_from_spec(len(devs), devs)):
        assert m.size == width and not m.logical
        assert list(m.devices) == devs[:width]
        assert tmesh.mesh_size(m) == width
    assert tmesh.mesh_from_spec(1, devs).devices == (devs[0],)


def test_shards_are_row_blocks_of_one_tensor():
    m = tmesh.make_mesh([CPU] * 4)
    t = torch.arange(32, dtype=torch.float32).reshape(16, 2)
    blocks = tmesh.shards(t, m)
    assert len(blocks) == 4
    for i, b in enumerate(blocks):
        assert b.shape == (4, 2) and b.data_ptr() == t[4 * i].data_ptr()
    rows = collections.namedtuple("Rows", "allocatable valid")
    with pytest.raises(ValueError, match="pad the node bucket"):
        tmesh.shard_nodes(rows(torch.zeros((6, 2)),
                               torch.ones(6, dtype=torch.bool)), m)


# ---------------------------------------------------------------------------
# Config: the parallel block in both codecs, validation, the --mesh flag
# ---------------------------------------------------------------------------


def test_parallel_block_native_decode_and_validation():
    def script(pkg):
        dc, vc = pkg.cli.decode_config, pkg.cli.validate_config
        cfg = dc({"parallel": {"mesh": "auto"}})
        with pytest.raises(Exception):
            dc({"parallel": {"lanes": 2}})  # unknown field
        return (cfg.parallel.mesh, vc(cfg),
                vc(dc({"parallel": {"mesh": 8}})),
                vc(dc({"parallel": {"mesh": 3}})),
                vc(dc({"parallel": {"mesh": "sideways"}})))

    got = both(script)
    assert got[:3] == ("auto", [], [])
    assert any("parallel.mesh" in e and "power of two" in e for e in got[3])
    assert any("parallel.mesh" in e for e in got[4])


def test_parallel_block_v1alpha1_round_trip():
    def script(pkg):
        cfg = pkg.config.KubeSchedulerConfiguration(
            parallel=pkg.config.ParallelConfig(mesh=4))
        doc = pkg.v1.encode(cfg)
        back = pkg.v1.decode(doc)
        doc2 = pkg.v1.encode(pkg.config.KubeSchedulerConfiguration())
        doc2.pop("parallel")
        return doc["parallel"], back.parallel.mesh, \
            pkg.v1.decode(doc2).parallel.mesh

    assert both(script) == ({"mesh": 4}, 4, "off")


def test_cli_mesh_flag_overlay():
    def script(pkg):
        p = pkg.cli.build_parser()
        got = [pkg.cli.resolve_config(p.parse_args(["--mesh", v])).parallel
               .mesh for v in ("4", "auto")]
        with pytest.raises(pkg.cli.ConfigError):
            pkg.cli.resolve_config(p.parse_args(["--mesh", "3"]))
        return got

    assert both(script) == [4, "auto"]


# ---------------------------------------------------------------------------
# Sharded-vs-single placement parity on the solve: the fuzz over mesh
# {1, 2, 4, 8}, the contended, predicate-mask and asymmetric 512x137 shapes
# ---------------------------------------------------------------------------


def _fuzz_tables(seed, n_nodes=48, n_pending=96):
    """The reference suite's randomized cluster: heterogeneous node sizes,
    existing load, mixed pod requests (non-trivial scores, real ties).
    Returns the JAX tables ``(dn, dp, ds)``."""
    rng = random.Random(seed)
    nodes = [
        make_node(f"n{i}", cpu_milli=rng.choice([4000, 8000, 16000]),
                  memory=rng.choice([8 * 2**30, 32 * 2**30]),
                  pods=rng.choice([16, 110]), zone=f"z{i % 4}")
        for i in range(n_nodes)]
    existing = [
        make_pod(f"old{i}", cpu_milli=rng.choice([100, 500]),
                 memory=2**28, node_name=f"n{rng.randrange(n_nodes)}")
        for i in range(n_nodes // 2)]
    pending = [
        make_pod(f"p{i}", cpu_milli=rng.choice([100, 250, 500]),
                 memory=rng.choice([2**27, 2**28]),
                 priority=rng.choice([0, 0, 10]))
        for i in range(n_pending)]
    pk = SnapshotPacker()
    for p in existing + pending:
        pk.intern_pod(p)
    return (nodes_to_device(pk.pack_nodes(nodes, existing)),
            pods_to_device(pk.pack_pods(pending)),
            selectors_to_device(pk.pack_selector_tables()))


def _solve_both(tables, d, **kw):
    """The JAX solve on a d-device mesh, the port's on a logical d-shard
    mesh and unsharded; returns the three (assigned, rounds) pairs."""
    dn, dp, ds = tables
    want = jbatch_assign(*jmesh.shard_cluster(dp, dn, ds, REF.mesh_of(d)),
                         **kw)
    tdn, tdp, tds = port_tables(dn, dp, ds)[:3]
    sdp, sdn, sds = tmesh.shard_cluster(tdp, tdn, tds, PORT.mesh_of(d))
    got = tbatch_assign(sdp, sdn, sds, **kw)
    flat = tbatch_assign(tdp, tdn, tds, **kw)
    return [(np.asarray(a).tolist(), int(r))
            for a, _u, r in (want, got, flat)]


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_sharded_bit_parity_fuzz(d):
    want, got, flat = _solve_both(_fuzz_tables(20260804 + d), d,
                                  per_node_cap=4)
    assert got == want == flat


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_sharded_bit_parity_contended(d):
    """Capacity-bound: several auction rounds, the per-node admission
    prefix sums and the rotation tie-break."""
    want, got, flat = _solve_both(_fuzz_tables(7, 16, 96), d, per_node_cap=2)
    assert got == want == flat
    assert want[1] > 1  # genuinely contended, same rounds


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_sharded_bit_parity_pred_mask(d):
    from kubernetes_tpu.config import default_predicate_mask
    from kubernetes_tpu.ops.predicates import BIT

    mask = default_predicate_mask() & ~(1 << BIT["PodFitsResources"])
    want, got, flat = _solve_both(_fuzz_tables(11, 16, 64), d,
                                  enabled_mask=mask)
    assert got == want == flat


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_sharded_bit_parity_asymmetric_512x137(d):
    """137 nodes pad to a 256 bucket, so the shards carry uneven valid
    populations: padding rows stay rejected on every shard."""
    pending = make_pods(512, "asym")
    pk = SnapshotPacker()
    for p in pending:
        pk.intern_pod(p)
    tables = (nodes_to_device(pk.pack_nodes(make_nodes(137, zones=4), [])),
              pods_to_device(pk.pack_pods(pending)),
              selectors_to_device(pk.pack_selector_tables()))
    want, got, flat = _solve_both(tables, d, per_node_cap=4)
    assert got == want == flat
    assert all(a < 137 for a in want[0][: len(pending)])


# ---------------------------------------------------------------------------
# The scheduler on the mesh: the sparse routes' per-shard pick, gangs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_restricted_primary_placement_parity_across_mesh(d):
    """The cold (partitioned) and steady (restricted) cycles on a live
    mesh: the per-shard candidate pick reproduces the reference's at the
    same width, and both equal the single-device placements."""
    def drive(pkg, mesh):
        s = _sched(pkg, mesh, incremental=pkg.config.IncrementalConfig(
            enabled=True, primary=True, candidate_bucket=8))
        for i in range(64):
            s.on_node_add(pkg.testing.make_node(
                f"node-{i}", cpu_milli=(4000 if i % 2 else 8000), pods=32,
                zone=f"z{i % 4}"))
        out = []
        for c in range(2):
            for i in range(4):
                s.on_pod_add(pkg.testing.make_pod(f"c{c}-{i}",
                                                  cpu_milli=300 + 100 * i))
            r = s.schedule_cycle()
            out.append((r.solve_scope, r.assignments, r.rounds,
                        r.snapshot_mode, r.solver_tier,
                        s.obs.recorder.records()[-1].mesh))
        return out

    got = both(lambda pkg: drive(pkg, d))
    assert [r[0] for r in got] == ["partitioned", "restricted"]
    assert [r[5] for r in got] == [d, d]
    flat = drive(PORT, None)
    assert [r[1] for r in got] == [r[1] for r in flat]


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_sharded_bit_parity_gang_driver(d):
    """Gang (all-or-nothing) rollback and the usage rebuild after it run
    against the sharded table."""
    def script(pkg):
        def drive(mesh):
            s = _sched(pkg, mesh)
            for i in range(8):
                s.on_node_add(pkg.testing.make_node(f"node-{i}",
                                                    cpu_milli=8000, pods=32))
            ok = pkg.cluster.make_gang_pods(2, 4, name_prefix="g")
            big = pkg.cluster.make_gang_pods(1, 8, name_prefix="huge")
            for p in big:
                p.requests = dataclasses.replace(p.requests,
                                                 cpu_milli=40000)
            for p in ok + big:
                s.on_pod_add(p)
            r = s.schedule_cycle()
            return r.assignments, r.scheduled, r.unschedulable, r.rounds

        off, on = drive(None), drive(d)
        assert off == on
        return on

    got = both(script)
    assert got[1] == got[2] == 8


# ---------------------------------------------------------------------------
# The resident table on the mesh: delta scatter == full rebuild, placement
# kept, a mesh change invalidates, the bucket pads to the mesh
# ---------------------------------------------------------------------------


def _churned(pkg, mesh):
    c = pkg.cache.SchedulerCache(**pkg.cache_kw)
    c.set_mesh(mesh)
    for i in range(64):
        c.add_node(pkg.testing.make_node(f"n{i}"))
    _, dev0, mode0 = c.device_snapshot()
    c.update_node(pkg.testing.make_node("n3", cpu_milli=1234))
    c.assume_pod(pkg.testing.make_pod("a", cpu_milli=100), "n7")
    c.add_pod(pkg.testing.make_pod("b", cpu_milli=50, node_name="n9"))
    _, dev_delta, mode1 = c.device_snapshot()
    c2 = pkg.cache.SchedulerCache(**pkg.cache_kw)
    c2.set_mesh(mesh)
    for i in range(64):
        c2.add_node(pkg.testing.make_node(
            f"n{i}", cpu_milli=(1234 if i == 3 else 32000)))
    c2.assume_pod(pkg.testing.make_pod("a", cpu_milli=100), "n7")
    c2.add_pod(pkg.testing.make_pod("b", cpu_milli=50, node_name="n9"))
    _, dev_full, _ = c2.device_snapshot()
    return c, dev_delta, dev_full, (mode0, mode1)


@pytest.mark.parametrize("d", [2, 8])
def test_sharded_delta_scatter_matches_full_rebuild(d):
    def script(pkg):
        c, dv, df, modes = _churned(pkg, pkg.mesh_of(d))
        same = {f: bool(np.array_equal(np.asarray(a), np.asarray(b)))
                for f, a, b in zip(type(dv)._fields, dv, df)}
        # the scatter keeps the node-axis placement (a silent fallback to
        # one device would still be bit-correct)
        return modes, same, pkg.width(c, dv)

    modes, same, width = both(script)
    assert modes == ("full", "delta") and all(same.values()) and width == d
    # the port's delta table holds the reference's values
    _, jdv, _, _ = _churned(REF, REF.mesh_of(d))
    c, tdv, _, _ = _churned(PORT, PORT.mesh_of(d))
    for f in type(jdv)._fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(tdv, f)).astype(np.float64),
            np.asarray(getattr(jdv, f)).astype(np.float64), err_msg=f)
    assert [b.shape[0] for b in tmesh.shards(tdv.allocatable,
                                             c.resident_mesh)] == \
        [64 // d] * d


def test_set_mesh_change_invalidates_resident():
    def script(pkg):
        c = pkg.cache.SchedulerCache(**pkg.cache_kw)
        c.set_mesh(pkg.mesh_of(4))
        c.add_node(pkg.testing.make_node("n0"))
        modes = [c.device_snapshot()[2], c.device_snapshot()[2]]
        c.set_mesh(pkg.mesh_of(2))  # drops the resident table
        _, dev, mode = c.device_snapshot()
        return modes + [mode], pkg.width(c, dev)

    assert both(script) == (["full", "clean", "full"], 2)


def test_tiny_cluster_pads_node_bucket_to_mesh():
    def script(pkg):
        c = pkg.cache.SchedulerCache(**pkg.cache_kw)
        c.set_mesh(pkg.mesh_of(8))
        c.add_node(pkg.testing.make_node("only"))
        _, dev, _ = c.device_snapshot()
        return int(dev.allocatable.shape[0]), pkg.width(c, dev)

    assert both(script) == (8, 8)


# ---------------------------------------------------------------------------
# The scheduler end to end on the mesh: steady state, provenance, warmup,
# the ladder's rung, device loss, takeover reconcile
# ---------------------------------------------------------------------------


def _steady(pkg, mesh):
    s = _sched(pkg, mesh)
    for i in range(32):
        s.on_node_add(pkg.testing.make_node(f"node-{i}", cpu_milli=8000,
                                            pods=32))
    out = []
    for c in range(3):
        for i in range(4):
            s.on_pod_add(pkg.testing.make_pod(f"p{c}-{i}", cpu_milli=100))
        r = s.schedule_cycle()
        rec = s.obs.recorder.records()[-1]
        out.append((r.assignments, r.scheduled, r.rounds, r.snapshot_mode,
                    r.solver_tier, r.solve_scope, rec.mesh,
                    rec.batch_shape))
    return out, s.metrics.mesh_devices.value(), \
        s.obs.jax.retrace_total("solve")


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_scheduler_mesh_steady_state_and_provenance(d):
    on, gauge, retraces = both(lambda pkg: _steady(pkg, d))
    off, gauge_off, _ = both(lambda pkg: _steady(pkg, None))
    assert [r[0] for r in on] == [r[0] for r in off]
    assert [r[3] for r in on] == ["full", "delta", "delta"]
    assert gauge == d and gauge_off == 0 and retraces == 0
    assert all(r[6] == d and r[7].endswith(f"+mesh{d}") for r in on)
    assert all(r[6] == 0 and "+mesh" not in r[7] for r in off)


def test_scheduler_mesh_warmup_registers_sharded_shapes():
    def warm(pkg, mesh):
        s = _sched(pkg, mesh, warmup=pkg.config.WarmupConfig(
            enabled=True, pod_buckets=(8,)))
        for i in range(16):
            s.on_node_add(pkg.testing.make_node(f"node-{i}"))
        device_loop.KEYS.clear()
        n = s.warmup(sample_pods=[pkg.testing.make_pod("w", cpu_milli=10)])
        return s, n, set(device_loop.KEYS)

    def script(pkg):
        s, n, warmed = warm(pkg, 8)
        device_loop.KEYS.clear()
        s.on_pod_add(pkg.testing.make_pod("real", cpu_milli=10))
        res = s.schedule_cycle()
        if pkg is PORT:
            # every round-loop key the cycle presents was warmed: on the
            # card the cycle captures nothing. The partitioned round is
            # another program than the mesh-off one, so its keys carry
            # the shard count and share none with a mesh-off scheduler's
            assert device_loop.KEYS and device_loop.KEYS <= warmed
            assert all(k[2][:2] == ("sharded", 8) for k in warmed)
            assert not warm(pkg, None)[2] & warmed
        return n, res.scheduled, s.obs.jax.retrace_total("solve")

    assert both(script) == (1, 1, 0)


def _ladder(pkg, mesh, cfg=None, sites=None):
    """One cycle with ``solve:batch`` losing its device: the ladder's
    answer, the flight record and the fallback counts."""
    fi = pkg.faults.FaultInjector(seed=0).arm("solve:batch", "device_lost")
    if cfg is not None:
        s = pkg.scheduler.Scheduler.from_config(
            pkg.cli.decode_config(cfg), clock=FakeClock(),
            enable_preemption=False, fault_injector=fi, **pkg.kw)
    else:
        s = _sched(pkg, mesh, fault_injector=fi)
    s.on_node_add(pkg.testing.make_node("n0"))
    s.on_pod_add(pkg.testing.make_pod("p0"))
    res = s.schedule_cycle()
    rec = s.obs.recorder.records()[-1]
    return (res.scheduled, res.solver_tier, res.solver_fallbacks,
            dict(s.metrics.solver_fallbacks._values),
            s.metrics.mesh_devices.value(), rec.mesh, rec.batch_shape)


@pytest.mark.parametrize("d", [2, 8])
def test_mesh_ladder_single_device_rung(d):
    """A lost device at the sharded solve: the ladder demotes sharded ->
    batch-single (one device of the mesh) before batch-cpu and greedy,
    and the cycle still binds."""
    got = both(lambda pkg: _ladder(pkg, d))
    assert got[:3] == (1, "batch-single", 1)
    # mesh off: no rung, the chain is batch -> batch-cpu
    off = both(lambda pkg: _ladder(pkg, None))
    assert off[1] != "batch-single"


def test_mesh_one_gives_the_references_gauge_provenance_and_tiers():
    """``parallel.mesh: 1`` through ``from_config`` builds a 1-device mesh
    as the reference's does: the gauge reads 1, the flight record's mesh
    is 1, the batch shape carries ``+mesh1`` and the ladder has the
    ``batch-single`` rung (a setting that was accepted and then dropped
    is a fault)."""
    got = both(lambda pkg: _ladder(pkg, None,
                                   cfg={"parallel": {"mesh": 1}}))
    assert got[:3] == (1, "batch-single", 1)
    assert got[4:6] == (1, 1) and got[6].endswith("+mesh1")
    assert got[3] == {("batch", "batch-single"): 1.0}


class _KernelFaultOnTheRung(tfaults.FaultInjector):
    """The sharded solve (at ``lost_site``) loses its device; the
    batch-single rung then hits a broken kernel."""

    def __init__(self, lost_site):
        super().__init__(seed=0)
        self.lost_site = lost_site
        self.sites = []

    def solver_hook(self, site, assigned, usage, rounds, n_nodes):
        self.sites.append(site)
        if site == self.lost_site:
            raise tfaults.DeviceLost("injected device loss")
        raise KernelError("injected kernel fault")


@pytest.mark.parametrize("solver", ["batch", "sinkhorn"])
def test_kernel_error_escapes_the_batch_single_rung(solver):
    """The rung catches what the ladder catches (solver faults, runtime
    errors) and nothing more: a KernelError on it leaves the cycle
    instead of falling through to batch-cpu's plain PyTorch."""
    fi = _KernelFaultOnTheRung(f"solve:{solver}")
    s = _sched(PORT, 4, fault_injector=fi, solver=solver)
    s.on_node_add(ttesting.make_node("n0"))
    s.on_pod_add(ttesting.make_pod("p0"))
    with pytest.raises(KernelError, match="injected kernel fault"):
        s.schedule_cycle()
    # the configured tier (and its retry) lost the device, the rung ran
    # and raised; batch-cpu was never reached
    assert set(fi.sites[:-1]) == {f"solve:{solver}"}
    assert fi.sites[-1] == "solve:batch-single"
    assert dict(s.metrics.solver_fallbacks._values) == {
        (solver, "batch-single"): 1.0}


def test_mesh_device_loss_cooloff_demotes_then_heals_sharded():
    """A lost shard at the snapshot seam exhausts the rebuild budget:
    single-device host mode for the cooloff, then the resident table
    re-placed onto the mesh. The flight record's mesh is per cycle."""
    def script(pkg):
        fi = pkg.faults.FaultInjector(seed=0).arm("snapshot:device",
                                                  "device_lost", count=2)
        clk = FakeClock()
        s = _sched(pkg, 8, clock=clk, fault_injector=fi,
                   recovery=pkg.config.RecoveryConfig(
                       device_reset_limit=1, device_cooloff_s=5.0))
        s.on_node_add(pkg.testing.make_node("n0", cpu_milli=64000,
                                            pods=200))
        out = []
        for i in range(3):
            s.on_pod_add(pkg.testing.make_pod(f"q{i}", cpu_milli=10))
            res = s.schedule_cycle()
            rec = s.obs.recorder.records()[-1]
            out.append((res.scheduled, res.snapshot_mode, rec.mesh,
                        rec.batch_shape))
            clk.advance(6)
        _, dev, _ = s.cache.device_snapshot()
        return out, s.metrics.recovery_device_resets.value(), \
            pkg.width(s.cache, dev)

    out, resets, width = both(script)
    assert [r[1] for r in out] == ["host", "full", "full"]
    assert [r[2] for r in out] == [0, 8, 8]
    assert resets == 2 and width == 8


def test_reconcile_replaces_resident_onto_mesh():
    def script(pkg):
        s = _sched(pkg, 4)
        s.on_node_add(pkg.testing.make_node("n0"))
        s.on_pod_add(pkg.testing.make_pod("p0"))
        s.schedule_cycle()
        s.reconcile([])
        s.on_pod_add(pkg.testing.make_pod("p1"))
        res = s.schedule_cycle()
        _, dev, _ = s.cache.device_snapshot()
        return res.snapshot_mode, res.assignments, pkg.width(s.cache, dev)

    assert both(script)[::2] == ("full", 4)


@pytest.mark.parametrize("d", [2, 8])
def test_memory_preflight_keys_buckets_by_mesh_width(d):
    """The capacity preflight judges a cycle at its (P, N, mesh): a mesh
    cycle reads the bucket measured at its width (over budget here: the
    batch sheds), where the single-device entry of the same (P, N) fits;
    a mesh-off scheduler with the same table reads that one and binds."""
    def script(pkg):
        out = []
        for mesh in (d, None):
            s = _sched(pkg, mesh)
            ml = s.obs.memledger
            ml.record_bucket_memory(8, 8, d, {"total_bytes": 1 << 30})
            ml.record_bucket_memory(8, 8, 0, {"total_bytes": 1 << 10})
            ml.config.limit_bytes = 1 << 20
            s.on_node_add(pkg.testing.make_node("n0"))
            s.on_pod_add(pkg.testing.make_pod("p0"))
            r = s.schedule_cycle()
            # a shed cycle attempts nothing and leaves no flight record
            recs = s.obs.recorder.records()
            out.append((r.scheduled, r.attempted, dict(ml.preflights),
                        ml._last_preflight["mesh"],
                        recs[-1].mesh if recs else None))
        return out

    on, off = both(script)
    assert on == (0, 0, {"ok": 0, "split": 0, "shed": 1}, d, None)
    assert off == (1, 1, {"ok": 1, "split": 0, "shed": 0}, 0, 0)
