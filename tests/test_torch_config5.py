"""The reference bench's BASELINE config 5 (``bench.py:1190-1206``: 50,000
nodes over 10 zones, batches of 4096, per-node cap 8, the node axis on
``make_mesh()``) past the pair's staged width, the port against the JAX
package. At 9000 nodes the node bucket is 16,384 columns, past
``STAGED_MAX_N = 12288``, so on a card the general round's pair takes
the wide route (``chip_smoke.py`` phase ``config5`` drives the full 50,000
nodes there); on the CPU both packages run their plain versions, the
reference's pair in Pallas interpret mode.

Placements, rounds, FitError messages and reasons are bit-exact. The plan
is exp/log math summed in another order: ``atol=1e-5, rtol=1e-4``, the
tolerance of ``tests/test_torch_sinkhorn.py``."""

import json
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.cli as jcli
import kubernetes_tpu.models.cluster as jcluster
import kubernetes_tpu.ops.fused_score as jfs
import kubernetes_tpu.ops.sinkhorn as js
import kubernetes_tpu.scheduler as jscheduler
import kubernetes_tpu.testing as jtesting
import kubernetes_tpu_torch.cli as tcli
import kubernetes_tpu_torch.models.cluster as tcluster
import kubernetes_tpu_torch.ops.fused_score as tfs
import kubernetes_tpu_torch.ops.sinkhorn as ts
import kubernetes_tpu_torch.scheduler as tscheduler
import kubernetes_tpu_torch.testing as ttesting
from kubernetes_tpu_torch.utils.interner import bucket_size

ATOL, RTOL = 1e-5, 1e-4

N_NODES = 9000
SOFT_TAINT = "DeletionCandidateOfClusterAutoscaler"
ZONE = "failure-domain.beta.kubernetes.io/zone"


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _nodes(cluster, testing):
    """``make_nodes(9000, zones=10)``, every 10th node tainted
    ``PreferNoSchedule`` (the chip cell's soft taint)."""
    taint = testing.Taint(SOFT_TAINT, "true", "PreferNoSchedule")
    nodes = cluster.make_nodes(N_NODES, zones=10)
    for nd in nodes[::10]:
        nd.taints = (taint,)
    return nodes


def _pending(cluster, testing):
    """64 pods preferring a seeded zone (weight 50, half tolerating the
    taint), 64 of the bench's base pods and one pod no node can hold."""
    rng = random.Random(7)
    tol = (testing.Toleration(key=SOFT_TAINT, operator="Exists",
                              effect="PreferNoSchedule"),)
    zoned = [testing.make_pod(
        f"pod-{i}", cpu_milli=100, memory=500 * 2**20,
        affinity=testing.node_affinity_preferred(
            (50, [testing.req(ZONE, "In", f"zone-{rng.randrange(10)}")])),
        tolerations=tol if i % 2 else ()) for i in range(64)]
    unfit = testing.make_pod("too-big", cpu_milli=8000, memory=2**30)
    return zoned + cluster.make_pods(64, "bench") + [unfit]


def _contended(cluster, testing):
    """The chip cell's contended cycle: 24 pods preferring ``node-1`` by
    hostname (room for all of them, but cap 8 a round) beside 40 base
    pods."""
    hot = [testing.make_pod(
        f"c5hot-{i}", cpu_milli=100, memory=500 * 2**20,
        affinity=testing.node_affinity_preferred(
            (50, [testing.req("kubernetes.io/hostname", "In", "node-1")])))
        for i in range(24)]
    return hot + cluster.make_pods(40, "c5fill")


def _run(pkg, tmp_path, mesh, pending=_pending, cycles=3, **kw):
    cluster, testing, cli, scheduler = pkg
    doc = {"apiVersion": "kubescheduler.config.k8s.io/v1alpha1",
           "kind": "KubeSchedulerConfiguration",
           "percentageOfNodesToScore": 100, "perNodeCap": 8,
           "maxBatch": 4096}
    if mesh is not None:
        doc["parallel"] = {"mesh": mesh}
    path = tmp_path / (f"config5-{pkg[0].__name__}-{mesh}-"
                       f"{pending.__name__}.json")
    path.write_text(json.dumps(doc))
    sched = scheduler.Scheduler.from_config(
        cli.load_config_file(str(path)), clock=FakeClock(),
        enable_preemption=False, **kw)
    for nd in _nodes(cluster, testing):
        sched.on_node_add(nd)
    for p in pending(cluster, testing):
        sched.on_pod_add(p)
    out = []
    for _ in range(cycles):
        r = sched.schedule_cycle()
        out.append((r.attempted, r.scheduled, r.rounds, r.assignments,
                    r.fit_errors, r.failure_reasons))
    return out


REF = (jcluster, jtesting, jcli, jscheduler)
PORT = (tcluster, ttesting, tcli, tscheduler)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    # the reference at mesh: auto (the suite's 8 virtual CPU devices)
    return _run(REF, tmp_path_factory.mktemp("ref"), "auto")


@pytest.mark.parametrize("mesh", ["auto", None])
def test_config5_past_the_staged_width_matches_the_reference(
        mesh, reference_run, tmp_path):
    assert bucket_size(N_NODES) == 16384 > tfs.STAGED_MAX_N
    got = _run(PORT, tmp_path, mesh, device="cpu")
    assert got == reference_run
    # every pod that fits binds; the one that does not fails with a
    # reason on every node
    assert sum(c[1] for c in got) == 128
    assert list(got[0][4]) == ["default/too-big"]


def test_contended_cycle_past_the_staged_width_matches_the_reference(
        tmp_path):
    # the chip cell's multi-round cycle: cap 8 admits 8 of the 24 pods
    # preferring node-1 a round, so 3 rounds, all 24 on node-1, as the
    # reference places them
    want = _run(REF, tmp_path, "auto", _contended, cycles=1)
    got = _run(PORT, tmp_path, "auto", _contended, cycles=1, device="cpu")
    assert got == want
    attempted, scheduled, rounds, assignments = got[0][:4]
    assert (attempted, scheduled, rounds) == (64, 64, 3)
    assert [assignments[f"default/c5hot-{i}"] for i in range(24)] == \
        ["node-1"] * 24


def _pair_inputs(P, N, seed):
    g = np.random.default_rng(seed)
    rf = (g.integers(0, 4, (P, N)) * 50).astype(np.float32)
    rr = g.integers(0, 2, (P, N)).astype(np.float32)
    mask = g.uniform(size=(P, N)) > 0.1
    mask[0] = False  # an all-infeasible row: both maxima 0
    return rf, rr, mask


def test_pair_past_the_staged_width_is_the_pallas_pair():
    rf, rr, mask = _pair_inputs(16, 16384, 3)
    want = np.asarray(jfs._pair_pallas(
        jnp.asarray(rf), jnp.asarray(rr), jnp.asarray(mask), 1.0, 2.0,
        interpret=True))
    got = tfs.fused_pair_normalize(torch.tensor(rf), torch.tensor(rr),
                                   torch.tensor(mask), 1.0, 2.0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_plan_past_the_staged_width_matches_the_reference():
    g = np.random.default_rng(5)
    score = g.uniform(0, 10, (16, 16384)).astype(np.float32)
    mask = g.uniform(size=(16, 16384)) > 0.3
    mask[5] = False  # a pod that fits nowhere
    cap = g.integers(0, 5, 16384).astype(np.float32)
    want = js.sinkhorn_plan(jnp.asarray(score), jnp.asarray(mask),
                            jnp.asarray(cap), iters=25, pallas=True,
                            interpret=True)
    got = ts.sinkhorn_plan(torch.tensor(score), torch.tensor(mask),
                           torch.tensor(cap), iters=25, pallas=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


class _Aligned:
    """A stand-in tensor: only its address matters to the route."""

    def __init__(self, ptr=0):
        self.ptr = ptr

    def data_ptr(self):
        return self.ptr


@pytest.mark.parametrize("n,staged", [(65536, False), (12304, False),
                                      (12288, True), (8192, True)])
def test_staged_route_ends_at_the_staged_limit(n, staged):
    assert tfs.staged_route(n, _Aligned(), _Aligned(1 << 20)) is staged
    # a misaligned operand never takes the staged route
    assert not tfs.staged_route(n, _Aligned(), _Aligned(8))


#: clusters of 1-16 v blocks an H100 keeps resident (``v_fit``; 132 SMs,
#: 66 clusters of 2, 15 of 8, 7 of 16; the sizes ``v_plan`` never asks
#: for left 0)
H100_FIT = (132, 66, 0, 33, 0, 0, 0, 15) + (0,) * 7 + (7,)


@pytest.mark.parametrize("P,N,plan", [
    # the config5 path: 512 strips of 128 columns are more than the card
    # holds at any cluster size, so a block a strip in waves (the plan the
    # card chose at this shape)
    (4096, 65536, (32, 512, 1, 4096)),
    (16, 16384, (32, 128, 1, 16))])
def test_the_wide_rows_pass_the_wrappers_row_rules(P, N, plan):
    # the card's wrappers read a row as 16-byte vectors: the config5
    # widths are multiples of four (the pair and u accept them), and the
    # v plan for the path's shape covers every row and column
    assert N % 4 == 0 and not tfs.staged_route(N, _Aligned(), _Aligned())
    lanes, strips, cluster, rows = ts.v_plan(P, N, H100_FIT)
    assert (lanes, strips, cluster, rows) == plan
    assert strips * 4 * lanes >= N and cluster * rows >= P


def test_chip_cells_document_is_the_benchs_config5(tmp_path):
    # chip_smoke.py's config5 cell asks both packages for the bench's
    # setting: cap 8, batches of 4096, every node scored, the node axis
    # on mesh auto (one card: a mesh of 1)
    import chip_smoke

    path = tmp_path / "config5.json"
    path.write_text(json.dumps({**chip_smoke.GV, **chip_smoke._c5_doc()}))
    cfgs = [pkg.load_config_file(str(path)) for pkg in (jcli, tcli)]
    for cfg in cfgs:
        assert (cfg.per_node_cap, cfg.max_batch,
                cfg.percentage_of_nodes_to_score) == (8, 4096, 100)
        assert cfg.parallel.mesh == "auto"
    sched = tscheduler.Scheduler.from_config(cfgs[1], device="cpu")
    assert (sched.per_node_cap, sched.max_batch, sched.mesh.size) == (
        8, 4096, 1)
    c5 = chip_smoke.CONFIG5
    assert chip_smoke.CONFIG5_SHAPE == (c5["batch"],
                                        bucket_size(c5["n_nodes"]))
