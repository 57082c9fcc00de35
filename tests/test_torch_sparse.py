"""The sparsity-first routes of the port (restricted candidate columns,
the partitioned cold solve, the resident score summary and the warm
Sinkhorn carry) held against the JAX package on the CPU.

Op level, every result is bit-identical to the reference's: the summary
(both Policy flags) and its delta patch, the tie-broken top-k (single
pass and sharded at {1, 2, 4, 8}), the candidate pick with its dirty and
hint boosts and the reserved hint split, the round-robin cold partition,
the sentinel-filled row gather and the local-to-global mapping. The
solver's warm-start plumbing (``sk_init``/``sk_tol``/``potentials_out``)
places as the reference does; potentials are held to the Sinkhorn
tolerance of tests/test_torch_sinkhorn.py (``atol=1e-5, rtol=1e-4``).
Driven on the reference suites' 96-node cluster (C = 32), the port's
``Scheduler(device="cpu")`` reproduces the JAX ``Scheduler
(pipeline_depth=1)`` cycle by cycle: bindings, rounds, snapshot modes,
solve scopes, reuse fractions and cold blocks, through churn, node
adds, under-placed fallbacks and the invalidation edges."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.ops.fused_score as jfs
import kubernetes_tpu_torch.ops.fused_score as tfs
from kubernetes_tpu.ops import arrays as jarr
from kubernetes_tpu.ops.assign import batch_assign as j_batch_assign
from kubernetes_tpu.ops.sinkhorn import sinkhorn_plan as j_plan
from kubernetes_tpu.testing import make_node, make_pod
from kubernetes_tpu_torch import scheduler as tsched
from kubernetes_tpu_torch.kernels import KernelError
from kubernetes_tpu_torch.ops import arrays as tarr
from kubernetes_tpu_torch.ops.assign import batch_assign as t_batch_assign
from kubernetes_tpu_torch.ops.sinkhorn import sinkhorn_plan as t_plan
from torch_parity import (
    drive_pair,
    incremental_cluster,
    incremental_pair,
    jax_tables,
    port_table,
    port_tables,
    to_port,
)

ATOL, RTOL = 1e-5, 1e-4


def _same(t, j):
    """Bit-identical values, shape and kind."""
    a, b = t.numpy(), np.asarray(j)
    assert a.shape == b.shape and a.dtype.kind == b.dtype.kind
    assert np.array_equal(a, b), (a, b)


def _summaries(rank, eligible):
    """The same NodeSummary for both packages."""
    rank = np.where(eligible, np.asarray(rank, np.float32),
                    np.float32(jfs._NEG)).astype(np.float32)
    eligible = np.asarray(eligible, bool)
    return (jfs.NodeSummary(eligible=jnp.asarray(eligible),
                            rank=jnp.asarray(rank)),
            tfs.NodeSummary(eligible=torch.tensor(eligible),
                            rank=torch.tensor(rank)))


def _varied_cluster(seed=3, n=40):
    """Nodes with mixed capacity, conditions and usage (pressured, not
    ready, cordoned, full pod slots), JAX-typed."""
    rng = random.Random(seed)
    nodes, bound = [], []
    for i in range(n):
        nd = make_node(f"n{i}", cpu_milli=rng.choice([2000, 4000, 8000]),
                       memory=rng.choice([4, 8, 16]) * 2**30,
                       pods=rng.choice([2, 5, 110]))
        k = i % 7
        if k == 1:
            nd.conditions.memory_pressure = True
        elif k == 2:
            nd.conditions.ready = False
        elif k == 3:
            nd.unschedulable = True
        nodes.append(nd)
        for j in range(rng.randrange(0, 3)):
            bound.append(make_pod(f"b{i}-{j}", node_name=nd.name,
                                  cpu_milli=rng.choice([0, 500, 1500]),
                                  memory=rng.choice([0, 2**30, 2**31])))
    return nodes, bound


# ---------------------------------------------------------------------------
# the score summary
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("honor, packed", [(True, False), (False, False),
                                           (True, True), (False, True)])
def test_node_summary_matches(honor, packed):
    nodes, bound = _varied_cluster()
    dn = jax_tables(nodes, bound, [])[0]
    want = jfs.node_summary(dn, honor_conditions=honor, prefer_packed=packed)
    got = tfs.node_summary(port_table(dn), honor_conditions=honor,
                           prefer_packed=packed)
    _same(got.eligible, want.eligible)
    _same(got.rank, want.rank)
    assert bool(np.asarray(want.eligible).any())
    assert not bool(np.asarray(want.eligible).all())


def test_summary_patch_equals_full_rebuild():
    """Patching changed rows into the resident summary equals a rebuild
    bit for bit, and the port's patch equals the reference's."""
    nodes, bound = _varied_cluster(seed=4)
    dn0 = jax_tables(nodes, bound, [])[0]
    more = [make_pod(f"m{i}", node_name=nodes[i].name, cpu_milli=700,
                     memory=2**30) for i in range(0, 40, 3)]
    dn1 = jax_tables(nodes, bound + more, [])[0]
    idx = np.asarray(list(range(0, 40, 3)) + [dn1.valid.shape[0]] * 3,
                     np.int32)  # three padding slots drop
    jsub = jfs.node_summary(jarr.gather_node_rows(dn1, jnp.asarray(idx)))
    want = jfs.patch_node_summary(jfs.node_summary(dn0), jsub, idx)
    t1 = port_table(dn1)
    tsub = tfs.node_summary(tarr.gather_node_rows(t1, torch.tensor(idx)))
    got = tfs.patch_node_summary(tfs.node_summary(port_table(dn0)), tsub,
                                 idx)
    rebuilt = tfs.node_summary(t1)
    for f in ("eligible", "rank"):
        _same(getattr(got, f), getattr(want, f))
        assert torch.equal(getattr(got, f), getattr(rebuilt, f))


# ---------------------------------------------------------------------------
# the top-k and the candidate pick
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharded_topk_bit_identical_on_tie_heavy_planes(seed, shards):
    rng = np.random.default_rng(seed)
    n, k = 256, 24
    score = rng.choice(np.linspace(0.0, 1.0, 7), size=n).astype(np.float32)
    want_v, want_i = jfs._sharded_topk(jnp.asarray(score), k, 1)
    got_v, got_i = tfs._sharded_topk(torch.tensor(score), k, shards)
    _same(got_v, want_v)
    _same(got_i, want_i)


@pytest.mark.parametrize("n, k, shards", [(100, 10, 3), (100, 60, 2),
                                          (96, 96, 4), (7, 3, 8)])
def test_sharded_topk_uneven_shapes(n, k, shards):
    rng = np.random.default_rng(n + k)
    score = rng.choice([0.0, 0.5, 1.0], size=n).astype(np.float32)
    want_v, want_i = jfs._sharded_topk(jnp.asarray(score), k, shards)
    got_v, got_i = tfs._sharded_topk(torch.tensor(score), k, shards)
    _same(got_v, want_v)
    _same(got_i, want_i)


@pytest.mark.parametrize("variant", ["plain", "hint", "quota"])
@pytest.mark.parametrize("seed", [0, 1])
def test_candidate_columns_match_on_every_shard_count(seed, variant):
    rng = np.random.default_rng(100 + seed)
    n, k = 128, 16
    js_, ts_ = _summaries(rng.choice(np.linspace(0, 1, 5), size=n),
                          rng.random(n) > 0.2)
    dirty = rng.random(n) > 0.9
    hint = rng.random(n) > 0.8
    kw_j, kw_t = {}, {}
    if variant != "plain":
        kw_j["hint_mask"] = jnp.asarray(hint)
        kw_t["hint_mask"] = torch.tensor(hint)
    if variant == "quota":
        kw_j["hint_quota"] = kw_t["hint_quota"] = 4
    want = jfs.candidate_columns(js_, jnp.asarray(dirty), k, **kw_j)
    for shards in (1, 2, 4, 8):
        got = tfs.candidate_columns(ts_, torch.tensor(dirty), k,
                                    num_shards=shards, **kw_t)
        _same(got, want)


def test_candidate_columns_dirty_survives_the_cut():
    n, k = 64, 4
    rank = np.linspace(1.0, 0.0, n)  # column 63 ranks last
    _js, ts_ = _summaries(rank, np.ones(n, bool))
    dirty = torch.zeros(n, dtype=torch.bool)
    dirty[63] = True
    assert 63 in tfs.candidate_columns(ts_, dirty, k).tolist()
    # a dirty INELIGIBLE column stays out, as a sentinel-free pick shows
    _js, ts2 = _summaries(rank, np.arange(n) != 63)
    assert 63 not in tfs.candidate_columns(ts2, dirty, k).tolist()


def test_candidate_columns_hint_quota_is_reserved_and_disjoint():
    n, k, hq = 64, 8, 4
    rank = np.linspace(1.0, 0.0, n)
    js_, ts_ = _summaries(rank, np.ones(n, bool))
    zeros = torch.zeros(n, dtype=torch.bool)
    hint = np.zeros(n, bool)
    hint[40:60] = True  # low-ranked hinted columns
    got = tfs.candidate_columns(ts_, zeros, k, hint_mask=torch.tensor(hint),
                                hint_quota=hq).tolist()
    assert got == [40, 41, 42, 43, 0, 1, 2, 3]
    # a hint set smaller than the quota pads its slots with the sentinel
    tiny = np.zeros(n, bool)
    tiny[50] = True
    got = tfs.candidate_columns(ts_, zeros, k, hint_mask=torch.tensor(tiny),
                                hint_quota=hq)
    assert got.tolist() == [50, n, n, n, 0, 1, 2, 3]
    _same(got, jfs.candidate_columns(js_, jnp.zeros(n, bool), k,
                                     hint_mask=jnp.asarray(tiny),
                                     hint_quota=hq))


@pytest.mark.parametrize("eligible_cols", [64, 3])
def test_partition_columns_round_robin_and_disjoint(eligible_cols):
    n, B, C = 64, 4, 8
    rank = np.linspace(1.0, 0.0, n)
    js_, ts_ = _summaries(rank, np.arange(n) < eligible_cols)
    got = tfs.partition_columns(ts_, torch.zeros(n, dtype=torch.bool), B, C)
    _same(got, jfs.partition_columns(js_, jnp.zeros(n, bool), B, C))
    assert tuple(got.shape) == (B, C)
    if eligible_cols == n:
        assert len(set(got.reshape(-1).tolist())) == B * C
        for b in range(B):
            assert got[b].tolist() == list(range(b, B * C, B))
    else:
        assert sorted(set(got.reshape(-1).tolist())) == [0, 1, 2, n]


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_partition_columns_match_sharded(shards):
    rng = np.random.default_rng(7)
    n = 128
    js_, ts_ = _summaries(rng.choice(np.linspace(0, 1, 5), size=n),
                          rng.random(n) > 0.3)
    dirty = rng.random(n) > 0.95
    want = jfs.partition_columns(js_, jnp.asarray(dirty), 4, 8, 1)
    _same(tfs.partition_columns(ts_, torch.tensor(dirty), 4, 8, shards),
          want)


# ---------------------------------------------------------------------------
# gathers and the mapping
# ---------------------------------------------------------------------------


def test_gather_node_rows_fills_sentinel_rows_with_zeros():
    nodes, bound = _varied_cluster(seed=5, n=24)
    dn = jax_tables(nodes, bound, [])[0]
    n = dn.valid.shape[0]
    idx = np.asarray([3, n, 0, 17, n, 23, 5, n], np.int32)
    want = jarr.gather_node_rows(dn, jnp.asarray(idx))
    got = tarr.gather_node_rows(port_table(dn), torch.tensor(idx))
    for f in type(got)._fields:
        _same(getattr(got, f), getattr(want, f))
    assert got.valid.tolist() == [True, False, True, True, False, True,
                                  True, False]


def test_map_restricted_assignment():
    cand = np.asarray([9, 4, 130, 2], np.int32)
    local = np.asarray([0, -1, 3, 2, 1, -1, 7], np.int32)  # 7 clips
    want = jarr.map_restricted_assignment(jnp.asarray(local),
                                          jnp.asarray(cand))
    got = tarr.map_restricted_assignment(torch.tensor(local),
                                         torch.tensor(cand))
    _same(got, want)


# ---------------------------------------------------------------------------
# the solver's warm start
# ---------------------------------------------------------------------------


def _plan_problem():
    rng = np.random.RandomState(0)
    score = rng.rand(12, 20).astype(np.float32)
    mask = rng.rand(12, 20) > 0.2
    cap = np.full((20,), 2.0, np.float32)
    return score, mask, cap


def test_sinkhorn_warm_start_early_exit_and_parity():
    score, mask, cap = _plan_problem()
    args_t = (torch.tensor(score), torch.tensor(mask), torch.tensor(cap))
    cold, cold_st, cold_pot = t_plan(*args_t, iters=60, with_stats=True,
                                     tol=1e-6, return_potentials=True)
    warm, warm_st, _ = t_plan(*args_t, iters=60, with_stats=True, tol=1e-6,
                              init=cold_pot, return_potentials=True)
    assert float(warm_st[0]) <= 2.0
    assert float(warm_st[0]) < float(cold_st[0])
    np.testing.assert_allclose(warm.numpy(), cold.numpy(), atol=1e-4)
    args_j = tuple(jnp.asarray(a) for a in (score, mask, cap))
    want, want_st, _ = j_plan(*args_j, iters=60, with_stats=True, tol=1e-6,
                              return_potentials=True)
    np.testing.assert_allclose(cold.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    assert abs(float(cold_st[0]) - float(want_st[0])) <= 1


def _solver_tables(n_pods=6, n_nodes=8):
    pods = [make_pod(f"p{i}", cpu_milli=100, memory=2**20)
            for i in range(n_pods)]
    nodes = [make_node(f"n{i}", cpu_milli=4000, memory=2**30)
             for i in range(n_nodes)]
    dn, dp, ds, _dv, _nt, _pt, _pk = jax_tables(nodes, [], pods)
    return (dn, dp, ds), port_tables(dn, dp, ds)[:3]


@pytest.mark.parametrize("sk_tol", [1e-4, None])
def test_batch_assign_potentials_roundtrip(sk_tol):
    """potentials_out / sk_init thread through the solver as in the
    reference: the carry has the solver's shapes, re-feeding it changes
    no placement, and both packages place and carry alike."""
    (jdn, jdp, jds), (tdn, tdp, tds) = _solver_tables()
    kw = dict(use_sinkhorn=True, sk_tol=sk_tol, potentials_out=True,
              stats_out=True)
    a1, _u, r1, st1, pot = t_batch_assign(tdp, tdn, tds, **kw)
    assert pot[0].shape == (tdp.valid.shape[0],)
    assert pot[1].shape == (tdn.valid.shape[0],)
    ja, _ju, jr, jst, jpot = j_batch_assign(jdp, jdn, jds, **kw)
    _same(a1, ja)
    assert int(r1) == int(jr)
    for t, j in zip(pot, jpot):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   rtol=RTOL)
    assert abs(float(st1[0]) - float(np.asarray(jst)[0])) <= 1
    a2, _u2, _r2, _st2, _pot2 = t_batch_assign(tdp, tdn, tds, sk_init=pot,
                                               **kw)
    assert torch.equal(a1, a2)


def test_lean_route_returns_zero_potentials():
    (jdn, jdp, jds), (tdn, tdp, tds) = _solver_tables()
    kw = dict(auto_sinkhorn=False, no_ports=True, potentials_out=True,
              stats_out=True)
    a, _u, _r, st, (pu, pv) = t_batch_assign(tdp, tdn, tds, **kw)
    ja = j_batch_assign(jdp, jdn, jds, **kw)[0]
    _same(a, ja)
    assert st.tolist() == [-1.0, -1.0]
    assert not pu.any() and not pv.any()
    assert pv.shape == (tdn.valid.shape[0],)


# ---------------------------------------------------------------------------
# driven parity with the JAX package's scheduler
# ---------------------------------------------------------------------------


def _churn_cycles(seed, n_cycles=4):
    """Preloaded pods, then seeded micro-batches with deletes of earlier
    pending pods' bound copies and a node added mid-run."""
    rng = random.Random(seed)
    nodes = incremental_cluster()
    pre = [make_pod(f"pre-{i}", node_name=f"n{rng.randrange(96)}",
                    cpu_milli=rng.choice([500, 2000, 8000]),
                    memory=rng.choice([1, 4, 16]) * 2**30)
           for i in range(40)]
    cycles = [[("node_add", nd) for nd in nodes]
              + [("pod_add", p) for p in pre]]
    for c in range(n_cycles):
        ev = [("pod_add", make_pod(f"p{c}-{i}",
                                   cpu_milli=rng.choice([100, 250, 500]),
                                   memory=rng.choice([128, 256, 512])
                                   * 2**20))
              for i in range(rng.randrange(4, 14))]
        if c == 1:
            ev.append(("pod_delete", pre[rng.randrange(40)]))
        if c == 2:
            ev.append(("node_add", make_node("extra", cpu_milli=32000,
                                             memory=64 * 2**30, pods=500)))
        cycles[-1] += ev
        cycles.append([])
    return cycles[:-1]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("solver", ["batch", "sinkhorn"])
@pytest.mark.parametrize("primary", [False, True])
def test_driven_parity_with_the_reference(monkeypatch, primary, solver,
                                          seed):
    # dense sinkhorn cycles hold the port's kernels' rule against the
    # reference's Pallas kernels in interpret mode (the tolerance loop of
    # the warm routes is jnp-only in both, whatever this says)
    monkeypatch.setenv("KTPU_PALLAS", "1")
    js, ts = incremental_pair(solver=solver, primary=primary,
                              candidate_bucket=32)
    got = drive_pair(js, ts, _churn_cycles(seed))
    scopes = [r.solve_scope for r in got]
    cold = "partitioned" if primary else "full"
    # full snapshots (the first cycle, the node add of the third) -> the
    # cold scope; the delta cycles after each -> restricted
    assert scopes == [cold, "restricted", cold, "restricted"], scopes
    assert all(r.unschedulable == 0 for r in got)
    if primary:
        assert got[0].cold_blocks == 4


def test_under_placed_restricted_falls_back_in_the_same_cycle():
    js, ts = incremental_pair(candidate_bucket=32)
    nodes = incremental_cluster(hetero=False)
    cycles = [
        [("node_add", nd) for nd in nodes]
        + [("pod_add", make_pod(f"a{i}", cpu_milli=50)) for i in range(2)],
        [("pod_add", make_pod("giant", cpu_milli=10_000_000))]
        + [("pod_add", make_pod(f"b{i}", cpu_milli=50)) for i in range(2)],
    ]
    r = drive_pair(js, ts, cycles)[1]
    assert r.solve_scope == "full"
    assert (r.scheduled, r.unschedulable) == (2, 1)
    assert "default/giant" in r.failure_reasons


def test_partitioned_under_placed_declines_to_dense():
    js, ts = incremental_pair(candidate_bucket=32, primary=True)
    nodes = incremental_cluster(hetero=False)
    cycles = [[("node_add", nd) for nd in nodes]
              + [("pod_add", make_pod("giant", cpu_milli=10_000_000))]
              + [("pod_add", make_pod(f"a{i}", cpu_milli=50))
                 for i in range(2)]]
    r = drive_pair(js, ts, cycles)[0]
    assert (r.solve_scope, r.scheduled, r.unschedulable) == ("full", 2, 1)


@pytest.mark.parametrize("primary", [False, True])
def test_small_cluster_never_restricts(primary):
    js, ts = incremental_pair(candidate_bucket=32, primary=primary)
    nodes = incremental_cluster(n_nodes=16, hetero=False)
    cycles = [[("node_add", nd) for nd in nodes]
              + [("pod_add", make_pod(f"a{i}", cpu_milli=50))
                 for i in range(2)],
              [("pod_add", make_pod(f"b{i}", cpu_milli=50))
               for i in range(2)]]
    assert [r.solve_scope for r in drive_pair(js, ts, cycles)] == [
        "full", "full"]


def _steady(js, ts, **extra):
    """Two cycles on the uniform 96-node cluster; the second restricted."""
    nodes = incremental_cluster(hetero=False)
    got = drive_pair(js, ts, [
        [("node_add", nd) for nd in nodes]
        + [("pod_add", make_pod(f"w{i}", cpu_milli=50)) for i in range(2)],
        [("pod_add", make_pod(f"x{i}", cpu_milli=50)) for i in range(2)]])
    assert got[1].solve_scope == "restricted"
    return nodes


@pytest.mark.parametrize("edge", ["node-add", "volume-state"])
def test_full_snapshot_edges_drop_the_warm_state(edge):
    """A node add and a volume-state replacement (pack-epoch growth) both
    surface as full snapshots: the summary generation moves, the warm
    potentials drop, the cycle solves cold, and the next delta cycle is
    restricted again."""
    js, ts = incremental_pair(solver="sinkhorn", candidate_bucket=32)
    _steady(js, ts)
    assert ts._sk_warm_pot is not None
    gen0 = ts.cache.summary_generation
    ev = ([("node_add", make_node("late", cpu_milli=64000,
                                  memory=256 * 2**30, pods=500))]
          if edge == "node-add" else [("volume_state", None)])
    r = drive_pair(js, ts, [ev + [("pod_add", make_pod(f"y{i}",
                                                       cpu_milli=50))
                                  for i in range(2)]])[0]
    assert (r.snapshot_mode, r.solve_scope) == ("full", "full")
    assert ts.cache.summary_generation > gen0
    assert ts._sk_warm_pot is None and not ts.cache.has_score_summary()
    got = drive_pair(js, ts, [[("pod_add", make_pod(f"z{i}", cpu_milli=50))
                               for i in range(2)]])
    assert got[0].solve_scope == "restricted"
    # the first restricted cycle after the edge rebuilt the summary
    assert got[0].reuse_frac == 0.0


def test_dirty_frac_blowout_drops_the_summary():
    js, ts = incremental_pair(solver="sinkhorn", candidate_bucket=32,
                              max_dirty_frac=0.05)
    js.cache.max_dirty_frac = ts.cache.max_dirty_frac = 0.5
    _steady(js, ts)
    gen0 = ts.cache.summary_generation
    ev = [("node_update", make_node(f"n{i}", cpu_milli=64000,
                                    memory=256 * 2**30, pods=499))
          for i in range(10)]  # ~10% of 96 nodes dirty > 5%
    r = drive_pair(js, ts, [ev + [("pod_add", make_pod(f"y{i}",
                                                        cpu_milli=50))
                                  for i in range(2)]])[0]
    assert (r.snapshot_mode, r.solve_scope) == ("delta", "full")
    assert ts.cache.summary_generation > gen0
    assert ts._sk_warm_pot is None and not ts.cache.has_score_summary()


def test_warm_potentials_carry_while_the_key_holds():
    js, ts = incremental_pair(solver="sinkhorn", candidate_bucket=32)
    _steady(js, ts)
    key0 = ts._sk_warm_pot[0]
    r = drive_pair(js, ts, [[("pod_add", make_pod(f"c{i}", cpu_milli=50))
                             for i in range(2)]])[0]
    assert r.solve_scope == "restricted"
    assert ts._sk_warm_pot[0] == key0
    assert key0[1:] == (32, ts.cache.summary_generation)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("primary", [False, True])
def test_warm_carry_through_churn_matches_the_reference(monkeypatch, primary,
                                                         seed):
    """The warm Sinkhorn carry across restricted cycles: 10 cycles of 8
    seeded pods on the 96-node cluster (C = 32), a bound pod deleted
    every third cycle. Every cycle agrees with the reference on
    ROUTE_FIELDS, and after every restricted cycle both packages hold a
    carry under the same key (pod bucket, C, summary generation)."""
    monkeypatch.setenv("KTPU_PALLAS", "1")
    js, ts = incremental_pair(solver="sinkhorn", primary=primary,
                              candidate_bucket=32)
    rng = random.Random(seed)
    placed = []
    events = [("node_add", nd) for nd in incremental_cluster()]
    restricted = 0
    for c in range(10):
        shapes = {}
        for i in range(8):
            name = f"w{c}-{i}"
            shapes[f"default/{name}"] = (
                name, rng.choice([100, 250, 500]),
                rng.choice([128, 256, 512]) * 2**20)
            events.append(("pod_add", make_pod(
                name, cpu_milli=shapes[f"default/{name}"][1],
                memory=shapes[f"default/{name}"][2])))
        if c and c % 3 == 0 and placed:
            name, cpu, mem, node = placed.pop(rng.randrange(len(placed)))
            events.append(("pod_delete", make_pod(
                name, cpu_milli=cpu, memory=mem, node_name=node)))
        r = drive_pair(js, ts, [events])[0]
        events = []
        assert r.unschedulable == 0
        for key, node in sorted(r.assignments.items()):
            placed.append(shapes[key] + (node,))
        if r.solve_scope == "restricted":
            restricted += 1
            assert ts._sk_warm_pot is not None
            assert ts._sk_warm_pot[0] == js._sk_warm_pot[0]
            assert ts._sk_warm_pot[0][1:] == (32,
                                              ts.cache.summary_generation)
    assert restricted >= 5


@pytest.mark.parametrize("exc, declines", [(KernelError, False),
                                           (RuntimeError, True)])
def test_route_decline_never_swallows_a_kernel_fault(monkeypatch, exc,
                                                     declines):
    """A solver fault (RuntimeError) inside the restricted solve declines
    to the dense ladder in the same cycle; a kernel fault (KernelError) is
    not a solver fault and stops the cycle."""
    js, ts = incremental_pair(candidate_bucket=32)
    _steady(js, ts)
    real = tsched.batch_assign

    def faulty(*args, **kw):
        if kw.get("no_spread") and args[1].valid.shape[0] == 32:
            raise exc("injected")
        return real(*args, **kw)

    monkeypatch.setattr(tsched, "batch_assign", faulty)
    for i in range(2):
        ts.on_pod_add(_port_pod(f"f{i}"))
    if declines:
        r = ts.schedule_cycle()
        assert (r.solve_scope, r.scheduled) == ("full", 2)
    else:
        with pytest.raises(KernelError):
            ts.schedule_cycle()


def _port_pod(name):
    return to_port(make_pod(name, cpu_milli=50))


def test_tuner_pinned_without_a_warmed_ladder():
    _js, ts = incremental_pair(candidate_bucket=32, auto_tune=True)
    ts._note_tuner_batch(60)
    assert ts._candidate_bucket(1024) == 32
    _js, ts2 = incremental_pair(candidate_bucket=32, auto_tune=False)
    ts2._warmed_cbuckets.update({16, 32, 64})
    ts2._note_tuner_batch(60)
    assert ts2._candidate_bucket(1024) == 32
    # with a ladder (warmup's job, not ported) the tuner would move
    ts._warmed_cbuckets.update({16, 32, 64})
    assert ts._candidate_bucket(1024) == 64


@pytest.mark.parametrize("cold_blocks, n_pad, C, want", [
    (0, 8192, 256, 8), (0, 128, 32, 4), (0, 64, 32, 2), (0, 32, 32, 1),
    (16, 128, 32, 4), (3, 8192, 256, 3)])
def test_cold_blocks_auto_and_clamp(cold_blocks, n_pad, C, want):
    js, ts = incremental_pair(cold_blocks=cold_blocks, candidate_bucket=C)
    assert ts._cold_blocks(n_pad, C) == want == js._cold_blocks(n_pad, C)
