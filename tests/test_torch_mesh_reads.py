"""A mesh cycle's reads outside the batch solve, per shard, held against
the JAX package's GSPMD run on the CPU.

The reference places a cycle's node table as one sharded ``jax.Array``
pytree (``kubernetes_tpu/parallel/mesh.py``) and runs every node-axis
pass partitioned. The port runs each pass as one program per shard over
its own block (``parallel/collectives.py`` holds every exchange). Here
seeded clusters go through the reference on ``jmesh.shard_cluster(...,
make_mesh(jax.devices()[:d]))`` (the 8 virtual CPU devices
``tests/conftest.py`` forces) and through the port's shard programs on a
logical mesh of d copies of the CPU device, at d in {2, 4, 8}:

- the failure pass's filter result, left in the shards' column blocks;
- ``explain_reduce`` with the FitError inputs (the failed rows);
- the preemption rows (``reason_rows``: the k rows, one gather);
- ``device_validate``'s code and count on honest results and on lying
  ones (out of range, float, non-finite, over capacity, an invalid
  node, a NaN usage, several failures at once in different shards);
- ``quality_reduce`` and a scenario pack's cost terms;
- the candidate pick with a hint mask and the partitioned block deal,
  and the candidate rows gathered from their owning blocks.

Everything is compared exactly (bit for bit), except the three f32
fractions of ``quality_reduce`` (``headroom``, ``fragmentation``,
``free_cpu_frac``): their node sums merge per shard, in another order
than XLA's, so they are held within rtol 1e-5, atol 1e-6. The "padded"
cluster has 20 nodes in a 32-row bucket, so at d = 4 and d = 8 whole
shards hold padding only."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.obs.explain as jexplain
import kubernetes_tpu.ops.arrays as jarrays
import kubernetes_tpu.ops.assign as jassign
import kubernetes_tpu.ops.fused_score as jfs
import kubernetes_tpu.ops.scenario_cost as jcost
import kubernetes_tpu.parallel.mesh as jmesh
import kubernetes_tpu.scheduler as jscheduler
import kubernetes_tpu_torch.obs.explain as texplain
import kubernetes_tpu_torch.ops.arrays as tarrays
import kubernetes_tpu_torch.ops.assign as tassign
import kubernetes_tpu_torch.ops.fused_score as tfs
import kubernetes_tpu_torch.ops.predicates as tpred
import kubernetes_tpu_torch.ops.scenario_cost as tcost
import kubernetes_tpu_torch.parallel.mesh as tmesh
import kubernetes_tpu_torch.scheduler as tscheduler
from kubernetes_tpu.api.types import NodeCondition, Taint, Toleration
from kubernetes_tpu.testing import make_node, make_pod
from kubernetes_tpu_torch.parallel import collectives as coll
from torch_parity import jax_tables, port_tables

CPU = torch.device("cpu")
WIDTHS = [2, 4, 8]
CASES = ["mixed", "padded"]
#: the f32 fractions of quality_reduce (the counts are exact)
Q_RTOL, Q_ATOL = 1e-5, 1e-6


def jmesh_of(d):
    return jmesh.make_mesh(jax.devices()[:d])


def tmesh_of(d):
    return tmesh.make_mesh([CPU] * d)


def _joined(x):
    """A value left in a mesh's blocks joined on the host (a whole
    tensor as it is)."""
    if isinstance(x, tmesh.Blocks):
        return np.concatenate([p.numpy() for p in x.parts], x.axis)
    return x.numpy()


def _cluster(name):
    """A seeded cluster whose batch leaves pods unplaced for every kind
    of reason: too big for any node, a node selector few nodes match, a
    taint few tolerate, nodes not ready, unreachable, cordoned or under
    memory pressure (best-effort pods), and a full node."""
    rng = np.random.default_rng(20261018 if name == "mixed" else 7)
    n_nodes = 40 if name == "mixed" else 20
    taint = Taint("dedicated", "gpu", "NoSchedule")
    nodes = []
    for i in range(n_nodes):
        cond = NodeCondition(ready=(i % 11 != 3),
                             network_unavailable=(i % 13 == 5),
                             memory_pressure=(i % 9 == 4))
        nodes.append(make_node(
            f"n{i}", cpu_milli=int(rng.choice([2000, 4000, 8000])),
            memory=int(rng.choice([4, 8, 16])) * 2**30,
            pods=int(rng.choice([4, 16, 110])), zone=f"z{i % 4}",
            labels={"disk": "ssd" if i % 3 == 0 else "hdd"},
            taints=(taint,) if i % 7 == 2 else (),
            unschedulable=(i % 17 == 8), conditions=cond))
    bound = [make_pod(f"old{i}", cpu_milli=int(rng.choice([500, 1500])),
                      memory=2**30, node_name=f"n{int(rng.integers(n_nodes))}")
             for i in range(n_nodes)]
    tol = (Toleration(key="dedicated", operator="Equal", value="gpu",
                      effect="NoSchedule"),)
    pending = []
    for i in range(48):
        kind = i % 6
        kw = {}
        if kind == 1:
            kw["node_selector"] = {"disk": "ssd"}
        elif kind == 2:
            kw["tolerations"] = tol
        cpu = {0: 64000, 3: 0}.get(kind, int(rng.choice([250, 1000, 3000])))
        mem = 0 if kind == 3 else int(rng.choice([2**28, 2**30, 6 * 2**30]))
        pending.append(make_pod(f"p{i}", cpu_milli=cpu, memory=mem,
                                priority=int(rng.choice([0, 10, 100])),
                                **kw))
    return nodes, bound, pending


@functools.lru_cache(maxsize=None)
def _tables(name):
    nodes, bound, pending = _cluster(name)
    dn, dp, ds, _dv, nt, _pt, _pk = jax_tables(nodes, bound, pending)
    return dn, dp, ds, nt.n


@functools.lru_cache(maxsize=None)
def _solved(name, d):
    """Both packages' placed tables and the sharded solve's result:
    ``(jax (dp, dn, ds, assigned, usage), port (dp, dn, ds, assigned,
    usage), real node count)``; the port's solve and usage equal the
    reference's."""
    dn, dp, ds, n_real = _tables(name)
    jdp, jdn, jds = jmesh.shard_cluster(dp, dn, ds, jmesh_of(d))
    ja, ju, _r = jassign.batch_assign(jdp, jdn, jds, per_node_cap=2)
    tdn, tdp, tds, _ = port_tables(dn, dp, ds)
    sdp, sdn, sds = tmesh.shard_cluster(tdp, tdn, tds, tmesh_of(d))
    ta, tu, _r = tassign.batch_assign(sdp, sdn, sds, per_node_cap=2)
    assert ta.tolist() == np.asarray(ja).tolist()
    assert isinstance(tu.requested, tmesh.Blocks)
    assert len(tu.requested.parts) == d
    for f in type(tu)._fields:
        np.testing.assert_array_equal(_joined(getattr(tu, f)),
                                      np.asarray(getattr(ju, f)), err_msg=f)
    return (jdp, jdn, jds, ja, ju), (sdp, sdn, sds, ta, tu), n_real


def _failure_pass(name, d):
    (jdp, jdn, jds, ja, ju), (sdp, sdn, sds, ta, tu), n_real = \
        _solved(name, d)
    jfr = jscheduler._filter_pass(jdp, jassign.nodes_with_usage(jdn, ju),
                                  jds, None)
    tdn_u = tassign.nodes_with_usage(sdn, tu)
    tfr = tscheduler._filter_pass(sdp, tdn_u, sds, None)
    failed = [i for i, a in enumerate(np.asarray(ja).tolist())
              if a < 0 and bool(np.asarray(jdp.valid)[i])]
    return jfr, tfr, failed, tdn_u, n_real


# ---------------------------------------------------------------------------
# 1. the filter result stays in the shards' column blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("d", WIDTHS)
def test_failure_filter_blocks_match_the_reference(d, name):
    jfr, tfr, failed, tdn_u, _n = _failure_pass(name, d)
    assert isinstance(tfr.reasons, tmesh.Blocks) and tfr.reasons.axis == 1
    assert len(tfr.reasons.parts) == d
    for i, part in enumerate(tfr.reasons.parts):
        # each block is its shard's columns, on its shard's device
        assert part.shape[1] == tdn_u.rows
        assert part.device == tdn_u.mesh.devices[i]
    np.testing.assert_array_equal(_joined(tfr.reasons),
                                  np.asarray(jfr.reasons))
    np.testing.assert_array_equal(_joined(tfr.mask), np.asarray(jfr.mask))
    assert failed  # the batch leaves pods to explain


# ---------------------------------------------------------------------------
# 2. explain_reduce as a shard program
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("d", WIDTHS)
def test_explain_reduce_per_shard_matches_the_reference(d, name):
    (jdp, jdn, _jds, _ja, ju), (sdp, *_rest), _n = _solved(name, d)
    jfr, tfr, failed, tdn_u, _n = _failure_pass(name, d)
    rows = jnp.asarray(failed)
    want = jexplain.explain_reduce(
        jfr.reasons[rows], jdn.valid, jnp.ones((len(failed),), bool),
        jdp.req[rows], jdn.allocatable - ju.requested, jdn.ready,
        jdn.network_unavailable)
    got = texplain.explain_rows(tfr.reasons, tdn_u,
                                tmesh.unreplicated(sdp).req,
                                torch.tensor(failed, dtype=torch.int64))
    for f in texplain.ExplainResult._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    # the one counted readback the cycle keeps
    host = texplain.read_back(got, lambda t: t.numpy())
    assert host["pod_bits"].tolist() == np.asarray(want.pod_bits).tolist()
    assert int(np.asarray(want.pod_bits).astype(bool).sum()) > 0


def test_explain_reduce_blocks_merge_bitwise_or_and_sums():
    """Direct: a (P, N) reasons plane cut into blocks reduces as the whole
    plane, the pod_bits as a bitwise OR of the blocks' bits (a bit set in
    two blocks counts once)."""
    g = np.random.default_rng(3)
    P, N, d = 6, 16, 4
    reasons = torch.tensor(g.integers(0, 1 << 6, (P, N)), dtype=torch.int32)
    reasons[:, :4] = 1  # bit 0 in every node of block 0 ...
    reasons[:, 12:] |= 1  # ... and of block 3
    valid = torch.tensor(g.uniform(size=N) > 0.2)
    mask = torch.tensor([True, True, False, True, True, True])
    mesh = tmesh_of(d)
    whole = texplain.explain_reduce(reasons, valid, mask)
    got = texplain.explain_reduce(
        tmesh.Blocks(mesh, tuple(reasons.chunk(d, 1)), 1),
        tmesh.row_blocks(valid, mesh), mask)
    for f in texplain.ExplainResult._fields:
        assert torch.equal(getattr(got, f), getattr(whole, f)), f


# ---------------------------------------------------------------------------
# 3. the preemption rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("d", WIDTHS)
def test_preemption_rows_match_the_reference(d, name):
    jfr, tfr, failed, _tdn_u, n_real = _failure_pass(name, d)
    pre = failed[::2]
    want = np.asarray(jfr.reasons[jnp.asarray(pre)][:, :n_real])
    coll.STATS.reset()
    got = tpred.reason_rows(tfr.reasons, torch.tensor(pre))[:, :n_real]
    np.testing.assert_array_equal(got.numpy(), want)
    # the k row indices to every shard and one gather of the k rows,
    # nothing else
    assert coll.STATS.by_op == {"bcast": 1, "cat": 1}
    assert coll.STATS.payload_bytes == (d - 1) * len(pre) * \
        (8 + tfr.reasons.parts[0].shape[1] * 4 * (1 + d))


# ---------------------------------------------------------------------------
# 4. device_validate per shard
# ---------------------------------------------------------------------------


def _lies(kind, ja, n_pad):
    """A lying solver's result: the numpy assignment, and the first row
    from which its claimed usage reads NaN (None: honest usage)."""
    a = np.asarray(ja).astype(np.int64)
    valid_rows = np.nonzero(a >= 0)[0]
    nan_lo = None
    if kind == "range":
        a[valid_rows[0]] = n_pad + 3
    elif kind == "float":
        a = a.astype(np.float32)
        a[valid_rows[0]] += 0.5
    elif kind == "nonfinite":
        a = a.astype(np.float32)
        a[valid_rows[0]] = np.inf
    elif kind == "capacity":
        a = np.where(a >= 0, 0, a)
    elif kind == "invalid":
        a[valid_rows[0]] = n_pad - 1  # a padding row: in range, invalid
    elif kind == "nan":
        nan_lo = n_pad // 2  # the last shard's rows only
    elif kind == "several":
        # capacity in block 0, NaN usage in the middle, an invalid node
        # in the last block: the merged code is the first failing check
        # in VALIDATE_REASONS order (invalid-node), not a shard's own
        a = np.where(a >= 0, 0, a)
        a[valid_rows[0]] = n_pad - 1
        nan_lo = n_pad // 4
    return a, nan_lo


def _nan_usage(u, lo, jax_side):
    if lo is None:
        return u
    if jax_side:
        req = u.requested.at[lo:].set(jnp.nan)
        return u._replace(requested=req)
    parts = []
    rows = u.requested.parts[0].shape[0]
    for i, p in enumerate(u.requested.parts):
        r = p.clone()
        r[max(lo - i * rows, 0):] = float("nan")
        parts.append(r)
    return u._replace(requested=u.requested._replace(parts=tuple(parts)))


LIES = ["honest", "range", "float", "nonfinite", "capacity", "invalid",
        "nan", "several"]


@pytest.mark.parametrize("kind", LIES)
@pytest.mark.parametrize("d", WIDTHS)
def test_device_validate_per_shard_matches_the_reference(d, kind):
    (jdp, jdn, _jds, ja, ju), (sdp, sdn, _sds, _ta, tu), _n = \
        _solved("padded", d)
    n_pad = sdn.n
    a, nan_lo = _lies(kind, ja, n_pad)
    want = jassign.device_validate(jnp.asarray(a), _nan_usage(ju, nan_lo,
                                                              True),
                                   jdp, jdn)
    got = tassign.device_validate(torch.tensor(a), _nan_usage(tu, nan_lo,
                                                              False),
                                  sdp, sdn)
    want = (int(want[0]), int(want[1]))
    assert (int(got[0]), int(got[1])) == want
    # and the unsharded check agrees
    lied = _nan_usage(tu, nan_lo, False)
    flat_u = tassign.UsageState(*[torch.tensor(_joined(getattr(lied, f)))
                                  for f in tassign.UsageState._fields])
    flat = tassign.device_validate(torch.tensor(a), flat_u,
                                   tmesh.unreplicated(sdp),
                                   coll.whole_table(sdn))
    assert (int(flat[0]), int(flat[1])) == want
    expect = {"honest": "", "range": "range", "float": "dtype",
              "nonfinite": "finiteness", "capacity": "capacity",
              "invalid": "invalid-node", "nan": "finiteness",
              "several": "invalid-node"}[kind]
    assert tassign.VALIDATE_REASONS[want[0]] == expect


# ---------------------------------------------------------------------------
# 5. quality_reduce per shard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("d", WIDTHS)
def test_quality_reduce_per_shard_matches_the_reference(d, name):
    (jdp, jdn, _jds, ja, ju), (sdp, sdn, _sds, ta, tu), _n = \
        _solved(name, d)
    want = np.asarray(jcost.quality_reduce(
        jnp.asarray(ja, jnp.int32), ju.requested, jdp, jdn))
    got = tcost.quality_reduce(ta.to(torch.int32), tu.requested, sdp,
                               sdn).numpy()
    # nodes_used, nodes_used_batch, placed, priority_headroom: exact
    np.testing.assert_array_equal(got[[0, 1, 2, 5]], want[[0, 1, 2, 5]])
    np.testing.assert_allclose(got, want, rtol=Q_RTOL, atol=Q_ATOL)


@pytest.mark.parametrize("fill_block", [1, 8])
@pytest.mark.parametrize("d", WIDTHS)
def test_pack_cost_terms_per_shard_match_the_reference(d, fill_block):
    """A scenario pack's cost terms run per shard: the consolidation fill
    order counted from each block's first global row, the gang score per
    column; bit for bit against the reference's sharded terms."""
    (jdp, jdn, _jds, _ja, _ju), (sdp, sdn, _sds, _ta, _tu), n_real = \
        _solved("padded", d)
    tp = tmesh.unreplicated(sdp)
    want = np.asarray(jcost.consolidation_bias(
        jdp.valid, jdn, jnp.float32(3.7), fill_block=fill_block))
    got = tcost.consolidation_bias(tp.valid, sdn,
                                   torch.tensor(3.7, dtype=torch.float32),
                                   fill_block=fill_block)
    assert isinstance(got, tmesh.Blocks) and got.axis == 1
    np.testing.assert_array_equal(_joined(got), want)
    home = np.random.default_rng(d).integers(
        -1, 4, tp.valid.shape[0]).astype(np.int32)
    want = np.asarray(jcost.gang_topology_score(
        jnp.asarray(home), jdn, jnp.float32(5.0), superpod=2))
    got = tcost.gang_topology_score(torch.tensor(home), sdn,
                                    torch.tensor(5.0), superpod=2)
    np.testing.assert_array_equal(_joined(got), want)


# ---------------------------------------------------------------------------
# 6. the sparse routes' candidate rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("d", WIDTHS)
def test_candidate_pick_per_shard_matches_the_reference(d, name):
    dn, _dp, _ds, n_real = _tables(name)
    jdn = jmesh.shard_nodes(dn, jmesh_of(d))
    tdn = tmesh.shard_nodes(port_tables(dn, _dp, _ds)[0], tmesh_of(d))
    N = tdn.n
    g = np.random.default_rng(d)
    dirty = g.uniform(size=N) < 0.15
    hint = g.uniform(size=N) < 0.3
    C = 8
    jsum = jfs.node_summary(jdn)
    tsum = tfs.node_summary(tdn)
    assert isinstance(tsum.rank, tmesh.Blocks)
    mesh = tdn.mesh
    for hq in (0, 3):
        jc, jsub = jarrays.gather_candidates(
            jsum, jnp.asarray(dirty), jdn, C, hint_mask=jnp.asarray(hint),
            num_shards=d, hint_quota=hq)
        coll.STATS.reset()
        tc, tsub = tarrays.gather_candidates(
            tsum, tmesh.upload_rows(dirty, mesh), tdn, C,
            hint_mask=tmesh.upload_rows(hint, mesh), num_shards=d,
            hint_quota=hq)
        assert tc.tolist() == np.asarray(jc).tolist(), hq
        for f in type(tsub)._fields:
            np.testing.assert_array_equal(
                getattr(tsub, f).numpy(), np.asarray(getattr(jsub, f)),
                err_msg=f)
        # the rows came from their owning blocks, never a whole table
        assert coll.STATS.by_op.get("gather_nodes", 0) == 0
        assert coll.STATS.by_op["owner"] == len(type(tsub)._fields) - 1
    B = 2
    jb = jfs.partition_columns(jsum, jnp.zeros((N,), bool), B, C, d)
    tb = tfs.partition_columns(
        tsum, tmesh.upload_rows(np.zeros((N,), bool), mesh), B, C, d)
    assert tb.tolist() == np.asarray(jb).tolist()


@pytest.mark.parametrize("d", [2, 4])
def test_summary_patch_lands_in_the_owning_block(d):
    """A delta's summary rows patch the block that owns each row, as the
    resident table's scatter does: equal to the whole summary patched."""
    dn, dp, ds, _n = _tables("mixed")
    tdn = port_tables(dn, dp, ds)[0]
    mesh = tmesh_of(d)
    sub = tarrays.gather_node_rows(tdn, torch.tensor([5, 33, 0, 63]))
    sub = sub._replace(requested=sub.requested + 100.0)
    idx = np.array([5, 33, 0, 64])  # 64: padding, dropped
    whole = tfs.patch_node_summary(tfs.node_summary(tdn),
                                   tfs.node_summary(sub), idx)
    blocks = tfs.patch_node_summary(
        tfs.node_summary(tmesh.shard_nodes(tdn, mesh)),
        tfs.node_summary(sub), idx)
    for f in ("eligible", "rank"):
        np.testing.assert_array_equal(_joined(getattr(blocks, f)),
                                      getattr(whole, f).numpy())


def test_round_figures_leave_out_the_reads_after_the_solve():
    """``collectives.ROUND`` keeps the last round body's collectives: the
    validation and the failure pass that follow a solve add to ``STATS``
    only."""
    _j, (sdp, sdn, sds, _ta, _tu), _n = _solved("mixed", 2)
    a, u, _r = tassign.batch_assign(sdp, sdn, sds, per_node_cap=2)
    round_ops = coll.ROUND.snapshot()
    assert round_ops["calls"] > 0
    calls = coll.STATS.calls
    tassign.device_validate(a, u, sdp, sdn)
    tscheduler._filter_pass(sdp, tassign.nodes_with_usage(sdn, u), sds, None)
    assert coll.STATS.calls > calls
    assert coll.ROUND.snapshot() == round_ops


# ---------------------------------------------------------------------------
# the one dispatch: per_shard
# ---------------------------------------------------------------------------


def _shift(x, rows, scale, sh=None):
    """``x`` plus each row's global index, times ``scale``, as a table:
    a per-block function (``sh`` None: the whole table)."""
    lo = 0 if sh is None else sh.lo
    y = (x + torch.arange(lo, lo + x.shape[0], dtype=x.dtype)[:, None]) \
        * scale
    return tpred.FilterResult(mask=y > rows, reasons=y)


def _shift_g(x, rows, scale, sh=None):
    """:func:`_shift` as a shard program that also merges the sum over
    every node row with ``all_sum``."""
    t = _shift(x, rows, scale, sh)
    total = yield coll.all_sum(t.reasons.sum(0, keepdim=True))
    return t, total


@pytest.mark.parametrize("d", WIDTHS)
def test_per_shard_runs_one_program_solo_or_per_block(d):
    """Off the mesh the program runs once; on a mesh it runs per block
    (each placed argument split, a tensor broadcast and counted, a host
    value as it is). A shard program's merged sum is the solo sum; a
    per-block table joins field by field into ``Blocks`` equal to the
    solo table, and ``part`` recovers each shard's view."""
    x = torch.arange(16 * 3, dtype=torch.float32).reshape(16, 3)
    scale = torch.tensor(2.0)
    mesh = tmesh_of(d)
    xb = tmesh.row_blocks(x, mesh)
    want_t, want_sum = tmesh.per_shard(_shift_g, x, 20, scale, shard=True)
    coll.STATS.reset()
    got0, got_sum = tmesh.per_shard(_shift_g, xb, 20, scale, shard=True)
    assert torch.equal(got_sum, want_sum)
    assert coll.STATS.by_op == {"bcast": 1, "sum": 1}
    # without ``split`` the result is shard 0's: its own block
    assert torch.equal(got0.reasons, want_t.reasons[:16 // d])
    got_t = tmesh.per_shard(_shift, xb, 20, scale, shard=True, split=0)
    assert tmesh.is_placed(got_t) and not tmesh.is_placed(want_t)
    joined = tmesh.join([tmesh.part(got_t, i) for i in range(d)], mesh)
    for f in tpred.FilterResult._fields:
        assert isinstance(getattr(got_t, f), tmesh.Blocks)
        np.testing.assert_array_equal(_joined(getattr(got_t, f)),
                                      getattr(want_t, f).numpy())
        np.testing.assert_array_equal(_joined(getattr(joined, f)),
                                      getattr(want_t, f).numpy())
    # the global signature a telemetry digest reads
    assert tmesh.abstract(got_t.reasons).shape == (16, 3)


# ---------------------------------------------------------------------------
# the whole-table gather is explicit and counted
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("logical", [True, False])
def test_whole_table_is_one_counted_gather(logical, monkeypatch):
    dn, dp, ds, _n = _tables("padded")
    tdn = port_tables(dn, dp, ds)[0]
    if not logical:
        monkeypatch.setattr(tmesh.Mesh, "logical",
                            property(lambda self: False))
    placed = tmesh.shard_nodes(tdn, tmesh_of(4))
    assert (placed.whole is not None) == logical
    coll.STATS.reset()
    got = coll.whole_table(placed)
    assert coll.STATS.by_op == {"gather_nodes": 1}
    for f in type(tdn)._fields:
        assert torch.equal(getattr(got, f), getattr(tdn, f)), f
