"""The partitioned node-axis solve of the port (``parallel/collectives.py``,
the split pair and u kernels, the shard programs of ``ops/``) held
against the JAX package on the CPU.

- each cross-shard reduction against the unsharded reduction on seeded
  numpy inputs, ties, all-masked rows and all-padding shards included;
- the split pair's plain versions against the reference's two
  ``pallas_call`` passes in interpret mode, bit for bit, and composed
  over d shards against the fused pair;
- the split u pass plus its merge against the reference's ``_u_kernel``
  in interpret mode and the port's whole-row pass, in both rules, at
  ``atol=1e-5, rtol=1e-4``;
- the partitioned solve at d in {2, 4, 8} (logical meshes of the CPU
  device) against ``kubernetes_tpu``'s ``batch_assign`` on a d-device JAX
  mesh (the 8 virtual CPU devices ``tests/conftest.py`` forces), bit for
  bit on placements and rounds;
- that a mesh of d > 1 runs the partitioned program and a mesh of one
  does not."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.ops.fused_score as jfs
import kubernetes_tpu.ops.sinkhorn as jsk
import kubernetes_tpu.parallel.mesh as jmesh
import kubernetes_tpu_torch.ops.fused_score as tfs
import kubernetes_tpu_torch.ops.sinkhorn as tsk
import kubernetes_tpu_torch.parallel.mesh as tmesh
from kubernetes_tpu.models.cluster import (
    make_nodes,
    make_pod_affinity_pods,
    make_pods,
    make_pv_pods,
    make_spread_constraint_pods,
    make_spread_pods,
)
from kubernetes_tpu.ops.arrays import (
    nodes_to_device,
    pods_to_device,
    selectors_to_device,
    topology_to_device,
    volumes_to_device,
)
from kubernetes_tpu.ops.assign import batch_assign as jbatch_assign
from kubernetes_tpu.ops.predicates import run_predicates as jrun_predicates
from kubernetes_tpu.snapshot import SnapshotPacker
from kubernetes_tpu_torch.ops.assign import batch_assign as tbatch_assign
from kubernetes_tpu_torch.ops.predicates import (
    run_predicates as trun_predicates,
)
from kubernetes_tpu_torch.parallel import collectives as coll
from torch_parity import port_table

ATOL, RTOL = 1e-5, 1e-4
CPU = torch.device("cpu")
WIDTHS = [2, 4, 8]


def tmesh_of(d):
    return tmesh.make_mesh([CPU] * d)


def jmesh_of(d):
    return jmesh.make_mesh(jax.devices()[:d])


def _parts(x, d, dim):
    return list(torch.tensor(x).chunk(d, dim))


def _joined(x):
    """A value a shard program left in a mesh's blocks, joined on the
    host (a whole tensor as it is)."""
    if isinstance(x, tmesh.Blocks):
        return np.concatenate([p.numpy() for p in x.parts], x.axis)
    return x.numpy()


# ---------------------------------------------------------------------------
# The reductions against the unsharded reduction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("shape", [(37,), (19, 5)])
def test_all_reduce_matches_the_unsharded_reduction(d, shape):
    g = np.random.default_rng(d * 100 + len(shape))
    # per-shard partials of an (d, ...) stack; integer-valued f32 with ties
    stack = g.integers(-4, 5, (d,) + shape).astype(np.float32)
    stack[0] = 0.0  # a shard of padding: neutral-looking zeros
    parts = [torch.tensor(s) for s in stack]
    devs = [CPU] * d
    for op, want in (("max", stack.max(0)), ("min", stack.min(0)),
                     ("sum", stack.sum(0))):
        got = coll.all_reduce(op, parts, devs)
        assert len(got) == d
        for t in got:
            np.testing.assert_array_equal(t.numpy(), want)
    flags = [torch.tensor(s > 2) for s in stack]
    for t in coll.all_reduce("or", flags, devs):
        np.testing.assert_array_equal(t.numpy(), (stack > 2).any(0))


@pytest.mark.parametrize("d", WIDTHS)
def test_argmax_merge_takes_the_lowest_global_index_among_ties(d):
    g = np.random.default_rng(d)
    P, rows = 23, 6
    vals = g.integers(0, 3, (P, d * rows)).astype(np.float32)
    vals[3] = 1.0  # a row tied everywhere
    vals[4, -1] = 9.0  # the maximum on the last shard
    v = torch.tensor(vals)
    bv, bi = [], []
    for k, blk in enumerate(v.chunk(d, 1)):
        bv.append(blk.amax(1))
        bi.append(blk.argmax(1) + k * rows)  # first max of the block
    got = coll.argmax_merge(bv, bi, [CPU] * d)
    for gv, gi in got:
        np.testing.assert_array_equal(gv.numpy(), vals.max(1))
        np.testing.assert_array_equal(gi.numpy(), vals.argmax(1))
    assert int(got[0][1][3]) == 0 and int(got[0][1][4]) == d * rows - 1


@pytest.mark.parametrize("d", WIDTHS)
def test_shard_offsets_are_the_exclusive_tie_cumsum(d):
    g = np.random.default_rng(d)
    tied = g.uniform(size=(17, d * 5)) > 0.6
    tied[2] = False  # no tie at all
    tied[5, :5] = False  # an all-empty first shard on one row
    counts = [b.sum(1, dtype=torch.int32)
              for b in torch.tensor(tied).chunk(d, 1)]
    got = coll.shard_offsets(counts, [CPU] * d)
    pos = np.cumsum(tied, 1)
    for k, (total, off) in enumerate(got):
        np.testing.assert_array_equal(total.numpy(), tied.sum(1))
        want = pos[:, k * 5 - 1] if k else np.zeros(17, np.int64)
        np.testing.assert_array_equal(off.numpy(), want)


@pytest.mark.parametrize("d", WIDTHS)
def test_owner_select_and_all_gather(d):
    g = np.random.default_rng(d)
    vals = g.integers(-9, 9, (d, 13, 3)).astype(np.int32)
    owner = g.integers(0, d, 13)
    got = coll.owner_select([torch.tensor(v) for v in vals],
                            torch.tensor(owner), [CPU] * d)
    want = vals[owner, np.arange(13)]
    for t in got:
        np.testing.assert_array_equal(t.numpy(), want)
    blocks = _parts(g.uniform(size=(5, d * 3)).astype(np.float32), d, 1)
    for t in coll.all_gather(blocks, 1, [CPU] * d):
        np.testing.assert_array_equal(t.numpy(), torch.cat(blocks, 1).numpy())


def test_lockstep_runs_one_program_per_shard_and_solo_is_the_identity():
    def program(x):
        m = yield coll.all_max(x.amax(1))
        s = yield coll.all_sum(x.sum(1))
        return m, s

    x = torch.tensor(np.random.default_rng(0).uniform(
        size=(7, 16)).astype(np.float32))
    outs = coll.lockstep([program(b) for b in x.chunk(4, 1)], [CPU] * 4)
    alone = coll.solo(program(x))
    for m, s in outs:
        np.testing.assert_array_equal(m.numpy(), alone[0].numpy())
        np.testing.assert_allclose(s.numpy(), alone[1].numpy(), rtol=1e-6)


# ---------------------------------------------------------------------------
# The pair split at its max / scale seam
# ---------------------------------------------------------------------------


def _pair_problem(seed, P, N):
    g = np.random.default_rng(seed)
    rf = g.integers(0, 7, (P, N)).astype(np.float32)
    rr = g.integers(0, 4, (P, N)).astype(np.float32)
    mask = g.uniform(size=(P, N)) > 0.35
    mask[1] = False  # an all-masked row: maxima 0
    rf[2] = 0.0  # a zero forward row: the mxf <= 0 rule
    return rf, rr, mask


def _ref_pair_passes(rf, rr, mask, w_fwd, w_rev):
    """The reference's two ``pallas_call``s of ``_pair_pallas`` in
    interpret mode, one grid step each: (mxf, mxr, out)."""
    from jax.experimental import pallas as pl

    P, N = rf.shape
    full = pl.BlockSpec((P, N), lambda i, j: (0, 0))
    vec = pl.BlockSpec((1, P), lambda i, j: (0, 0))
    mxf, mxr = pl.pallas_call(
        jfs._pair_max_kernel, grid=(1, 1), in_specs=[full] * 3,
        out_specs=[vec, vec],
        out_shape=[jax.ShapeDtypeStruct((1, P), jnp.float32)] * 2,
        interpret=True)(jnp.asarray(rf), jnp.asarray(rr), jnp.asarray(mask))
    out = pl.pallas_call(
        jfs._make_pair_scale_kernel(float(w_fwd), float(w_rev)),
        grid=(1, 1), in_specs=[full, full, vec, vec], out_specs=full,
        out_shape=jax.ShapeDtypeStruct((P, N), jnp.float32),
        interpret=True)(jnp.asarray(rf), jnp.asarray(rr), mxf, mxr)
    return np.asarray(mxf)[0], np.asarray(mxr)[0], np.asarray(out)


@pytest.mark.parametrize("shape", [(16, 24), (33, 40)])
def test_split_pair_plain_versions_match_the_reference_passes(shape):
    rf, rr, mask = _pair_problem(3, *shape)
    jmxf, jmxr, jout = _ref_pair_passes(rf, rr, mask, 2.0, 3.0)
    mxf, mxr = tfs.fused_pair_max_plain(torch.tensor(rf), torch.tensor(rr),
                                        torch.tensor(mask))
    np.testing.assert_array_equal(mxf.numpy(), jmxf)
    np.testing.assert_array_equal(mxr.numpy(), jmxr)
    out = tfs.fused_pair_scale_plain(torch.tensor(rf), torch.tensor(rr),
                                     torch.tensor(jmxf), torch.tensor(jmxr),
                                     2.0, 3.0)
    np.testing.assert_array_equal(out.numpy(), jout)


@pytest.mark.parametrize("d", WIDTHS)
def test_split_pair_over_shards_equals_the_fused_pair(d):
    rf, rr, mask = _pair_problem(d, 21, 8 * d)
    rf_t, rr_t, m_t = (torch.tensor(a) for a in (rf, rr, mask))
    mx = [tfs.fused_pair_max(a, b, m) for a, b, m in zip(
        rf_t.chunk(d, 1), rr_t.chunk(d, 1), m_t.chunk(d, 1))]
    mxf = coll.all_reduce("max", [m[0] for m in mx], [CPU] * d)[0]
    mxr = coll.all_reduce("max", [m[1] for m in mx], [CPU] * d)[0]
    got = torch.cat([tfs.fused_pair_scale(a, b, mxf, mxr, 1.0, 1.0)
                     for a, b in zip(rf_t.chunk(d, 1), rr_t.chunk(d, 1))], 1)
    want = tfs.fused_pair_normalize_plain(rf_t, rr_t, m_t, 1.0, 1.0)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# ---------------------------------------------------------------------------
# The Sinkhorn row pass split at its reduction
# ---------------------------------------------------------------------------


def _u_problem(seed, P, N):
    g = np.random.default_rng(seed)
    mask = g.uniform(size=(P, N)) > 0.3
    mask[0] = False  # an all-masked row: u = NEG_INF
    logk = np.where(mask, g.uniform(0, 20, (P, N)),
                    jsk.NEG_INF).astype(np.float32)
    v = np.minimum(g.normal(size=N), 0.0).astype(np.float32)
    log_r = np.where(mask.any(1), 0.0, jsk.NEG_INF).astype(np.float32)
    return logk, v, log_r


def _ref_u_kernel(logk, v, log_r):
    from jax.experimental import pallas as pl

    P, N = logk.shape
    return np.asarray(pl.pallas_call(
        jsk._u_kernel, grid=(1,),
        in_specs=[pl.BlockSpec((P, N), lambda i: (0, 0)),
                  pl.BlockSpec((1, N), lambda i: (0, 0)),
                  pl.BlockSpec((1, P), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, P), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((1, P), jnp.float32),
        interpret=True)(jnp.asarray(logk), jnp.asarray(v)[None],
                        jnp.asarray(log_r)[None]))[0]


def _split_u(logk, v, log_r, d, jnp_rule):
    lk, vv = torch.tensor(logk), torch.tensor(v)
    parts = [tsk.sinkhorn_u_partial(a, b, jnp_rule)
             for a, b in zip(lk.chunk(d, 1), vv.chunk(d, 0))]
    return coll.lse_merge([p[0] for p in parts], [p[1] for p in parts],
                          torch.tensor(log_r), jnp_rule, [CPU] * d)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("jnp_rule", [False, True])
def test_split_u_pass_matches_the_reference_kernel_and_the_whole_pass(
        d, jnp_rule):
    logk, v, log_r = _u_problem(d, 29, 12 * d)
    got = _split_u(logk, v, log_r, d, jnp_rule)
    whole = tsk.sinkhorn_u_plain(torch.tensor(logk), torch.tensor(v),
                                 torch.tensor(log_r), jnp_rule)
    for u in got:
        np.testing.assert_allclose(u.numpy(), whole.numpy(), rtol=RTOL,
                                   atol=ATOL)
    if jnp_rule:
        want = np.asarray(jnp.where(
            jnp.isfinite(u := jnp.asarray(log_r) - jax.scipy.special
                         .logsumexp(jnp.asarray(logk) + jnp.asarray(v),
                                    axis=1)), u, jsk.NEG_INF))
    else:
        want = _ref_u_kernel(logk, v, log_r)
    np.testing.assert_allclose(got[0].numpy(), want, rtol=RTOL, atol=ATOL)


def test_split_u_pass_with_an_all_padding_shard():
    """A shard whose columns are all padding (logk = NEG_INF, v = 0): its
    shift clamps at NEG_INF and its sum carries no mass into u."""
    logk, v, log_r = _u_problem(5, 11, 16)
    logk[:, 12:] = jsk.NEG_INF
    v[12:] = 0.0
    m, s = tsk.sinkhorn_u_partial_plain(torch.tensor(logk[:, 12:]),
                                        torch.tensor(v[12:]))
    assert torch.all(m == jsk.NEG_INF)
    got = _split_u(logk, v, log_r, 4, False)[0]
    np.testing.assert_allclose(got.numpy(), _ref_u_kernel(logk, v, log_r),
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# The partitioned solve against the reference's sharded solve
# ---------------------------------------------------------------------------


def _pack(nodes, existing, pending, pvcs=(), pvs=()):
    pk = SnapshotPacker()
    if pvcs or pvs:
        pk.set_volume_state(pvcs, pvs, ())
    for p in list(existing) + list(pending):
        pk.intern_pod(p)
    dn = nodes_to_device(pk.pack_nodes(nodes, existing))
    dp = pods_to_device(pk.pack_pods(pending))
    ds = selectors_to_device(pk.pack_selector_tables())
    tt = pk.pack_topology_tables()
    dt = topology_to_device(tt) if tt.n_pairs else None
    dv = (volumes_to_device(pk.pack_volume_tables(pending))
          if (pvcs or pvs or any(p.volumes for p in pending)) else None)
    return dp, dn, ds, dt, dv


@functools.lru_cache(maxsize=None)
def _case(name):
    if name == "batch":
        nodes = make_nodes(64, zones=4)
        return _pack(nodes, make_pods(40, "old", assigned_round_robin_over=64),
                     make_spread_pods(96, n_services=6))
    if name == "topology":
        return _pack(make_nodes(64, zones=4),
                     make_pods(48, "old", assigned_round_robin_over=64),
                     make_spread_constraint_pods(48, hard=True)
                     + make_pod_affinity_pods(48, n_groups=6))
    if name == "volumes":
        pending, pvcs, pvs = make_pv_pods(64, kind="gce-pd")
        return _pack(make_nodes(32, zones=4), [], pending, pvcs, pvs)
    if name == "sinkhorn":
        # varied existing usage -> distinct node scores: the plan's argmax
        # is not tie-sensitive to the reduction order
        return _pack(make_nodes(32, zones=4),
                     make_pods(80, "old", assigned_round_robin_over=32),
                     make_pods(96, "pend"))
    raise KeyError(name)


def _port(t):
    return None if t is None else port_table(t)


def _both(name, d, **kw):
    """The reference's solve on a d-device mesh and the port's partitioned
    solve on a logical d-shard mesh: ``[(assigned, rounds)] * 2``."""
    dp, dn, ds, dt, dv = _case(name)
    jm = jmesh_of(d)
    jargs = jmesh.shard_cluster(dp, dn, ds, jm, topo=dt) if dt is not None \
        else jmesh.shard_cluster(dp, dn, ds, jm)
    jkw = dict(kw)
    if dt is not None:
        jkw["topo"] = jargs[3]
    if dv is not None:
        jkw["vol"] = jmesh.replicate(dv, jm)
    want = jbatch_assign(*jargs[:3], **jkw)
    tm = tmesh_of(d)
    tp, tn, ts_, tt, tv = (_port(t) for t in (dp, dn, ds, dt, dv))
    targs = tmesh.shard_cluster(tp, tn, ts_, tm, topo=tt) if tt is not None \
        else tmesh.shard_cluster(tp, tn, ts_, tm)
    assert isinstance(targs[1], tmesh.ShardedNodes)
    tkw = dict(kw)
    if tt is not None:
        tkw["topo"] = targs[3]
    if tv is not None:
        tkw["vol"] = tmesh.replicate(tv, tm)
    got = tbatch_assign(*targs[:3], **tkw)
    return [(np.asarray(a).tolist(), int(r)) for a, _u, r in
            (want[:3], got[:3])]


@pytest.mark.parametrize("d", WIDTHS)
def test_partitioned_predicates_match_the_reference(d):
    dp, dn, ds, _dt, _dv = _case("batch")
    jm = jmesh_of(d)
    want = np.asarray(jrun_predicates(
        *jmesh.shard_cluster(dp, dn, ds, jm)).mask)
    args = tmesh.shard_cluster(port_table(dp), port_table(dn),
                               port_table(ds), tmesh_of(d))
    got = trun_predicates(*args)
    # the partitioned pass leaves its result in the shards' column blocks
    assert isinstance(got.mask, tmesh.Blocks) and len(got.mask.parts) == d
    np.testing.assert_array_equal(_joined(got.mask), want)
    flat = trun_predicates(port_table(dp), port_table(dn), port_table(ds))
    np.testing.assert_array_equal(_joined(got.reasons), flat.reasons.numpy())


@pytest.mark.parametrize("name", ["batch", "topology", "volumes"])
@pytest.mark.parametrize("d", WIDTHS)
def test_partitioned_solve_matches_the_references_sharded_solve(name, d):
    want, got = _both(name, d)
    assert got == want


@pytest.mark.parametrize("d", WIDTHS)
def test_partitioned_sinkhorn_solve_matches_the_reference(d):
    want, got = _both("sinkhorn", d, use_sinkhorn=True)
    assert got == want


@pytest.mark.parametrize("d", WIDTHS)
def test_partitioned_lean_round_matches_the_reference(d):
    """Every preference kernel gated off: the lean round, whose row maxima
    and rotated pick reduce across shards."""
    from kubernetes_tpu.ops.assign import _PREFERENCE_KERNELS

    want, got = _both("batch", d, skip_priorities=_PREFERENCE_KERNELS,
                      no_ports=True, per_node_cap=2)
    assert got == want
    assert want[1] >= 1


def test_partitioned_sinkhorn_potentials_match_the_unsharded_ones():
    """The potentials of a plan round (u replicated, v in the shards' row
    blocks) agree with the unsharded solve's within the stated
    tolerance; the per-shard usage joins to the unsharded usage."""
    dp, dn, ds, _dt, _dv = _case("sinkhorn")
    tp, tn, ts_ = port_table(dp), port_table(dn), port_table(ds)
    flat = tbatch_assign(tp, tn, ts_, use_sinkhorn=True, potentials_out=True)
    got = tbatch_assign(*tmesh.shard_cluster(tp, tn, ts_, tmesh_of(4)),
                        use_sinkhorn=True, potentials_out=True)
    # v stays in the shards' row blocks
    assert isinstance(got[3][1], tmesh.Blocks)
    for a, b in zip(got[3], flat[3]):
        np.testing.assert_allclose(_joined(a), b.numpy(), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_array_equal(_joined(got[1].requested),
                                  flat[1].requested.numpy())


# ---------------------------------------------------------------------------
# A mesh of d > 1 runs the partitioned program; a mesh of one does not
# ---------------------------------------------------------------------------


def _counting(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def wrapped(*a, **k):
        calls.append((name, tuple(a[0].shape)))
        return real(*a, **k)

    monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("d", [1, 2, 4])
def test_a_mesh_wider_than_one_runs_the_partitioned_program(d, monkeypatch):
    # the kernel route (the card's default): on CPU tensors the kernels'
    # plain versions, reached through their wrappers
    monkeypatch.setenv("KTPU_PALLAS", "1")
    calls = []
    for name in ("fused_pair_max_plain", "fused_pair_scale_plain",
                 "fused_pair_normalize_plain"):
        _counting(monkeypatch, tfs, name, calls)
    for name in ("sinkhorn_u_partial_plain", "sinkhorn_u_plain"):
        _counting(monkeypatch, tsk, name, calls)
    dp, dn, ds, _dt, _dv = _case("sinkhorn")
    args = tmesh.shard_cluster(port_table(dp), port_table(dn),
                               port_table(ds), tmesh_of(d))
    coll.STATS.reset()
    tbatch_assign(*args, use_sinkhorn=True)
    names = [c[0] for c in calls]
    n_nodes = dn.valid.shape[0]
    if d == 1:
        assert coll.STATS.calls == 0
        assert not isinstance(args[1], tmesh.ShardedNodes)
        assert "fused_pair_normalize_plain" in names
        assert "sinkhorn_u_plain" in names
        assert not {"fused_pair_max_plain", "fused_pair_scale_plain",
                    "sinkhorn_u_partial_plain"} & set(names)
        return
    assert coll.STATS.calls > 0 and coll.STATS.moved_bytes == 0
    assert {"max", "or", "offsets", "argmax", "lse"} <= set(
        coll.STATS.by_op)
    assert "fused_pair_normalize_plain" not in names
    assert "sinkhorn_u_plain" not in names
    for name in ("fused_pair_max_plain", "fused_pair_scale_plain",
                 "sinkhorn_u_partial_plain"):
        shapes = [c[1] for c in calls if c[0] == name]
        # once per shard each time the pass runs, on the shard's block
        assert shapes and len(shapes) % d == 0, name
        assert {s[1] for s in shapes} == {n_nodes // d}, name


# ---------------------------------------------------------------------------
# The scheduler on a mesh: a broken split kernel stops the cycle
# ---------------------------------------------------------------------------


def _pref_cluster():
    """Nodes over 4 zones, every 4th with a PreferNoSchedule taint, and
    pods preferring a zone: the gates keep both NodeAffinity and
    TaintToleration on, so the general round scores the pair."""
    from kubernetes_tpu_torch.api.types import Taint
    from kubernetes_tpu_torch.testing import (
        make_node,
        make_pod,
        node_affinity_preferred,
        req,
    )

    taint = Taint("soft", "true", "PreferNoSchedule")
    nodes = [make_node(f"n{i}", cpu_milli=4000, pods=16, zone=f"z{i % 4}",
                       taints=(taint,) if i % 4 == 0 else ())
             for i in range(16)]
    pods = [make_pod(f"p{i}", cpu_milli=100, affinity=node_affinity_preferred(
        (50, [req("failure-domain.beta.kubernetes.io/zone", "In",
                  f"z{i % 4}")]))) for i in range(24)]
    return nodes, pods


def _pref_scheduler(mesh, solver, monkeypatch):
    from kubernetes_tpu_torch.config import ParallelConfig
    from kubernetes_tpu_torch.scheduler import Scheduler

    monkeypatch.setattr(tmesh, "local_devices",
                        lambda kind="cuda": [CPU] * 8)
    s = Scheduler(device="cpu", solver=solver, enable_preemption=False,
                  parallel=ParallelConfig(mesh=mesh) if mesh else None)
    nodes, pods = _pref_cluster()
    for nd in nodes:
        s.on_node_add(nd)
    for p in pods:
        s.on_pod_add(p)
    return s


@pytest.mark.parametrize("solver", ["batch", "sinkhorn"])
def test_scheduler_mesh_cycle_equals_the_mesh_off_cycle(solver,
                                                        monkeypatch):
    off = _pref_scheduler(None, solver, monkeypatch).schedule_cycle()
    coll.STATS.reset()
    on = _pref_scheduler(4, solver, monkeypatch).schedule_cycle()
    assert coll.STATS.calls > 0
    assert (on.assignments, on.rounds, on.solver_tier) == \
        (off.assignments, off.rounds, off.solver_tier)
    assert on.scheduled == 24


@pytest.mark.parametrize("solver,module,wrapper", [
    ("batch", tfs, "fused_pair_max"), ("batch", tfs, "fused_pair_scale"),
    ("sinkhorn", tsk, "sinkhorn_u_partial"),
    ("sinkhorn", tsk, "sinkhorn_v")])
def test_a_kernel_error_of_a_split_kernel_escapes_every_rung(
        solver, module, wrapper, monkeypatch):
    """A split kernel that fails to build or launch raises KernelError on
    the partitioned solve: it leaves the cycle, and no rung (the
    ``batch-single`` rung, ``batch-cpu``, greedy) answers in its place."""
    from kubernetes_tpu_torch.kernels import KernelError

    def broken(*a, **k):
        raise KernelError(f"injected: {wrapper} failed to launch")

    # the kernel route, on which the split kernels launch (the card's
    # default; on CPU tensors KTPU_PALLAS=1 asks for it)
    monkeypatch.setenv("KTPU_PALLAS", "1")
    s = _pref_scheduler(4, solver, monkeypatch)
    monkeypatch.setattr(module, wrapper, broken)
    with pytest.raises(KernelError, match=wrapper):
        s.schedule_cycle()
    assert dict(s.metrics.solver_fallbacks._values) == {}


# ---------------------------------------------------------------------------
# The distinct-card code path, on one device: every copy is a no-op, the
# rest (blocks uploaded apart, the owning block's delta scatter, the
# Python round loop with its counted reads) runs as on several cards
# ---------------------------------------------------------------------------


@pytest.fixture
def distinct_cards(monkeypatch):
    """A mesh of copies of the CPU device taken as distinct cards: every
    placement copies, as a copy to another card does."""
    monkeypatch.setattr(tmesh.Mesh, "logical",
                        property(lambda self: False))
    monkeypatch.setattr(tmesh, "_to", lambda t, dev: None if t is None
                        else t.to(dev).clone())
    monkeypatch.setattr(tmesh, "local_devices",
                        lambda kind="cuda": [CPU] * 8)


def _steady_cycles(mesh):
    from kubernetes_tpu_torch.config import ParallelConfig
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.testing import make_node, make_pod

    s = Scheduler(device="cpu", enable_preemption=False,
                  parallel=ParallelConfig(mesh=mesh) if mesh else None)
    for i in range(32):
        s.on_node_add(make_node(f"node-{i}", cpu_milli=4000 + 500 * (i % 3),
                                pods=32, zone=f"z{i % 4}"))
    out = []
    for c in range(3):
        for i in range(6):
            s.on_pod_add(make_pod(f"p{c}-{i}", cpu_milli=100 + 50 * i))
        r = s.schedule_cycle()
        out.append((r.assignments, r.rounds, r.snapshot_mode))
    return s, out


@pytest.mark.parametrize("d", [2, 4])
def test_distinct_card_path_places_as_the_mesh_off_solve(d, distinct_cards):
    from kubernetes_tpu_torch.ops import device_loop

    off, want = _steady_cycles(None)
    device_loop.KEYS.clear()
    coll.STATS.reset()
    s, got = _steady_cycles(d)
    assert got == want
    assert [m for _a, _r, m in got] == ["full", "delta", "delta"]
    # one graph cannot span cards: the partitioned rounds took the Python
    # loop, which registers no graph key
    assert not any(k[2] and k[2][0] == "sharded" for k in device_loop.KEYS)
    s.cache.device_snapshot()  # the last cycle's binds, scattered
    placed = s.cache.placed_table
    assert placed is not None and len(placed.blocks) == d
    # no whole table on the first card: the placement is the resident
    # table, and no cycle gathered one
    assert placed.whole is None
    assert s.cache.placed_table is s.cache.device_snapshot()[1]
    assert coll.STATS.by_op.get("gather_nodes", 0) == 0
    flat = off.cache.device_snapshot()[1]
    ptrs = {blk.requested.data_ptr() for blk in placed.blocks}
    assert len(ptrs) == d
    for i, blk in enumerate(placed.blocks):
        # blocks of their own (uploaded apart, scattered apart), holding
        # the mesh-off table's rows after the deltas
        for f, a, b in zip(type(blk)._fields, blk, flat):
            want_rows = b if f == "zone_valid" else b.chunk(d, 0)[i]
            assert torch.equal(a, want_rows), f


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _cycle_view(r):
    """What a mesh cycle must keep of its mesh-off twin's cycle."""
    return (r.assignments, r.failure_reasons, r.fit_errors, r.rounds,
            r.preempted, r.nominations, r.host_syncs, r.solver_tier,
            r.solve_scope,
            None if r.explain is None else (
                r.explain.to_json(),
                {k: pe.to_json() for k, pe in r.explain.pods.items()}))


def _burst_script(mesh):
    """The preempt-burst cell shrunk to 64 nodes (preemption on, a PDB
    guarding every 10th bound pod): wave 1 binds and leaves its
    preemptors unplaced, preemption nominates, the poachers are held off
    by pass A (the nominated phantoms), leave, and the preemptors bind;
    then a steady sparse-route pair on another scheduler (the partitioned
    cold solve, then the restricted one). Returns the cycles' views and
    the victims deleted, and the two schedulers."""
    from kubernetes_tpu_torch.config import IncrementalConfig, ParallelConfig
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.testing import make_node, make_pod
    from torch_parity import preempt_burst_cluster, to_port

    nodes, bound, wave1, poachers, pdb = to_port(preempt_burst_cluster(5))
    victims = []
    clk = _Clock()
    par = ParallelConfig(mesh=mesh) if mesh else None
    s = Scheduler(device="cpu", clock=clk, max_preemptions_per_cycle=4,
                  pdb_lister=lambda: [pdb],
                  victim_deleter=lambda p: victims.append(p.key()),
                  parallel=par)
    for nd in nodes:
        s.on_node_add(nd)
    for p in bound + wave1:
        s.on_pod_add(p)
    out = [_cycle_view(s.schedule_cycle())]
    clk.t += 0.5
    for p in poachers:
        s.on_pod_add(p)
    out.append(_cycle_view(s.schedule_cycle()))
    for p in poachers:
        s.on_pod_delete(p)
    for _ in range(3):
        clk.t += 11.0
        out.append(_cycle_view(s.schedule_cycle()))
    sp = Scheduler(device="cpu", clock=_Clock(), enable_preemption=False,
                   incremental=IncrementalConfig(enabled=True, primary=True,
                                                 candidate_bucket=8),
                   parallel=par)
    for i in range(64):
        sp.on_node_add(make_node(f"node-{i}",
                                 cpu_milli=(4000 if i % 2 else 8000),
                                 pods=32, zone=f"z{i % 4}"))
    for c in range(2):
        for i in range(4):
            sp.on_pod_add(make_pod(f"c{c}-{i}", cpu_milli=300 + 100 * i))
        out.append(_cycle_view(sp.schedule_cycle()))
    return out, victims, s, sp


@pytest.mark.parametrize("d", [2, 4])
def test_distinct_cards_hold_no_whole_table_and_cycle_as_mesh_off(
        d, distinct_cards):
    """On distinct cards a mesh cycle keeps no whole node table on the
    first card and gathers none: the failure pass, explain, the
    preemption rows, pass A, the validation, the usage and the sparse
    routes' candidate pick all run per shard, and give the mesh-off
    scheduler's assignments, explain reports, victims, nominations and
    host syncs."""
    want, want_victims, *_ = _burst_script(None)
    coll.STATS.reset()
    got, got_victims, s, sp = _burst_script(d)
    assert got == want
    assert got_victims == want_victims and got_victims
    assert any(v[5] for v in got)  # preemption nominated
    assert [v[8] for v in got[-2:]] == ["partitioned", "restricted"]
    assert coll.STATS.by_op.get("gather_nodes", 0) == 0
    for sched in (s, sp):
        resident = sched.cache.device_snapshot()[1]
        placed = sched.cache.placed_table
        assert placed is resident and placed.whole is None


@pytest.mark.parametrize("pack", ["consolidation", "gang-topology"])
def test_distinct_cards_scenario_pack_runs_per_shard(pack, distinct_cards):
    """A scenario pack's cost term and the quality reduction run per
    shard on distinct cards: the mesh-off scheduler's placements and
    quality counts (its fractions within rtol 1e-5, atol 1e-6: the node
    sums merge per shard), and no whole-table gather."""
    from kubernetes_tpu_torch.config import ParallelConfig, ScenarioConfig
    from kubernetes_tpu_torch.models.cluster import make_gang_pods
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.testing import make_node, make_pod

    def drive(mesh):
        s = Scheduler(device="cpu", clock=_Clock(), enable_preemption=False,
                      scenario=ScenarioConfig(pack=pack, quality=True),
                      parallel=ParallelConfig(mesh=mesh) if mesh else None)
        for i in range(24):
            s.on_node_add(make_node(f"node-{i}", cpu_milli=4000, pods=16,
                                    zone=f"z{i % 4}"))
        pods = ([make_pod(f"p{i}", cpu_milli=300 + 100 * (i % 4))
                 for i in range(20)] if pack == "consolidation"
                else make_gang_pods(3, 4, name_prefix="g"))
        out = []
        for c in range(2):
            for p in pods:
                s.on_pod_add(dataclasses.replace(p, name=f"{p.name}-{c}"))
            r = s.schedule_cycle()
            out.append((r.assignments, r.rounds, r.scenario_quality))
        return out

    want = drive(None)
    coll.STATS.reset()
    got = drive(2)
    assert coll.STATS.by_op.get("gather_nodes", 0) == 0
    for (ga, gr, gq), (wa, wr, wq) in zip(got, want):
        assert (ga, gr) == (wa, wr)
        assert ga and gq.keys() == wq.keys()
        np.testing.assert_allclose([gq[k] for k in sorted(gq)],
                                   [wq[k] for k in sorted(wq)],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("d", [2, 4])
def test_distinct_cards_batch_single_rung_gathers_once(d, distinct_cards):
    """The ``batch-single`` rung re-pins the cycle onto the first card:
    it takes the one whole-table gather of the cycle, and the cycle binds
    as the mesh-off ladder's does."""
    from kubernetes_tpu_torch.config import ParallelConfig
    from kubernetes_tpu_torch.faults import FaultInjector
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.testing import make_node, make_pod

    fi = FaultInjector(seed=0).arm("solve:batch", "device_lost")
    s = Scheduler(device="cpu", clock=_Clock(), enable_preemption=False,
                  fault_injector=fi, parallel=ParallelConfig(mesh=d))
    for i in range(8):
        s.on_node_add(make_node(f"n{i}", cpu_milli=1000, pods=4))
    for i in range(16):
        s.on_pod_add(make_pod(f"p{i}", cpu_milli=600 + 200 * (i % 3)))
    coll.STATS.reset()
    r = s.schedule_cycle()
    assert r.solver_tier == "batch-single"
    assert coll.STATS.by_op.get("gather_nodes", 0) == 1
    assert r.scheduled and r.unschedulable  # the failure pass ran too
    assert s.cache.placed_table.whole is None


@pytest.mark.parametrize("d", [2, 4])
def test_distinct_cards_exact_solver_gathers_once_per_cycle(
        d, distinct_cards):
    """The exact tier re-pins the cycle onto the first card: its shared
    filter pass runs per shard and its mask is gathered whole beside the
    table (one ``gather_nodes`` a cycle); the cycles bind, fail and
    explain as the mesh-off scheduler's."""
    from kubernetes_tpu_torch.config import ParallelConfig
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.testing import make_node, make_pod

    def drive(mesh):
        s = Scheduler(device="cpu", clock=_Clock(), enable_preemption=False,
                      solver="exact",
                      parallel=ParallelConfig(mesh=mesh) if mesh else None)
        for i in range(12):
            s.on_node_add(make_node(f"n{i}", cpu_milli=2000 + 1000 * (i % 3),
                                    pods=8, zone=f"z{i % 4}"))
        out, gathers = [], []
        for c in range(2):
            for i in range(10):
                # every fifth pod fits no node
                cpu = 9000 if i % 5 == 4 else 300 + 200 * (i % 4)
                s.on_pod_add(make_pod(f"p{c}-{i}", cpu_milli=cpu))
            coll.STATS.reset()
            r = s.schedule_cycle()
            gathers.append(coll.STATS.by_op.get("gather_nodes", 0))
            out.append(_cycle_view(r))
        return out, gathers, s

    want, _g, _s = drive(None)
    got, gathers, s = drive(d)
    assert got == want
    assert [v[7] for v in got] == ["exact", "exact"]
    assert all(v[0] for v in got) and all(v[1] for v in got)
    assert gathers == [1, 1]
    assert s.cache.placed_table.whole is None


@pytest.mark.parametrize("d", WIDTHS)
def test_partitioned_solve_splits_the_pod_by_node_inputs(d):
    """A plugin's (P, N) mask and score and the static volume reasons go
    to the shards as column blocks: the partitioned solve places as the
    unsharded one, with them and on the volume case."""
    dp, dn, ds, _dt, _dv = _case("batch")
    tp, tn, ts_ = port_table(dp), port_table(dn), port_table(ds)
    g = np.random.default_rng(d)
    P, N = tp.valid.shape[0], tn.valid.shape[0]
    kw = dict(extra_mask=torch.tensor(g.uniform(size=(P, N)) > 0.2),
              extra_score=torch.tensor(g.integers(0, 5, (P, N))
                                       .astype(np.float32)),
              per_node_cap=2)
    flat = tbatch_assign(tp, tn, ts_, **kw)
    got = tbatch_assign(*tmesh.shard_cluster(tp, tn, ts_, tmesh_of(d)),
                        **kw)
    assert got[0].tolist() == flat[0].tolist()
    assert int(got[2]) == int(flat[2])
    vp, vn, vs, _vt, vv = (_port(t) for t in _case("volumes"))
    sv = torch.zeros((vp.valid.shape[0], vn.valid.shape[0]),
                     dtype=torch.int32)
    sv[::3, ::5] = 1  # a static reason on a lattice of pairs
    flat = tbatch_assign(vp, vn, vs, vol=vv, static_vol=sv)
    got = tbatch_assign(*tmesh.shard_cluster(vp, vn, vs, tmesh_of(d)),
                        vol=tmesh.replicate(vv, tmesh_of(d)), static_vol=sv)
    assert got[0].tolist() == flat[0].tolist()
    assert int(got[2]) == int(flat[2])


@pytest.mark.parametrize("d", [2, 4])
def test_custom_priority_kernel_sees_the_whole_table_on_a_mesh(d,
                                                               monkeypatch):
    """A registered (non-stock) priority kernel may reduce over the node
    axis: on a mesh it runs on the whole table and the whole mask,
    gathered across shards, and keeps its block's columns, so placements
    equal the unsharded solve's."""
    import kubernetes_tpu_torch.ops.priorities as tpr

    def spread_by_row_max(pods, nodes, sel, topo, mask):
        free = (nodes.allocatable - nodes.requested)[:, 0]
        row = torch.where(mask, free[None, :], 0.0)
        mx = row.amax(1, keepdim=True).clamp_min(1.0)
        return torch.floor(10.0 * row / mx)

    monkeypatch.setitem(tpr.PRIORITY_REGISTRY, "RowMaxFree",
                        spread_by_row_max)
    weights = {"LeastRequestedPriority": 1, "RowMaxFree": 2}
    dp, dn, ds, _dt, _dv = _case("sinkhorn")
    tp, tn, ts_ = port_table(dp), port_table(dn), port_table(ds)
    flat = tbatch_assign(tp, tn, ts_, weights, per_node_cap=2)
    coll.STATS.reset()
    got = tbatch_assign(*tmesh.shard_cluster(tp, tn, ts_, tmesh_of(d)),
                        weights, per_node_cap=2)
    assert coll.STATS.by_op.get("cat", 0) > 0
    assert got[0].tolist() == flat[0].tolist()
    assert int(got[2]) == int(flat[2])
