"""The port's solvers against the JAX package's, on the parity grids of
tests/test_fused_validate.py: ``batch_assign`` (lean and general rounds,
the transport-plan route), ``greedy_assign`` and the validators give
bit-identical placements, usage, round counts and verdict codes."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.ops.assign as ja
import kubernetes_tpu.ops.predicates as jpred
import kubernetes_tpu.ops.priorities as jprio
import kubernetes_tpu_torch.ops.assign as ta
from kubernetes_tpu.ops.arrays import nodes_to_device
from kubernetes_tpu.testing import make_node, make_pod
from test_fused_validate import _corruptions
from test_predicates import random_cluster
from torch_parity import (
    jax_tables,
    port_tables,
    pref_affinity_cluster,
    random_volume_cluster,
    resource_batch,
)


def _same(j_out, t_out):
    ja_, ju, jr = j_out[:3]
    ta_, tu, tr = t_out[:3]
    np.testing.assert_array_equal(ta_.numpy(), np.asarray(ja_))
    np.testing.assert_array_equal(tu.requested.numpy(),
                                  np.asarray(ju.requested))
    np.testing.assert_array_equal(tu.nonzero_req.numpy(),
                                  np.asarray(ju.nonzero_req))
    np.testing.assert_array_equal(tu.port_any.numpy(),
                                  np.asarray(ju.port_any))
    assert int(jr) == int(tr)


def _gates(nt, pt):
    skip, no_ports, no_aff, no_spread = jprio.solver_gates(nt, pt)
    return dict(skip_priorities=skip, no_ports=no_ports,
                no_pod_affinity=no_aff, no_spread=no_spread)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("cap", [1, 4])
def test_batch_assign_general_round_matches(seed, cap):
    rng = random.Random(800 + seed)
    nodes, scheduled, pending = random_cluster(rng, n_nodes=10, n_sched=12,
                                               n_pending=24)
    jdn, jdp, jds, _dv, nt, pt, _pk = jax_tables(nodes, scheduled, pending)
    dn, dp, ds, _ = port_tables(jdn, jdp, jds)
    kw = dict(per_node_cap=cap, **_gates(nt, pt))
    _same(ja.batch_assign(jdp, jdn, jds, **kw),
          ta.batch_assign(dp, dn, ds, **kw))
    # with the gates off every kernel and the port guard run in full
    _same(ja.batch_assign(jdp, jdn, jds, per_node_cap=cap),
          ta.batch_assign(dp, dn, ds, per_node_cap=cap))


@pytest.mark.parametrize("seed", range(3))
def test_batch_assign_preferred_affinity_matches(seed):
    nodes, bound, pending = pref_affinity_cluster(
        900 + seed, n_nodes=40, n_bound=60, n_pending=300)
    jdn, jdp, jds, _dv, nt, pt, _pk = jax_tables(nodes, bound, pending)
    dn, dp, ds, _ = port_tables(jdn, jdp, jds)
    kw = dict(per_node_cap=4, max_rounds=128, **_gates(nt, pt))
    for extra in ({}, {"use_sinkhorn": True}, {"auto_sinkhorn": False}):
        _same(ja.batch_assign(jdp, jdn, jds, **kw, **extra),
              ta.batch_assign(dp, dn, ds, **kw, **extra))


@pytest.mark.parametrize("seed", range(3))
def test_batch_assign_with_volumes_matches(seed):
    cluster = random_volume_cluster(1000 + seed)
    jdn, jdp, jds, jdv, nt, pt, _pk = jax_tables(*cluster, volumes=True)
    dn, dp, ds, dv = port_tables(jdn, jdp, jds, jdv)
    jsv = jpred.static_volume_reasons(jdp, jdn, jds, jdv)
    import kubernetes_tpu_torch.ops.predicates as tpred

    tsv = tpred.static_volume_reasons(dp, dn, ds, dv)
    _same(ja.batch_assign(jdp, jdn, jds, vol=jdv, static_vol=jsv,
                          per_node_cap=2),
          ta.batch_assign(dp, dn, ds, vol=dv, static_vol=tsv,
                          per_node_cap=2))


@pytest.mark.parametrize("seed", range(4))
def test_greedy_assign_matches(seed):
    rng = random.Random(1100 + seed)
    nodes, scheduled, pending = random_cluster(rng, n_nodes=8, n_sched=10,
                                               n_pending=14)
    jdn, jdp, jds, _dv, nt, pt, _pk = jax_tables(nodes, scheduled, pending)
    dn, dp, ds, _ = port_tables(jdn, jdp, jds)
    ja_, ju = ja.greedy_assign(jdp, jdn, jds, **_gates(nt, pt))
    ta_, tu = ta.greedy_assign(dp, dn, ds, **_gates(nt, pt))
    np.testing.assert_array_equal(ta_.numpy(), np.asarray(ja_))
    np.testing.assert_array_equal(tu.requested.numpy(),
                                  np.asarray(ju.requested))


@pytest.mark.parametrize("cap,n_nodes,n_pods", [
    (8, 16, 40),     # uncontended, one round
    (1, 4, 48),      # windowed (P > N*cap), many rounds
    (4, 3, 30),      # contended, capacity binds
])
def test_lean_round_matches_general_and_reference(cap, n_nodes, n_pods):
    for seed in range(3):
        rng = random.Random(700 + seed)
        nodes = [make_node(f"n{i}", cpu_milli=4000, memory=8192 * 2**20)
                 for i in range(n_nodes)]
        pending = resource_batch(rng, n_pods)
        jdn, jdp, jds, _dv, nt, pt, _pk = jax_tables(nodes, [], pending)
        dn, dp, ds, _ = port_tables(jdn, jdp, jds)
        kw = dict(per_node_cap=cap, **_gates(nt, pt))
        lean = ta.batch_assign(dp, dn, ds, **kw)
        ones = torch.ones((dp.valid.shape[0], dn.valid.shape[0]),
                          dtype=torch.bool)
        general = ta.batch_assign(dp, dn, ds, extra_mask=ones, **kw)
        _same(lean, general)
        _same(ja.batch_assign(jdp, jdn, jds, **kw), lean)


def test_non_bucketed_node_axis_matches():
    from kubernetes_tpu.snapshot import SnapshotPacker

    rng = random.Random(11)
    nodes = [make_node(f"n{i}", cpu_milli=2000) for i in range(90)]
    pending = resource_batch(rng, 30)
    pk = SnapshotPacker()
    for p in pending:
        pk.intern_pod(p)
    nt = pk.pack_nodes(nodes, [])
    jdn = nodes_to_device(nt, pad_to=96)  # 96 % 64 != 0
    _dn, jdp, jds, _dv, _nt, pt, _pk = jax_tables(nodes, [], pending)
    dn, dp, ds, _ = port_tables(jdn, jdp, jds)
    kw = dict(per_node_cap=4, **_gates(nt, pt))
    want = ja.batch_assign(jdp, jdn, jds, **kw)
    _same(want, ta.batch_assign(dp, dn, ds, **kw))
    ones = torch.ones((dp.valid.shape[0], 96), dtype=torch.bool)
    _same(want, ta.batch_assign(dp, dn, ds, extra_mask=ones, **kw))


def test_lean_round_respects_predicate_mask():
    rng = random.Random(7)
    nodes = [make_node(f"n{i}", cpu_milli=500) for i in range(3)]
    pending = resource_batch(rng, 24)
    jdn, jdp, jds, _dv, nt, pt, _pk = jax_tables(nodes, [], pending)
    dn, dp, ds, _ = port_tables(jdn, jdp, jds)
    em = ~(1 << jpred.BIT["PodFitsResources"]) & ((1 << 18) - 1)
    kw = dict(per_node_cap=4, enabled_mask=em, **_gates(nt, pt))
    got = ta.batch_assign(dp, dn, ds, **kw)
    _same(ja.batch_assign(jdp, jdn, jds, **kw), got)
    assert int((got[0] >= 0).sum()) == 24  # capacity really was bypassed


def _verdicts(a, ju, tu, jdp, jdn, dp, dn, em=None):
    jcode = ja.device_validate(a, ju, jdp, jdn, em)
    tcode = ta.device_validate(a, tu, dp, dn, em)
    assert (jcode is None) == (tcode is None)
    if jcode is not None:
        assert int(tcode[0]) == int(jcode[0])
        assert int(tcode[1]) == int(jcode[1])
    assert (ta.validate_solution(a, tu, dp, dn, em)
            == ja.validate_solution(a, ju, jdp, jdn, em))


@pytest.mark.parametrize("seed", range(4))
def test_validators_match(seed):
    rng = random.Random(900 + seed)
    nodes, scheduled, pending = random_cluster(rng, n_nodes=6, n_sched=8,
                                               n_pending=12)
    jdn, jdp, jds, _dv, nt, _pt, _pk = jax_tables(nodes, scheduled, pending)
    dn, dp, ds, _ = port_tables(jdn, jdp, jds)
    a_j, ju, _ = ja.batch_assign(jdp, jdn, jds)
    a_t, tu, _ = ta.batch_assign(dp, dn, ds)
    a = np.asarray(a_j)
    np.testing.assert_array_equal(a_t.numpy(), a)
    for _tag, bad in _corruptions(rng, a, jdn.valid.shape[0], nt.n):
        _verdicts(bad, ju, tu, jdp, jdn, dp, dn)
    bad_ju = ju._replace(requested=ju.requested.at[0, 0].set(jnp.nan))
    bad_tu = tu._replace(requested=tu.requested.clone())
    bad_tu.requested[0, 0] = float("nan")
    _verdicts(a, bad_ju, bad_tu, jdp, jdn, dp, dn)


def test_validator_respects_resource_policy_bypass():
    nodes = [make_node(f"n{i}", cpu_milli=1000) for i in range(3)]
    pending = [make_pod(f"p{i}", cpu_milli=900) for i in range(9)]
    jdn, jdp, jds, _dv, *_ = jax_tables(nodes, [], pending)
    dn, dp, _ds, _ = port_tables(jdn, jdp, jds)
    herd = np.zeros((jdp.valid.shape[0],), np.int32)
    ju = ja._apply_batch(ja.usage_from_nodes(jdn), jdp, jnp.asarray(herd),
                         jnp.asarray(np.ones_like(herd, bool)) & jdp.valid)
    tu = ta._apply_batch(ta.usage_from_nodes(dn), dp,
                         torch.from_numpy(herd), dp.valid.clone())
    np.testing.assert_array_equal(tu.requested.numpy(),
                                  np.asarray(ju.requested))
    em = ~(1 << jpred.BIT["PodFitsResources"]) & ((1 << 18) - 1)
    for mask in (None, em):
        _verdicts(herd, ju, tu, jdp, jdn, dp, dn, mask)
    assert ta.VALIDATE_REASONS == ja.VALIDATE_REASONS
