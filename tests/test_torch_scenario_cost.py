"""The port's scenario cost terms and quality reduction
(``kubernetes_tpu_torch/ops/scenario_cost.py``) against the JAX
package's (``kubernetes_tpu/ops/scenario_cost.py``, plain ``jnp``) on the
same seeded tables: ``slice_distance`` (unlabeled ``-1`` zones
included), ``consolidation_bias`` and ``gang_topology_score`` must be
bit-identical; ``quality_reduce``'s three counts must be exact and its
four fractions within ``rtol=1e-5, atol=1e-6`` (f32 sums in another
order than XLA's). ``quality_reduce`` must also be capturable: no host
read, no data-dependent shape, no host data brought in."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.ops.scenario_cost as jsc
import kubernetes_tpu.scenarios.quality as jq
import kubernetes_tpu_torch.ops.scenario_cost as tsc
import kubernetes_tpu_torch.scenarios.quality as tq
from kubernetes_tpu.testing import make_node, make_pod
from test_torch_pipeline import _HostReads
from torch_parity import jax_tables, port_tables

#: the quality vector's fractions: f32 sums in another order than XLA's
Q_RTOL, Q_ATOL = 1e-5, 1e-6
COUNTS = ("nodes_used", "nodes_used_batch", "placed")


def _bits(x) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(x, np.float32))
    return a.view(np.int32)


def _cluster(seed: int, n_nodes: int = 40, n_bound: int = 30,
             n_pending: int = 23, n_zones: int = 7):
    """Seeded nodes over ``n_zones`` zones (every 5th node unlabeled, so
    its zone id is -1), bound pods on a random subset, pending pods with
    mixed priorities."""
    rng = random.Random(seed)
    nodes = [make_node(f"n{i}", cpu_milli=rng.choice([2000, 4000, 8000]),
                       memory=rng.choice([4, 8, 16]) * 2**30, pods=110,
                       zone=(None if i % 5 == 4
                             else f"z{rng.randrange(n_zones)}"))
             for i in range(n_nodes)]
    bound = [make_pod(f"b{i}", cpu_milli=rng.choice([100, 500, 1000]),
                      memory=rng.choice([1, 2]) * 2**28,
                      node_name=f"n{rng.randrange(n_nodes)}")
             for i in range(n_bound)]
    pending = [make_pod(f"p{i}", cpu_milli=rng.choice([100, 300, 700]),
                        memory=2**28, priority=rng.choice([0, 10, 100]))
               for i in range(n_pending)]
    return nodes, bound, pending


def _tables(seed):
    nodes, bound, pending = _cluster(seed)
    jdn, jdp, jds, _dv, nt, _pt, _pk = jax_tables(nodes, bound, pending)
    dn, dp, _ds, _ = port_tables(jdn, jdp, jds)
    return jdn, jdp, dn, dp, nt, len(pending)


def test_slice_distance_bit_identical():
    grid = np.arange(-1, 12, dtype=np.int32)
    for sp in (0, 1, 2, 3, 4, 8):
        want = np.asarray(jsc.slice_distance(
            jnp.asarray(grid)[:, None], jnp.asarray(grid)[None, :],
            superpod=sp))
        t = torch.from_numpy(grid)
        got = tsc.slice_distance(t[:, None], t[None, :], superpod=sp)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), sp
        # the host twin the gang scores use
        assert np.array_equal(
            tq.slice_distance_host(grid[:, None], grid[None, :], sp), want)
        assert np.array_equal(
            tq.slice_distance_host(grid[:, None], grid[None, :], sp),
            jq.slice_distance_host(grid[:, None], grid[None, :], sp))
    # unlabeled is fabric even against itself
    m1 = torch.tensor([-1], dtype=torch.int32)
    assert tsc.slice_distance(m1, m1).tolist() == [2]


@pytest.mark.parametrize("fill_block", [1, 64])
@pytest.mark.parametrize("seed", [1, 2])
def test_consolidation_bias_bit_identical(seed, fill_block):
    jdn, jdp, dn, dp, _nt, _n = _tables(seed)
    for w in (10.0, 0.0, 3.7):
        want = jsc.consolidation_bias(jdp.valid, jdn, jnp.float32(w),
                                      fill_block=fill_block)
        got = tsc.consolidation_bias(dp.valid, dn,
                                     torch.tensor(w, dtype=torch.float32),
                                     fill_block=fill_block)
        assert got.dtype == torch.float32
        assert got.shape == tuple(want.shape)
        assert np.array_equal(_bits(got.numpy()), _bits(want)), w


@pytest.mark.parametrize("superpod", [1, 2, 4])
@pytest.mark.parametrize("seed", [1, 2])
def test_gang_topology_score_bit_identical(seed, superpod):
    jdn, jdp, dn, dp, _nt, n = _tables(seed)
    rng = np.random.RandomState(seed)
    P = dp.valid.shape[0]
    home = rng.randint(-1, 9, size=P).astype(np.int32)
    home[n:] = -1
    for w in (5.0, 1.25):
        want = jsc.gang_topology_score(jnp.asarray(home), jdn,
                                       jnp.float32(w), superpod=superpod)
        got = tsc.gang_topology_score(torch.from_numpy(home), dn,
                                      torch.tensor(w, dtype=torch.float32),
                                      superpod=superpod)
        assert np.array_equal(_bits(got.numpy()), _bits(want)), w


def _assignment(rng, P, n_nodes, n, place_frac):
    a = np.where(rng.rand(P) < place_frac, rng.randint(0, n_nodes, size=P),
                 -1).astype(np.int32)
    a[n:] = -1
    return a


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_quality_reduce_parity(seed):
    jdn, jdp, dn, dp, nt, n = _tables(10 + seed)
    rng = np.random.RandomState(seed)
    P = dp.valid.shape[0]
    # seed 3 places nothing: the min-priority guard's empty case
    assigned = _assignment(rng, P, nt.n, n, 0.0 if seed == 3 else 0.7)
    usage = np.asarray(jdn.requested).copy()
    sel = (assigned >= 0) & np.asarray(jdp.valid)
    np.add.at(usage, assigned[sel], np.asarray(jdp.req)[sel])
    want = np.asarray(jsc.quality_reduce(jnp.asarray(assigned),
                                         jnp.asarray(usage), jdp, jdn))
    got = tsc.quality_reduce(torch.from_numpy(assigned),
                             torch.from_numpy(usage), dp, dn)
    assert got.dtype == torch.float32 and got.shape == (7,)
    got = got.numpy()
    for i, name in enumerate(tsc.QUALITY_FIELDS):
        if name in COUNTS:
            assert got[i] == want[i], (name, got[i], want[i])
        else:
            np.testing.assert_allclose(got[i], want[i], rtol=Q_RTOL,
                                       atol=Q_ATOL, err_msg=name)
    # the decode rounds the fractions to 4 places: equal dicts unless a
    # fraction sits on a rounding edge
    dj, dt = jq.decode_quality(want), tq.decode_quality(got)
    for k in COUNTS:
        assert dt[k] == dj[k]
    assert set(dt) == set(dj) == set(tsc.QUALITY_FIELDS)


def test_quality_reduce_is_capturable():
    _jdn, _jdp, dn, dp, nt, n = _tables(5)
    rng = np.random.RandomState(5)
    assigned = torch.from_numpy(_assignment(rng, dp.valid.shape[0], nt.n, n,
                                            0.7))
    w = torch.tensor(2.0)
    with _HostReads() as mode:
        tsc.quality_reduce(assigned, dn.requested, dp, dn)
        tsc.consolidation_bias(dp.valid, dn, w, 64)
        tsc.gang_topology_score(torch.zeros_like(assigned), dn, w, 4)
    assert mode.bad == []


def test_fields_and_host_helpers_match_reference():
    assert tsc.QUALITY_FIELDS == jsc.QUALITY_FIELDS
    rng = np.random.RandomState(3)
    batch = [make_pod(f"g{i}", cpu_milli=100, pod_group=f"grp{i % 3}",
                      pod_group_min_available=2) for i in range(9)]
    batch += [make_pod("solo", cpu_milli=100)]
    zones = rng.randint(-1, 6, size=12)
    for _ in range(5):
        assigned = rng.randint(-1, 12, size=len(batch))
        for sp in (1, 4):
            assert tq.gang_stats(batch, assigned, zones, sp) == \
                jq.gang_stats(batch, assigned, zones, sp)
        assert tq.gang_stats(batch, assigned) == jq.gang_stats(batch,
                                                               assigned)
    alloc = rng.rand(12, 4) * 4000
    req = rng.rand(12, 4) * 2000
    for assigned in (rng.randint(-1, 12, size=20), np.full(4, -1)):
        assert tq.node_resources_score(alloc, req, assigned) == \
            jq.node_resources_score(alloc, req, assigned)
