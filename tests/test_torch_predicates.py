"""The port's Filter pass against the JAX package's: on seeded clusters
with taints, required and preferred node affinity, node selectors, host
ports, node conditions and volumes, the reason bitmasks (and therefore
the feasibility masks) are equal bit for bit; so are the failure
reductions behind the FitError text."""

import random

import numpy as np
import pytest
import torch

import kubernetes_tpu.ops.predicates as jp
import kubernetes_tpu_torch.ops.predicates as tp
from kubernetes_tpu.obs.explain import explain_reduce
from kubernetes_tpu.snapshot import FIXED_RESOURCE_NAMES
from test_predicates import random_cluster
from torch_parity import jax_tables, port_tables, random_volume_cluster


def _eq(j, t):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("seed", range(6))
def test_reason_bits_match(seed):
    rng = random.Random(100 + seed)
    nodes, scheduled, pending = random_cluster(rng, n_nodes=11, n_sched=14,
                                               n_pending=13)
    jdn, jdp, jds, _dv, nt, pt, _pk = jax_tables(nodes, scheduled, pending)
    dn, dp, ds, _ = port_tables(jdn, jdp, jds)
    jr = jp.run_predicates(jdp, jdn, jds)
    tr = tp.run_predicates(dp, dn, ds)
    _eq(jr.reasons, tr.reasons)
    _eq(jr.mask, tr.mask)
    # the usage-invariant half and the selector-program table
    jh = jp.static_predicate_reasons(jdp, jdn, jds)
    th = tp.static_predicate_reasons(dp, dn, ds)
    _eq(jh[0], th[0])
    _eq(jh[1], th[1])
    _eq(jp.preferred_program_score(jds, jdn),
        tp.preferred_program_score(ds, dn))
    # a Policy that drops PodFitsResources and the taint check
    em = ((1 << 18) - 1) & ~(1 << jp.BIT["PodFitsResources"]) \
        & ~(1 << jp.BIT["PodToleratesNodeTaints"])
    _eq(jp.run_predicates(jdp, jdn, jds, enabled_mask=em).reasons,
        tp.run_predicates(dp, dn, ds, enabled_mask=em).reasons)
    # the port-free gate is exact only for port-free batches
    assert tp.pods_have_no_ports(pt) == jp.pods_have_no_ports(pt)
    if tp.pods_have_no_ports(pt):
        _eq(jr.reasons, tp.run_predicates(dp, dn, ds, no_ports=True).reasons)


@pytest.mark.parametrize("seed", range(4))
def test_volume_reason_bits_match(seed):
    cluster = random_volume_cluster(200 + seed)
    jdn, jdp, jds, jdv, *_ = jax_tables(*cluster, volumes=True)
    dn, dp, ds, dv = port_tables(jdn, jdp, jds, jdv)
    jsv = jp.static_volume_reasons(jdp, jdn, jds, jdv)
    tsv = tp.static_volume_reasons(dp, dn, ds, dv)
    _eq(jsv, tsv)
    _eq(jp.run_predicates(jdp, jdn, jds, None, jdv, jsv).reasons,
        tp.run_predicates(dp, dn, ds, None, dv, tsv).reasons)


def test_topology_tables_are_refused():
    rng = random.Random(5)
    nodes, scheduled, pending = random_cluster(rng, n_nodes=3, n_sched=2,
                                               n_pending=2)
    dn, dp, ds, _ = port_tables(*jax_tables(nodes, scheduled, pending)[:3])
    with pytest.raises(NotImplementedError, match="ROADMAP A.7"):
        tp.run_predicates(dp, dn, ds, topo=object())


@pytest.mark.parametrize("seed", range(4))
def test_failure_reductions_and_fit_error_text_match(seed):
    rng = random.Random(300 + seed)
    nodes, scheduled, pending = random_cluster(rng, n_nodes=7, n_sched=6,
                                               n_pending=10)
    jdn, jdp, jds, _dv, nt, pt, pk = jax_tables(nodes, scheduled, pending)
    dn, dp, ds, _ = port_tables(jdn, jdp, jds)
    jr = jp.run_predicates(jdp, jdn, jds)
    free = jdn.allocatable - jdn.requested
    ex = explain_reduce(jr.reasons, jdn.valid,
                        np.ones(jdp.valid.shape, bool), jdp.req, free,
                        jdn.ready, jdn.network_unavailable)
    tr = tp.run_predicates(dp, dn, ds)
    got = tp.failure_counts(tr.reasons, dn.valid, dp.req,
                            dn.allocatable - dn.requested, dn.ready,
                            dn.network_unavailable)
    _eq(ex.pod_bits, got["bits"])
    _eq(ex.per_pod, got["per_reason"])
    _eq(ex.insufficient, got["insufficient"])
    _eq(ex.not_ready, got["not_ready"])
    _eq(ex.net_unavail, got["net_unavail"])
    res_names = (list(FIXED_RESOURCE_NAMES)
                 + pk.u.scalar_resources.items())[: pt.req.shape[1]]
    for i in range(len(pending)):
        args = (np.asarray(ex.per_pod)[i], np.asarray(ex.insufficient)[i],
                np.asarray(ex.not_ready)[i], np.asarray(ex.net_unavail)[i],
                nt.n, pt.req[i], res_names)
        assert (tp.fit_error_message_from_counts(*args)
                == jp.fit_error_message_from_counts(*args))
        assert tp.decode_reasons(int(got["bits"][i])) == jp.decode_reasons(
            int(np.asarray(ex.pod_bits)[i]))


def test_resource_fit_mask_matches():
    g = np.random.default_rng(9)
    req = g.choice([0.0, 100.0, 500.0, 2000.0], size=(16, 4)).astype(
        np.float32)
    req[:, 3] = 1.0  # the pods column (RES_PODS)
    alloc = g.choice([1000.0, 4000.0], size=(8, 4)).astype(np.float32)
    used = g.choice([0.0, 900.0, 3500.0], size=(8, 4)).astype(np.float32)
    want = jp.resource_fit_mask(req, alloc, used)
    got = tp.resource_fit_mask(torch.from_numpy(req), torch.from_numpy(alloc),
                               torch.from_numpy(used))
    _eq(want, got)
