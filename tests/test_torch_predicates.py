"""The port's Filter pass against the JAX package's: on seeded clusters
with taints, required and preferred node affinity, node selectors, host
ports, node conditions, volumes, inter-pod affinity and topology spread,
the reason bitmasks (and therefore the feasibility masks) are equal bit
for bit; so are the failure reductions behind the FitError text."""

import random

import numpy as np
import pytest
import torch

import kubernetes_tpu.ops.predicates as jp
import kubernetes_tpu.ops.priorities as jprio
import kubernetes_tpu_torch.ops.predicates as tp
from kubernetes_tpu.obs.explain import explain_reduce
from kubernetes_tpu.snapshot import FIXED_RESOURCE_NAMES
from test_predicates import random_cluster
from test_topology import random_affinity_cluster, random_spread_cluster
from torch_parity import (
    jax_tables,
    jax_topo_tables,
    port_tables,
    port_topo_tables,
    random_volume_cluster,
    topo_mixed_cluster,
)


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


def _topology_cluster(case):
    if case < 3:
        return random_affinity_cluster(random.Random(150 + case))
    if case < 6:
        return random_spread_cluster(random.Random(160 + case))
    return topo_mixed_cluster(170 + case, n_nodes=16, n_bound=8,
                              n_pending=30)


@pytest.mark.parametrize("case", range(8))
def test_topology_reason_bits_match(case):
    """MatchInterPodAffinity and EvenPodsSpread bits, with the batch gates
    on and off: equal bit for bit, and the gates exact where they hold."""
    nodes, scheduled, pending = _topology_cluster(case)
    jdn, jdp, jds, jdt, nt, pt, _pk = jax_topo_tables(nodes, scheduled,
                                                      pending)
    dn, dp, ds, dt = port_topo_tables(jdn, jdp, jds, jdt)
    jr = jp.run_predicates(jdp, jdn, jds, jdt)
    tr = tp.run_predicates(dp, dn, ds, dt)
    _eq(jr.reasons, tr.reasons)
    _eq(jr.mask, tr.mask)
    if case < 6:  # the seeded clusters hold bound pods the terms see
        assert (tr.reasons & ((1 << tp.BIT["MatchInterPodAffinity"])
                              | (1 << tp.BIT["EvenPodsSpread"]))).any()
    _skip, _ports, no_aff, no_spread = jprio.solver_gates(nt, pt)
    for gates in ({}, dict(no_pod_affinity=no_aff, no_spread=no_spread)):
        _eq(jp.run_predicates(jdp, jdn, jds, jdt, **gates).reasons,
            tp.run_predicates(dp, dn, ds, dt, **gates).reasons)
    if no_aff or no_spread:
        gated = tp.run_predicates(dp, dn, ds, dt, no_pod_affinity=no_aff,
                                  no_spread=no_spread)
        _eq(jr.reasons, gated.reasons)


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


@pytest.mark.parametrize("seed", range(4))
def test_fit_error_message_matches_the_reference(seed):
    """The raw-row FitError builder (``fit_error_message``, the
    reference's ``ops/predicates.py:90``) on the port's reason rows gives
    the reference's text on its own rows, and the text the device
    reductions give (``fit_error_message_from_counts``)."""
    rng = random.Random(500 + seed)
    nodes, scheduled, pending = random_cluster(rng, n_nodes=9, n_sched=8,
                                               n_pending=12)
    jdn, jdp, jds, _dv, nt, pt, pk = jax_tables(nodes, scheduled, pending)
    dn, dp, ds, _ = port_tables(jdn, jdp, jds)
    jr = jp.run_predicates(jdp, jdn, jds)
    tr = tp.run_predicates(dp, dn, ds)
    res_names = (list(FIXED_RESOURCE_NAMES)
                 + pk.u.scalar_resources.items())[: pt.req.shape[1]]
    jfree = np.asarray(jdn.allocatable - jdn.requested)
    tfree = (dn.allocatable - dn.requested).numpy()
    counts = tp.failure_counts(tr.reasons, dn.valid, dp.req,
                               dn.allocatable - dn.requested, dn.ready,
                               dn.network_unavailable)
    for i in range(len(pending)):
        want = jp.fit_error_message(
            np.asarray(jr.reasons)[i], np.asarray(jdn.valid), pt.req[i],
            jfree, np.asarray(jdn.ready), np.asarray(jdn.network_unavailable),
            res_names)
        got = tp.fit_error_message(
            tr.reasons[i].numpy(), dn.valid.numpy(), pt.req[i], tfree,
            dn.ready.numpy(), dn.network_unavailable.numpy(), res_names)
        assert got == want
        if int(counts["bits"][i]):
            assert got == tp.fit_error_message_from_counts(
                counts["per_reason"][i].numpy(),
                counts["insufficient"][i].numpy(),
                int(counts["not_ready"][i]), int(counts["net_unavail"][i]),
                nt.n, pt.req[i], res_names)


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
