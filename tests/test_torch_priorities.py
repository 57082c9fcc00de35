"""The port's Score pass against the JAX package's: every stock kernel
and the ``run_priorities`` totals are bit-identical (hoisted or not,
gated or not, fused or not), and the fused NodeAffinity+TaintToleration
pair — the plain version of the port's CUDA kernel — equals the JAX
package's fused pair computed by its Pallas kernels (interpret mode)."""

import random

import numpy as np
import pytest
import torch

import kubernetes_tpu.ops.predicates as jpred
import kubernetes_tpu.ops.priorities as jp
import kubernetes_tpu_torch.ops.predicates as tpred
import kubernetes_tpu_torch.ops.priorities as tp
from kubernetes_tpu_torch.ops import fused_score
from test_predicates import random_cluster
from torch_parity import jax_tables, port_tables, pref_affinity_cluster

#: kernels whose output needs topology tables (not ported: ROADMAP A.7)
_TOPOLOGY = ("InterPodAffinityPriority", "EvenPodsSpreadPriority")


def _clusters():
    for seed in range(3):
        rng = random.Random(500 + seed)
        yield random_cluster(rng, n_nodes=12, n_sched=16, n_pending=14)
    for seed in range(2):
        yield pref_affinity_cluster(600 + seed, n_nodes=24, n_bound=30,
                                    n_pending=40)


def _eq(j, t):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("case", range(5))
def test_stock_kernels_and_totals_bit_identical(case):
    nodes, scheduled, pending = list(_clusters())[case]
    jdn, jdp, jds, _dv, nt, pt, _pk = jax_tables(nodes, scheduled, pending)
    dn, dp, ds, _ = port_tables(jdn, jdp, jds)
    jmask = jpred.run_predicates(jdp, jdn, jds).mask
    mask = tpred.run_predicates(dp, dn, ds).mask
    for name, fn in jp.PRIORITY_REGISTRY.items():
        if name in _TOPOLOGY:
            continue
        _eq(fn(jdp, jdn, jds, None, jmask),
            tp.PRIORITY_REGISTRY[name](dp, dn, ds, None, mask))
    weights = dict(jp.DEFAULT_WEIGHTS, MostRequestedPriority=2,
                   RequestedToCapacityRatioPriority=1,
                   ResourceLimitsPriority=3)
    skip = jp.empty_priorities(nt, pt)
    assert tp.empty_priorities(nt, pt) == skip
    assert tp.solver_gates(nt, pt) == jp.solver_gates(nt, pt)
    jh = jp.hoist_priorities(jdp, jdn, jds, weights, skip)
    th = tp.hoist_priorities(dp, dn, ds, weights, skip)
    assert set(jh) == set(th)
    for w in (None, weights):
        for sk in ((), skip):
            want = jp.run_priorities(jdp, jdn, jds, jmask, w, skip=sk)
            for hoisted in (None, th):
                for fused in (False, True):
                    got = tp.run_priorities(dp, dn, ds, mask, w, skip=sk,
                                            hoisted=hoisted, fused=fused)
                    _eq(want, got)


@pytest.mark.parametrize("weights", [(1.0, 1.0), (3.0, 2.0)])
def test_fused_pair_equals_jax_pallas_pair(monkeypatch, weights):
    nodes, scheduled, pending = pref_affinity_cluster(
        700, n_nodes=40, n_bound=20, n_pending=90)
    jdn, jdp, jds, _dv, *_ = jax_tables(nodes, scheduled, pending)
    dn, dp, ds, _ = port_tables(jdn, jdp, jds)
    jmask = jpred.run_predicates(jdp, jdn, jds).mask
    jh = jp.hoist_priorities(jdp, jdn, jds)
    raw_na = jh["NodeAffinityPriority"][1]
    raw_tt = jh["TaintTolerationPriority"][1]
    # the JAX package's Pallas kernel pair, interpret mode on the CPU
    monkeypatch.setenv("KTPU_PALLAS", "1")
    want = np.asarray(jp._fused_pair_normalize(raw_na, raw_tt, jmask,
                                               *weights))
    # the port's pair (plain version on CPU tensors) on the same inputs
    got = fused_score.fused_pair_normalize(
        torch.tensor(np.asarray(raw_na)), torch.tensor(np.asarray(raw_tt)),
        torch.tensor(np.asarray(jmask)), *weights)
    np.testing.assert_array_equal(got.numpy(), want)
    # and the two separate normalizes it replaces
    sep = (weights[0] * tp._normalize_reduce(
        torch.tensor(np.asarray(raw_na)), torch.tensor(np.asarray(jmask)),
        False) + weights[1] * tp._normalize_reduce(
        torch.tensor(np.asarray(raw_tt)), torch.tensor(np.asarray(jmask)),
        True))
    assert torch.equal(got, sep)


def test_fusion_disengages_for_float_weights():
    w = dict(tp.DEFAULT_WEIGHTS, NodeAffinityPriority=1.5)
    assert not tp._fusable(w, ())
    assert tp._fusable(tp.DEFAULT_WEIGHTS, ())
