"""The port's transport plan against the JAX package's. The scaling
passes run in another summation order (ATen's exp/log and reductions
against XLA:CPU's and against the Pallas kernels in interpret mode), so
potentials and plans are held to ``atol=1e-5, rtol=1e-4`` in f32 — the
reference's own Pallas-vs-jnp tolerance. The port also reproduces the
reference's quality pins: the plan beats argmax on tied preferences,
and the auto-router takes the plan exactly when that signature shows."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.ops.sinkhorn as js
import kubernetes_tpu_torch.ops.sinkhorn as ts
from kubernetes_tpu_torch.ops.arrays import (
    nodes_to_device,
    pods_to_device,
    selectors_to_device,
)
from kubernetes_tpu_torch.ops.assign import batch_assign
from kubernetes_tpu_torch.snapshot import SnapshotPacker
from test_sinkhorn import tied_preferences_workload
from torch_parity import to_port

ATOL, RTOL = 1e-5, 1e-4


def _problem(seed, P, N, zero_caps=False):
    g = np.random.default_rng(seed)
    score = g.uniform(0, 10, (P, N)).astype(np.float32)
    mask = g.uniform(size=(P, N)) > 0.3
    mask[min(5, P - 1)] = False  # one fully infeasible pod
    cap = g.integers(0 if zero_caps else 1, 5, N).astype(np.float32)
    return score, mask, cap


def _log_tables(score, mask, cap, eps=0.5):
    logk = np.where(mask, score / eps, js.NEG_INF).astype(np.float32)
    log_r = np.where(mask.any(1), 0.0, js.NEG_INF).astype(np.float32)
    log_c = np.where(cap > 0, np.log(np.maximum(cap, 1e-30)),
                     js.NEG_INF).astype(np.float32)
    return logk, log_r, log_c


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("shape", [(32, 24), (303, 41)])
def test_scaling_passes_match_the_pallas_kernels(shape):
    logk, log_r, log_c = _log_tables(*_problem(1, *shape, zero_caps=True))
    ju, jv, _ = js._scale_pallas(jnp.asarray(logk), jnp.asarray(log_r),
                                 jnp.asarray(log_c), 20, interpret=True)
    tu, tv, _ = ts._scale(torch.tensor(logk), torch.tensor(log_r),
                          torch.tensor(log_c), 20, kernel_route=True)
    _close(tu, ju)
    _close(tv, jv)
    # one pass each, from the same potentials
    u0 = torch.tensor(np.asarray(ju))
    v0 = torch.tensor(np.asarray(jv))
    _close(ts.sinkhorn_u(torch.tensor(logk), v0, torch.tensor(log_r)),
           ju)
    _close(ts.sinkhorn_v(torch.tensor(logk), u0, torch.tensor(log_c)),
           jv)


def _reference_v(logk, u, log_c, jnp_rule):
    """The reference's column pass: its ``_v_kernel`` as ``_scale_pallas``
    launches it (columns padded to its block, interpret mode) in the
    Pallas rule; its jnp scaling's v step in the jnp rule."""
    if jnp_rule:
        v = jnp.minimum(jnp.asarray(log_c)
                        - js._col_lse(jnp.asarray(logk), jnp.asarray(u)), 0.0)
        return np.asarray(jnp.where(jnp.isfinite(v), v, 0.0))
    from jax.experimental import pallas as pl

    P, N0 = logk.shape
    _bp, bn, _P, N = js._block_shapes(P, N0)
    logk = np.pad(logk, ((0, 0), (0, N - N0)), constant_values=js.NEG_INF)
    log_c = np.pad(log_c, (0, N - N0), constant_values=js.NEG_INF)
    v_call = pl.pallas_call(
        js._v_kernel, grid=(N // bn,),
        in_specs=[pl.BlockSpec((P, bn), lambda j: (0, j)),
                  pl.BlockSpec((1, P), lambda j: (0, 0)),
                  pl.BlockSpec((1, bn), lambda j: (0, j))],
        out_specs=pl.BlockSpec((1, bn), lambda j: (0, j)),
        out_shape=jax.ShapeDtypeStruct((1, N), jnp.float32), interpret=True)
    return np.asarray(v_call(jnp.asarray(logk), jnp.asarray(u)[None, :],
                             jnp.asarray(log_c)[None, :]))[0, :N0]


@pytest.mark.parametrize("jnp_rule", [False, True])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_per_block_v_matches_the_reference_column_pass(d, jnp_rule):
    # a mesh of d shards runs the v pass on each shard's column block:
    # the blocks' potentials, side by side, are the reference's whole pass
    P, N = 96, 64
    logk, _log_r, log_c = _log_tables(*_problem(7 + d, P, N,
                                                zero_caps=True))
    u = np.random.default_rng(d).uniform(-3, 0, P).astype(np.float32)
    u[::7] = js.NEG_INF  # rows that ship nothing
    want = _reference_v(logk, u, log_c, jnp_rule)
    got = torch.cat([
        ts.sinkhorn_v_plain(torch.tensor(lk), torch.tensor(u),
                            torch.tensor(lc), jnp_rule)
        for lk, lc in zip(np.split(logk, d, 1), np.split(log_c, d))])
    _close(got, want)


def test_scaling_matches_the_jnp_loop_with_stats_and_tolerance():
    logk, log_r, log_c = _log_tables(*_problem(2, 64, 16))
    args_j = [jnp.asarray(a) for a in (logk, log_r, log_c)]
    args_t = [torch.tensor(a) for a in (logk, log_r, log_c)]
    ju, jv, jstats = js._scale_jnp(*args_j, 30, with_stats=True)
    tu, tv, tstats = ts._scale(*args_t, 30, with_stats=True,
                               kernel_route=False)
    _close(tu, ju)
    _close(tv, jv)
    assert int(tstats[0]) == int(np.asarray(jstats)[0])
    ju, jv, jstats = js._scale_jnp(*args_j, 60, tol=1e-4)
    tu, tv, tstats = ts._scale(*args_t, 60, tol=1e-4, kernel_route=False)
    _close(tu, ju)
    _close(tv, jv)
    assert abs(int(tstats[0]) - int(np.asarray(jstats)[0])) <= 1


def _zero_cap_problem(P, N):
    """Integer scores, a 70% feasible mask and capacities 1-2 with columns
    2 and 5 at zero capacity (a BestEffort pod batched with requesting
    pods gives a node 0 slots while it stays feasible there)."""
    g = np.random.default_rng(0)
    score = g.integers(0, 100, (P, N)).astype(np.float32)
    mask = g.random((P, N)) < 0.7
    cap = g.integers(1, 3, N).astype(np.float32)
    cap[[2, 5]] = 0
    return score, mask, cap


@pytest.mark.parametrize("start", ["zeros", "partial"])
@pytest.mark.parametrize("shape", [(8, 16), (32, 24), (303, 41)])
def test_tolerance_loop_matches_the_jnp_loop_on_zero_capacity_columns(
        shape, start):
    # the tolerance loop is the reference's jnp scaling on every backend:
    # a zero-capacity column keeps v ~ NEG_INF and takes no mass
    score, mask, cap = _zero_cap_problem(*shape)
    args_j = (jnp.asarray(score), jnp.asarray(mask), jnp.asarray(cap))
    args_t = (torch.tensor(score), torch.tensor(mask), torch.tensor(cap))
    P, N = shape
    if start == "zeros":
        init = (np.zeros(P, np.float32), np.zeros(N, np.float32))
    else:
        _p, (ju, jv) = js.sinkhorn_plan(*args_j, iters=3, pallas=False,
                                        return_potentials=True)
        init = (np.asarray(ju), np.asarray(jv))
    want, jst, (ju, jv) = js.sinkhorn_plan(
        *args_j, init=tuple(jnp.asarray(a) for a in init), tol=1e-3,
        with_stats=True, return_potentials=True)
    got, tst, (tu, tv) = ts.sinkhorn_plan(
        *args_t, init=tuple(torch.tensor(a) for a in init), tol=1e-3,
        with_stats=True, return_potentials=True)
    _close(got, want)
    _close(tu, ju)
    _close(tv, jv)
    assert abs(int(tst[0]) - int(np.asarray(jst)[0])) <= 1
    assert float(got[:, [2, 5]].sum()) == 0.0


@pytest.mark.parametrize("seed", range(3))
def test_plan_matches(seed):
    score, mask, cap = _problem(10 + seed, 48, 20)
    want = js.sinkhorn_plan(jnp.asarray(score), jnp.asarray(mask),
                            jnp.asarray(cap), iters=25, pallas=True,
                            interpret=True)
    got = ts.sinkhorn_plan(torch.tensor(score), torch.tensor(mask),
                           torch.tensor(cap), iters=25, pallas=True)
    _close(got, want)
    # warm start from the reference's potentials, with stats
    _p, jst, (ju, jv) = js.sinkhorn_plan(
        jnp.asarray(score), jnp.asarray(mask), jnp.asarray(cap), iters=5,
        pallas=False, with_stats=True, return_potentials=True)
    init_t = (torch.tensor(np.asarray(ju)), torch.tensor(np.asarray(jv)))
    want = js.sinkhorn_plan(jnp.asarray(score), jnp.asarray(mask),
                            jnp.asarray(cap), iters=10, pallas=True,
                            interpret=True, init=(ju, jv))
    got, _st, (tu, tv) = ts.sinkhorn_plan(
        torch.tensor(score), torch.tensor(mask), torch.tensor(cap),
        iters=10, init=init_t, with_stats=True, return_potentials=True,
        pallas=True)
    _close(got, want)


def test_plan_respects_marginals():
    score, mask, cap = _problem(0, 64, 16)
    cap = np.random.default_rng(5).integers(1, 8, 16).astype(np.float32)
    plan = ts.sinkhorn_plan(torch.tensor(score), torch.tensor(mask),
                            torch.tensor(cap), iters=60).numpy()
    rows, cols = plan.sum(1), plan.sum(0)
    assert np.all(rows <= 1.0 + 1e-3)
    assert np.all(cols <= cap + 0.05 * cap + 1e-2)
    assert rows[5] == 0.0
    assert np.all(plan[~mask] == 0.0)


def _port_tables(nodes, pods):
    nodes, pods = to_port(nodes), to_port(pods)
    pk = SnapshotPacker()
    for p in pods:
        pk.intern_pod(p)
    return (nodes_to_device(pk.pack_nodes(nodes, []), device="cpu"),
            pods_to_device(pk.pack_pods(pods), device="cpu"),
            selectors_to_device(pk.pack_selector_tables(), device="cpu"))


def test_plan_beats_argmax_on_tied_preferences():
    nodes, pods, points = tied_preferences_workload()
    dn, dp, ds = _port_tables(nodes, pods)
    res = {}
    for flag in (False, True):
        a, _, _ = batch_assign(dp, dn, ds, per_node_cap=2, use_sinkhorn=flag,
                               auto_sinkhorn=False)
        a = a.numpy()[: len(pods)]
        assert int((a >= 0).sum()) == len(pods)
        res[flag] = points(a)
    assert res[True] > res[False], res


def test_auto_routing_fires_on_tied_contention_by_default():
    nodes, pods, points = tied_preferences_workload()
    dn, dp, ds = _port_tables(nodes, pods)
    res = {}
    for label, kw in (("default", {}),
                      ("argmax_only", {"auto_sinkhorn": False}),
                      ("forced_plan", {"use_sinkhorn": True})):
        a, _, _ = batch_assign(dp, dn, ds, per_node_cap=2, **kw)
        res[label] = points(a.numpy()[: len(pods)])
    assert res["default"] == res["forced_plan"], res
    assert res["default"] > res["argmax_only"], res


def test_auto_routing_stays_on_argmax_for_margin_ordered_preferences():
    from kubernetes_tpu.api.types import (
        Affinity,
        NodeSelectorTerm,
        PreferredSchedulingTerm,
        Requirement,
    )

    nodes, pods, _ = tied_preferences_workload()
    zone = "failure-domain.beta.kubernetes.io/zone"
    cold = Affinity(node_preferred=(PreferredSchedulingTerm(
        weight=10, preference=NodeSelectorTerm(
            (Requirement(zone, "In", ("cold",)),))),))
    pods = [dataclasses.replace(p, affinity=cold)
            if p.name.startswith("flat") else p for p in pods]
    dn, dp, ds = _port_tables(nodes, pods)
    a_auto, _, r_auto = batch_assign(dp, dn, ds, per_node_cap=2)
    a_arg, _, r_arg = batch_assign(dp, dn, ds, per_node_cap=2,
                                   auto_sinkhorn=False)
    assert torch.equal(a_auto, a_arg) and int(r_auto) == int(r_arg)
