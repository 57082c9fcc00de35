"""The port's kernel-route policy against the reference's, on the CPU.

The reference picks its Pallas route with ``use_pallas()``
(``KTPU_PALLAS``: ``0`` the plain jnp route, ``1`` the Pallas route in
interpret mode off the TPU, unset the Pallas route only on a TPU); the
port's ``ops/fused_score.use_kernels`` reads the same variable (``0`` the
plain route, ``1`` the kernel route, which on a CPU tensor runs the
kernels' plain versions in the Pallas rule, unset the kernel route only in
a process that sees a CUDA card). The plain route is refused on a CUDA
tensor. Every case runs under the variable unset, ``"0"`` and ``"1"``,
set alike for both packages, and holds the port to the reference:

- the transport plan with zero-capacity columns (the two routes' rules
  differ there) at ``atol=1e-5, rtol=1e-4`` with equal row argmax;
- ``batch_assign(use_sinkhorn=True)`` where feasible columns run out of
  slots: equal placements and rounds;
- ``run_priorities`` fused and unfused, and ``batch_assign`` with
  ``fused_score`` on and off: bit-equal totals and equal placements, the
  unfused pair reaching no pair kernel;
- the partitioned solve at d in {2, 4} under ``"0"``: equal to the
  reference's sharded solve, and reaching none of the six kernel wrappers;
- a route flip at one shape keys a second round-loop graph;
- on the kernel route a ``KernelError`` escapes the cycle; the plain route
  is taken only when ``KTPU_PALLAS=0`` asks for it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kubernetes_tpu.ops.fused_score as jfs
import kubernetes_tpu.ops.predicates as jpred
import kubernetes_tpu.ops.priorities as jp
import kubernetes_tpu.ops.sinkhorn as jsk
import kubernetes_tpu_torch.ops.fused_score as tfs
import kubernetes_tpu_torch.ops.predicates as tpred
import kubernetes_tpu_torch.ops.priorities as tp
import kubernetes_tpu_torch.ops.sinkhorn as tsk
from kubernetes_tpu.ops.assign import batch_assign as jbatch_assign
from kubernetes_tpu.testing import make_node, make_pod
from kubernetes_tpu_torch.kernels import KernelError
from kubernetes_tpu_torch.ops import device_loop
from kubernetes_tpu_torch.ops.assign import batch_assign as tbatch_assign
from test_torch_mesh_partitioned import _both
from torch_parity import jax_tables, port_tables, pref_affinity_cluster

ATOL, RTOL = 1e-5, 1e-4

#: (module, wrapper) of every hand-kernel entry a route can reach
WRAPPERS = [(tfs, "fused_pair_normalize"), (tfs, "fused_pair_max"),
            (tfs, "fused_pair_scale"), (tsk, "sinkhorn_u"),
            (tsk, "sinkhorn_u_partial"), (tsk, "sinkhorn_v")]


@pytest.fixture(params=[None, "0", "1"], ids=["unset", "0", "1"])
def route(request, monkeypatch):
    """``KTPU_PALLAS`` for both packages: unset, ``"0"`` or ``"1"``."""
    if request.param is None:
        monkeypatch.delenv("KTPU_PALLAS", raising=False)
    else:
        monkeypatch.setenv("KTPU_PALLAS", request.param)
    return request.param


def _no_wrappers(monkeypatch):
    """Every kernel wrapper raises ``KernelError`` when called."""
    for module, name in WRAPPERS:
        def broken(*_a, _name=name, **_k):
            raise KernelError(f"injected: {_name} was called")

        monkeypatch.setattr(module, name, broken)


# ---------------------------------------------------------------------------
# The policy
# ---------------------------------------------------------------------------


def test_use_kernels_reads_the_references_variable(route, monkeypatch):
    want = route == "1"
    assert tfs.use_kernels("cpu") is want
    assert tfs.use_kernels(torch.device("cpu")) is want
    # the reference's two functions, read here on its CPU backend
    assert jfs.use_pallas() is want and jsk.use_pallas() is want
    # the sinkhorn module shares the one policy
    assert tsk.use_kernels is tfs.use_kernels
    # an explicit route wins over the variable on a CPU tensor
    assert tfs.use_kernels("cpu", True) is True
    assert tfs.use_kernels("cpu", False) is False
    # unset is decided per process, as default_backend() is: in a process
    # that sees a card a CPU tensor takes the card's route too
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tfs.use_kernels("cpu") is (route != "0")
    if route != "0":
        assert tfs.use_kernels(torch.device("cuda", 0)) is True


@pytest.mark.parametrize("asked", [None, False], ids=["policy", "explicit"])
def test_the_plain_route_is_refused_on_a_card(route, asked, monkeypatch):
    """On a CUDA tensor the plain route raises ``PlainRouteRefused`` (a
    ``KernelError``, so it escapes every rung), whether ``KTPU_PALLAS=0``
    or an explicit ``pallas=False`` / ``fused_score=False`` asks for it;
    a scheduler on the card refuses it when it is built."""
    from kubernetes_tpu_torch.scheduler import Scheduler

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    cuda = torch.device("cuda", 0)
    if asked is None and route != "0":
        assert tfs.use_kernels(cuda) is True
        return
    with pytest.raises(tfs.PlainRouteRefused, match="plain route"):
        tfs.use_kernels(cuda, asked)
    assert issubclass(tfs.PlainRouteRefused, KernelError)
    if asked is None:
        with pytest.raises(tfs.PlainRouteRefused):
            Scheduler(device="cuda")


def test_fused_score_off_takes_the_unfused_pair(monkeypatch):
    """``batch_assign(fused_score=False)`` scores the pair with the two
    separate normalizes: the same placements and rounds as the fused
    solve and the reference's unfused one, with no pair wrapper reached;
    on a card it is refused, as the plain route is."""
    import kubernetes_tpu_torch.ops.assign as tassign

    monkeypatch.setenv("KTPU_PALLAS", "1")
    tn, tp_, ts_ = _pref_tables()
    fused = tbatch_assign(tp_, tn, ts_)
    dn, dp, ds, *_ = jax_tables(*pref_affinity_cluster(
        11, n_nodes=16, n_bound=8, n_pending=48))
    want = jbatch_assign(dp, dn, ds, fused_score=False)
    with monkeypatch.context() as m:
        for module, name in WRAPPERS[:3]:
            def broken(*_a, _name=name, **_k):
                raise KernelError(f"injected: {_name} was called")

            m.setattr(module, name, broken)
        a, _u, r = tbatch_assign(tp_, tn, ts_, fused_score=False)
    assert a.tolist() == fused[0].tolist() == np.asarray(want[0]).tolist()
    assert int(r) == int(fused[2]) == int(want[2])
    # the same call on a card's tables is refused (the tables' device
    # taken for a CUDA one by the policy the solve consults)
    monkeypatch.setattr(tassign, "use_kernels",
                        lambda _dev, asked=None: tfs.use_kernels(
                            torch.device("cuda", 0), asked))
    with pytest.raises(tfs.PlainRouteRefused):
        tbatch_assign(tp_, tn, ts_, fused_score=False)


# ---------------------------------------------------------------------------
# The transport plan
# ---------------------------------------------------------------------------


def _zero_capacity_plan():
    """A seeded 16 x 8 plan: columns 0 and 3 at capacity 0, every other
    column at 2, column 0 scoring 5 more than the rest."""
    g = np.random.default_rng(0)
    score = g.integers(0, 10, (16, 8)).astype(np.float32)
    score[:, 0] += 5
    mask = g.random((16, 8)) < 0.8
    cap = np.full(8, 2, np.float32)
    cap[[0, 3]] = 0
    return score, mask, cap


@pytest.mark.parametrize("pallas", [None, False, True],
                         ids=["policy", "plain", "kernel"])
def test_zero_capacity_plan_matches_the_reference(route, pallas):
    score, mask, cap = _zero_capacity_plan()
    kw = {} if pallas is None else {"pallas": pallas}
    want = np.asarray(jsk.sinkhorn_plan(
        jnp.asarray(score), jnp.asarray(mask), jnp.asarray(cap),
        interpret=True if pallas else None, **kw))
    got = tsk.sinkhorn_plan(torch.tensor(score), torch.tensor(mask),
                            torch.tensor(cap), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    plain = pallas is False or (pallas is None and route != "1")
    if plain:
        # the jnp rule: a zero-capacity column takes no mass
        assert float(np.abs(got[:, [0, 3]]).sum()) == 0.0


@pytest.mark.parametrize("tol", [None, 1e-3])
def test_the_plain_plan_reaches_no_kernel_wrapper(monkeypatch, tol):
    """On the plain route the passes are the plain versions, called
    directly: no wrapper runs, with stats, a warm start or a tolerance."""
    _no_wrappers(monkeypatch)
    score, mask, cap = _zero_capacity_plan()
    args = (torch.tensor(score), torch.tensor(mask), torch.tensor(cap))
    init = (torch.zeros(16), torch.zeros(8))
    plan, stats = tsk.sinkhorn_plan(*args, pallas=False, with_stats=True,
                                    init=init, tol=tol)
    want, jstats = jsk.sinkhorn_plan(
        jnp.asarray(score), jnp.asarray(mask), jnp.asarray(cap),
        pallas=False, with_stats=True, init=tuple(map(jnp.asarray, init)),
        tol=tol)
    np.testing.assert_allclose(plan.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    assert abs(int(stats[0]) - int(np.asarray(jstats)[0])) <= 1
    with pytest.raises(KernelError, match="sinkhorn_u was called"):
        tsk.sinkhorn_plan(*args, pallas=True)


def _slot_starved_cluster():
    """12 nodes of 1 CPU; every third is bound to 950m (50m left: no
    requesting pod fits, a BestEffort pod does, so the plan sees a
    feasible column with 0 slots), others partly; 40 pending pods, every
    fourth BestEffort, the rest 100-300m."""
    g = np.random.default_rng(0)
    nodes = [make_node(f"n{i}", cpu_milli=1000, memory=8 * 2**30, pods=20,
                       zone=f"z{i % 3}") for i in range(12)]
    bound = [make_pod(f"b{i}", cpu_milli=950, node_name=f"n{i}")
             for i in range(0, 12, 3)]
    bound += [make_pod(f"c{i}", cpu_milli=int(g.integers(0, 6)) * 100,
                       node_name=f"n{i}") for i in range(1, 12, 3)]
    pending = [make_pod(f"be{i}") if i % 4 == 0 else
               make_pod(f"p{i}", cpu_milli=int(g.choice([100, 200, 300])))
               for i in range(40)]
    return nodes, bound, pending


@pytest.mark.parametrize("per_node_cap", [1, 2])
def test_plan_solve_matches_the_reference_when_slots_run_out(route,
                                                             per_node_cap):
    dn, dp, ds, *_ = jax_tables(*_slot_starved_cluster())
    tn, tp_, ts_, _ = port_tables(dn, dp, ds)
    want = jbatch_assign(dp, dn, ds, use_sinkhorn=True,
                         per_node_cap=per_node_cap)
    got = tbatch_assign(tp_, tn, ts_, use_sinkhorn=True,
                        per_node_cap=per_node_cap)
    assert got[0].tolist() == np.asarray(want[0]).tolist()
    assert int(got[2]) == int(want[2])


# ---------------------------------------------------------------------------
# The pair
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_and_unfused_totals_are_bit_equal(route, seed, monkeypatch):
    nodes, bound, pending = pref_affinity_cluster(
        700 + seed, n_nodes=24, n_bound=12, n_pending=40)
    jdn, jdp, jds, *_ = jax_tables(nodes, bound, pending)
    dn, dp, ds, _ = port_tables(jdn, jdp, jds)
    jmask = jpred.run_predicates(jdp, jdn, jds).mask
    mask = tpred.run_predicates(dp, dn, ds).mask
    jh = jp.hoist_priorities(jdp, jdn, jds)
    th = tp.hoist_priorities(dp, dn, ds)
    want = {f: np.asarray(jp.run_priorities(jdp, jdn, jds, jmask,
                                            hoisted=jh, fused=f))
            for f in (False, True)}
    np.testing.assert_array_equal(want[True], want[False])
    fused = tp.run_priorities(dp, dn, ds, mask, hoisted=th, fused=True)
    np.testing.assert_array_equal(fused.numpy(), want[True])
    # unfused: the two separate normalizes, never the pair's kernel
    _no_wrappers(monkeypatch)
    unfused = tp.run_priorities(dp, dn, ds, mask, hoisted=th, fused=False)
    assert torch.equal(unfused, fused)


# ---------------------------------------------------------------------------
# The partitioned solve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("name,kw", [("batch", {}),
                                     ("sinkhorn", {"use_sinkhorn": True})],
                         ids=["batch", "sinkhorn"])
def test_plain_partitioned_solve_matches_the_reference(d, name, kw,
                                                       monkeypatch):
    monkeypatch.setenv("KTPU_PALLAS", "0")
    _no_wrappers(monkeypatch)
    want, got = _both(name, d, **kw)
    assert got == want


# ---------------------------------------------------------------------------
# The graph key, and a kernel fault on the kernel route
# ---------------------------------------------------------------------------


def _pref_tables():
    nodes, bound, pending = pref_affinity_cluster(11, n_nodes=16,
                                                  n_bound=8, n_pending=48)
    dn, dp, ds, *_ = jax_tables(nodes, bound, pending)
    return port_tables(dn, dp, ds)[:3]


def test_a_route_flip_keys_a_second_graph(monkeypatch):
    """The resolved route is part of the round-loop graph's key: a flip
    between two solves at one shape asks for a second graph (the card
    captures it), and flipping back finds the first."""
    tn, tp_, ts_ = _pref_tables()
    device_loop.KEYS.clear()
    out = {}
    for env in ("1", "0", "1", "0"):
        monkeypatch.setenv("KTPU_PALLAS", env)
        a, _u, r = tbatch_assign(tp_, tn, ts_)
        out.setdefault(env, []).append((a.tolist(), int(r)))
    assert len(device_loop.KEYS) == 2
    statics = [dict(kv for kv in k[2] if isinstance(kv, tuple)
                    and len(kv) == 2 and isinstance(kv[0], str))
               for k in device_loop.KEYS]
    assert sorted((s["fused"], s["kernel_route"]) for s in statics) == [
        (False, False), (True, True)]
    # each route gives the same answer every time, and the two agree (the
    # pair is bit-identical either way; this batch does not plan)
    assert out["1"][0] == out["1"][1] == out["0"][0] == out["0"][1]


@pytest.mark.parametrize("solver,module,wrapper", [
    ("batch", tfs, "fused_pair_normalize"),
    ("sinkhorn", tsk, "sinkhorn_u"), ("sinkhorn", tsk, "sinkhorn_v")])
def test_a_kernel_error_escapes_on_the_kernel_route(route, solver, module,
                                                    wrapper, monkeypatch):
    """A kernel that fails raises ``KernelError`` out of the cycle through
    every retry and tier; it never sends the solve down the plain route.
    The plain route is taken when ``KTPU_PALLAS`` asks for it (``0``, or
    unset in a process without a card), and then the broken wrapper is
    never reached."""
    from kubernetes_tpu_torch.config import RobustnessConfig
    from kubernetes_tpu_torch.scheduler import Scheduler
    from torch_parity import FakeClock, to_port

    def broken(*a, **k):
        raise KernelError(f"injected: {wrapper} failed to launch")

    monkeypatch.setattr(module, wrapper, broken)
    s = Scheduler(device="cpu", solver=solver, enable_preemption=False,
                  clock=FakeClock(),
                  robustness=RobustnessConfig(solver_retries=1),
                  retry_sleep=lambda _s: None)
    nodes, bound, pending = pref_affinity_cluster(3, n_nodes=16, n_bound=8,
                                                  n_pending=24,
                                                  oversized_every=0)
    for nd in nodes:
        s.on_node_add(to_port(nd))
    for p in bound + pending:
        s.on_pod_add(to_port(p))
    if route == "1":
        with pytest.raises(KernelError, match=wrapper):
            s.schedule_cycle()
    else:
        r = s.schedule_cycle()
        assert r.scheduled == len(pending) and r.solver_tier == solver
    assert not s.metrics.solver_fallbacks._values
