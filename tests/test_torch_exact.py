"""The ``exact`` solver tier of the PyTorch port: its host Hungarian
(``kubernetes_tpu_torch/native.py``, the pure-numpy path) held against the
JAX package's ``native.hungarian`` (the C++ library where it builds) on
tie-heavy inputs, assignment for assignment, and the scheduler's ``exact``
tier driven beside the JAX package's: the same placements, and the same
hazard routing of port / volume / topology batches to the round solver."""

import itertools

import numpy as np
import pytest

from kubernetes_tpu import native as jnative
from kubernetes_tpu.api.types import (
    Affinity,
    LabelSelector,
    PodAffinityTerm,
)
from kubernetes_tpu.testing import make_node, make_pod
from kubernetes_tpu_torch import native as tnative
from torch_parity import Pair

NEG = tnative.NEG


def brute_force_best(score):
    """Cardinality first, then total score (the scheduling objective)."""
    P, S = score.shape
    for k in range(min(P, S), -1, -1):
        best = None
        for rows in itertools.combinations(range(P), k):
            for perm in itertools.permutations(range(S), k):
                vals = [score[r, c] for r, c in zip(rows, perm)]
                if all(v > -1e29 for v in vals):
                    total = float(sum(vals))
                    best = total if best is None else max(best, total)
        if best is not None:
            return k, best
    return 0, 0.0


@pytest.mark.parametrize("seed", range(6))
def test_hungarian_matches_brute_force(seed):
    rng = np.random.RandomState(seed)
    for _ in range(5):
        P, S = rng.randint(1, 5), rng.randint(1, 5)
        score = rng.uniform(0, 10, (P, S)).astype(np.float32)
        score[rng.uniform(size=score.shape) < 0.3] = NEG
        got = tnative.hungarian(score)
        used = [c for c in got if c >= 0]
        assert len(used) == len(set(used))
        k, want = brute_force_best(score)
        assert len(used) == k
        total = sum(score[r, c] for r, c in enumerate(got) if c >= 0)
        assert abs(total - want) < 1e-4


@pytest.mark.parametrize("levels", [2, 4, 11])
def test_hungarian_equals_the_references_on_tie_heavy_inputs(levels):
    """Integer scores from a few levels make most optima tied: the port
    must pick the very assignment the reference picks, not only an equal
    total (the scheduler binds what it picks)."""
    for seed in range(60):
        rng = np.random.RandomState(1000 * levels + seed)
        P, S = rng.randint(1, 16), rng.randint(1, 16)
        score = rng.randint(0, levels, (P, S)).astype(np.float32)
        score[rng.uniform(size=score.shape) < 0.25] = NEG
        np.testing.assert_array_equal(tnative.hungarian(score),
                                      jnative.hungarian(score))


def test_exact_assign_respects_capacity_like_the_reference():
    rng = np.random.RandomState(7)
    for _ in range(20):
        P, N = rng.randint(1, 12), rng.randint(1, 6)
        score = rng.randint(0, 3, (P, N)).astype(np.float32)
        mask = rng.uniform(size=(P, N)) > 0.2
        cap = rng.randint(0, 4, N)
        got = tnative.exact_assign(score, mask, cap)
        np.testing.assert_array_equal(got,
                                      jnative.exact_assign(score, mask, cap))
        for j in range(N):
            assert np.sum(got == j) <= cap[j]
        assert all(mask[i, got[i]] for i in range(P) if got[i] >= 0)


def _exact_pair():
    return Pair(solver="exact", rc={})


def test_exact_solver_beats_greedy_argmax():
    pair = _exact_pair()
    pair.feed([make_node("big", cpu_milli=1000, memory=2**33),
               make_node("small", cpu_milli=900, memory=2**33)],
              [make_pod("a", cpu_milli=800), make_pod("b", cpu_milli=800)])
    rt = pair.cycle()
    assert rt.solver_tier == "exact" and rt.scheduled == 2
    assert set(rt.assignments.values()) == {"big", "small"}


def test_exact_solver_respects_pod_count_capacity():
    pair = _exact_pair()
    pair.feed([make_node("n0", pods=2)], [make_pod(f"p{i}")
                                          for i in range(5)])
    rt = pair.cycle()
    assert rt.scheduled == 2 and rt.unschedulable == 3


@pytest.mark.parametrize("seed", range(3))
def test_exact_solver_places_a_contended_cluster_like_the_reference(seed):
    rng = np.random.RandomState(seed)
    nodes = [make_node(f"n{i}", cpu_milli=int(rng.choice([1000, 2000, 4000])),
                       zone=f"z{i % 3}") for i in range(10)]
    pods = [make_pod(f"p{i}", cpu_milli=int(rng.choice([300, 500, 900])),
                     priority=int(rng.choice([0, 10])))
            for i in range(24)]
    pair = _exact_pair()
    pair.feed(nodes, pods)
    rt = pair.cycle()
    assert rt.solver_tier == "exact" and rt.scheduled > 0
    assert pair.s[1].exact_fallbacks == pair.s[0].exact_fallbacks == 0


def test_exact_routes_a_topology_batch_to_the_round_solver():
    """The Hungarian models per-node slots only: a batch with pod
    anti-affinity goes to ``batch``, as in the reference."""
    anti = Affinity(pod_anti_affinity_required=(PodAffinityTerm(
        label_selector=LabelSelector(match_labels={"app": "x"}),
        topology_key="kubernetes.io/hostname"),))
    pair = _exact_pair()
    pair.feed([make_node(f"n{i}", cpu_milli=4000) for i in range(4)],
              [make_pod(f"p{i}", cpu_milli=100, labels={"app": "x"},
                        affinity=anti) for i in range(6)])
    rt = pair.cycle()
    assert rt.solver_tier == "batch" and rt.scheduled == 4
    assert pair.s[1].exact_fallbacks == pair.s[0].exact_fallbacks == 1
