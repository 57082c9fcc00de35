"""The port's explain reduction (``kubernetes_tpu_torch/obs/explain.py``)
against the JAX package's (``kubernetes_tpu/obs/explain.py``): the same
seeded (P, N) reason matrices, node masks (padded nodes included), pod
masks and FitError inputs go through both ``explain_reduce``s, and every
output field must be equal, dtype included (tolerance 0). The host
report built from the two read-backs must serialize identically."""

import numpy as np
import pytest
import torch

from kubernetes_tpu.obs import explain as jex
from kubernetes_tpu_torch.obs import explain as tex
from kubernetes_tpu_torch.ops.sync import SYNCS

N_BITS = len(tex.PREDICATE_BITS)


def _reasons(g, P, N):
    """Sparse reason bits: about 40% zeros, 30% single bits (so the
    one-bit-away counts are non-trivial) and 30% two- or three-bit masks."""
    kind = g.random((P, N))
    single = np.left_shift(1, g.integers(0, N_BITS, (P, N)))
    multi = np.zeros((P, N), np.int64)
    for _ in range(3):
        multi |= np.left_shift(1, g.integers(0, N_BITS, (P, N)))
    return np.where(kind < 0.4, 0, np.where(kind < 0.7, single, multi)) \
        .astype(np.int32)


def _inputs(seed, P, N, n_valid, fit):
    g = np.random.default_rng(seed)
    reasons = _reasons(g, P, N)
    # a few bits dominate, as in real cycles (resources, taints)
    hot = g.random((P, N)) < 0.3
    reasons[hot] |= 1 << tex.BIT["PodFitsResources"]
    node_valid = np.zeros((N,), bool)
    node_valid[:n_valid] = True
    pod_mask = g.random((P,)) < 0.7
    args = [reasons, node_valid, pod_mask]
    if fit:
        R = 5
        req = g.choice([0.0, 100.0, 500.0, 2000.0], (P, R)).astype(np.float32)
        free = g.choice([0.0, 99.0, 500.0, 1000.0], (N, R)).astype(np.float32)
        ready = g.random((N,)) < 0.8
        netun = g.random((N,)) < 0.2
        args += [req, free, ready, netun]
    return args


CASES = [(seed, P, N, n_valid, fit)
         for seed, (P, N, n_valid) in enumerate(
             [(8, 16, 16), (37, 64, 50), (1, 8, 5), (64, 128, 100),
              (16, 40, 0), (24, 8, 8)])
         for fit in (False, True)]


@pytest.mark.parametrize("seed, P, N, n_valid, fit", CASES)
def test_explain_reduce_matches_exactly(seed, P, N, n_valid, fit):
    args = _inputs(seed, P, N, n_valid, fit)
    want = jex.explain_reduce(*args)
    got = tex.explain_reduce(*[torch.from_numpy(a) for a in args])
    assert tex.ExplainResult._fields == jex.ExplainResult._fields
    for name in jex.ExplainResult._fields:
        w, t = np.asarray(getattr(want, name)), getattr(got, name)
        assert t.dtype == torch.int32, name
        assert t.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(t.numpy(), w, err_msg=name)


@pytest.mark.parametrize("seed, P, N, n_valid, fit", CASES[::3])
def test_read_back_is_one_transfer_of_every_field(seed, P, N, n_valid, fit):
    args = _inputs(seed, P, N, n_valid, fit)
    ex = tex.explain_reduce(*[torch.from_numpy(a) for a in args])
    before = SYNCS.count
    host = tex.read_back(ex)
    assert SYNCS.count == before + 1
    assert set(host) == set(tex.ExplainResult._fields)
    for name in tex.ExplainResult._fields:
        np.testing.assert_array_equal(host[name],
                                      getattr(ex, name).numpy(),
                                      err_msg=name)


@pytest.mark.parametrize("top_k", [1, 3, 18])
@pytest.mark.parametrize("seed", range(3))
def test_build_report_matches(seed, top_k):
    P, N = 20, 48
    args = _inputs(100 + seed, P, N, 40, True)
    jhost = {k: np.asarray(v)
             for k, v in jex.explain_reduce(*args)._asdict().items()}
    thost = tex.read_back(
        tex.explain_reduce(*[torch.from_numpy(a) for a in args]))
    keys = [f"ns/pod-{i}" for i in range(P)]
    rows = [i for i in range(P) if args[2][i]]
    for ex_j, ex_t in ((jhost, thost), (None, None)):
        want = jex.build_report(7, N, keys, rows, ex_j, top_k)
        got = tex.build_report(7, N, keys, rows, ex_t, top_k)
        assert got.to_json() == want.to_json()
        assert ({k: pe.to_json() for k, pe in got.pods.items()}
                == {k: pe.to_json() for k, pe in want.pods.items()})
        assert got.top_reasons(top_k) == want.top_reasons(top_k)
        assert (tex.summarize_breakdown(got.reason_pods, N)
                == jex.summarize_breakdown(want.reason_pods, N))
    for name in tex.PREDICATE_BITS + ("NotAPredicate",):
        assert tex.reason_message(name) == jex.reason_message(name)


def test_report_of_failed_rows_equals_the_masked_full_batch():
    """The scheduler reduces only the failed rows with an all-true mask;
    per-row values and the cluster rollup equal the reference's masked
    reduction over the whole batch."""
    P, N = 32, 64
    reasons, node_valid, pod_mask, req, free, ready, netun = _inputs(
        42, P, N, 60, True)
    full = jex.explain_reduce(reasons, node_valid, pod_mask, req, free,
                              ready, netun)
    rows = np.flatnonzero(pod_mask)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    part = tex.explain_reduce(
        t(reasons[rows]), t(node_valid), torch.ones(len(rows), dtype=bool),
        t(req[rows]), t(free), t(ready), t(netun))
    for name in tex.ExplainResult._fields:
        w = np.asarray(getattr(full, name))
        if name not in ("pair_hist", "pods_blocked"):
            w = w[rows]
        np.testing.assert_array_equal(getattr(part, name).numpy(), w,
                                      err_msg=name)
