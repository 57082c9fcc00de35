"""Exact assignment on the host: the pure-numpy path of
``kubernetes_tpu/native.py`` (the reference also builds the same
algorithm as C++ in ``native/ktpu.cc`` and falls back to this numpy
version without a toolchain; the two agree on every input,
``tests/test_native.py``). The ``exact`` solver tier runs it; it is
O(n^3) host work by design, for gang / offline packing where total score
matters more than wall-clock.
"""

from __future__ import annotations

import numpy as np

#: feasibility sentinel shared with the device solvers (ops/assign.NEG)
NEG = -1e30


def hungarian(score: np.ndarray) -> np.ndarray:
    """Exact max-total-score assignment of rows (pods) to columns (node
    slots), one row per column. ``score`` (P, S) f32; entries <= NEG/10
    are infeasible. Returns (P,) int32 column per row, -1 = unassigned.

    The augmenting-path algorithm computes a perfect matching over rows,
    so every call pads P dummy "unassigned" columns whose score (-1e9)
    sits strictly between any real score and the infeasible sentinel:
    the optimum then maximizes cardinality first (every dummy taken costs
    more than any feasible edge), score total second — exactly the
    scheduling objective — and rows infeasible everywhere park on dummies
    instead of distorting the matching with sentinel-cost ties."""
    score = np.ascontiguousarray(score, np.float32)
    P, S = score.shape
    if P == 0 or S == 0:
        return np.full((P,), -1, np.int32)
    pad = np.full((P, P), -1e9, np.float32)
    padded = np.ascontiguousarray(np.concatenate([score, pad], axis=1))
    out = _hungarian_py(padded)
    out[out >= S] = -1  # dummy columns = unassigned
    return out


def _hungarian_py(score: np.ndarray) -> np.ndarray:
    """The shortest-augmenting-path algorithm in numpy."""
    BIG = 1e12
    P, S = score.shape
    # graftlint: disable=R5 -- host Hungarian oracle: f64 keeps the dual
    # potentials' tie-break ordering exact; nothing here rides the device
    cost = np.where(score <= -1e29, BIG, -score.astype(np.float64))
    u = np.zeros(P + 1)
    v = np.zeros(S + 1)
    match = np.zeros(S + 1, np.int64)
    way = np.zeros(S + 1, np.int64)
    for r in range(1, P + 1):
        minv = np.full(S + 1, np.inf)
        used = np.zeros(S + 1, bool)
        j0 = 0
        match[0] = r
        while True:
            used[j0] = True
            i0 = match[j0]
            cur = cost[i0 - 1, :] - u[i0] - v[1:]
            better = (~used[1:]) & (cur < minv[1:])
            minv[1:][better] = cur[better]
            way[1:][better] = j0
            free = ~used[1:]
            if not free.any():
                break
            j1 = 1 + int(np.argmin(np.where(free, minv[1:], np.inf)))
            delta = minv[j1]
            u[match[used]] += delta
            v[used] -= delta
            minv[1:][free] -= delta
            j0 = j1
            if match[j0] == 0:
                break
        while j0:
            j1 = way[j0]
            match[j0] = match[j1]
            j0 = j1
    out = np.full((P,), -1, np.int32)
    for j in range(1, S + 1):
        r = match[j]
        if r > 0 and cost[r - 1, j - 1] < BIG:
            out[r - 1] = j - 1
    return out


def exact_assign(
    score: np.ndarray, mask: np.ndarray, capacity: np.ndarray
) -> np.ndarray:
    """Assignment with per-node multi-capacity via slot expansion: node j
    contributes ``capacity[j]`` identical columns. ``score``/``mask``
    (P, N); ``capacity`` (N,) ints >= 0. Returns (P,) node index or -1.

    This is the exact counterpart of one batch_assign round for workloads
    where total score matters more than wall-clock (gang/offline packing);
    resource-vector feasibility beyond slot counts must be pre-encoded in
    ``mask``/``capacity`` by the caller."""
    P, N = score.shape
    cap = np.minimum(np.asarray(capacity, np.int64), P)
    cols = np.repeat(np.arange(N), cap)  # slot -> node
    if len(cols) == 0:
        return np.full((P,), -1, np.int32)
    s = np.where(mask, score, NEG)[:, cols]
    slot = hungarian(np.ascontiguousarray(s, np.float32))
    out = np.full((P,), -1, np.int32)
    ok = slot >= 0
    out[ok] = cols[slot[ok]]
    return out
