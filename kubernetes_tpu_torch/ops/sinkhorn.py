"""Sinkhorn optimal-transport scoring for batched assignment (the port of
``kubernetes_tpu/ops/sinkhorn.py``).

The round solver's per-pod argmax is myopic: every pod bids its best node
regardless of global contention. The entropic-OT plan instead balances the
whole batch against node capacities, so pods whose best nodes tie on
scarce capacity but whose second choices differ are spread by opportunity
cost (pinned by tests/test_torch_sinkhorn.py, the port of
``test_plan_beats_argmax_on_tied_preferences``).

Formulation: unbalanced entropic OT with
  - row marginals: each schedulable pod ships (at most) mass 1,
  - column marginals: node j receives AT MOST ``capacity_j`` (the column
    scaling only ever scales down),
  - kernel K = exp(score/eps) on feasible (pod, node) pairs.

Iterations run in log space. Each iteration is one row pass
(:func:`sinkhorn_u`) and one column pass (:func:`sinkhorn_v`); on a CUDA
tensor each is a hand-written kernel (``csrc/sinkhorn.cu``), on a CPU
tensor its plain PyTorch version beside it. Each pass takes one of two
rules, as the reference does: the fixed-iteration scaling follows its
Pallas kernels (max shift clamped at NEG_INF, ``+1e-30`` inside the log,
u <= NEG_INF/2 -> NEG_INF, v <= NEG_INF/2 -> 0); the tolerance-gated loop
follows its jnp scaling, which the reference runs on every backend
(``jax.scipy.special.logsumexp``, a non-finite u -> NEG_INF, a non-finite
v -> 0, so a zero-capacity column keeps v ~ NEG_INF and takes no mass).
The kernels sum in another order than the plain versions, so the two
agree to a few ulps: the tests hold potentials and plans to
``atol=1e-5, rtol=1e-4``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from kubernetes_tpu_torch import kernels
from kubernetes_tpu_torch.parallel import collectives as coll

NEG_INF = -1e30

#: convergence tolerance for the telemetry loop: max |u - u_prev| under
#: this counts the iteration as converged (log-domain, so ~relative)
STATS_TOL = 1e-3

#: the v pass: one block of V_WARPS warps an SM (each asks for more than
#: half an SM's shared memory), a strip of 4 * lanes columns for lanes in
#: V_LANES (a warp load covers 32 / lanes rows), shared by the blocks of
#: one thread block cluster of a size in V_CLUSTERS, each a band of the
#: rows (at least V_MIN_ROWS: one 4-row tile for each warp). The plan is
#: one wave: no more strips than clusters of that size the card keeps
#: resident (``v_fit``), as many blocks as that allows.
V_WARPS = 16
V_LANES = (32, 16, 8)
V_CLUSTERS = (1, 2, 4, 8, 16)
V_MIN_ROWS = 64


def v_plan(P: int, N: int, fit) -> Tuple[int, int, int, int]:
    """(lanes, strips, cluster, rows a block) of the v pass over (P, N) on
    a card that keeps ``fit[c - 1]`` clusters of c blocks resident: of
    the plans that are one wave, the one with the most blocks, then the
    widest strip (wider row segments read faster from HBM), then the
    smallest cluster (a strip of 128 columns per block, in waves, when no
    plan is one wave). Block r of a cluster owns rows [r * rows,
    min((r + 1) * rows, P)), none of them empty."""
    best, best_key = (V_LANES[0], -(-N // (4 * V_LANES[0])), 1, P), None
    for lanes in V_LANES:
        strips = -(-N // (4 * lanes))
        for cluster in V_CLUSTERS:
            if strips > fit[cluster - 1] or (cluster > 1 and
                                             cluster * V_MIN_ROWS > P):
                continue
            key = (strips * cluster, lanes, -cluster)
            if best_key is None or key > best_key:
                best, best_key = (lanes, strips, cluster,
                                  -(-P // cluster)), key
    return best


_V_FIT: dict = {}


def v_fit(t) -> Tuple[int, ...]:
    """Clusters of 1, 2, ..., V_CLUSTERS[-1] blocks of the v pass that the
    card holding ``t`` keeps resident at once (asked of the card once, then
    cached)."""
    index = t.device.index if t.device.index is not None else 0
    got = _V_FIT.get(index)
    if got is None:
        import ctypes

        out = (ctypes.c_int * V_CLUSTERS[-1])()
        with kernels.on_device(t):
            code = kernels.lib("sinkhorn").ktt_sinkhorn_v_fit(out)
        kernels.check(code, "sinkhorn_v_fit")
        got = _V_FIT[index] = tuple(out)
    return got


#: the split u pass (one shard's row pass): a block of U_WARPS warps walks
#: a tile of rows, each row read by one warp in tiles of U_TILE_COLS
#: columns (8 float4 a lane, all loaded before any arithmetic), or by
#: ``wpr`` warps of the block when the rows alone would leave most of the
#: card's warp slots empty; the grid is one wave at U_BLOCKS_PER_SM blocks
#: an SM (the kernel's launch bounds keep that many resident).
U_WARPS = 8
U_TILE_COLS = 1024
U_BLOCKS_PER_SM = 4


def u_partial_plan(P: int, N: int, sms: int) -> Tuple[int, int, int]:
    """(warps a row, rows a warp group walks, blocks) of the split u pass
    over a (P, N) block on a card with ``sms`` SMs: a wide row is split
    over 2, 4 or 8 warps while twice the warps it then takes still fit
    the card's resident warp slots (and it has a tile for each); block b
    owns rows [b * groups * rows, (b + 1) * groups * rows), every block at
    least one row."""
    slots = U_BLOCKS_PER_SM * sms
    tiles = -(-N // U_TILE_COLS)
    wpr = 1
    while wpr < min(U_WARPS, tiles) and 2 * P * wpr <= slots * U_WARPS:
        wpr *= 2
    groups = U_WARPS // wpr
    rows = max(-(-P // (groups * slots)), 1)
    return wpr, rows, max(-(-P // (groups * rows)), 1)


def _lse(x, dim: int, jnp_rule: bool):
    """Log-sum-exp of ``x`` along ``dim`` in the pass's rule: the jnp rule
    is ``jax.scipy.special.logsumexp`` (shift by the max, 0 when it is not
    finite); the Pallas rule clamps the shift at NEG_INF and adds
    ``1e-30`` inside the log."""
    m = x.amax(dim, keepdim=True)
    if jnp_rule:
        m = torch.where(torch.isfinite(m), m, 0.0)
        return (torch.log(torch.exp(x - m).sum(dim, keepdim=True))
                + m).squeeze(dim)
    m = m.clamp_min(NEG_INF)
    return (torch.log(torch.exp(x - m).sum(dim, keepdim=True) + 1e-30)
            + m).squeeze(dim)


def sinkhorn_u_plain(logk, v, log_r, jnp_rule: bool = False):
    """Row pass: ``u = log_r - lse_j(logk + v)`` (plain version)."""
    u = log_r - _lse(logk + v[None, :], 1, jnp_rule)
    if jnp_rule:
        return torch.where(torch.isfinite(u), u, NEG_INF)
    return torch.where(u > NEG_INF / 2, u, NEG_INF)


def sinkhorn_v_plain(logk, u, log_c, jnp_rule: bool = False):
    """Column pass: ``v = min(log_c - lse_i(logk + u), 0)`` (plain)."""
    v = torch.clamp_max(log_c - _lse(logk + u[:, None], 0, jnp_rule), 0.0)
    if jnp_rule:
        return torch.where(torch.isfinite(v), v, 0.0)
    return torch.where(v > NEG_INF / 2, v, 0.0)


def sinkhorn_u_partial_plain(logk, v, jnp_rule: bool = False):
    """The split row pass over one shard's columns (plain version):
    ``(m, s)``, each (P,), with ``m`` the row's shift (the Pallas rule
    clamps it at NEG_INF; the jnp rule takes 0 where the max is not
    finite) and ``s = sum_j exp(logk + v - m)``. The shards' pairs merge
    into u in ``parallel/collectives.lse_combine``."""
    x = logk + v[None, :]
    m = x.amax(1, keepdim=True)
    if jnp_rule:
        m = torch.where(torch.isfinite(m), m, 0.0)
    else:
        m = m.clamp_min(NEG_INF)
    return m[:, 0], torch.exp(x - m).sum(1)


def sinkhorn_u_partial(logk, v, jnp_rule: bool = False):
    """``(m, s)`` of one shard's (P, n) block: the plain version on a CPU
    tensor, the CUDA kernel on a CUDA tensor (or it raises; any n)."""
    if logk.device.type == "cpu":
        return sinkhorn_u_partial_plain(logk, v, jnp_rule)
    P, N = logk.shape
    kernels.require(logk, "sinkhorn_u_partial logk", torch.float32)
    kernels.require(v, "sinkhorn_u_partial v", torch.float32, (N,))
    wpr, rows, blocks = u_partial_plan(P, N, kernels.sm_count(logk))
    ms = torch.empty((2, P), dtype=torch.float32, device=logk.device)
    with kernels.on_device(logk):
        code = kernels.lib("sinkhorn").ktt_sinkhorn_u_partial(
            logk.data_ptr(), v.data_ptr(), ms[0].data_ptr(), ms[1].data_ptr(),
            P, N, wpr, rows, blocks, int(jnp_rule), kernels.stream_ptr(logk))
    kernels.check(code, "sinkhorn_u_partial")
    kernels.count_launch("sinkhorn_u_partial", (P, N))
    return ms[0], ms[1]


def sinkhorn_u(logk, v, log_r, jnp_rule: bool = False):
    """(P,) row potentials in the Pallas rule, or the jnp rule with
    ``jnp_rule``. CPU tensors take the plain version; CUDA tensors launch
    the kernel (or raise; N must be a multiple of four)."""
    if logk.device.type == "cpu":
        return sinkhorn_u_plain(logk, v, log_r, jnp_rule)
    P, N = logk.shape
    kernels.require(logk, "sinkhorn_u logk", torch.float32)
    kernels.require(v, "sinkhorn_u v", torch.float32, (N,))
    kernels.require(log_r, "sinkhorn_u log_r", torch.float32, (P,))
    kernels.require_vec4(N, "sinkhorn_u", logk, v)
    u = torch.empty((P,), dtype=torch.float32, device=logk.device)
    fn = kernels.lib("sinkhorn").ktt_sinkhorn_u
    with kernels.on_device(logk):
        code = fn(logk.data_ptr(), v.data_ptr(), log_r.data_ptr(),
                  u.data_ptr(), P, N, int(jnp_rule),
                  kernels.stream_ptr(logk))
    kernels.check(code, "sinkhorn_u")
    kernels.count_launch("sinkhorn_u", (P, N))
    return u


def sinkhorn_v(logk, u, log_c, jnp_rule: bool = False):
    """(N,) column potentials in the Pallas rule, or the jnp rule with
    ``jnp_rule``. CPU tensors take the plain version; CUDA tensors launch
    the kernel (or raise; any N)."""
    if logk.device.type == "cpu":
        return sinkhorn_v_plain(logk, u, log_c, jnp_rule)
    P, N = logk.shape
    kernels.require(logk, "sinkhorn_v logk", torch.float32)
    kernels.require(u, "sinkhorn_v u", torch.float32, (P,))
    kernels.require(log_c, "sinkhorn_v log_c", torch.float32, (N,))
    lanes, _strips, cluster, rows = v_plan(P, N, v_fit(logk))
    v = launch_v(logk, u, log_c, lanes, cluster, rows, jnp_rule)
    kernels.count_launch("sinkhorn_v", (P, N))
    return v


def launch_v(logk, u, log_c, lanes: int, cluster: int, rows: int,
             jnp_rule: bool = False):
    """Launch the v kernel with strips of ``4 * lanes`` columns, each over
    a cluster of ``cluster`` blocks of ``rows`` rows (covering every row),
    in the Pallas or the jnp rule and return v (no checks and no count:
    :func:`sinkhorn_v` makes both; the one place the C entry point is
    called)."""
    P, N = logk.shape
    v = torch.empty((N,), dtype=torch.float32, device=logk.device)
    with kernels.on_device(logk):
        code = kernels.lib("sinkhorn").ktt_sinkhorn_v(
            logk.data_ptr(), u.data_ptr(), log_c.data_ptr(), v.data_ptr(), P,
            N, lanes, cluster, rows, int(jnp_rule), kernels.stream_ptr(logk))
    kernels.check(code, "sinkhorn_v")
    return v


def _u_pass(logk, v, log_r, jnp_rule, sh):
    """The row pass of one shard program: the whole-row kernel off the
    mesh (``sh`` None), else the split pass and the merge across shards."""
    if sh is None:
        return sinkhorn_u(logk, v, log_r, jnp_rule)
    m, s = sinkhorn_u_partial(logk, v, jnp_rule)
    return (yield coll.lse(m, s, log_r, jnp_rule))


def _step(logk, log_r, log_c, u, v, jnp_rule=False, sh=None):
    u = yield from _u_pass(logk, v, log_r, jnp_rule, sh)
    v = sinkhorn_v(logk, u, log_c, jnp_rule)
    return u, v


def _delta(u2, u):
    finite = (u2 > NEG_INF / 2) & (u > NEG_INF / 2)
    return torch.where(finite, (u2 - u).abs(), 0.0).amax()


def _stats_scan(logk, log_r, log_c, u, v, iters, tol=STATS_TOL, sh=None):
    """``iters`` scaling iterations while tracking convergence, all on
    device: returns (u, v, stats) with stats = [first iteration whose max
    row-potential delta dropped under ``tol`` (``iters`` if never), final
    delta]."""
    conv = torch.full((), -1, dtype=torch.int32, device=logk.device)
    delta = torch.zeros((), dtype=torch.float32, device=logk.device)
    for i in range(iters):
        u2, v2 = yield from _step(logk, log_r, log_c, u, v, sh=sh)
        delta = _delta(u2, u)
        conv = torch.where((conv < 0) & (delta < tol),
                           torch.full_like(conv, i + 1), conv)
        u, v = u2, v2
    used = torch.where(conv < 0, torch.full_like(conv, iters), conv)
    return u, v, torch.stack([used.to(torch.float32), delta])


def _tol_scan(logk, log_r, log_c, u, v, iters, tol, sh=None):
    """Tolerance-gated scaling loop: iterate until the max row-potential
    delta drops under ``tol`` or the ``iters`` budget runs out. Its passes
    take the jnp rule, as the reference's loop (``_scale_jnp``) does on
    every backend. The loop condition is read on the host, one counted
    sync per iteration (one for the whole mesh: u is replicated)."""
    i = 0
    delta = float("inf")
    while i < iters and delta >= tol:
        u2, v2 = yield from _step(logk, log_r, log_c, u, v, jnp_rule=True,
                                  sh=sh)
        # graftlint: disable=R1 -- never captured: a tolerance makes
        # ops/assign._general_statics return None, so these rounds take
        # device_loop's Python loop and this read is one counted sync
        delta = yield coll.host(_delta(u2, u))
        u, v = u2, v2
        i += 1
    import numpy as np

    from kubernetes_tpu_torch.ops.arrays import upload

    stats = upload([float(i), delta], logk.device, np.float32)
    return u, v, stats


def _scale_g(logk, log_r, log_c, iters, with_stats=False, u0=None, v0=None,
             tol=None, sh=None):
    P, N = logk.shape
    u = (torch.zeros((P,), dtype=torch.float32, device=logk.device)
         if u0 is None else u0)
    v = (torch.zeros((N,), dtype=torch.float32, device=logk.device)
         if v0 is None else v0)
    if tol is not None:
        return (yield from _tol_scan(logk, log_r, log_c, u, v, iters, tol,
                                     sh))
    if with_stats:
        return (yield from _stats_scan(logk, log_r, log_c, u, v, iters,
                                       sh=sh))
    for _ in range(iters):
        u, v = yield from _step(logk, log_r, log_c, u, v, sh=sh)
    return u, v, None


def _scale(logk, log_r, log_c, iters, with_stats=False, u0=None, v0=None,
           tol=None):
    """Alternating log-domain scaling, columns capped at 0 (inequality).
    Returns (u, v, stats) — stats is None unless ``with_stats`` or ``tol``
    is set. ``u0``/``v0`` warm-start the potentials (scaling converges
    from any start, so a warm start changes only the iteration count);
    ``tol`` switches to the tolerance-gated loop (:func:`_tol_scan`)."""
    return coll.solo(_scale_g(logk, log_r, log_c, iters, with_stats, u0, v0,
                              tol))


def sinkhorn_plan_g(score, mask, capacity, eps=0.5, iters=25,
                    with_stats=False, init=None, tol=None,
                    return_potentials=False, sh=None):
    """:func:`sinkhorn_plan` as one shard's program: ``score``, ``mask``,
    ``capacity`` and ``init``'s v are the shard's column block, u is
    replicated; the row pass's log-sum-exp and the rows' any-feasible
    test reduce across shards (``sh`` None: alone, the unsharded plan)."""
    score = score.to(torch.float32)
    row_ok = mask.any(1)
    if sh is not None:
        row_ok = yield coll.all_or(row_ok)
    logk = torch.where(mask, score / eps, NEG_INF).contiguous()
    log_r = torch.where(row_ok, 0.0, NEG_INF)
    log_c = torch.where(capacity > 0,
                        torch.log(torch.clamp_min(capacity, 1e-30)), NEG_INF)
    log_c = log_c.to(torch.float32)
    u0 = v0 = None
    if init is not None:
        # sanitize a foreign start: non-finite rows restart from zero (a
        # NEG_INF row potential would wedge its row at zero mass)
        u0, v0 = init
        u0 = torch.where(torch.isfinite(u0) & (u0 > NEG_INF / 2), u0,
                         0.0).to(torch.float32).contiguous()
        v0 = torch.where(torch.isfinite(v0) & (v0 > NEG_INF / 2), v0,
                         0.0).to(torch.float32).contiguous()
    u, v, stats = yield from _scale_g(logk, log_r, log_c, iters,
                                      with_stats=with_stats, u0=u0, v0=v0,
                                      tol=tol, sh=sh)
    plan = torch.exp(torch.clamp(logk + u[:, None] + v[None, :], NEG_INF,
                                 30.0))
    plan = torch.where(mask, plan, 0.0)
    out = (plan,)
    if with_stats:
        out = out + (stats,)
    if return_potentials:
        out = out + ((u, v),)
    return out if len(out) > 1 else plan


def sinkhorn_plan(
    score: torch.Tensor,
    mask: torch.Tensor,
    capacity: torch.Tensor,
    eps: float = 0.5,
    iters: int = 25,
    with_stats: bool = False,
    init: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    tol: Optional[float] = None,
    return_potentials: bool = False,
):
    """Transport plan (P, N): plan[p, j] ≈ how much of pod p's unit demand
    node j serves at equilibrium. Row sums <= 1; column sums <= capacity
    + O(tolerance).

    ``with_stats`` additionally returns a (2,) f32 device tensor
    [iterations-to-converge, final max row-potential delta]. ``init`` is a
    ``(u0, v0)`` warm start (scaling converges from any start to the same
    fixpoint); ``tol`` switches to the tolerance-gated loop;
    ``return_potentials`` appends the final ``(u, v)``."""
    return coll.solo(sinkhorn_plan_g(score, mask, capacity, eps, iters,
                                     with_stats, init, tol,
                                     return_potentials))
